"""Carry the JAX package's arrays into the port's tensors.

Both packages integrate the same input when the JAX Problem's y0 and params
come across as numpy arrays:

    y0, params = inputs_from_numpy(np.asarray(p.y0),
                                   {k: np.asarray(v) for k, v in p.params.items()},
                                   device="cpu", dtype=torch.float64)

The same function carries states drawn from np.random.default_rng(seed).
"""

from __future__ import annotations

import numpy as np
import torch


def inputs_from_numpy(y0, params, *, device, dtype):
    """(y0 tensor, {name: tensor}) on `device` in `dtype`; shapes kept
    (params["b"] is 0-d or (ny, 1), as the JAX package makes it)."""
    def move(x):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    return move(y0), {k: move(v) for k, v in params.items()}
