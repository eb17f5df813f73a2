"""Carry the JAX package's arrays into the port's tensors.

Both packages integrate the same input when the JAX Problem's y0 and params
come across as numpy arrays:

    y0, params = inputs_from_numpy(np.asarray(p.y0),
                                   {k: np.asarray(v) for k, v in p.params.items()},
                                   device="cpu", dtype=torch.float64)

The same function carries states drawn from np.random.default_rng(seed),
of any family's shape ((3, ny, nx) for sir), and any family's parameters.
A sharded run's global parameters (the JAX package's parallel/sharded.py::
sharded_params, as numpy) come across with sharded_params_from_numpy,
which keeps the masks boolean. A structured forcing comes across as plain
data with forcing_from_numpy: each stimulus's profiles and variable, read
off the JAX Stimulus, and its pulse train's starts, duration and
amplitude, so that both packages integrate the same stimulus. A free-form
waveform cannot be carried across this way: its torch twin is written by
hand and passed as the stimulus's `waveform`.
"""

from __future__ import annotations

import numpy as np
import torch

from crdmodel_tpu_torch.core.forcing import (SeparableForcing, Stimulus,
                                             pulse_train)


def inputs_from_numpy(y0, params, *, device, dtype):
    """(y0 tensor, {name: tensor}) on `device` in `dtype`; shapes kept
    (params["b"] is 0-d or (ny, 1), as the JAX package makes it)."""
    def move(x):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    return move(y0), {k: move(v) for k, v in params.items()}


# the boolean entries of a sharded run's parameters: the pad cells, the
# freeze's interior rows and the obstacle's tissue
MASKS = ("valid", "interior", "tissue")


def sharded_params_from_numpy(params, *, device, dtype):
    """The JAX package's sharded_params dict (numpy arrays, "coeffs" a
    tuple) as the port's parallel/sharded.py::sharded_params on `device`:
    the masks (MASKS) bool, every other entry in `dtype`, shapes kept."""
    def move(name, x):
        return torch.tensor(np.asarray(x), device=device,
                            dtype=torch.bool if name in MASKS else dtype)

    return {k: (tuple(move(k, c) for c in v) if k == "coeffs"
                else move(k, v)) for k, v in params.items()}


def forcing_from_numpy(stimuli) -> SeparableForcing:
    """The port's SeparableForcing from plain data: `stimuli`, one mapping a
    stimulus, with "var" and the numpy (or None) "row", "col", "spatial"
    and "zprof" of the JAX Stimulus, and either "pulses" = (starts,
    duration, amplitude) of a pulse train (core/forcing.py::pulse_train)
    or "waveform", a torch waveform written by hand (the waveform contract
    of core/forcing.py)."""
    def array(x):
        return None if x is None else np.asarray(x, np.float64)

    out = []
    for st in stimuli:
        if ("pulses" in st) == ("waveform" in st):
            raise ValueError("a stimulus takes one of 'pulses' and "
                             "'waveform'")
        waveform = (pulse_train(*st["pulses"]) if "pulses" in st
                    else st["waveform"])
        out.append(Stimulus(waveform=waveform, var=int(st.get("var", 0)),
                            row=array(st.get("row")),
                            col=array(st.get("col")),
                            spatial=array(st.get("spatial")),
                            zprof=array(st.get("zprof"))))
    return SeparableForcing(*out)
