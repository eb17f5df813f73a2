"""tests/test_torch_kinetics_kernels.py's checks on the other three of
the six families (the Oregonator, the Brusselator, SIR), in a file of
their own so that pytest-xdist's loadfile spreads them:

    python -m pytest tests/test_torch_kinetics_kernels2.py -m cuda --noconftest
"""

import pytest
import torch

from test_torch_kinetics_kernels import (cuda_matches_plain, kernel_steps,
                                         plain_matches_jax)

FAMILIES = ("brusselator", "oregonator", "sir")


@pytest.mark.parametrize("model", FAMILIES)
def test_plain_kernels_match_jax_kernels(model):
    plain_matches_jax(model)


@pytest.mark.parametrize("model", FAMILIES)
def test_plain_tile_sums_add_to_the_plain_total(model):
    import numpy as np
    for name, call, plain, sums, args in kernel_steps(model, "cpu",
                                                      torch.float64):
        y_b, ss_b = plain(*args)
        np.testing.assert_allclose(float(sums(*args).sum()),
                                   float(ss_b.sum()), rtol=1e-12,
                                   err_msg=name)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs an NVIDIA GPU and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("model", FAMILIES)
def test_cuda_kernels_match_plain(model, dtype):
    cuda_matches_plain(model, dtype)
