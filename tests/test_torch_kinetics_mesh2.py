"""tests/test_torch_kinetics_mesh.py's checks on the other three of the
six families (the Oregonator, the Brusselator, SIR), the whole sharded
runs through the plain K8, K9 and K10 against the port's sharded torch
path (Gray-Scott flat and torus, SIR with three variables; steps equal,
fields within each method's limit) and the gates, in a file of their own
so that pytest-xdist's loadfile spreads them:

    python -m pytest tests/test_torch_kinetics_mesh2.py -m cuda --noconftest
"""

import pytest
import torch

from test_torch_kinetics_mesh import (PLAIN_RUNS, UNEVEN, cuda_matches_plain,
                                      gates_take_the_families_as_the_jax_gates,
                                      plain_matches_jax,
                                      run_through_plain_kernels, shard_steps)

FAMILIES = ("brusselator", "oregonator", "sir")


@pytest.mark.parametrize("model", FAMILIES)
def test_plain_shard_kernels_match_jax_kernels(model):
    plain_matches_jax(model)


@pytest.mark.parametrize("case,method,atol", PLAIN_RUNS)
def test_sharded_run_through_plain_kernels(case, method, atol):
    run_through_plain_kernels(case, method, atol)


def test_gates_take_the_families_as_the_jax_gates():
    gates_take_the_families_as_the_jax_gates()


@pytest.mark.parametrize("shape,over", [((2, 2), {}), ((3, 1), UNEVEN)])
@pytest.mark.parametrize("model", FAMILIES)
def test_plain_tile_sums_add_to_the_plain_total(model, shape, over):
    import numpy as np
    for name, call, plain, sums, args in shard_steps(
            model, "cpu", torch.float64, shape, **over):
        _, ss_b = plain(*args)
        np.testing.assert_allclose(float(sums(*args).sum()),
                                   float(ss_b.sum()), rtol=1e-12,
                                   err_msg=name)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs an NVIDIA GPU and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("model", FAMILIES)
def test_cuda_shard_kernels_match_plain(model, dtype):
    cuda_matches_plain(model, dtype)
