"""Kernel K9, the fused RKC2 step on one shard of a mesh
(crdmodel_tpu_torch/ops/fused_shard_rkc.py).

On the CPU: one sharded step through the kernel's plain version against
the JAX package's K9 run in interpret mode under shard_map on its 8
virtual devices, f32, from a numpy-seeded state, the stage count chosen
from the cross-shard max of rho on both sides (physical cells to 2e-5,
the error sum to 1e-3 relative: the limits of K2's test), on even and
uneven meshes; whole small runs through the plain K9 against the port's
sharded torch path. On a CUDA card (marker `cuda`): the CUDA kernel
against its plain version, y_new's block bitwise:

    python -m pytest tests/test_torch_fused_shard_rkc.py -m cuda --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.core.problem import build_problem
from crdmodel_tpu_torch.ops import fused_shard_rkc as f9
from crdmodel_tpu_torch.parallel.mesh import make_mesh
from crdmodel_tpu_torch.parallel.sharded import (gather, make_reduce,
                                                 mesh_pad_spec, shard_params,
                                                 sharded_params,
                                                 sharded_rho_bound,
                                                 simulate_sharded,
                                                 split_state)

# 96x48; x_mesh 50 gives 100x50, which a 3x1 mesh pads (blocks of 34 rows
# here, 40 in the JAX package's 8-row layout)
BASE = dict(model="fhn", surface="torus", x_mesh=48, surface_width=20.0,
            surface_length=40.0, t_final=0.5, output_timestep=2, beta=1.25,
            beta_min=0.7, beta_max=1.7, vary_beta=1, t_boundary=0.3,
            dtype="float32", rtol=1e-5, atol=1e-8, use_pallas=True,
            method="rkc2")
FLAT = dict(surface="flat", vary_beta=0, surface_width=10.0,
            surface_length=20.0)
CASES = {"torus_2x2": ({}, (2, 2)), "flat_2x2": (FLAT, (2, 2)),
         "torus_uneven_3x1": (dict(x_mesh=50), (3, 1))}


def _state(shape, seed=13):
    return np.random.default_rng(seed).uniform(-2.0, 2.0, shape)


def _mesh(shape, device="cpu"):
    return make_mesh(shape=shape, devices=[device] * 8)


def port_step(kw, shape, y_np, h, seg_end):
    """One step of the port's sharded K9 path: (physical y_new, err sum)."""
    cfg = SimConfig(**kw)
    problem = build_problem(cfg, "cpu")
    mesh = _mesh(shape)
    pad = mesh_pad_spec(cfg, mesh)
    frkc = f9.build_fused_shard_rkc(problem, mesh,
                                    sharded_rho_bound(problem, mesh, pad),
                                    pad)
    y = split_state(torch.tensor(y_np, dtype=torch.float32), mesh, pad, cfg)
    params = {**shard_params(sharded_params(problem, pad), mesh, pad, cfg),
              "_seg_end": torch.tensor(seg_end, dtype=torch.float32)}
    y_new, ss, _ = frkc.step_err(torch.tensor(0.0), frkc.pad(y),
                                 torch.tensor(h, dtype=torch.float32), params)
    return (gather(frkc.unpad(y_new), mesh, pad).numpy(),
            float(make_reduce(mesh)(ss)))


def jax_step(kw, shape, y_np, h, seg_end):
    """The same step through the JAX package's K9 in interpret mode under
    shard_map, rho pmax'd: (physical y_new, psum'd error sum)."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild
    from crdmodel_tpu.core.problem import make_rho_bound as jrho
    from crdmodel_tpu.parallel import sharded as jsh
    from crdmodel_tpu.parallel.mesh import AXIS_X, AXIS_Y
    from crdmodel_tpu.parallel.mesh import make_mesh as jmake_mesh
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    cfg = JSimConfig(**kw)
    jp = jbuild(cfg)
    mesh = jmake_mesh(shape=shape)
    pad = jsh.mesh_pad_spec(cfg, mesh)
    f32 = jnp.float32
    rho = jrho(cfg, jp.model, jp.geometry, f32,
               max_reduce=lambda x: lax.pmax(x, (AXIS_Y, AXIS_X)))
    if pad is not None:
        rho = jsh._mask_rho(rho)
    frkc = jsh.maybe_fused_shard_rkc(jp, mesh, rho, interpret=True,
                                     pad_spec=pad)
    assert frkc is not None
    params, specs = jsh.sharded_params(jp, pad)

    def local(y, params):
        p = frkc.prepare_params({**params,
                                 "_seg_end": jnp.asarray(seg_end, f32)})
        y_new, ss, _ = frkc.step_err(jnp.asarray(0.0, f32), frkc.pad(y),
                                     jnp.asarray(h, f32), p)
        return frkc.unpad(y_new), lax.psum(jnp.sum(ss), (AXIS_Y, AXIS_X))

    state = P(None, AXIS_Y, AXIS_X)
    fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(state, specs),
                               out_specs=(state, P()), check_vma=False))
    y = pad.pad_field(y_np) if pad is not None else y_np
    y_new, ss = fn(jnp.asarray(y, f32), params)
    return np.asarray(y_new)[:, :cfg.ny, :cfg.nx], float(ss)


@pytest.mark.parametrize("h,seg_end", [(0.05, 0.2), (0.5, 0.5)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_step_matches_jax_kernel(case, h, seg_end):
    change, shape = CASES[case]
    kw = {**BASE, **change}
    cfg = SimConfig(**kw)
    y_np = _state((2, cfg.ny, cfg.nx))
    got, ss = port_step(kw, shape, y_np, h, seg_end)
    want, ss_want = jax_step(kw, shape, y_np, h, seg_end)
    assert np.max(np.abs(got - want)) <= 2e-5 * max(1.0, np.abs(y_np).max())
    assert abs(ss - ss_want) <= 1e-3 * ss_want


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_run_through_plain_kernel(case):
    """A whole small run through the plain K9 against the sharded torch
    path (its recurrence scalars in f32, the kernel's from f64 tables):
    steps within 2%, fields within 1e-4."""
    change, shape = CASES[case]
    cfg = SimConfig(**{**BASE, **change})
    mesh = _mesh(shape)
    fused = simulate_sharded(cfg, mesh=mesh)
    torch_path = simulate_sharded(dataclasses.replace(cfg, use_pallas=False),
                                  mesh=mesh)
    assert fused.fused and not torch_path.fused and fused.ok
    n, m = fused.total_steps(), torch_path.total_steps()
    assert abs(n - m) <= 0.02 * m
    np.testing.assert_allclose(fused.trajectory.numpy(),
                               torch_path.trajectory.numpy(), rtol=0,
                               atol=1e-4)


def test_gate():
    problem = build_problem(SimConfig(**BASE), "cpu")
    assert f9.is_shard_rkc_supported(problem, torch.float32, 24, 24)
    assert not f9.is_shard_rkc_supported(problem, torch.float32, 23, 48)
    assert not f9.is_shard_rkc_supported(problem, torch.float64, 48, 48)
    with pytest.raises(ValueError, match="max-reduced rho_fn"):
        f9.build_fused_shard_rkc(problem, _mesh((2, 2)), None)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs an NVIDIA GPU and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_version(case, dtype):
    """The CUDA kernel against its plain version on every shard at s = 2,
    5 and 23: y_new's block bitwise, the error sums to rounding, two
    launches bitwise."""
    from crdmodel_tpu_torch.ops.fused_rkc import static_stage_tables
    from crdmodel_tpu_torch.ops.fused_shard_step import interior
    from crdmodel_tpu_torch.ops.kernel_common import make_shard_constants
    from crdmodel_tpu_torch.parallel.halo import mirror_halo_pad

    change, shape = CASES[case]
    cfg = SimConfig(**{**BASE, **change})
    problem = build_problem(cfg, "cuda")
    mesh = _mesh(shape, "cuda")
    pad = mesh_pad_spec(cfg, mesh)
    y = torch.tensor(_state((2, cfg.ny, cfg.nx)), dtype=dtype, device="cuda")
    bufs = mirror_halo_pad(list(split_state(y, mesh, pad, cfg)), mesh,
                           f9.P_RKC, pad)
    consts = make_shard_constants(problem, mesh, pad, f9.P_RKC, dtype)
    mu1, ctab = static_stage_tables(f9.S_MAX_KERNEL, dtype, "cuda")
    for s in (2, 5, 23):
        st = torch.tensor(s, dtype=torch.int32, device="cuda")
        h = torch.tensor(0.05, dtype=dtype, device="cuda")
        for fz in (0.0, 1.0):
            fzt = torch.tensor(fz, dtype=dtype, device="cuda")
            for buf, sc in zip(bufs, consts):
                args = (buf, h, fzt, st, mu1, ctab, sc, cfg.rtol, cfg.atol)
                y_k, ss_k = f9.fused_shard_rkc_step(*args)
                y_k2, ss_k2 = f9.fused_shard_rkc_step(*args)
                y_r, ss_r = f9.fused_shard_rkc_step_reference(*args)
                torch.cuda.synchronize()
                p = f9.P_RKC
                assert torch.equal(interior(y_k, p), interior(y_k2, p))
                assert torch.equal(ss_k, ss_k2)
                assert torch.equal(interior(y_k, p), interior(y_r, p))
                tol = 1e-10 if dtype == torch.float64 else 1e-3
                assert abs(float(ss_k.sum()) - float(ss_r.sum())) <= (
                    tol * float(ss_r.sum()))
