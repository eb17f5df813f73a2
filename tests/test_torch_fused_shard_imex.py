"""Kernel K10, the fused IMEX ark324 step on one shard of a mesh
(crdmodel_tpu_torch/ops/fused_shard_imex.py).

On the CPU: one sharded step through the kernel's plain version against
the JAX package's K10 run in interpret mode under shard_map on its 8
virtual devices, f32, from a numpy-seeded state, on even and uneven meshes,
frozen and released: y on the physical cells to K3's limits
(tests/test_torch_fused_imex.py: 5e-7 FHN, 2e-6 Goldbeter, whose JAX
kernel differentiates the kinetics where the port takes the closed-form
Jacobian), the error sum to 1e-4 relative where the error estimate
dominates it (h = 0.1 for FHN; at h = 0.01 the Newton term's f32 rounding
is a tenth of it, ROADMAP queue 3); whole small runs through the plain K10
against the port's sharded torch path; the mirror-pad invariant of uneven
meshes; the plain version of the kernel's partial sums
(fused_shard_imex_tile_sums: their number, and their total against the
plain step's sum) on even and mirror-padded meshes. On a CUDA card (marker
`cuda`): the CUDA kernel against its plain version, y_new's block and
every partial sum bitwise:

    python -m pytest tests/test_torch_fused_shard_imex.py -m cuda --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.core.problem import build_problem
from crdmodel_tpu_torch.ops import fused_shard_imex as f10
from crdmodel_tpu_torch.parallel.mesh import make_mesh
from crdmodel_tpu_torch.parallel.sharded import (gather, make_reduce,
                                                 mesh_pad_spec, shard_params,
                                                 sharded_params,
                                                 simulate_sharded,
                                                 split_state)

BETAS = {"fhn": 1.25, "goldbeter": 0.4}
# (h, whether the error sums are compared) and the limit on y, as K3's test
STEPS = {"fhn": ((0.01, False), (0.1, True)), "goldbeter": ((0.01, True),)}
Y_ATOL = {"fhn": 5e-7, "goldbeter": 2e-6}
# (seg_end, fz): a step in the frozen piece, and one after the release
SEGMENTS = ((0.2, 1.0), (0.5, 0.0))


def _kw(model, **over):
    return {**dict(model=model, surface="torus", x_mesh=32,
                   surface_width=20.0, surface_length=40.0, t_final=0.4,
                   output_timestep=2, beta=BETAS[model], t_boundary=0.3,
                   dtype="float32", rtol=1e-5, atol=1e-8, method="ark324",
                   use_pallas=True), **over}


def _state(y0, seed=0):
    """The IC plus 0.05 N(0, 1) noise (tests/test_imex.py's state)."""
    return y0 + 0.05 * np.random.default_rng(seed).standard_normal(y0.shape)


def _mesh(shape, device="cpu"):
    return make_mesh(shape=shape, devices=[device] * 8)


def port_step(kw, shape, y_np, h, seg_end):
    """One step of the port's sharded K10 path: (physical y_new, err sum)."""
    cfg = SimConfig(**kw)
    problem = build_problem(cfg, "cpu")
    mesh = _mesh(shape)
    pad = mesh_pad_spec(cfg, mesh)
    fused = f10.build_fused_shard_imex(problem, mesh, pad)
    y = split_state(torch.tensor(y_np, dtype=torch.float32), mesh, pad, cfg)
    params = shard_params(sharded_params(problem, pad), mesh, pad, cfg)
    y_new, ss = fused.step_err(torch.tensor(0.0), fused.pad(y),
                               torch.tensor(h, dtype=torch.float32),
                               {**params, "_seg_end": torch.tensor(seg_end)})
    return (gather(fused.unpad(y_new), mesh, pad).numpy(),
            float(make_reduce(mesh)(ss)))


def jax_step(kw, shape, y_np, h, seg_end):
    """The same step through the JAX package's K10 in interpret mode under
    shard_map: (physical y_new, psum'd error sum). Its blocks may be taller
    (8-row rounding), so only physical cells compare."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild
    from crdmodel_tpu.parallel import sharded as jsh
    from crdmodel_tpu.parallel.mesh import AXIS_X, AXIS_Y
    from crdmodel_tpu.parallel.mesh import make_mesh as jmake_mesh
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    cfg = JSimConfig(**kw)
    jp = jbuild(cfg)
    mesh = jmake_mesh(shape=shape)
    pad = jsh.mesh_pad_spec(cfg, mesh)
    fused = jsh.maybe_fused_shard_imex(jp, mesh, interpret=True,
                                       pad_spec=pad)
    assert fused is not None
    params, specs = jsh.sharded_params(jp, pad)
    f32 = jnp.float32

    def local(y, params):
        p = fused.prepare_params({**params,
                                  "_seg_end": jnp.asarray(seg_end, f32)})
        y_new, ss = fused.step_err(jnp.asarray(0.0, f32), fused.pad(y),
                                   jnp.asarray(h, f32), p)
        return fused.unpad(y_new), lax.psum(jnp.sum(ss), (AXIS_Y, AXIS_X))

    state = P(None, AXIS_Y, AXIS_X)
    fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(state, specs),
                               out_specs=(state, P()), check_vma=False))
    y = pad.pad_field(y_np) if pad is not None else y_np
    y_new, ss = fn(jnp.asarray(y, f32), params)
    return np.asarray(y_new)[:, :cfg.ny, :cfg.nx], float(ss)


@pytest.mark.parametrize("shape", [(2, 2), (3, 1), (1, 3)])
@pytest.mark.parametrize("model", sorted(BETAS))
def test_plain_step_matches_jax_kernel(model, shape):
    kw = _kw(model)
    cfg = SimConfig(**kw)
    y0 = build_problem(cfg, "cpu").y0.numpy()
    y_np = _state(y0).astype(np.float32)
    for seg_end, fz in SEGMENTS:
        for h, sums in STEPS[model]:
            got, ss = port_step(kw, shape, y_np, h, seg_end)
            want, ss_want = jax_step(kw, shape, y_np, h, seg_end)
            np.testing.assert_allclose(got, want, rtol=0, atol=Y_ATOL[model])
            if sums:
                assert abs(ss - ss_want) <= 1e-4 * ss_want
            if fz:
                # the frozen edge rows hold still
                np.testing.assert_array_equal(got[:, [0, -1]],
                                              y_np[:, [0, -1]])


# the whole runs' limit on the fields: FHN's closed-form and forward-mode
# Jacobians round alike (the runs agree bitwise); Goldbeter's differ by
# ulps in f32, which the rtol 1e-5 run carries to 3.7e-5 (measured on the
# CPU) with the same steps
RUN_ATOL = {"fhn": 1e-6, "goldbeter": 1e-4}


@pytest.mark.parametrize("shape", [(2, 2), (3, 1)])
@pytest.mark.parametrize("model", sorted(BETAS))
def test_sharded_run_through_plain_kernel(model, shape):
    """A whole small run through the plain K10 takes the sharded torch
    path's steps (closed-form against forward-mode Jacobian), fields
    within RUN_ATOL."""
    cfg = SimConfig(**_kw(model, t_final=0.25, t_boundary=0.1))
    mesh = _mesh(shape)
    fused = simulate_sharded(cfg, mesh=mesh)
    torch_path = simulate_sharded(dataclasses.replace(cfg, use_pallas=False),
                                  mesh=mesh)
    assert fused.fused and not torch_path.fused and fused.ok
    np.testing.assert_array_equal(fused.stats.steps.numpy(),
                                  torch_path.stats.steps.numpy())
    np.testing.assert_allclose(fused.trajectory.numpy(),
                               torch_path.trajectory.numpy(), rtol=0,
                               atol=RUN_ATOL[model])


def test_mirror_pad_cells_stay_copies():
    """On an uneven mesh the pad cells evolve as bitwise copies of their
    wrapped physical sources, step after step, and only the physical cells
    enter the error sum."""
    cfg = SimConfig(**_kw("fhn"))
    problem = build_problem(cfg, "cpu")
    mesh = _mesh((3, 2))
    pad = mesh_pad_spec(cfg, mesh)
    assert pad.y.active and not pad.x.active
    fused = f10.build_fused_shard_imex(problem, mesh, pad)
    params = {**shard_params(sharded_params(problem, pad), mesh, pad, cfg),
              "_seg_end": torch.tensor(0.5)}
    y_np = _state(problem.y0.numpy())
    yp = fused.pad(split_state(torch.tensor(y_np, dtype=torch.float32), mesh,
                               pad, cfg))
    for _ in range(3):
        yp, _ = fused.step_err(torch.tensor(0.0), yp, torch.tensor(0.05),
                               params)
        full = gather(fused.unpad(yp), mesh).numpy()
        rows = np.arange(pad.y.n_pad) % cfg.ny
        np.testing.assert_array_equal(full, full[:, rows])
    assert [c.valid_rows for c in fused.constants] == [22, 22, 22, 22, 20, 20]


def test_gate():
    problem = build_problem(SimConfig(**_kw("fhn")), "cpu")
    assert f10.is_shard_imex_supported(problem, torch.float32, 8, 8)
    assert not f10.is_shard_imex_supported(problem, torch.float32, 7, 64)
    assert not f10.is_shard_imex_supported(problem, torch.float64, 64, 64)
    walls = build_problem(SimConfig(**_kw("fhn", surface="flat",
                                          boundary="noflux")), "cpu")
    assert not f10.is_shard_imex_supported(walls, torch.float32, 64, 64)


def test_cpu_wrapper_is_the_plain_version():
    cfg = SimConfig(**_kw("goldbeter"))
    problem = build_problem(cfg, "cpu")
    consts = f10.build_fused_shard_imex(problem, _mesh((2, 2)),
                                        None).constants
    yp = torch.tensor(_state(np.ones((2, 48, 32))), dtype=torch.float32)
    args = (yp, torch.tensor(0.01), torch.tensor(1.0), consts[0], cfg.rtol,
            cfg.atol)
    before = f10.fused_shard_imex_step.launches
    a = f10.fused_shard_imex_step(*args)
    b = f10.fused_shard_imex_step_reference(*args)
    assert f10.fused_shard_imex_step.launches == before
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(2, 2), (3, 1), (3, 2)])
@pytest.mark.parametrize("model", sorted(BETAS))
def test_tile_sums_are_the_one_pass_kernels(model, shape, dtype):
    """The plain partial sums have the one-pass kernel's length (one a
    32x32 tile of the block, fused_imex's 32x32 plan) on every shard,
    mirror-padded ones included, and add up to the plain step's sum (the
    error and the Newton's updates over the physical cells) within f32
    rounding (f64: 1e-13), frozen and released."""
    from crdmodel_tpu_torch.ops.fused_imex import TILE
    from crdmodel_tpu_torch.ops.kernel_common import make_shard_constants
    from crdmodel_tpu_torch.parallel.halo import mirror_halo_pad

    cfg = SimConfig(**_kw(model))
    problem = build_problem(cfg, "cpu")
    mesh = _mesh(shape)
    pad = mesh_pad_spec(cfg, mesh)
    y = torch.tensor(_state(problem.y0.numpy()), dtype=dtype)
    bufs = mirror_halo_pad(list(split_state(y, mesh, pad, cfg)), mesh,
                           f10.HALO, pad)
    consts = make_shard_constants(problem, mesh, pad, f10.HALO, dtype)
    tile_x = tile_y = TILE
    tol = 1e-5 if dtype == torch.float32 else 1e-13
    for buf, sc in zip(bufs, consts):
        nyl, nxl = (n - 2 * f10.HALO for n in buf.shape[1:])
        for fz in (0.0, 1.0):
            args = (buf, torch.tensor(0.01, dtype=dtype),
                    torch.tensor(fz, dtype=dtype), sc, cfg.rtol, cfg.atol)
            sums = f10.fused_shard_imex_tile_sums(*args)
            _, total = f10.fused_shard_imex_step_reference(*args)
            assert sums.shape == (-(-nyl // tile_y) * -(-nxl // tile_x),)
            assert abs(float(sums.sum()) - float(total)) <= tol * float(total)
    padded = any(sc.valid_rows < buf.shape[1] - 2 * f10.HALO
                 for buf, sc in zip(bufs, consts))
    assert padded == (shape[0] == 3)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs an NVIDIA GPU and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(2, 2), (1, 3)])
@pytest.mark.parametrize("model", sorted(BETAS))
def test_kernel_matches_plain_version(model, shape, dtype):
    """The CUDA kernel against its plain version on every shard: y_new's
    block and every partial sum bitwise (fused_shard_imex_tile_sums), the
    error sums' total to rounding, two launches bitwise; the kernel's
    shared bytes are slots_plan's, two blocks an SM in f32."""
    from crdmodel_tpu_torch.ops.fused_shard_step import interior
    from crdmodel_tpu_torch.ops.kernel_common import make_shard_constants
    from crdmodel_tpu_torch.parallel.halo import mirror_halo_pad

    cfg = SimConfig(**_kw(model, x_mesh=64))
    problem = build_problem(cfg, "cuda")
    mesh = _mesh(shape, "cuda")
    pad = mesh_pad_spec(cfg, mesh)
    y = torch.tensor(_state(problem.y0.cpu().numpy()), dtype=dtype,
                     device="cuda")
    bufs = mirror_halo_pad(list(split_state(y, mesh, pad, cfg)), mesh,
                           f10.HALO, pad)
    consts = make_shard_constants(problem, mesh, pad, f10.HALO, dtype)
    for fz in (0.0, 1.0):
        for buf, sc in zip(bufs, consts):
            args = (buf, torch.tensor(0.01, dtype=dtype, device="cuda"),
                    torch.tensor(fz, dtype=dtype, device="cuda"), sc,
                    cfg.rtol, cfg.atol)
            y_k, ss_k = f10.fused_shard_imex_step(*args)
            y_k2, ss_k2 = f10.fused_shard_imex_step(*args)
            y_r, ss_r = f10.fused_shard_imex_step_reference(*args)
            torch.cuda.synchronize()
            p = f10.HALO
            assert torch.equal(interior(y_k, p), interior(y_k2, p))
            assert torch.equal(ss_k, ss_k2)
            assert torch.equal(interior(y_k, p), interior(y_r, p))
            assert torch.equal(ss_k, f10.fused_shard_imex_tile_sums(*args))
            tol = 1e-10 if dtype == torch.float64 else 1e-3
            assert abs(float(ss_k.sum()) - float(ss_r.sum())) <= (
                tol * float(ss_r.sum()))
    info = f10.kernel_info(dtype, consts[0].kinetics_id)
    assert info["shared_bytes"] == f10.slots_plan(y.element_size())[2]
    assert info["blocks_per_sm"] >= (2 if dtype == torch.float32 else 1)
