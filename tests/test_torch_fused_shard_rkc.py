"""Kernel K9, the fused RKC2 step on one shard of a mesh
(crdmodel_tpu_torch/ops/fused_shard_rkc.py).

On the CPU: one sharded step through the kernel's plain version against
the JAX package's K9 run in interpret mode under shard_map on its 8
virtual devices, f32, from a numpy-seeded state, the stage count chosen
from the cross-shard max of rho on both sides (physical cells to 2e-5,
the error sum to 1e-3 relative: the limits of K2's test), on even and
uneven meshes; whole small runs through the plain K9 against the port's
sharded torch path; the plain version of the kernel's partial sums
(fused_shard_rkc_tile_sums: the one-pass kernel's tiles, their number and
their total) on even and mirror-padded meshes; a model of the chunks'
cone of dependence over the padded shard. On a CUDA card (marker
`cuda`): the CUDA kernel against its plain version, y_new's block and
every partial sum bitwise, also at the chunk boundaries:

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


def _shard_inputs(case, dtype, device="cpu"):
    """(config, halo-padded buffers, shard constants, stage tables) of a
    CASES entry from _state on `device`."""
    from crdmodel_tpu_torch.ops.fused_rkc import static_stage_tables
    from crdmodel_tpu_torch.ops.kernel_common import make_shard_constants
    from crdmodel_tpu_torch.parallel.halo import mirror_halo_pad

    change, shape = CASES[case]
    cfg = SimConfig(**{**BASE, **change})
    problem = build_problem(cfg, device)
    mesh = _mesh(shape, device)
    pad = mesh_pad_spec(cfg, mesh)
    y = torch.tensor(_state((2, cfg.ny, cfg.nx)), dtype=dtype, device=device)
    bufs = mirror_halo_pad(list(split_state(y, mesh, pad, cfg)), mesh,
                           f9.P_RKC, pad)
    consts = make_shard_constants(problem, mesh, pad, f9.P_RKC, dtype)
    return (cfg, bufs, consts,
            static_stage_tables(f9.S_MAX_KERNEL, dtype, device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_sums_are_the_one_pass_kernels(case, dtype):
    """The plain partial sums have the one-pass kernel's length (one a
    tile of fused_rkc.tile_plan(S_MAX_KERNEL + 1): 32x32 in f32, 16x8 in
    f64, over the block) on every shard, mirror-padded ones included, and
    add up to the plain step's error sum over the physical cells within
    f32 rounding (f64: 1e-13); an s beyond the tables gives NaN sums."""
    from crdmodel_tpu_torch.ops.fused_rkc import tile_plan

    cfg, bufs, consts, (mu1, ctab) = _shard_inputs(case, dtype)
    tile_x, tile_y, _ = tile_plan(f9.S_MAX_KERNEL + 1, bufs[0].element_size())
    assert f9.sum_tiles(f9.S_MAX_KERNEL, bufs[0].element_size()) == (
        tile_x, tile_y) == ((32, 32) if dtype == torch.float32 else (16, 8))
    tol = 1e-5 if dtype == torch.float32 else 1e-13
    for buf, sc in zip(bufs, consts):
        nyl, nxl = (n - 2 * f9.P_RKC for n in buf.shape[1:])
        n_tiles = -(-nyl // tile_y) * -(-nxl // tile_x)
        for s in (2, 6, 17, 23):
            args = (buf, torch.tensor(0.05, dtype=dtype),
                    torch.tensor(1.0, dtype=dtype),
                    torch.tensor(s, dtype=torch.int32), mu1, ctab, sc,
                    cfg.rtol, cfg.atol)
            sums = f9.fused_shard_rkc_tile_sums(*args)
            _, total = f9.fused_shard_rkc_step_reference(*args)
            assert sums.shape == (n_tiles,)
            assert abs(float(sums.sum()) - float(total)) <= tol * float(total)
        beyond = (buf, *args[1:3], torch.tensor(f9.S_MAX_KERNEL + 1,
                                                dtype=torch.int32), *args[4:])
        assert bool(torch.isnan(f9.fused_shard_rkc_tile_sums(*beyond)).all())
    padded = any(sc.valid_rows < buf.shape[1] - 2 * f9.P_RKC
                 for buf, sc in zip(bufs, consts))
    assert padded == (case == "torus_uneven_3x1")


def _cone(s, n, tile_x, halo=f9.P_RKC, tile=32, depth=6):
    """A model of K9's step along one axis of a shard whose block has n
    cells inside `halo` rings: the chunks of f9.extent_rings(s), each over
    tiles of `tile` cells covering the block grown by its rings, each tile
    loading its region `count` cells out (csrc/rkc_chunk.cuh), reading
    the buffer (right on [-halo, n + halo); clamped, so wrong, beyond), the
    hand-off of the chunk before (written on its extent only) and F0
    (written by the first chunk on its extent). Every evaluation is right
    where its input is right one cell either side. Returns the interval
    on which y_new is right and asserts, chunk by chunk, that a region
    reads no further out than the exchange's halo."""
    def meet(a, b):
        return max(a[0], b[0]), min(a[1], b[1])

    buffer = (-halo, n + halo)
    pair = f0 = buffer
    for first, count, rings in f9.extent_rings(s, depth):
        extent = (-rings, n + rings)
        tiles_end = -rings + tile * -(-(n + 2 * rings) // tile)
        load = (-rings - count, tiles_end + count)
        assert load[0] >= -halo, "a region reads before the buffer"
        right = meet(meet(load, pair), buffer)
        for e in range(first, first + count):
            right = (right[0] + 1, right[1] - 1)
            if e == 0:      # F0, in shared memory for the rest of the chunk
                f0 = right
            else:           # every later evaluation reads F0 at its point
                right = meet(right, f0)
        if first == 0:      # F0 handed on, on the first chunk's extent
            f0 = meet(f0, extent)
        pair = meet(right, extent)
    assert rings == 0
    return pair


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("s", range(2, f9.S_MAX_KERNEL + 1))
def test_chunk_cone_stays_inside_the_halo(s, itemsize):
    """For every stage count and both dtypes' sum tiles: the block lies
    P_RKC >= s + 1 rings in; each chunk's region reads only rings inside
    the exchange's halo, and only values still right at that evaluation
    reach the block: y_new is right on every cell of the block, so on every
    sum tile, and each sum tile lies inside one of the last chunk's
    tiles."""
    tile_x, tile_y = f9.sum_tiles(f9.S_MAX_KERNEL, itemsize)
    assert f9.P_RKC >= s + 1
    assert 32 % tile_x == 0 and 32 % tile_y == 0
    for n in (f9.P_RKC, 33, 100, 848, 3248):
        lo, hi = _cone(s, n, tile_x)
        assert lo <= 0 and hi >= n
    # the model fails where the halo is too shallow for the step
    with pytest.raises(AssertionError):
        lo, hi = _cone(s, 100, tile_x, halo=s)
        assert lo <= 0 and hi >= 100


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs an NVIDIA GPU and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["torus_2x2", "torus_uneven_1x3"])
def test_cuda_kernel_chunk_boundaries(case, dtype):
    """K9 at the stage counts around its chunk boundaries (D - 1, D,
    D + 1, 2D, 17, 23), on a 2x2 and an uneven 1x3 mesh: y_new's block
    bitwise the plain version's, two launches equal, every partial sum
    bitwise fused_shard_rkc_tile_sums'; the kernel's shared bytes are
    K2's (chunk_plan), two blocks an SM in f32."""
    from crdmodel_tpu_torch.ops import fused_rkc as fr
    from crdmodel_tpu_torch.ops.fused_shard_step import interior

    from crdmodel_tpu_torch.core.problem import make_rho_bound
    from crdmodel_tpu_torch.ops.kernel_common import make_shard_constants
    from crdmodel_tpu_torch.parallel.halo import mirror_halo_pad

    # 96x48 on 2x2 (blocks of 48x24), 160x80 on 1x3 (27, 27, 26 columns)
    shape, x_mesh = ((2, 2), 48) if case == "torus_2x2" else ((1, 3), 80)
    cfg = SimConfig(**{**BASE, "diffusion": 1000.0, "x_mesh": x_mesh})
    problem = build_problem(cfg, "cuda")
    mesh = _mesh(shape, "cuda")
    pad = mesh_pad_spec(cfg, mesh)
    y = torch.tensor(_state((2, cfg.ny, cfg.nx)), dtype=dtype, device="cuda")
    rho = float(make_rho_bound(cfg, problem.model, problem.geometry, dtype)(
        0.0, y, problem.params))
    bufs = mirror_halo_pad(list(split_state(y, mesh, pad, cfg)), mesh,
                           f9.P_RKC, pad)
    consts = make_shard_constants(problem, mesh, pad, f9.P_RKC, dtype)
    mu1, ctab = fr.static_stage_tables(f9.S_MAX_KERNEL, dtype, "cuda")
    d = fr.CHUNK
    for s in (d - 1, d, d + 1, 2 * d, 17, f9.S_MAX_KERNEL):
        st = torch.tensor(s, dtype=torch.int32, device="cuda")
        h = torch.tensor(0.65 * (s - 1) ** 2 / rho, dtype=dtype,
                         device="cuda")
        for fz in (0.0, 1.0):
            fzt = torch.tensor(fz, dtype=dtype, device="cuda")
            for buf, sc in zip(bufs, consts):
                args = (buf, h, fzt, st, mu1, ctab, sc, cfg.rtol, cfg.atol)
                y_k, ss_k = f9.fused_shard_rkc_step(*args)
                y_k2, ss_k2 = f9.fused_shard_rkc_step(*args)
                y_r, _ = f9.fused_shard_rkc_step_reference(*args)
                torch.cuda.synchronize()
                p = f9.P_RKC
                assert torch.equal(interior(y_k, p), interior(y_k2, p))
                assert torch.equal(ss_k, ss_k2)
                assert torch.equal(interior(y_k, p), interior(y_r, p))
                assert torch.equal(ss_k, f9.fused_shard_rkc_tile_sums(*args))
    info = f9.kernel_info(dtype, consts[0].kinetics_id)
    assert info["shared_bytes"] == fr.chunk_plan(bufs[0].element_size())[3]
    assert info["blocks_per_sm"] >= (2 if dtype == torch.float32 else 1)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs an NVIDIA GPU and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_version(case, dtype):
    """The CUDA kernel against its plain version on every shard at s = 2,
    5 and 23: y_new's block and every partial sum bitwise, the error sums'
    total to rounding, two launches bitwise."""
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
                assert torch.equal(ss_k, f9.fused_shard_rkc_tile_sums(*args))
                tol = 1e-10 if dtype == torch.float64 else 1e-3
                assert abs(float(ss_k.sum()) - float(ss_r.sum())) <= (
                    tol * float(ss_r.sum()))
