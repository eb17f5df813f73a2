"""Kernel K13, the fused RKC2 step on one shard of the 3-D box
(crdmodel_tpu_torch/ops/fused_shard_box3d_rkc.py).

On the CPU: one sharded step through the kernel's plain version against
the JAX package's K13 in interpret mode under shard_map on its 8 virtual
devices, f32, from a numpy-seeded state, in each operator mode and on an
uneven mesh (K12's cases, tests/test_torch_fused_shard_box3d.py), at two
steps whose stage counts (from the max-reduced rho, capped at C_RKC = 7)
reach 5 and the cap: physical cells within 1e-5 of the state's scale (JAX's
own bar for K13, tests/test_shard_box3d.py:233) and the WRMS error norm
as K12's test holds it; whole small runs through the plain K13 against the
port's sharded torch path and against the single-device plain K7; the
gate; the kernel's chunked schedule on each shard's buffer
(ops/box_stream.py::box_rkc_stream_model, each chunk's tiles over the
block grown by the evaluations still to come, NaN outside what the chunk
before handed on) against the plain step, the block bitwise, at every s
and z chunking; the partial sums' cover, totals and plan. On a CUDA card
(marker `cuda`): the CUDA kernel against its plain version at s = 2, 5
and 7, y_new's block and every partial sum bitwise, the launched kernel
traced:

    python -m pytest tests/test_torch_fused_shard_box3d_rkc.py -m cuda --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.core.problem import build_problem
from crdmodel_tpu_torch.integrate import rkc
from crdmodel_tpu_torch.ops import fused_shard_box3d_rkc as f13
from crdmodel_tpu_torch.parallel.mesh import make_mesh
from crdmodel_tpu_torch.parallel.sharded import (gather, make_reduce,
                                                 mesh_pad_spec, shard_params,
                                                 sharded_params,
                                                 sharded_rho_bound,
                                                 simulate_sharded,
                                                 split_state)
from crdmodel_tpu_torch.sim import simulate
from test_torch_fused_shard_box3d import (CASES, _state, assert_wrms_close,
                                          box_kw, jax_shard_step, shard_case)

# steps whose stage counts reach about 5 and the cap on the cases' grids
H = {"s5": 0.05, "cap": 0.3}


def _mesh(shape, device="cpu"):
    return make_mesh(shape=shape, devices=[device] * 8)


def port_step(kw, build_kw, shape, y_np, h, seg_end):
    """One step of the port's sharded K13 path: (physical y_new, err sum,
    the stage count)."""
    cfg = SimConfig(**kw)
    problem = build_problem(cfg, "cpu", **build_kw)
    mesh = _mesh(shape)
    pad = mesh_pad_spec(cfg, mesh)
    rho_fn = sharded_rho_bound(problem, mesh, pad)
    fused = f13.build_fused_shard_box3d_rkc(problem, mesh, rho_fn, pad)
    y = split_state(torch.tensor(y_np, dtype=torch.float32), mesh, pad, cfg)
    params = {**shard_params(sharded_params(problem, pad), mesh, pad, cfg),
              "_seg_end": torch.tensor(seg_end, dtype=torch.float32)}
    h = torch.tensor(h, dtype=torch.float32)
    y_new, ss, _ = fused.step_err(torch.tensor(0.0), fused.pad(y), h, params)
    s = min(int(rkc.choose_stages(h, rho_fn(0.0, y, params))), f13.C_RKC)
    return (gather(fused.unpad(y_new), mesh, pad).numpy(),
            float(make_reduce(mesh)(ss)), s)


@pytest.mark.parametrize("name,h", [(name, "cap") for name in sorted(CASES)]
                         + [(name, "s5") for name in ("field", "profile",
                                                      "uneven")])
def test_plain_step_matches_jax_kernel(name, h):
    kw, build_kw, shape = CASES[name]
    kw = {**kw, "method": "rkc2", "t_boundary": 0.5}
    cfg = SimConfig(**kw)
    y_np = _state((2, cfg.nz, cfg.ny, cfg.nx))
    got, ss, s = port_step(kw, build_kw, shape, y_np, H[h], 0.2)
    want, ss_want = jax_shard_step(kw, build_kw, shape, y_np, H[h], 0.2,
                                   "k13")
    assert np.max(np.abs(got - want)) <= 1e-5 * max(1.0, np.abs(y_np).max())
    assert_wrms_close(ss, ss_want, y_np.size)
    if h == "cap" and cfg.model != "fhn":
        assert s == f13.C_RKC


@pytest.mark.parametrize("name", ["profile", "tissue", "field", "uneven"])
def test_sharded_run_through_plain_kernel(name):
    """A whole small run through the plain K13 takes the steps of the
    single-device plain K7 and of the sharded torch path (whose stage
    counts stay within K13's cap at this size, as in
    tests/test_shard_box3d.py:225-233), fields within K9's bar of 1e-4
    (tests/test_torch_fused_shard_rkc.py): the error sums add in another
    order, so h rounds otherwise step by step, and the kernels' RKC
    recurrence rounds otherwise than integrate/rkc.py's; scar cells hold
    their IC within rkc2's rounding."""
    kw, build_kw, shape = CASES[name]
    cfg = SimConfig(**{**kw, "method": "rkc2"})
    mesh = _mesh(shape)
    runs = [simulate_sharded(c, mesh=mesh,
                             problem=build_problem(c, "cpu", **build_kw))
            for c in (cfg, dataclasses.replace(cfg, use_pallas=False))]
    runs.append(simulate(cfg, device="cpu",
                         problem=build_problem(cfg, "cpu", **build_kw)))
    fused, torch_path, single = runs
    assert fused.fused and single.fused and not torch_path.fused
    assert fused.ok
    for other in (single, torch_path):
        np.testing.assert_array_equal(fused.stats.steps.numpy(),
                                      other.stats.steps.numpy())
        np.testing.assert_allclose(fused.trajectory.numpy(),
                                   other.trajectory.numpy(), rtol=0,
                                   atol=1e-4)
    if "obstacle_mask" in build_kw:
        inert = ~build_kw["obstacle_mask"]
        traj = fused.trajectory.numpy()
        assert np.abs(traj[:, :, inert] - traj[:1, :, inert]).max() <= 1e-6


def test_gate():
    cfg = SimConfig(**box_kw(method="rkc2"))
    problem = build_problem(cfg, "cpu")
    assert f13.is_shard_box3d_rkc_supported(problem, torch.float32, 8, 8)
    assert not f13.is_shard_box3d_rkc_supported(problem, torch.float32, 7,
                                                64)
    assert not f13.is_shard_box3d_rkc_supported(problem, torch.float64, 16,
                                                16)
    periodic = build_problem(SimConfig(**box_kw(method="rkc2",
                                                boundary="periodic")), "cpu")
    assert not f13.is_shard_box3d_rkc_supported(periodic, torch.float32, 16,
                                                16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(CASES))
def test_stream_model_matches_plain_shard_step(name, dtype):
    """The kernel's schedule (box_rkc_stream_model with the shard's
    halo: chunk c's tiles over the block grown by extent_rings(s, 4), the
    hand-on planes NaN outside that extent) on each shard's buffer gives
    the plain step's block bitwise, y_new and the estimate, at every s up
    to the cap, in the plan's z chunks and in chunks of 1, 2, 3 and all
    planes."""
    from crdmodel_tpu_torch.ops import box_stream as bs
    from crdmodel_tpu_torch.ops.fused_rkc import (rkc_stages_reference,
                                                  static_stage_tables)
    from crdmodel_tpu_torch.ops.fused_shard_rkc import extent_rings
    from crdmodel_tpu_torch.ops.kernel_common import make_box_rhs_block

    bufs, consts = shard_case(name, dtype)
    mu1, ctab = static_stage_tables(f13.C_RKC, dtype)
    h = torch.tensor(2e-3, dtype=dtype)
    p = f13.HALO
    for s in range(2, f13.C_RKC + 1):
        assert bs.rkc_chunks(s, shard=True) == extent_rings(s, bs.DEPTH)
    for k, (buf, sc) in enumerate(zip(bufs, consts)):
        nz = buf.shape[1]
        plan_chunk = bs.stream_plan(buf.element_size(), tuple(buf.shape[1:]),
                                    p)[1]
        fzt = torch.tensor(float(k % 2), dtype=dtype)
        for s in range(2, f13.C_RKC + 1):
            want_y, want_est = rkc_stages_reference(
                buf, h, torch.tensor(s), mu1, ctab,
                make_box_rhs_block(sc, fzt))
            for z_chunk in sorted({1, 2, 3, nz, plan_chunk}):
                got_y, got_est = bs.box_rkc_stream_model(
                    buf, h, s, mu1, ctab, fzt, sc, z_chunk, halo=p)
                assert torch.equal(f13.interior(got_y, p),
                                   f13.interior(want_y, p)), (s, z_chunk)
                assert torch.equal(f13.interior(got_est, p),
                                   f13.interior(want_est, p)), (s, z_chunk)
                # past the first chunk's extent the hand-on planes are NaN,
                # and so is what the last chunk computes from them there
                if len(bs.rkc_chunks(s)) > 1:
                    assert torch.isnan(got_y[:, :, 0]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(CASES))
def test_tile_sums_add_up_to_error_sum(name, dtype):
    """The chunk kernel's partial sums in plain torch (one a tile and z
    chunk of the block, mirror-pad cells out) add up to the plain step's
    error sum at s = 2, 5 and 7, and are NaN at an s outside the tables; in
    the persistent scheme's modes no plain version replays them."""
    from crdmodel_tpu_torch.ops import box_stream as bs
    from crdmodel_tpu_torch.ops.fused_rkc import static_stage_tables

    bufs, consts = shard_case(name, dtype)
    mu1, ctab = static_stage_tables(f13.C_RKC, dtype)
    for buf, sc in zip(bufs, consts):
        if not bs.rkc_uses_stream(sc.kind):
            with pytest.raises(ValueError, match="persistent"):
                f13.fused_shard_box3d_rkc_tile_sums(
                    buf, torch.tensor(2e-3, dtype=dtype),
                    torch.tensor(1.0, dtype=dtype),
                    torch.tensor(5, dtype=torch.int32), mu1, ctab, sc, 1e-4,
                    1e-7)
            continue
        tiles = bs.stream_plan(buf.element_size(), tuple(buf.shape[1:]),
                               sc.halo, min_tiles=bs.RKC_MIN_TILES)[2]
        for s in (2, 5, 7, 1, f13.C_RKC + 1):
            args = (buf, torch.tensor(2e-3, dtype=dtype),
                    torch.tensor(1.0, dtype=dtype),
                    torch.tensor(s, dtype=torch.int32), mu1, ctab, sc, 1e-4,
                    1e-7)
            sums = f13.fused_shard_box3d_rkc_tile_sums(*args)
            assert sums.shape == (tiles,)
            if not 2 <= s <= f13.C_RKC:
                assert torch.isnan(sums).all()
                continue
            _, ss = f13.fused_shard_box3d_rkc_step_reference(*args)
            rel = abs(float(sums.sum()) - float(ss)) / float(ss)
            assert rel <= (1e-5 if dtype == torch.float32 else 1e-13)


def test_launches_at_the_slab_shard():
    """The sharded slab's shard (2, 32, 272, 272): the first chunk's tiles
    cover the block and 4 rings at s = 6 and 7 (9 x 17 tiles in two z
    chunks of 16: 306 blocks), 3 rings at s = 4 and 5; the last chunk's are
    the block's 128 tiles in two z chunks, 256 blocks, one round of the
    card's 264 resident blocks, which the first launch also takes at
    s <= 3 (one chunk). The first chunk's extent plus the region's 4 rings
    fit the halo of 8."""
    from crdmodel_tpu_torch.ops import box_stream as bs

    shape = (32, 272, 272)
    assert bs.rkc_chunks(7, shard=True) == [(0, 4, 4), (4, 4, 0)]
    assert bs.rkc_chunks(5, shard=True) == [(0, 3, 3), (3, 3, 0)]
    assert bs.rkc_chunks(3, shard=True) == [(0, 4, 0)]
    mt = bs.RKC_MIN_TILES
    assert bs.stream_plan(4, shape, f13.HALO, rings=4,
                          min_tiles=mt)[1:3] == (16, 306)
    assert bs.stream_plan(4, shape, f13.HALO, min_tiles=mt)[1:3] == (16, 256)
    assert bs.rkc_launch_blocks(shape, f13.HALO, f13.C_RKC) == [306, 256]
    assert max(r for s in range(2, f13.C_RKC + 1)
               for _, _, r in bs.rkc_chunks(s, shard=True)) + bs.DEPTH <= (
        f13.HALO)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs an NVIDIA GPU and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_version(name, dtype):
    """The CUDA kernel against its plain version on every shard at s = 2,
    5 and 7, frozen and released: y_new's block bitwise, two launches
    bitwise; in the tensor mode every partial sum bitwise
    (fused_shard_box3d_rkc_tile_sums) and the chunk kernel launched once a
    chunk of the tables' largest s, in the others the error sums to
    rounding and the persistent kernel once (traced)."""
    from crdmodel_tpu_torch.core.problem import make_rho_bound
    from crdmodel_tpu_torch.ops import box_stream as bs
    from crdmodel_tpu_torch.ops import trace
    from crdmodel_tpu_torch.ops.fused_rkc import static_stage_tables
    from crdmodel_tpu_torch.ops.kernel_common import make_shard_box_constants
    from crdmodel_tpu_torch.parallel.halo import mirror_halo_pad

    kw, build_kw, shape = CASES[name]
    cfg = SimConfig(**{**kw, "method": "rkc2", "t_boundary": 0.5})
    problem = build_problem(cfg, "cuda", **build_kw)
    mesh = _mesh(shape, "cuda")
    pad = mesh_pad_spec(cfg, mesh)
    y = torch.tensor(_state((2, cfg.nz, cfg.ny, cfg.nx)), dtype=dtype,
                     device="cuda")
    bufs = mirror_halo_pad(list(split_state(y, mesh, pad, cfg)), mesh,
                           f13.HALO, pad)
    consts = make_shard_box_constants(problem, mesh, pad, f13.HALO, dtype)
    mu1, ctab = static_stage_tables(f13.C_RKC, dtype, "cuda")
    stream = bs.rkc_uses_stream(consts[0].kind)
    rho = float(make_rho_bound(cfg, problem.model, problem.geometry, dtype,
                               diffusion_field=problem.diffusion_field,
                               diffusion_tensor=problem.diffusion_tensor,
                               face_mask=problem.face_mask)(
        0.0, y, problem.params))
    for s in (2, 5, 7):
        st = torch.tensor(s, dtype=torch.int32, device="cuda")
        # the step s - 1 stages stabilize (integrate/rkc.py::STAB_FACTOR)
        h = rkc.STAB_FACTOR * (s - 1) ** 2 / rho
        for fz in (0.0, 1.0):
            for buf, sc in zip(bufs, consts):
                args = (buf, torch.tensor(h, dtype=dtype, device="cuda"),
                        torch.tensor(fz, dtype=dtype, device="cuda"), st,
                        mu1, ctab, sc, cfg.rtol, cfg.atol)
                y_k, ss_k = f13.fused_shard_box3d_rkc_step(*args)
                y_k2, ss_k2 = f13.fused_shard_box3d_rkc_step(*args)
                y_r, ss_r = f13.fused_shard_box3d_rkc_step_reference(*args)
                torch.cuda.synchronize()
                block = f13.interior
                assert torch.equal(block(y_k, f13.HALO),
                                   block(y_k2, f13.HALO))
                assert torch.equal(ss_k, ss_k2)
                assert torch.equal(block(y_k, f13.HALO),
                                   block(y_r, f13.HALO))
                if stream:
                    sums = f13.fused_shard_box3d_rkc_tile_sums(*args)
                    assert ss_k.shape == sums.shape
                    assert torch.equal(ss_k, sums)
                else:
                    tol = 1e-10 if dtype == torch.float64 else 1e-3
                    assert abs(float(ss_k.sum()) - float(ss_r.sum())) <= (
                        tol * float(ss_r.sum()))
        names = trace.kernel_names(
            lambda: f13.fused_shard_box3d_rkc_step(*args), n=1)
        assert len(names) == (bs.rkc_launches(f13.C_RKC) if stream else 1)
        assert all(bs.rkc_kernel_name(consts[0].kind, shard=True) in k
                   for k in names), names
