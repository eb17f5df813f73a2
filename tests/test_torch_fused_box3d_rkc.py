"""Kernel K7, the fused RKC2 step on the 3-D box (ops/fused_box3d_rkc.py),
on the CPU: its gate against the JAX gate (crdmodel_tpu/ops/
pallas_box3d_rkc.py::is_box3d_rkc_supported), declines included; its plain
version against one step of the JAX Pallas kernel in interpret mode in
each operator mode at s = 2, 5 and 7 (the JAX step's stage choice pinned),
y_new within f32 rounding (4e-6 of the state's scale, the Chebyshev
combination's few roundings) and the WRMS error norm to 2e-3 plus 1e-4
of itself (the estimate's .8(y0 - y_new) carries y_new's rounding over
rtol |y0|: some 6e-4 at rtol 1e-4); whole runs through the plain version
(use_pallas=True on the CPU) against JAX interpret-mode runs: the same
steps, trajectories within the JAX suite's 1e-5
(tests/test_box3d_rkc_kernel.py); and the stage cap's contract: where the
accuracy-limited step needs more than C_RKC = 7 stages, the capped run
takes more steps to the same solution. The kernel's chunked z-streaming
schedule (ops/box_stream.py::box_rkc_stream_model) against the plain step,
bitwise, at every s and z chunking on boxes of 1 to 8 planes; its partial
sums' plan and order.
On a CUDA card (marker `cuda`): the CUDA kernel against the plain version,
y_new and every partial sum bitwise, two launches bitwise equal, the
launched kernel traced:

    python -m pytest tests/test_torch_fused_box3d_rkc.py -m cuda --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.core.problem import build_problem, make_rho_bound
from crdmodel_tpu_torch.integrate import rkc
from crdmodel_tpu_torch.ops import box_stream as bs
from crdmodel_tpu_torch.ops import fused_box3d_rkc as fk
from crdmodel_tpu_torch.ops.fused_rkc import (rkc_stages_reference,
                                              static_stage_tables)
from crdmodel_tpu_torch.ops.kernel_common import (freeze_scalar,
                                                  make_box_rhs_block,
                                                  prepare_box_constants)
from crdmodel_tpu_torch.sim import simulate
from test_torch_fused_box3d import STREAM_MODES, stream_case

NZ, NY, NX = 6, 24, 24


def box_kw(**kw):
    """The JAX box RKC suite's slab (tests/test_box3d_rkc_kernel.py::
    box_cfg)."""
    base = dict(model="aliev_panfilov", surface="box", x_mesh=NX,
                surface_width=10.0, surface_length=10.0, surface_depth=3.0,
                z_mesh=NZ, t_final=2.0, output_timestep=2, beta=0.0,
                dtype="float32", method="rkc2", rtol=1e-4, atol=1e-7,
                boundary="noflux", use_pallas=True)
    base.update(kw)
    return base


def scar_column():
    jj, ii = np.mgrid[0:NY, 0:NX]
    scar = (jj - 12) ** 2 + (ii - 11) ** 2 <= 9
    return np.broadcast_to(~scar, (NZ, NY, NX)).copy()


def field_3d(seed=0):
    """The JAX box suites' diffusion field (tests/test_box3d_kernel.py)."""
    return 0.08 + 0.04 * np.random.default_rng(seed).random((NZ, NY, NX))


def transmural_tensor(z_layers_closed=True):
    """tests/test_anisotropic3d.py::_transmural_tensor, its z couplings
    inside the wall or reaching the top and bottom layers."""
    z = np.linspace(0, 1, NZ)[:, None, None] * np.ones((NZ, NY, NX))
    th = (z - 0.5) * np.pi / 3
    dpar, dperp, dtrans = 0.3, 0.08, 0.02
    c, s = np.cos(th), np.sin(th)
    inner = (z > 0.2) & (z < 0.8) if z_layers_closed else z >= 0.0
    return (dpar * c * c + dperp * s * s, dpar * s * s + dperp * c * c,
            np.full_like(c, dtrans), (dpar - dperp) * c * s,
            np.where(inner, 0.01, 0.0), np.where(inner, -0.008, 0.0))


# name -> (config changes, build arguments): one box of each mode
CASES = {
    "noflux": ({}, {}),
    "noflux_z": (dict(boundary="noflux_z"), {}),
    "scar": ({}, dict(obstacle_mask=scar_column())),
    "field": ({}, dict(diffusion_field=field_3d())),
    "tensor": (dict(boundary="noflux_z", beta=0.05, t_final=0.5),
               dict(diffusion_tensor=transmural_tensor())),
    "fhn_ramp_freeze": (dict(model="fhn", beta=1.25, t_final=1.0,
                             t_boundary=0.4, vary_beta=1, beta_min=0.7,
                             beta_max=1.7, boundary="noflux_z"), {}),
}

GATE_CASES = [
    ("noflux", {}, {}),
    ("periodic_z", dict(boundary="periodic"), {}),
    ("noflux_x", dict(boundary="noflux_x"), {}),
    ("scar", {}, dict(obstacle_mask=scar_column())),
    ("field", {}, dict(diffusion_field=field_3d())),
    ("field_open_z", dict(boundary="noflux_y"),
     dict(diffusion_field=field_3d())),
    ("tensor", dict(boundary="noflux_z"),
     dict(diffusion_tensor=transmural_tensor())),
    ("tensor_open_z_layers", dict(boundary="noflux_x"),
     dict(diffusion_tensor=transmural_tensor(False))),
    ("f64", dict(dtype="float64"), {}),
]


def state(shape, model, seed=9):
    rng = np.random.default_rng(seed)
    if model == "fhn":
        return rng.uniform(-2.0, 2.0, shape)
    return np.stack([rng.uniform(-0.1, 1.1, shape[1:]),
                     rng.uniform(0.0, 2.0, shape[1:])])


def wrms(ss, y):
    return float(np.sqrt(float(ss) / y.numel()))


@pytest.mark.parametrize("name,cfg_kw,build", GATE_CASES,
                         ids=[c[0] for c in GATE_CASES])
def test_gate_agrees_with_jax(name, cfg_kw, build):
    import jax.numpy as jnp

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild
    from crdmodel_tpu.ops import pallas_box3d_rkc

    kw = box_kw(**cfg_kw)
    jp = jbuild(JSimConfig(**kw), **build)
    tp = build_problem(SimConfig(**kw), "cpu", **build)
    want = pallas_box3d_rkc.is_box3d_rkc_supported(jp, jnp.dtype(kw["dtype"]))
    assert fk.is_box3d_rkc_supported(tp, getattr(torch, kw["dtype"])) == want


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_step_matches_jax_interpret_kernel(name, monkeypatch):
    import jax.numpy as jnp

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild
    from crdmodel_tpu.integrate import rkc as jrkc
    from crdmodel_tpu.ops import pallas_box3d_rkc

    cfg_kw, build = CASES[name]
    kw = box_kw(**cfg_kw)
    jp = jbuild(JSimConfig(**kw), **build)
    tp = build_problem(SimConfig(**kw), "cpu", **build)
    bc = prepare_box_constants(tp, torch.float32, "cpu")
    y_np = state(tuple(tp.y0.shape), kw["model"]).astype(np.float32)
    y = torch.tensor(y_np)
    scale = float(np.abs(y_np).max())
    rho = float(make_rho_bound(tp.cfg, tp.model, tp.geometry, torch.float32,
                               diffusion_field=tp.diffusion_field,
                               diffusion_tensor=tp.diffusion_tensor,
                               face_mask=tp.face_mask)(0.0, y, tp.params))
    mu1, ctab = static_stage_tables(fk.C_RKC, torch.float32)
    frkc = pallas_box3d_rkc.build_fused_box3d_rkc_step(jp, jnp.float32,
                                                       interpret=True)
    for s in (2, 5, 7):
        # the JAX step picks s itself: pin its choice
        monkeypatch.setattr(jrkc, "choose_stages",
                            lambda h, r, s=s: jnp.int32(s))
        h = min(0.65 * (s - 1) ** 2 / rho, 1e-2) if s > 2 else 1e-3
        for seg_end in (0.2, 1.5):
            jpar = {**jp.params, "_seg_end": jnp.float32(seg_end)}
            yp, jss, _ = frkc.step_err(jnp.float32(0.0),
                                       frkc.pad(jnp.asarray(y_np)),
                                       jnp.float32(h), jpar)
            want = np.asarray(frkc.unpad(yp))
            tpar = {**tp.params, "_seg_end": torch.tensor(seg_end)}
            fz = freeze_scalar(tpar, bc.has_freeze, float(kw.get(
                "t_boundary", 0.0)), torch.float32)
            got, ss = fk.fused_box3d_rkc_step(
                y, torch.tensor(h), fz, torch.tensor(s, dtype=torch.int32),
                mu1, ctab, bc, kw["rtol"], kw["atol"])
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=4e-6 * scale)
            want_norm = wrms(jss, y)
            assert (abs(wrms(ss.sum(), y) - want_norm)
                    <= 2e-3 + 1e-4 * want_norm)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_runs_take_jax_interpret_steps(name):
    import jax

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild
    from crdmodel_tpu.sim import make_run_fn

    cfg_kw, build = CASES[name]
    kw = box_kw(**cfg_kw)
    jp = jbuild(JSimConfig(**kw), **build)
    traj, stats = jax.jit(make_run_fn(jp, interpret=True)[0])(jp.y0,
                                                              jp.params)
    cfg = SimConfig(**kw)
    got = simulate(cfg, "cpu", problem=build_problem(cfg, "cpu", **build))
    assert got.fused and got.ok
    for field in ("steps", "accepted", "rejected"):
        np.testing.assert_array_equal(getattr(got.stats, field).numpy(),
                                      np.asarray(getattr(stats, field)),
                                      err_msg=field)
    np.testing.assert_allclose(got.trajectory[1:].numpy(), np.asarray(traj),
                               rtol=0, atol=1e-5)


def test_stage_cap_takes_more_steps_same_solution():
    """tests/test_box3d_rkc_kernel.py::test_stage_cap_takes_more_steps_
    same_solution with Aliev–Panfilov kinetics (the port's kernels take
    reaction on): strong diffusion and a loose tolerance push the
    accuracy-limited h above the coverage of 7 stages; the uncapped torch
    path takes s > 7, the kernel's plain version caps h (h_limit) and takes
    more steps to the same solution."""
    cfg = SimConfig(**box_kw(diffusion=16.0, rtol=1e-2, atol=1e-5))
    capped = simulate(cfg, "cpu")
    free = simulate(dataclasses.replace(cfg, use_pallas=False), "cpu")
    assert capped.fused and not free.fused and capped.ok and free.ok
    p = free.problem
    rho = make_rho_bound(cfg, p.model, p.geometry, torch.float32,
                         diffusion_field=p.diffusion_field,
                         face_mask=p.face_mask)(0.0, p.y0, p.params)
    h_mean = cfg.t_final / free.total_steps()
    assert int(rkc.choose_stages(torch.tensor(h_mean), rho)) > fk.C_RKC
    assert capped.total_steps() > free.total_steps()
    np.testing.assert_allclose(capped.trajectory[-1].numpy(),
                               free.trajectory[-1].numpy(), rtol=0,
                               atol=5e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nz", [1, 2, 3, 8])
@pytest.mark.parametrize("name", STREAM_MODES)
def test_stream_model_matches_plain_step(name, nz, dtype):
    """The kernel's schedule (box_rkc_stream_model: chunks of at most four
    evaluations, evaluation i at plane p - i, three-plane rings, Y_{e-1}'s
    u from the ring before, the chunk's cones, F0 and the last two stage
    values handed on, the input's plane clamped) gives the plain step's
    y_new and estimate bitwise at every s up to the cap, in every z
    chunking, frozen and released; no plane it reads is one it has not
    produced (its rings and hand-on planes start as NaN)."""
    bc, y = stream_case(name, nz, dtype)
    mu1, ctab = static_stage_tables(fk.C_RKC, dtype)
    h = torch.tensor(2e-3, dtype=dtype)
    plan_chunk = bs.stream_plan(y.element_size(), tuple(y.shape[1:]))[1]
    for fz in (0.0, 1.0):
        fzt = torch.tensor(fz, dtype=dtype)
        for s in range(2, fk.C_RKC + 1):
            want_y, want_est = rkc_stages_reference(
                y, h, torch.tensor(s), mu1, ctab,
                make_box_rhs_block(bc, fzt))
            for z_chunk in sorted({1, 2, 3, nz, plan_chunk}):
                got_y, got_est = bs.box_rkc_stream_model(
                    y, h, s, mu1, ctab, fzt, bc, z_chunk)
                assert torch.equal(got_y, want_y), (fz, s, z_chunk)
                assert torch.equal(got_est, want_est), (fz, s, z_chunk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", STREAM_MODES)
def test_tile_sums_add_up_to_error_sum(name, dtype):
    """The chunk kernel's partial sums in plain torch (one a tile and z
    chunk of its plan) add up to the plain step's error sum at s = 2, 5 and
    7, and are NaN at an s outside the tables; in the persistent scheme's
    modes no plain version replays them."""
    bc, y = stream_case(name, 8, dtype)
    mu1, ctab = static_stage_tables(fk.C_RKC, dtype)
    if not bs.rkc_uses_stream(bc.kind):
        with pytest.raises(ValueError, match="persistent"):
            fk.fused_box3d_rkc_tile_sums(
                y, torch.tensor(2e-3, dtype=dtype),
                torch.tensor(1.0, dtype=dtype),
                torch.tensor(5, dtype=torch.int32), mu1, ctab, bc, 1e-4,
                1e-7)
        return
    tiles = bs.stream_plan(y.element_size(), tuple(y.shape[1:]),
                           min_tiles=bs.RKC_MIN_TILES)[2]
    for s in (2, 5, 7):
        args = (y, torch.tensor(2e-3, dtype=dtype),
                torch.tensor(1.0, dtype=dtype),
                torch.tensor(s, dtype=torch.int32), mu1, ctab, bc, 1e-4,
                1e-7)
        sums = fk.fused_box3d_rkc_tile_sums(*args)
        _, ss = fk.fused_box3d_rkc_step_reference(*args)
        assert sums.shape == (tiles,)
        rel = abs(float(sums.sum()) - float(ss)) / float(ss)
        assert rel <= (1e-5 if dtype == torch.float32 else 1e-13)
    for s in (1, fk.C_RKC + 1):
        args = (y, torch.tensor(2e-3, dtype=dtype),
                torch.tensor(1.0, dtype=dtype),
                torch.tensor(s, dtype=torch.int32), mu1, ctab, bc, 1e-4,
                1e-7)
        assert torch.isnan(fk.fused_box3d_rkc_tile_sums(*args)).all()


def test_chunks_plan_and_tables():
    """The dispatch (the chunk kernel in the tensor mode, the persistent
    kernels in the others), the chunks of each s (two of at most four
    evaluations from s = 4; one launch a chunk), the slab's launches (K6's
    512 tiles each), the chunk kernel's shared bytes, and the tables the
    kernel takes (s_cap up to C_RKC, two chunks)."""
    assert fk.C_RKC == bs.RKC_STAGES == 2 * bs.DEPTH - 1
    assert [bs.rkc_kernel_name(m) for m in (
        "box_profile", "box_tissue", "box_field", "box_tensor")] == [
        "fused_box3d_rkc_kernel"] * 3 + [bs.RKC_STREAM_KERNEL]
    assert bs.rkc_kernel_name("box_field", shard=True) == (
        "fused_shard_box3d_rkc_kernel")
    assert [bs.rkc_chunks(s) for s in range(2, 8)] == [
        [(0, 3, 0)], [(0, 4, 0)], [(0, 2, 0), (2, 3, 0)],
        [(0, 3, 0), (3, 3, 0)], [(0, 3, 0), (3, 4, 0)],
        [(0, 4, 0), (4, 4, 0)]]
    assert bs.rkc_launch_blocks((32, 512, 512), None, fk.C_RKC) == [512, 512]
    assert bs.rkc_launch_blocks((32, 512, 512), None, 3) == [512]
    assert [bs.rkc_launches(s_cap) for s_cap in range(2, 8)] == [
        1, 1, 2, 2, 2, 2]
    # four rings of three planes on the 40 x 24 region, F0's two variables
    # on four planes at both slots of each thread, the warps' sums, the
    # region's int offsets
    region = 40 * 24
    for itemsize in (4, 8):
        assert bs.rkc_shared_bytes(itemsize) == (
            (3 * 4 * region + 2 * 4 * 1024 + 16) * itemsize + 4 * region)
    for s_cap in (2, fk.C_RKC):
        mu1, ctab = static_stage_tables(s_cap, torch.float32)
        assert fk.check_rkc_tables(mu1, ctab, torch.float32,
                                   torch.device("cpu")) == s_cap
    mu1, ctab = static_stage_tables(fk.C_RKC + 1, torch.float32)
    with pytest.raises(ValueError, match="2..7"):
        fk.check_rkc_tables(mu1, ctab, torch.float32, torch.device("cpu"))


def check_cuda_sums(ss_k, args, dtype):
    """The partial sums of a step on the card: in the chunk kernel's modes
    bitwise the plain version's in its order (fused_box3d_rkc_tile_sums,
    NaN where it is), in the persistent scheme's (an order the card's
    occupancy sets) their total to rounding, NaN at an s outside the
    tables."""
    if bs.rkc_uses_stream(args[6].kind):
        sums = fk.fused_box3d_rkc_tile_sums(*args)
        assert ss_k.shape == sums.shape
        assert torch.equal(torch.isnan(ss_k), torch.isnan(sums))
        assert torch.equal(ss_k.nan_to_num(), sums.nan_to_num())
        return
    if not 2 <= int(args[3]) <= fk.C_RKC:    # no table row: NaN sums
        assert torch.isnan(ss_k).all()
        return
    _, ss_r = fk.fused_box3d_rkc_step_reference(*args)
    rel = abs(float(ss_k.sum()) - float(ss_r.sum())) / float(ss_r.sum())
    assert rel <= (1e-4 if dtype == torch.float32 else 1e-12)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("s", [2, 5, 7])
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernel_matches_plain(name, s, dtype):
    """y_new bitwise equal to the plain version (the same operations in
    the same order, -fmad=false); in the tensor mode every partial sum
    bitwise the plain version's in the chunk kernel's order
    (fused_box3d_rkc_tile_sums), in the others the per-block sums to
    rounding; two launches bitwise; the kernel the dispatch names
    (traced): the chunk kernel once a chunk of the tables' largest s (a
    chunk the step's s lacks returns at once), its shared bytes the plan's
    and, in f32, two blocks an SM; or the persistent kernel once."""
    from crdmodel_tpu_torch.ops import trace
    from crdmodel_tpu_torch.ops.fused_box3d import MODE_IDS

    cfg_kw, build = CASES[name]
    kw = box_kw(**cfg_kw)
    p = build_problem(SimConfig(**kw), "cuda", **build)
    bc = prepare_box_constants(p, dtype, "cuda")
    y = torch.tensor(state(tuple(p.y0.shape), kw["model"]), dtype=dtype,
                     device="cuda")
    mu1, ctab = static_stage_tables(fk.C_RKC, dtype, "cuda")
    ht = torch.tensor(2e-3, dtype=dtype, device="cuda")
    st = torch.tensor(s, dtype=torch.int32, device="cuda")
    for fz in (0.0, 1.0):
        fzt = torch.tensor(fz, dtype=dtype, device="cuda")
        args = (y, ht, fzt, st, mu1, ctab, bc, 1e-4, 1e-7)
        before = fk.fused_box3d_rkc_step.launches
        y_k, ss_k = fk.fused_box3d_rkc_step(*args)
        y_k2, ss_k2 = fk.fused_box3d_rkc_step(*args)
        assert fk.fused_box3d_rkc_step.launches == before + 2
        y_r, _ = fk.fused_box3d_rkc_step_reference(*args)
        torch.cuda.synchronize()
        assert torch.equal(y_k, y_k2) and torch.equal(ss_k, ss_k2)
        assert torch.equal(y_k, y_r)
        check_cuda_sums(ss_k, args, dtype)
    names = trace.kernel_names(lambda: fk.fused_box3d_rkc_step(*args), n=1)
    stream = bs.rkc_uses_stream(bc.kind)
    assert len(names) == (bs.rkc_launches(fk.C_RKC) if stream else 1)
    assert all(bs.rkc_kernel_name(bc.kind) in k for k in names), names
    if stream:
        info = bs.kernel_info("crd_fused_box3d_rkc_info", dtype,
                              MODE_IDS[bc.kind], bc.kinetics_id)
        assert info["shared_bytes"] == bs.rkc_shared_bytes(
            y.element_size())
        assert info["blocks_per_sm"] >= (2 if dtype == torch.float32
                                         else 1)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nz", [1, 2, 3])
@pytest.mark.parametrize("name", STREAM_MODES)
def test_cuda_shallow_boxes(name, nz, dtype):
    """The kernel on boxes of 1, 2 and 3 planes (the input's clamp at both
    walls within one ring) on a grid no tile divides, at every s and at an
    s outside the tables (y kept, NaN sums): y_new bitwise, the partial
    sums as check_cuda_sums holds them."""
    bc, y = stream_case(name, nz, dtype, "cuda")
    mu1, ctab = static_stage_tables(fk.C_RKC, dtype, "cuda")
    for s in range(1, fk.C_RKC + 2):
        args = (y, torch.tensor(2e-3, dtype=dtype, device="cuda"),
                torch.tensor(1.0, dtype=dtype, device="cuda"),
                torch.tensor(s, dtype=torch.int32, device="cuda"), mu1, ctab,
                bc, 1e-4, 1e-7)
        y_k, ss_k = fk.fused_box3d_rkc_step(*args)
        want = (fk.fused_box3d_rkc_step_reference(*args)[0]
                if 2 <= s <= fk.C_RKC else y)
        torch.cuda.synchronize()
        assert torch.equal(y_k, want), s
        check_cuda_sums(ss_k, args, dtype)
