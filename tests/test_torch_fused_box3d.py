"""Kernel K6, the fused ERK step on the 3-D box (ops/fused_box3d.py), on
the CPU: its gate against the JAX gate (crdmodel_tpu/ops/pallas_box3d.py::
is_box3d_supported) on the same problems, declines included; its plain
version against one step of the JAX Pallas kernel in interpret mode in
each operator mode (profile, tissue, field, tensor) and with FitzHugh–
Nagumo's beta ramp and freeze, within f32 rounding (2e-6 of the state's
scale; the step's WRMS error norm to 5e-5 plus 1e-4 of itself, the
rounding of the stage sums over rtol |y|, where the controller accepts at
1); and whole runs through the plain version (use_pallas=True on the CPU)
against JAX interpret-mode runs: the same steps, trajectories within the
JAX box suite's 5e-6 (tests/test_box3d_kernel.py).
The z-streaming scheme's plan and dispatch (ops/box_stream.py): its
schedule's model against the plain step bitwise (y_new and the error, f32
and f64, frozen and released, the four modes and the beta ramp, nz = 1, 2,
3, 8 on a grid no tile divides, z chunks of 1, 2, 3 and nz planes), and
its partial sums: every cell in exactly one, adding up to the plain
step's error sum.
On a CUDA card (marker `cuda`): the CUDA kernel against the plain version,
y_new bitwise, two launches bitwise equal, every partial sum of a bs32
launch bitwise the plain version's in the kernel's order, the launched
kernel the dispatch names (pooled profiler traces) and the stream
kernel's shared bytes and blocks an SM; boxes of 1, 2 and 3 planes. The
JAX package is imported inside the tests that use it, so that the card
tests run where JAX is not installed:

    python -m pytest tests/test_torch_fused_box3d.py -m cuda --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.core.problem import build_problem
from crdmodel_tpu_torch.integrate.erk import TABLEAUS, Tableau
from crdmodel_tpu_torch.ops import box_stream as bs
from crdmodel_tpu_torch.ops import fused_box3d as fb
from crdmodel_tpu_torch.ops.fused_step import erk_stages_reference
from crdmodel_tpu_torch.ops.kernel_common import (box_mode, freeze_scalar,
                                                  make_box_rhs_block,
                                                  prepare_box_constants)
from crdmodel_tpu_torch.sim import simulate

NZ, NY, NX = 6, 24, 24


def box_kw(**kw):
    """The JAX box suites' slab (tests/test_box3d_kernel.py::box_cfg)."""
    base = dict(model="aliev_panfilov", surface="box", x_mesh=NX,
                surface_width=10.0, surface_length=10.0, surface_depth=3.0,
                z_mesh=NZ, t_final=2.0, output_timestep=2, beta=0.0,
                dtype="float32", method="bs32", rtol=1e-4, atol=1e-7,
                boundary="noflux", use_pallas=True)
    base.update(kw)
    return base


def wrms(ss, y):
    """The WRMS error norm of a step from its sum of squares."""
    return float(np.sqrt(float(ss) / y.numel()))


def scar_column():
    jj, ii = np.mgrid[0:NY, 0:NX]
    scar = (jj - 12) ** 2 + (ii - 11) ** 2 <= 9
    return np.broadcast_to(~scar, (NZ, NY, NX)).copy()


def transmural_tensor(z_layers_closed=True):
    """The transmural fibre rotation (tests/test_anisotropic3d.py::
    _transmural_tensor) with z couplings inside the wall, or reaching the
    top and bottom layers when z_layers_closed is False."""
    z = np.linspace(0, 1, NZ)[:, None, None] * np.ones((NZ, NY, NX))
    th = (z - 0.5) * np.pi / 3
    dpar, dperp, dtrans = 0.3, 0.08, 0.02
    c, s = np.cos(th), np.sin(th)
    inner = (z > 0.2) & (z < 0.8) if z_layers_closed else z >= 0.0
    return (dpar * c * c + dperp * s * s, dpar * s * s + dperp * c * c,
            np.full_like(c, dtrans), (dpar - dperp) * c * s,
            np.where(inner, 0.01, 0.0), np.where(inner, -0.008, 0.0))


# name -> (config, build arguments, h of the one-step checks)
CASES = {
    "profile": (box_kw(), {}, 2e-3),
    "profile_noflux_z": (box_kw(boundary="noflux_z"), {}, 2e-3),
    "tissue": (box_kw(), dict(obstacle_mask=scar_column()), 2e-3),
    "field": (box_kw(), dict(diffusion_field=0.8 + 0.4 * np.random.
                             default_rng(0).random((NZ, NY, NX))), 2e-3),
    "tensor": (box_kw(boundary="noflux_z", beta=0.05),
               dict(diffusion_tensor=transmural_tensor()), 2e-3),
    "fhn_ramp_freeze": (box_kw(model="fhn", beta=1.25, t_final=1.0,
                               t_boundary=0.4, vary_beta=1, beta_min=0.7,
                               beta_max=1.7, boundary="noflux_z"), {}, 2e-3),
}
# the mode each case takes
MODE_OF = {"profile": "box_profile", "profile_noflux_z": "box_profile",
           "tissue": "box_tissue", "field": "box_field",
           "tensor": "box_tensor", "fhn_ramp_freeze": "box_profile"}


def state(shape, model, seed=7):
    rng = np.random.default_rng(seed)
    if model == "fhn":
        return rng.uniform(-2.0, 2.0, shape)
    return np.stack([rng.uniform(-0.1, 1.1, shape[1:]),
                     rng.uniform(0.0, 2.0, shape[1:])])


def nine_stages(tab_cls):
    """A 9-stage tableau (one over the kernels' MAX_STAGES)."""
    z9 = np.zeros(9)
    return tab_cls(name="nine", order=1, err_order=2,
                   a=np.zeros((9, 9)), b=z9, bhat=z9, c=z9)


# (name, config changes, build arguments, method): the gate's cases
GATE_CASES = [
    ("noflux", {}, {}, "bs32"),
    ("noflux_z", dict(boundary="noflux_z"), {}, "dopri54"),
    ("zonneveld43", {}, {}, "zonneveld43"),
    ("periodic_z", dict(boundary="periodic"), {}, "bs32"),
    ("noflux_x", dict(boundary="noflux_x"), {}, "bs32"),
    ("scar", {}, dict(obstacle_mask=scar_column()), "bs32"),
    ("field", {}, dict(diffusion_field=0.8 + 0.4 * np.random.default_rng(
        1).random((NZ, NY, NX))), "bs32"),
    ("field_periodic_z", dict(boundary="noflux_x"),
     dict(diffusion_field=np.ones((NZ, NY, NX))), "bs32"),
    ("tensor", dict(boundary="noflux_z"),
     dict(diffusion_tensor=transmural_tensor()), "bs32"),
    ("tensor_open_z_layers", dict(boundary="noflux_x"),
     dict(diffusion_tensor=transmural_tensor(False)), "bs32"),
    ("f64", dict(dtype="float64"), {}, "bs32"),
    ("nine_stages", {}, {}, "nine"),
]


@pytest.mark.parametrize("name,cfg_kw,build,method", GATE_CASES,
                         ids=[c[0] for c in GATE_CASES])
def test_gate_agrees_with_jax(name, cfg_kw, build, method):
    import jax.numpy as jnp

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild
    from crdmodel_tpu.integrate import erk as jerk
    from crdmodel_tpu.ops import pallas_box3d

    kw = box_kw(**cfg_kw)
    jp = jbuild(JSimConfig(**kw), **build)
    tp = build_problem(SimConfig(**kw), "cpu", **build)
    if method == "nine":
        jtab = nine_stages(jerk.Tableau)
        ttab = nine_stages(Tableau)
    else:
        jtab, ttab = jerk.TABLEAUS[method], TABLEAUS[method]
    dt = getattr(torch, kw["dtype"])
    want = pallas_box3d.is_box3d_supported(jp, jtab, jnp.dtype(kw["dtype"]))
    assert fb.is_box3d_supported(tp, ttab, dt) == want
    jmode = pallas_box3d._box_mode(jp)[0]
    assert box_mode(tp)[0] == jmode


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_step_matches_jax_interpret_kernel(name):
    import jax.numpy as jnp

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild
    from crdmodel_tpu.integrate import erk as jerk
    from crdmodel_tpu.ops import pallas_box3d

    kw, build, h = CASES[name]
    jp = jbuild(JSimConfig(**kw), **build)
    tp = build_problem(SimConfig(**kw), "cpu", **build)
    bc = prepare_box_constants(tp, torch.float32, "cpu")
    assert bc.kind == MODE_OF[name]
    y_np = state(tuple(tp.y0.shape), kw["model"]).astype(np.float32)
    y = torch.tensor(y_np)
    scale = float(np.abs(y_np).max())
    for method in ("bs32", "dopri54"):
        fs = pallas_box3d.build_fused_box3d_step(
            jp, jerk.TABLEAUS[method], jnp.float32, interpret=True)
        for seg_end in (0.2, 1.5):
            jpar = {**jp.params, "_seg_end": jnp.float32(seg_end)}
            yp, jss = fs.step_err(jnp.float32(0.0),
                                  fs.pad(jnp.asarray(y_np)),
                                  jnp.float32(h), jpar)
            want = np.asarray(fs.unpad(yp))
            tpar = {**tp.params, "_seg_end": torch.tensor(seg_end)}
            fz = freeze_scalar(tpar, bc.has_freeze, float(kw.get(
                "t_boundary", 0.0)), torch.float32)
            got, ss = fb.fused_box3d_step(y, torch.tensor(h), fz, bc,
                                          TABLEAUS[method], kw["rtol"],
                                          kw["atol"])
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=2e-6 * scale)
            want_norm = wrms(jss, y)
            assert (abs(wrms(ss.sum(), y) - want_norm)
                    <= 5e-5 + 1e-4 * want_norm)


def test_tissue_mode_holds_inert_cells_bitwise():
    kw, build, h = CASES["tissue"]
    tp = build_problem(SimConfig(**kw), "cpu", **build)
    bc = prepare_box_constants(tp, torch.float32, "cpu")
    y = torch.tensor(state(tuple(tp.y0.shape), kw["model"]),
                     dtype=torch.float32)
    got, _ = fb.fused_box3d_step(y, torch.tensor(h), torch.tensor(0.0), bc,
                                 TABLEAUS["dopri54"], 1e-4, 1e-7)
    inert = torch.tensor(~build["obstacle_mask"])
    assert torch.equal(got[:, inert], y[:, inert])


# (name, config changes, build arguments): the whole-run cases
RUN_CASES = {
    "noflux": ({}, {}),
    "noflux_z": (dict(boundary="noflux_z"), {}),
    "scar": ({}, dict(obstacle_mask=scar_column())),
    # the JAX suite's field (tests/test_box3d_kernel.py::field_3d)
    "field": ({}, dict(diffusion_field=0.08 + 0.04 * np.random.default_rng(
        0).random((NZ, NY, NX)))),
    "tensor": (dict(boundary="noflux_z", beta=0.05, t_final=0.5),
               dict(diffusion_tensor=transmural_tensor())),
    "fhn_ramp_freeze": (dict(model="fhn", beta=1.25, t_final=1.0,
                             t_boundary=0.4, vary_beta=1, beta_min=0.7,
                             beta_max=1.7, boundary="noflux_z"), {}),
}


@pytest.mark.parametrize("name", sorted(RUN_CASES))
def test_plain_runs_take_jax_interpret_steps(name):
    import jax

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild
    from crdmodel_tpu.sim import make_run_fn

    cfg_kw, build = RUN_CASES[name]
    kw = box_kw(**cfg_kw)
    jp = jbuild(JSimConfig(**kw), **build)
    traj, stats = jax.jit(make_run_fn(jp, interpret=True)[0])(jp.y0,
                                                              jp.params)
    cfg = SimConfig(**kw)
    before = fb.fused_box3d_step.launches
    got = simulate(cfg, "cpu", problem=build_problem(cfg, "cpu", **build))
    assert got.fused and got.ok
    assert fb.fused_box3d_step.launches == before   # no kernel on the CPU
    for field in ("steps", "accepted", "rejected"):
        np.testing.assert_array_equal(getattr(got.stats, field).numpy(),
                                      np.asarray(getattr(stats, field)),
                                      err_msg=field)
    np.testing.assert_allclose(got.trajectory[1:].numpy(), np.asarray(traj),
                               rtol=0, atol=5e-6)
    if name == "scar":
        inert = torch.tensor(~build["obstacle_mask"])
        held = got.trajectory[:, :, inert]
        assert torch.equal(held, held[:1].expand_as(held))


def test_wrapper_refuses_other_constants():
    kw, build, h = CASES["profile"]
    tp = build_problem(SimConfig(**kw), "cpu", **build)
    bc = prepare_box_constants(tp, torch.float32, "cpu")
    y = tp.y0.clone()
    with pytest.raises(ValueError, match="device"):
        fb.launch_box3d("crd_fused_box3d_step", y, torch.tensor(h),
                        torch.tensor(0.0), bc, 5, (), 1e-4, 1e-7)
    flat = build_problem(SimConfig(**{**kw, "surface": "flat",
                                      "z_mesh": 0, "surface_depth": 0.0}),
                         "cpu")
    with pytest.raises(ValueError, match="box_mode is None"):
        prepare_box_constants(flat, torch.float32, "cpu")
    with pytest.raises(ValueError, match="box_mode is None"):
        prepare_box_constants(build_problem(SimConfig(**{
            **kw, "boundary": "periodic"}), "cpu"), torch.float32, "cpu")
    assert dataclasses.replace(bc).kind == "box_profile"


# the stream scheme's checks: a grid no tile divides (nx, ny = 37, 19),
# nz from 1 to 8 (the config takes nz >= 3: the shallower boxes are the
# three-plane problem's constants cut to their planes)
STREAM_NY, STREAM_NX = 19, 37


def stream_case(name, nz, dtype, device="cpu"):
    """(constants, state) of CASES[name]'s mode on an (nz, 19, 37) box,
    the state made from a seed with numpy."""
    kw, _, _ = CASES[name]
    kw = {**kw, "z_mesh": max(nz, 3), "y_mesh": STREAM_NY,
          "x_mesh": STREAM_NX, "surface_width": STREAM_NX / 3.0,
          "surface_length": STREAM_NY / 3.0}
    shape = (max(nz, 3), STREAM_NY, STREAM_NX)
    rng = np.random.default_rng(5)
    jj, ii = np.mgrid[0:STREAM_NY, 0:STREAM_NX]
    build = {
        "tissue": dict(obstacle_mask=np.broadcast_to(
            (jj - 9) ** 2 + (ii - 17) ** 2 > 12, shape).copy()),
        "field": dict(diffusion_field=0.8 + 0.4 * rng.random(shape)),
        "tensor": dict(diffusion_tensor=transmural_tensor_of(shape)),
    }.get(name, {})
    p = build_problem(SimConfig(**kw), device, **build)
    bc = bs.box_planes(prepare_box_constants(p, dtype, device), nz)
    y = torch.tensor(state((2, nz, STREAM_NY, STREAM_NX), kw["model"]),
                     dtype=dtype, device=device)
    return bc, y


def transmural_tensor_of(shape):
    """transmural_tensor on an (nz, ny, nx) box, z couplings inside the
    wall."""
    nz = shape[0]
    z = np.linspace(0, 1, nz)[:, None, None] * np.ones(shape)
    th = (z - 0.5) * np.pi / 3
    dpar, dperp, dtrans = 0.3, 0.08, 0.02
    c, s = np.cos(th), np.sin(th)
    inner = (z > 0.2) & (z < 0.8)
    return (dpar * c * c + dperp * s * s, dpar * s * s + dperp * c * c,
            np.full_like(c, dtrans), (dpar - dperp) * c * s,
            np.where(inner, 0.01, 0.0), np.where(inner, -0.008, 0.0))


STREAM_MODES = ["profile", "tissue", "field", "tensor", "fhn_ramp_freeze"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nz", [1, 2, 3, 8])
@pytest.mark.parametrize("name", STREAM_MODES)
def test_stream_model_matches_plain_step(name, nz, dtype):
    """The stream scheme's schedule (box_stream_model: plane by plane,
    three-plane rings, progressive accumulation, the stage input's plane
    clamped) gives the plain step's y_new and error bitwise, in every z
    chunking, frozen and released; no plane it reads is one it has not
    produced (its rings start as NaN)."""
    bc, y = stream_case(name, nz, dtype)
    tab = TABLEAUS["bs32"]
    h = torch.tensor(2e-3, dtype=dtype)
    plan_chunk = bs.stream_plan(y.element_size(), tuple(y.shape[1:]))[1]
    for fz in (0.0, 1.0):
        fzt = torch.tensor(fz, dtype=dtype)
        want_y, want_err = erk_stages_reference(
            y, h, make_box_rhs_block(bc, fzt), tab)
        for z_chunk in sorted({1, 2, 3, nz, plan_chunk}):
            got_y, got_err = bs.box_stream_model(y, h, fzt, bc, tab, z_chunk)
            assert torch.equal(got_y, want_y), (fz, z_chunk)
            assert torch.equal(got_err, want_err), (fz, z_chunk)


@pytest.mark.parametrize("nz", [1, 3, 8])
def test_stream_tile_sums_cover_every_cell_once(nz):
    """Each partial sum adds exactly the cells of its tile and z chunk:
    integer squares (exact in f32) sum to each tile's own total, and the
    partials to the whole box's."""
    shape = (nz, STREAM_NY, STREAM_NX)
    tile_y, z_chunk, tiles, _ = bs.stream_plan(4, shape)
    sq = torch.tensor(1.0 + np.arange(2 * np.prod(shape)).reshape(
        2, *shape) % 7, dtype=torch.float32)
    got = bs.stream_tile_sums(sq, tile_y, z_chunk)
    assert got.shape == (tiles,)
    want = []
    for z0 in range(0, nz, z_chunk):
        for y0 in range(0, STREAM_NY, tile_y):
            for x0 in range(0, STREAM_NX, bs.TILE_X):
                want.append(float(sq[:, z0:z0 + z_chunk, y0:y0 + tile_y,
                                     x0:x0 + bs.TILE_X].sum()))
    assert got.tolist() == want
    assert float(got.sum()) == float(sq.sum())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", STREAM_MODES)
def test_stream_tile_sums_add_up_to_error_sum(name, dtype):
    bc, y = stream_case(name, 8, dtype)
    args = (y, torch.tensor(2e-3, dtype=dtype), torch.tensor(1.0,
                                                             dtype=dtype),
            bc, TABLEAUS["bs32"], 1e-4, 1e-7)
    sums = fb.fused_box3d_tile_sums(*args)
    _, ss = fb.fused_box3d_step_reference(*args)
    assert sums.shape == (bs.stream_plan(y.element_size(),
                                         tuple(y.shape[1:]))[2],)
    rel = abs(float(sums.sum()) - float(ss)) / float(ss)
    assert rel <= (1e-5 if dtype == torch.float32 else 1e-13)


def test_stream_plan_and_dispatch():
    """bs32 takes the stream scheme, zonneveld43 and dopri54 the persistent
    one; the slab's 512 x 512 planes fill the card without z chunks, and
    the plan's shared bytes are its rings', offsets' and warp sums'."""
    assert bs.uses_stream(TABLEAUS["bs32"])
    for method in ("zonneveld43", "dopri54"):
        assert not bs.uses_stream(TABLEAUS[method])
        assert bs.kernel_name(TABLEAUS[method]) == (
            "fused_box3d_step_kernel")
        assert bs.kernel_name(TABLEAUS[method], shard=True) == (
            "fused_shard_box3d_kernel")
    assert bs.kernel_name(TABLEAUS["bs32"]) == bs.STREAM_KERNEL
    tile_y, z_chunk, tiles, smem = bs.stream_plan(4, (32, 512, 512))
    assert (tile_y, z_chunk, tiles) == (16, 32, 512)
    # four rings of three planes on the 40 x 24 region, the region's int
    # offsets, the warps' sums; outside the profile mode the tile's errors
    # of two variables on four planes
    assert smem == (3 * 4 * 40 * 24 + 16) * 4 + 4 * 40 * 24
    for mode in ("box_tissue", "box_field", "box_tensor"):
        assert bs.stream_plan(8, (32, 512, 512), mode=mode)[3] == (
            (3 * 4 * 40 * 24 + 2 * 4 * 32 * 16 + 16) * 8 + 4 * 40 * 24)
    with pytest.raises(ValueError, match="persistent"):
        kw, build, h = CASES["profile"]
        p = build_problem(SimConfig(**kw), "cpu", **build)
        bc = prepare_box_constants(p, torch.float32, "cpu")
        fb.fused_box3d_tile_sums(p.y0, torch.tensor(h), torch.tensor(0.0),
                                 bc, TABLEAUS["dopri54"], 1e-4, 1e-7)


def check_cuda_step(args, dtype):
    """One bs32 or dopri54 step of K6 on the card against its plain
    version: y_new bitwise, two launches bitwise, the launch counted; a
    bs32 step's partial sums bitwise the plain version's in the stream
    kernel's order, a dopri54 step's total to rounding; the launched
    kernel the dispatch names, from pooled profiler traces."""
    from crdmodel_tpu_torch.ops import trace

    tab = args[4]
    before = fb.fused_box3d_step.launches
    y_k, ss_k = fb.fused_box3d_step(*args)
    y_k2, ss_k2 = fb.fused_box3d_step(*args)
    assert fb.fused_box3d_step.launches == before + 2
    y_r, ss_r = fb.fused_box3d_step_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(y_k, y_k2) and torch.equal(ss_k, ss_k2)
    assert torch.equal(y_k, y_r)
    if bs.uses_stream(tab):
        sums = fb.fused_box3d_tile_sums(*args)
        assert ss_k.shape == sums.shape and torch.equal(ss_k, sums)
    else:
        rel = abs(float(ss_k.sum()) - float(ss_r.sum())) / float(
            ss_r.sum())
        assert rel <= (1e-5 if dtype == torch.float32 else 1e-12)
    want, other = bs.kernels()
    if not bs.uses_stream(tab):
        want, other = other, want
    names = trace.kernel_names(lambda: fb.fused_box3d_step(*args))
    assert any(want in n for n in names), names
    assert not any(other in n for n in names), names


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("method", ["bs32", "dopri54"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernel_matches_plain(name, method, dtype):
    """y_new bitwise equal to the plain version (the same operations in
    the same order, -fmad=false); a bs32 step's partial sums bitwise, a
    dopri54 step's per-block sums to rounding; the launched kernel the
    dispatch names; the stream kernel's shared bytes the plan's and, in
    f32, at least two blocks an SM."""
    from crdmodel_tpu_torch.ops.fused_box3d import MODE_IDS

    kw, build, h = CASES[name]
    p = build_problem(SimConfig(**kw), "cuda", **build)
    bc = prepare_box_constants(p, dtype, "cuda")
    y = torch.tensor(state(tuple(p.y0.shape), kw["model"]), dtype=dtype,
                     device="cuda")
    ht = torch.tensor(h, dtype=dtype, device="cuda")
    for fz in (0.0, 1.0):
        fzt = torch.tensor(fz, dtype=dtype, device="cuda")
        check_cuda_step((y, ht, fzt, bc, TABLEAUS[method], 1e-4, 1e-7),
                        dtype)
    if method == "bs32":
        info = bs.kernel_info("crd_fused_box3d_info", dtype,
                              MODE_IDS[bc.kind], bc.kinetics_id)
        assert info["shared_bytes"] == bs.stream_plan(
            y.element_size(), tuple(y.shape[1:]), mode=bc.kind)[3]
        assert info["blocks_per_sm"] >= (2 if dtype == torch.float32
                                         else 1)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nz", [1, 2, 3])
@pytest.mark.parametrize("name", STREAM_MODES)
def test_cuda_stream_shallow_boxes(name, nz, dtype):
    """The stream kernel on boxes of 1, 2 and 3 planes (the stage input's
    clamp at both walls within one ring) on a grid no tile divides."""
    bc, y = stream_case(name, nz, dtype, "cuda")
    for fz in (0.0, 1.0):
        check_cuda_step((y, torch.tensor(2e-3, dtype=dtype, device="cuda"),
                         torch.tensor(fz, dtype=dtype, device="cuda"), bc,
                         TABLEAUS["bs32"], 1e-4, 1e-7), dtype)
