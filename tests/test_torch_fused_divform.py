"""Kernel K4, the fused divergence-form ERK step
(crdmodel_tpu_torch/ops/fused_divform.py).

On the CPU: the kernel's plain version against the JAX package's Pallas
kernel (ops/pallas_divform.py) run in interpret mode, f32, one step from a
numpy-seeded state, on three cases: no-flux walls with a scar
(Aliev–Panfilov, with a freeze), a torus obstacle (FitzHugh–Nagumo) and a
flat 2-D diffusion field (dopri54); and the gate.
The register-resident scheme of bs32 (csrc/erk_slots.cuh, ops/
erk_slots.py): its plan's arithmetic, the launcher's dispatch on the
stage count for each tableau the gate takes, the partial sums' length
(one a tile) at the main path's and odd shapes, and the plain partial sums
(fused_divform_tile_sums) against the plain total.
On a CUDA card (marker `cuda`): the CUDA kernel against the plain version,
y_new bitwise, and every partial sum bitwise the plain version's in the
kernel's order, on the cases above, a torus narrower than the halo and an
odd flat grid, with each tableau. The JAX package is imported inside the
test that uses it, so that the card tests run where JAX is not installed:

    python -m pytest tests/test_torch_fused_divform.py -m cuda --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.convert import inputs_from_numpy
from crdmodel_tpu_torch.core.grid import face_openness
from crdmodel_tpu_torch.core.problem import build_problem
from crdmodel_tpu_torch.integrate.erk import TABLEAUS
from crdmodel_tpu_torch.ops import erk_slots
from crdmodel_tpu_torch.ops import fused_divform as fd
from crdmodel_tpu_torch.ops.fused_step import TILE_X, tile_plan
from crdmodel_tpu_torch.ops.kernel_common import (SMEM_BYTES,
                                                  prepare_divform_constants)

FLAT = dict(surface="flat", x_mesh=48, surface_width=20.0,
            surface_length=20.0)
COMMON = dict(t_final=2.0, dtype="float32", rtol=1e-4, atol=1e-7,
              wave_length=0.25, wave_width=0.5)


def _scar(ny, nx, rows, cols):
    mask = np.ones((ny, nx), bool)
    mask[rows, cols] = False
    return mask


# name: (config, build arguments, method, h)
CASES = {
    "ap_noflux_scar": (
        dict(FLAT, model="aliev_panfilov", beta=0.1, diffusion=1.0,
             boundary="noflux", t_boundary=0.4),
        dict(obstacle_mask=_scar(48, 48, slice(20, 30), slice(22, 34))),
        "bs32", 0.02),
    "fhn_torus_obstacle": (
        dict(model="fhn", surface="torus", x_mesh=40, beta=1.25),
        dict(obstacle_mask=_scar(160, 40, slice(60, 80), slice(10, 18))),
        "bs32", 0.05),
    "fhn_flat_xy_field": (
        dict(FLAT, model="fhn", beta=1.25),
        dict(diffusion_field=0.05 + 0.1 * np.random.default_rng(7).random(
            (48, 48))),
        "dopri54", 0.05),
}
# (t, segment end, fz): frozen and released where the case has a freeze
# (segments never straddle tBoundary)
SEGMENTS = ((0.1, 0.4, 1.0), (0.5, 1.0, 0.0))


def _state(shape, model, seed=3):
    rng = np.random.default_rng(seed)
    if model == "aliev_panfilov":
        return np.stack([rng.uniform(-0.1, 1.1, shape[1:]),
                         rng.uniform(0.0, 2.0, shape[1:])])
    return rng.uniform(-2.0, 2.0, shape)


def _case(name, **over):
    kw, build, method, h = CASES[name]
    return {**COMMON, **kw, **over}, build, method, h


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_step_matches_jax_kernel(name):
    """fused_divform_step_reference through build_fused_divform_step against
    the JAX Pallas kernel in interpret mode, f32: y within 2e-5 of the
    state's scale (f32 rounding: JAX on the CPU contracts a*b + c into
    FMAs, the port rounds every operation, as tests/test_torch_fused_step.py
    holds K1), the error sum to 1e-3 relative, and the scar cells bitwise
    at their start (tests/test_divform_kernel.py's bar)."""
    import jax
    import jax.numpy as jnp

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild_problem
    from crdmodel_tpu.integrate.erk import TABLEAUS as JTABLEAUS
    from crdmodel_tpu.ops import pallas_divform

    kw, build, method, h = _case(name)
    jp = jbuild_problem(JSimConfig(**kw), **build)
    fused = pallas_divform.build_fused_divform_step(
        jp, JTABLEAUS[method], jnp.float32, interpret=True)
    jstep = jax.jit(lambda yp, hh, seg: fused.step_err(
        0.0, yp, hh, {**jp.params, "_seg_end": seg}))
    tp = build_problem(SimConfig(**kw), "cpu", **build)
    assert fd.is_divform_supported(tp, TABLEAUS[method], torch.float32)
    step_err = fd.build_fused_divform_step(tp, TABLEAUS[method])
    y_np = _state(np.shape(jp.y0), kw["model"]).astype(np.float32)
    y_t, _ = inputs_from_numpy(y_np, {}, device="cpu", dtype=torch.float32)
    scale = max(1.0, float(np.abs(y_np).max()))
    for t, seg_end, fz in SEGMENTS:
        yp_new, ss_j = jstep(fused.pad(jnp.asarray(y_np)), jnp.float32(h),
                             jnp.float32(seg_end))
        params = {**tp.params, "_seg_end": torch.tensor(seg_end)}
        y_new, ss = step_err(torch.tensor(t), y_t, torch.tensor(h), params)
        want = np.asarray(fused.unpad(yp_new))
        assert np.max(np.abs(y_new.numpy() - want)) <= 2e-5 * scale
        ss_j = float(ss_j)
        assert abs(float(ss) - ss_j) <= 1e-3 * ss_j
        if tp.obstacle_mask is not None:
            scar = ~tp.obstacle_mask
            np.testing.assert_array_equal(y_new.numpy()[:, scar],
                                          y_np[:, scar])
            np.testing.assert_array_equal(want[:, scar], y_np[:, scar])
        if kw.get("t_boundary", 0.0) > 0 and fz:
            np.testing.assert_array_equal(y_new[:, [0, -1]].numpy(),
                                          y_np[:, [0, -1]])


def test_plain_step_f64_is_the_torch_path_step():
    """In f64 the plain K4 takes the torch path's bs32 step on the bounded
    case: the same operator and the same stage order, to 1e-14."""
    from crdmodel_tpu_torch.integrate.erk import make_default_step_err

    kw, build, method, h = _case("ap_noflux_scar", dtype="float64")
    p = build_problem(SimConfig(**kw), "cpu", **build)
    y = torch.tensor(_state(tuple(p.y0.shape), kw["model"]))
    tstep, init = make_default_step_err(TABLEAUS[method], p.rhs, kw["rtol"],
                                        kw["atol"])
    for t_val, seg_end, _ in SEGMENTS:
        params = {**p.params, "_seg_end": torch.tensor(seg_end,
                                                       dtype=torch.float64)}
        t = torch.tensor(t_val, dtype=torch.float64)
        hh = torch.tensor(h, dtype=torch.float64)
        want_y, want_ss, _ = tstep(t, y, hh, params, init(t, y, params))
        got_y, got_ss = fd.build_fused_divform_step(p, TABLEAUS[method])(
            t, y, hh, params)
        assert float((got_y - want_y).abs().max()) <= 1e-14 * float(
            want_y.abs().max())
        np.testing.assert_allclose(float(got_ss), float(want_ss), rtol=1e-12)


def test_gate():
    kw, build, _, _ = _case("ap_noflux_scar")
    p = build_problem(SimConfig(**kw), "cpu", **build)
    bs32 = TABLEAUS["bs32"]
    assert fd.is_divform_supported(p, bs32, torch.float32)
    assert fd.is_divform_supported(p, TABLEAUS["dopri54"], torch.float32)
    assert not fd.is_divform_supported(p, bs32, torch.float64)
    assert not fd.is_divform_supported(dataclasses.replace(p, forcing=object()),
                                       bs32, torch.float32)
    two_diffusing = dataclasses.replace(p, model=dataclasses.replace(
        p.model, diffusive_vars=(0, 1), diffusion_ratios=(1.0, 1.0)))
    assert not fd.is_divform_supported(two_diffusing, bs32, torch.float32)
    p_jd = build_problem(SimConfig(**{**kw, "just_diffusion": 1}), "cpu",
                         **build)
    assert not fd.is_divform_supported(p_jd, bs32, torch.float32)
    gb = build_problem(SimConfig(**{**kw, "model": "goldbeter",
                                    "beta": 0.4}), "cpu", **build)
    assert fd.is_divform_supported(gb, bs32, torch.float32)
    # closed south faces without their north partners: aS is no longer
    # roll_y(aN), so the kernel cannot read aS from aN
    oE, oW, oN, oS = face_openness(p.cfg.ny, p.cfg.nx, "noflux")
    lopsided = dataclasses.replace(p, face_mask=(oE, oW, np.ones_like(oN),
                                                 oS))
    assert not fd.is_divform_supported(lopsided, bs32, torch.float32)
    with pytest.raises(ValueError, match="roll_y"):
        prepare_divform_constants(lopsided, torch.float32, "cpu")
    # a periodic constant-D problem is K1's
    periodic = build_problem(SimConfig(**{**kw, "boundary": "periodic"}),
                             "cpu")
    assert not fd.is_divform_supported(periodic, bs32, torch.float32)


def test_constants_are_contiguous_fields():
    kw, build, _, _ = _case("fhn_torus_obstacle")
    p = build_problem(SimConfig(**kw), "cpu", **build)
    dc = prepare_divform_constants(p, torch.float32, "cpu")
    assert dc.kind == "divform" and len(dc.coeffs) == 3
    for c in (*dc.coeffs, dc.tissue):
        assert tuple(c.shape) == (p.cfg.ny, p.cfg.nx) and c.is_contiguous()
    assert set(np.unique(dc.tissue.numpy())) == {0.0, 1.0}
    kw, build, _, _ = _case("fhn_flat_xy_field")
    p = build_problem(SimConfig(**kw), "cpu", **build)
    assert prepare_divform_constants(p, torch.float32, "cpu").tissue is None


def test_wrapper_refuses_other_devices():
    kw, build, method, _ = _case("ap_noflux_scar")
    p = build_problem(SimConfig(**kw), "cpu", **build)
    dc = prepare_divform_constants(p, torch.float32, "cpu")
    y = torch.empty(p.y0.shape, device="meta")
    with pytest.raises(ValueError, match="no fused divergence-form"):
        fd.fused_divform_step(y, torch.tensor(0.1), torch.tensor(0.0), dc,
                              TABLEAUS[method], 1e-4, 1e-7)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("method", ["bs32", "dopri54"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernel_matches_plain(name, method, dtype):
    """y_new bitwise equal to the plain version (the same operations in
    the same order, -fmad=false); the per-block error sums to rounding."""
    kw, build, _, h = _case(name, t_boundary=0.4)
    p = build_problem(SimConfig(**kw), "cuda", **build)
    dc = prepare_divform_constants(p, dtype, "cuda")
    y = torch.tensor(_state(tuple(p.y0.shape), kw["model"]), dtype=dtype,
                     device="cuda")
    ht = torch.tensor(h, dtype=dtype, device="cuda")
    for _, _, fz in SEGMENTS:
        fzt = torch.tensor(fz, dtype=dtype, device="cuda")
        args = (y, ht, fzt, dc, TABLEAUS[method], 1e-4, 1e-7)
        before = fd.fused_divform_step.launches
        y_k, ss_k = fd.fused_divform_step(*args)
        y_k2, ss_k2 = fd.fused_divform_step(*args)
        assert fd.fused_divform_step.launches == before + 2
        y_r, ss_r = fd.fused_divform_step_reference(*args)
        torch.cuda.synchronize()
        assert torch.equal(y_k, y_k2) and torch.equal(ss_k, ss_k2)
        assert torch.equal(y_k, y_r)
        rel = abs(float(ss_k.sum()) - float(ss_r.sum())) / float(ss_r.sum())
        assert rel <= (1e-5 if dtype == torch.float32 else 1e-12)


# the shared memory and registers of one H100 SM
SM_SHARED_BYTES = 228 * 1024
SM_REGISTERS = 65536
# the edges of the register-resident scheme: a torus narrower than a
# tile's rings (the wrap loops run more than once) and a flat grid whose
# sides are no multiple of the tile (partial tiles); each with a freeze
EDGE_CASES = {
    "fhn_torus_4_columns": (
        dict(model="fhn", surface="torus", x_mesh=4, beta=1.25,
             t_boundary=0.4),
        dict(obstacle_mask=_scar(16, 4, slice(6, 9), slice(1, 3))),
        "bs32", 0.05),
    "ap_noflux_odd": (
        dict(FLAT, model="aliev_panfilov", x_mesh=37, beta=0.1,
             diffusion=1.0, boundary="noflux", t_boundary=0.4),
        {}, "bs32", 0.02),
}


@pytest.mark.parametrize("op_planes", [0, 1])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_slots_plan(itemsize, op_planes):
    """K1's tile for bs32 with its rings; the slots cover the tile and
    its first STAGES - 1 rings, no slot row of threads to spare; the
    shared bytes fit a block (SMEM_BYTES less the static kilobyte), and
    two f32 blocks of 64 registers a thread fit an SM."""
    tile_y, (width, rows), slots, smem = erk_slots.slots_plan(itemsize,
                                                              op_planes)
    assert tile_y == tile_plan(erk_slots.STAGES, itemsize)[1] == 32
    assert (width, rows) == (TILE_X + 8, tile_y + 8)
    points = (width - 2) * (rows - 2)
    assert (slots - 1) * erk_slots.THREADS < points <= (
        slots * erk_slots.THREADS)
    assert smem <= SMEM_BYTES - 1024
    if itemsize == 4:
        assert 2 * (smem + 1024) <= SM_SHARED_BYTES
        assert 2 * erk_slots.THREADS * 64 <= SM_REGISTERS


@pytest.mark.parametrize("method", sorted(TABLEAUS))
def test_dispatch_names_a_kernel_for_each_tableau(method):
    """Every tableau the gate takes has a kernel: bs32 the
    register-resident scheme, the others K1's scheme."""
    kw, build, _, _ = _case("ap_noflux_scar")
    p = build_problem(SimConfig(**kw), "cpu", **build)
    tab = TABLEAUS[method]
    assert fd.is_divform_supported(p, tab, torch.float32)
    assert erk_slots.uses_slots(tab) == (method == "bs32")
    assert erk_slots.kernel_name(tab) == (
        erk_slots.SLOTS_KERNEL if method == "bs32" else
        erk_slots.TILE_KERNEL)


@pytest.mark.parametrize("x_mesh,want", [(400, 650), (200, 175), (37, 10),
                                         (101, 52)])
def test_partial_sums_one_a_tile(x_mesh, want):
    """The plain partial sums number the kernel's tiles: 650 at the
    bounded tissue's 1600x400, 175 at a 2x2 shard's 800x200, and partial
    tiles at odd sides."""
    kw, _, _, h = _edge_case("ap_noflux_odd", x_mesh=x_mesh,
                             surface_length=80.0)
    p = build_problem(SimConfig(**kw), "cpu")
    assert p.cfg.ny == 4 * x_mesh
    ny, nx = p.cfg.ny, p.cfg.nx
    assert -(-nx // TILE_X) * -(-ny // 32) == want
    dc = prepare_divform_constants(p, torch.float32, "cpu")
    y = torch.tensor(_state(tuple(p.y0.shape), kw["model"]),
                     dtype=torch.float32)
    sums = fd.fused_divform_tile_sums(y, torch.tensor(h), torch.tensor(0.0),
                                      dc, TABLEAUS["bs32"], 1e-4, 1e-7)
    assert sums.shape == (want,)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(CASES) + sorted(EDGE_CASES))
def test_tile_sums_add_to_the_plain_total(name, dtype):
    """The plain partial sums, in the kernel's tile order, add up to the
    plain version's total to rounding, for each tableau and freeze."""
    kw, build, _, h = _edge_case(name, t_boundary=0.4)
    p = build_problem(SimConfig(**kw), "cpu", **build)
    dc = prepare_divform_constants(p, dtype, "cpu")
    y = torch.tensor(_state(tuple(p.y0.shape), kw["model"]), dtype=dtype)
    for method in sorted(TABLEAUS):
        for _, _, fz in SEGMENTS:
            args = (y, torch.tensor(h, dtype=dtype),
                    torch.tensor(fz, dtype=dtype), dc, TABLEAUS[method],
                    1e-4, 1e-7)
            sums = fd.fused_divform_tile_sums(*args)
            _, total = fd.fused_divform_step_reference(*args)
            tile_y = tile_plan(TABLEAUS[method].stages, y.element_size())[1]
            ny, nx = p.cfg.ny, p.cfg.nx
            assert sums.shape == (-(-nx // TILE_X) * -(-ny // tile_y),)
            rel = 1e-5 if dtype == torch.float32 else 1e-12
            np.testing.assert_allclose(float(sums.sum()), float(total),
                                       rtol=rel)


def _edge_case(name, **over):
    if name in EDGE_CASES:
        kw, build, method, h = EDGE_CASES[name]
        return {**COMMON, **kw, **over}, build, method, h
    return _case(name, **over)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("method", sorted(TABLEAUS))
@pytest.mark.parametrize("name", sorted(CASES) + sorted(EDGE_CASES))
def test_cuda_partial_sums_bitwise(name, method, dtype):
    """Both schemes on every case, frozen and not: y_new bitwise the
    plain version's, two launches equal, one partial sum a tile, each
    bitwise the plain version's in the kernel's order
    (fused_divform_tile_sums); the launch runs the kernel the dispatch
    names (erk_slots.kernel_name), and the register-resident kernel's
    shared bytes are slots_plan's."""
    from crdmodel_tpu_torch.ops import trace

    kw, build, _, h = _edge_case(name, t_boundary=0.4)
    p = build_problem(SimConfig(**kw), "cuda", **build)
    dc = prepare_divform_constants(p, dtype, "cuda")
    y = torch.tensor(_state(tuple(p.y0.shape), kw["model"]), dtype=dtype,
                     device="cuda")
    tab = TABLEAUS[method]
    for _, _, fz in SEGMENTS:
        args = (y, torch.tensor(h, dtype=dtype, device="cuda"),
                torch.tensor(fz, dtype=dtype, device="cuda"), dc, tab, 1e-4,
                1e-7)
        # a trace can miss kernels, or hold none: pooled traces
        names = trace.kernel_names(lambda: fd.fused_divform_step(*args))
        assert any(erk_slots.kernel_name(tab) in n for n in names), names
        y_k, ss_k = fd.fused_divform_step(*args)
        y_k2, ss_k2 = fd.fused_divform_step(*args)
        y_r, _ = fd.fused_divform_step_reference(*args)
        sums = fd.fused_divform_tile_sums(*args)
        torch.cuda.synchronize()
        assert torch.equal(y_k, y_k2) and torch.equal(ss_k, ss_k2)
        assert torch.equal(y_k, y_r)
        assert ss_k.shape == sums.shape and torch.equal(ss_k, sums)
    if erk_slots.uses_slots(tab):
        info = erk_slots.kernel_info("crd_fused_divform_info", dtype,
                                     dc.kinetics_id)
        smem = erk_slots.slots_plan(y.element_size())[3]
        assert info["shared_bytes"] == smem
        assert info["blocks_per_sm"] >= (2 if dtype == torch.float32 else 1)
