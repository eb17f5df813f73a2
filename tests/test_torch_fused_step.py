"""Kernel K1, the fused ERK step (crdmodel_tpu_torch/ops/fused_step.py).

On the CPU: the kernel's plain version against the JAX package's Pallas
kernel run in interpret mode, f32, one step from a numpy-seeded state;
the launcher's dispatch on the stage count (ops/erk_slots.py: bs32 on the
register-resident scheme, the others on erk_tile.cuh's) for each tableau
the gate takes, the partial sums' length (one a tile) at the main path's
and odd shapes, and the plain partial sums (fused_step_tile_sums) against
the plain total.
On a CUDA card (marker `cuda`): the CUDA kernel against the plain version,
and y_new and every partial sum bitwise the plain version's in the
kernel's order on the torus, the flat surface, Goldbeter, Aliev–Panfilov,
a torus narrower than a tile's region and an odd grid, with each tableau.
The JAX package is imported inside the test that uses it, so that the card
tests run where JAX is not installed:

    python -m pytest tests/test_torch_fused_step.py -m cuda --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.convert import inputs_from_numpy
from crdmodel_tpu_torch.core.problem import build_problem
from crdmodel_tpu_torch.integrate.erk import TABLEAUS
from crdmodel_tpu_torch.ops import fused_step as fs
from crdmodel_tpu_torch.ops.kernel_common import prepare_constants

BASE = dict(model="fhn", x_mesh=16, surface_width=20, surface_length=40,
            t_final=1.0, output_timestep=2, beta=1.25, beta_min=0.7,
            beta_max=1.7, t_boundary=0.4, dtype="float32", rtol=1e-4,
            atol=1e-6)
SURFACES = {"torus": dict(surface="torus", vary_beta=1),    # beta field
            "flat": dict(surface="flat", vary_beta=0)}      # beta scalar
# a step long enough that the error estimate stands well above f32
# rounding (dopri54's 5th-order error at h=0.01 is at the rounding level)
H = 0.1


def _state(shape, seed=11):
    return np.random.default_rng(seed).uniform(-2.0, 2.0, shape)


def _close(got, want, y_scale):
    err = np.max(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)))
    assert err <= 2e-5 * max(1.0, y_scale), err


@pytest.mark.parametrize("method", ["bs32", "dopri54"])
@pytest.mark.parametrize("surface", sorted(SURFACES))
def test_plain_step_matches_jax_kernel(surface, method):
    import jax
    import jax.numpy as jnp

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild_problem
    from crdmodel_tpu.integrate.erk import TABLEAUS as JTABLEAUS
    from crdmodel_tpu.ops import pallas_step

    kw = {**BASE, **SURFACES[surface]}
    jp = jbuild_problem(JSimConfig(**kw))
    fused = pallas_step.build_fused_step(jp, JTABLEAUS[method], jnp.float32,
                                         interpret=True)
    jstep = jax.jit(lambda yp, h, seg: fused.step_err(
        0.0, yp, h, {**jp.params, "_seg_end": seg}))
    tp = build_problem(SimConfig(**kw), device="cpu")
    kc = prepare_constants(tp, torch.float32, "cpu")
    y_np = _state(np.shape(jp.y0)).astype(np.float32)
    y_t, _ = inputs_from_numpy(y_np, {}, device="cpu", dtype=torch.float32)
    h_t = torch.tensor(H, dtype=torch.float32)
    for seg_end, fz in ((0.4, 1.0), (1.0, 0.0)):
        yp_new, ss_j = jstep(fused.pad(jnp.asarray(y_np)), jnp.float32(H),
                             jnp.float32(seg_end))
        y_new, ss = fs.fused_step(y_t, h_t, torch.tensor(fz), kc,
                                  TABLEAUS[method], kw["rtol"], kw["atol"])
        _close(y_new.numpy(), fused.unpad(yp_new), np.abs(y_np).max())
        ss_j = float(ss_j)
        assert abs(float(ss.sum()) - ss_j) <= 1e-3 * ss_j
        if fz:
            # frozen rows hold still
            np.testing.assert_array_equal(y_new[:, [0, -1]].numpy(),
                                          y_np[:, [0, -1]])


# the Goldbeter torus of data/GoldbeterModelArgs.ini (beta 0.4), with a
# freeze; states near its wave-segment ICs (positive concentrations)
GB_KW = dict(BASE, model="goldbeter", surface="torus", beta=0.4,
             wave_inside=1, wave_length=0.2)
GB_H = 0.01         # Goldbeter's stiff kinetics: bs32 is stable at ~0.01


def _gb_state(y0, seed=11):
    return y0 * np.exp(0.05 * np.random.default_rng(seed).standard_normal(
        y0.shape))


@pytest.mark.parametrize("method", ["bs32", "dopri54"])
def test_plain_goldbeter_step_matches_jax_kernel(method):
    """K1's plain version with the Goldbeter kinetics against the JAX
    Pallas kernel in interpret mode, f32, frozen and released; the limits
    of test_plain_step_matches_jax_kernel."""
    import jax
    import jax.numpy as jnp

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild_problem
    from crdmodel_tpu.integrate.erk import TABLEAUS as JTABLEAUS
    from crdmodel_tpu.ops import pallas_step

    jp = jbuild_problem(JSimConfig(**GB_KW))
    fused = pallas_step.build_fused_step(jp, JTABLEAUS[method], jnp.float32,
                                         interpret=True)
    jstep = jax.jit(lambda yp, h, seg: fused.step_err(
        0.0, yp, h, {**jp.params, "_seg_end": seg}))
    tp = build_problem(SimConfig(**GB_KW), device="cpu")
    assert fs.is_supported(tp, TABLEAUS[method], torch.float32)
    kc = prepare_constants(tp, torch.float32, "cpu")
    y_np = _gb_state(np.asarray(jp.y0)).astype(np.float32)
    y_t, _ = inputs_from_numpy(y_np, {}, device="cpu", dtype=torch.float32)
    h_t = torch.tensor(GB_H, dtype=torch.float32)
    for seg_end, fz in ((0.4, 1.0), (1.0, 0.0)):
        yp_new, ss_j = jstep(fused.pad(jnp.asarray(y_np)), jnp.float32(GB_H),
                             jnp.float32(seg_end))
        y_new, ss = fs.fused_step(y_t, h_t, torch.tensor(fz), kc,
                                  TABLEAUS[method], GB_KW["rtol"],
                                  GB_KW["atol"])
        _close(y_new.numpy(), fused.unpad(yp_new), np.abs(y_np).max())
        ss_j = float(ss_j)
        assert abs(float(ss.sum()) - ss_j) <= 1e-3 * ss_j


# Aliev–Panfilov on the torus (the beta window of tests/test_golden.py),
# with a freeze; states spanning rest, upstroke and recovery
AP_KW = dict(BASE, model="aliev_panfilov", surface="torus", beta=0.15,
             diffusion=1.0, wave_length=0.25, wave_width=0.5)
AP_H = 0.02


def _ap_state(shape, seed=11):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-0.1, 1.1, shape[1:]),
                     rng.uniform(0.0, 2.0, shape[1:])])


@pytest.mark.parametrize("method", ["bs32", "dopri54"])
def test_plain_aliev_panfilov_step_matches_jax_kernel(method):
    """K1's plain version with the Aliev–Panfilov kinetics against the JAX
    Pallas kernel in interpret mode, f32, frozen and released; the limits
    of test_plain_step_matches_jax_kernel."""
    import jax
    import jax.numpy as jnp

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild_problem
    from crdmodel_tpu.integrate.erk import TABLEAUS as JTABLEAUS
    from crdmodel_tpu.ops import pallas_step

    jp = jbuild_problem(JSimConfig(**AP_KW))
    fused = pallas_step.build_fused_step(jp, JTABLEAUS[method], jnp.float32,
                                         interpret=True)
    jstep = jax.jit(lambda yp, h, seg: fused.step_err(
        0.0, yp, h, {**jp.params, "_seg_end": seg}))
    tp = build_problem(SimConfig(**AP_KW), device="cpu")
    assert fs.is_supported(tp, TABLEAUS[method], torch.float32)
    kc = prepare_constants(tp, torch.float32, "cpu")
    assert kc.kinetics_id == 2
    y_np = _ap_state(np.shape(jp.y0)).astype(np.float32)
    y_t, _ = inputs_from_numpy(y_np, {}, device="cpu", dtype=torch.float32)
    h_t = torch.tensor(AP_H, dtype=torch.float32)
    for seg_end, fz in ((0.4, 1.0), (1.0, 0.0)):
        yp_new, ss_j = jstep(fused.pad(jnp.asarray(y_np)), jnp.float32(AP_H),
                             jnp.float32(seg_end))
        y_new, ss = fs.fused_step(y_t, h_t, torch.tensor(fz), kc,
                                  TABLEAUS[method], AP_KW["rtol"],
                                  AP_KW["atol"])
        _close(y_new.numpy(), fused.unpad(yp_new), np.abs(y_np).max())
        ss_j = float(ss_j)
        assert abs(float(ss.sum()) - ss_j) <= 1e-3 * ss_j


def test_step_err_uses_segment_freeze():
    """build_fused_step reads the freeze from params['_seg_end']."""
    cfg = SimConfig(**{**BASE, **SURFACES["torus"]})
    p = build_problem(cfg, device="cpu")
    step_err = fs.build_fused_step(p, TABLEAUS["bs32"])
    y = torch.tensor(_state(tuple(p.y0.shape)), dtype=torch.float32)
    h = torch.tensor(H, dtype=torch.float32)
    for seg_end, frozen in ((0.4, True), (1.0, False)):
        params = {**p.params, "_seg_end": torch.tensor(seg_end)}
        y_new, err_ss = step_err(torch.tensor(0.0), y, h, params)
        assert bool(torch.equal(y_new[:, 0], y[:, 0])) == frozen
        assert err_ss.dim() == 0 and float(err_ss) > 0


def test_gate():
    cfg = SimConfig(**{**BASE, **SURFACES["torus"]})
    p = build_problem(cfg, device="cpu")
    assert fs.is_supported(p, TABLEAUS["dopri54"], torch.float32)
    assert not fs.is_supported(p, TABLEAUS["bs32"], torch.float64)
    p_jd = build_problem(dataclasses.replace(cfg, just_diffusion=1), "cpu")
    assert not fs.is_supported(p_jd, TABLEAUS["bs32"], torch.float32)
    assert not fs.is_supported(dataclasses.replace(p, forcing=object()),
                               TABLEAUS["bs32"], torch.float32)
    assert not fs.is_supported(
        dataclasses.replace(p, diffusion_field=np.ones((32, 16))),
        TABLEAUS["bs32"], torch.float32)


def test_gate_admits_goldbeter():
    p = build_problem(SimConfig(**GB_KW), device="cpu")
    assert fs.is_supported(p, TABLEAUS["bs32"], torch.float32)
    assert prepare_constants(p, torch.float32, "cpu").kinetics_id == 1
    assert prepare_constants(build_problem(SimConfig(**BASE), "cpu"),
                             torch.float32, "cpu").kinetics_id == 0


@pytest.mark.parametrize("method", ["bs32", "zonneveld43", "dopri54"])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_tile_plan_fits(method, itemsize):
    tx, ty, smem = fs.tile_plan(TABLEAUS[method].stages, itemsize)
    assert smem <= fs.SMEM_BYTES and tx == 32 and ty >= 8


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("method", ["bs32", "dopri54"])
@pytest.mark.parametrize("surface", sorted(SURFACES))
def test_cuda_kernel_matches_plain(surface, method, dtype):
    cfg = SimConfig(**{**BASE, **SURFACES[surface], "x_mesh": 48,
                       "surface_length": 80})
    p = build_problem(cfg, device="cuda")
    kc = prepare_constants(p, dtype, "cuda")
    y = torch.tensor(_state(tuple(p.y0.shape)), dtype=dtype, device="cuda")
    h = torch.tensor(H, dtype=dtype, device="cuda")
    tol = 2e-5 if dtype == torch.float32 else 1e-12
    for fz in (0.0, 1.0):
        fzt = torch.tensor(fz, dtype=dtype, device="cuda")
        before = fs.fused_step.launches
        y_k, ss_k = fs.fused_step(y, h, fzt, kc, TABLEAUS[method], 1e-4, 1e-6)
        y_k2, ss_k2 = fs.fused_step(y, h, fzt, kc, TABLEAUS[method], 1e-4, 1e-6)
        assert fs.fused_step.launches == before + 2
        y_r, ss_r = fs.fused_step_reference(y, h, fzt, kc, TABLEAUS[method],
                                            1e-4, 1e-6)
        torch.cuda.synchronize()
        assert torch.equal(y_k, y_k2) and torch.equal(ss_k, ss_k2)
        scale = max(1.0, float(y.abs().max()))
        assert float((y_k - y_r).abs().max()) <= tol * scale
        rel = abs(float(ss_k.sum()) - float(ss_r.sum())) / float(ss_r.sum())
        assert rel <= (1e-3 if dtype == torch.float32 else 1e-10)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("method", ["bs32", "dopri54"])
def test_cuda_goldbeter_kernel_matches_plain(method, dtype):
    cfg = SimConfig(**{**GB_KW, "x_mesh": 48, "surface_length": 80})
    p = build_problem(cfg, device="cuda")
    kc = prepare_constants(p, dtype, "cuda")
    y = torch.tensor(_gb_state(p.y0.cpu().numpy()), dtype=dtype,
                     device="cuda")
    h = torch.tensor(GB_H, dtype=dtype, device="cuda")
    tol = 2e-5 if dtype == torch.float32 else 1e-12
    for fz in (0.0, 1.0):
        fzt = torch.tensor(fz, dtype=dtype, device="cuda")
        args = (y, h, fzt, kc, TABLEAUS[method], 1e-4, 1e-6)
        y_k, ss_k = fs.fused_step(*args)
        y_k2, ss_k2 = fs.fused_step(*args)
        y_r, ss_r = fs.fused_step_reference(*args)
        torch.cuda.synchronize()
        assert torch.equal(y_k, y_k2) and torch.equal(ss_k, ss_k2)
        scale = max(1.0, float(y.abs().max()))
        assert float((y_k - y_r).abs().max()) <= tol * scale
        rel = abs(float(ss_k.sum()) - float(ss_r.sum())) / float(ss_r.sum())
        assert rel <= (1e-3 if dtype == torch.float32 else 1e-10)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("method", ["bs32", "dopri54"])
def test_cuda_aliev_panfilov_kernel_matches_plain(method, dtype):
    cfg = SimConfig(**{**AP_KW, "x_mesh": 48, "surface_length": 80})
    p = build_problem(cfg, device="cuda")
    kc = prepare_constants(p, dtype, "cuda")
    y = torch.tensor(_ap_state(tuple(p.y0.shape)), dtype=dtype, device="cuda")
    h = torch.tensor(AP_H, dtype=dtype, device="cuda")
    for fz in (0.0, 1.0):
        fzt = torch.tensor(fz, dtype=dtype, device="cuda")
        args = (y, h, fzt, kc, TABLEAUS[method], 1e-4, 1e-6)
        y_k, ss_k = fs.fused_step(*args)
        y_k2, ss_k2 = fs.fused_step(*args)
        y_r, ss_r = fs.fused_step_reference(*args)
        torch.cuda.synchronize()
        assert torch.equal(y_k, y_k2) and torch.equal(ss_k, ss_k2)
        assert torch.equal(y_k, y_r)
        rel = abs(float(ss_k.sum()) - float(ss_r.sum())) / float(ss_r.sum())
        assert rel <= (1e-5 if dtype == torch.float32 else 1e-12)


# The register-resident scheme's cases (csrc/erk_slots.cuh): 400x100 grids
# with interior tiles, tiles at the wrap and a partial tile column; the
# beta field and the scalar; each kinetics family; a torus of 4 columns,
# narrower than a tile's region, which the wrap covers many times; an odd
# 148x37 grid, partial tiles on both axes. (config keywords, state of y0's
# shape, h)
WIDE = dict(x_mesh=100, surface_length=80)
SLOT_CASES = {
    "torus": ({**BASE, **SURFACES["torus"], **WIDE}, _state, H),
    "flat": ({**BASE, **SURFACES["flat"], **WIDE}, _state, H),
    "goldbeter": ({**GB_KW, **WIDE}, None, GB_H),
    "aliev_panfilov": ({**AP_KW, **WIDE}, _ap_state, AP_H),
    "torus_4_columns": ({**BASE, **SURFACES["torus"], "x_mesh": 4,
                         "surface_length": 80}, _state, H),
    "odd": ({**BASE, **SURFACES["flat"], "x_mesh": 37,
             "surface_length": 80}, _state, H)}


def _slot_inputs(name, dtype, device):
    """(problem, constants, y, h) of a case of SLOT_CASES (Goldbeter's
    state a perturbation of its y0)."""
    kw, state, h = SLOT_CASES[name]
    p = build_problem(SimConfig(**kw), device=device)
    y_np = (_gb_state(p.y0.cpu().numpy()) if state is None
            else state(tuple(p.y0.shape)))
    y = torch.tensor(y_np, dtype=dtype, device=device)
    return (p, prepare_constants(p, dtype, device), y,
            torch.tensor(h, dtype=dtype, device=device))


@pytest.mark.parametrize("method", sorted(TABLEAUS))
def test_dispatch_names_a_kernel_for_each_tableau(method):
    """Every tableau the gate takes has a kernel: bs32 the
    register-resident scheme, the others erk_tile.cuh's."""
    from crdmodel_tpu_torch.ops import erk_slots
    p = build_problem(SimConfig(**{**BASE, **SURFACES["torus"]}), "cpu")
    tab = TABLEAUS[method]
    assert fs.is_supported(p, tab, torch.float32)
    assert erk_slots.uses_slots(tab) == (method == "bs32")
    assert erk_slots.kernel_name(tab) == (
        erk_slots.SLOTS_KERNEL if method == "bs32" else
        erk_slots.TILE_KERNEL)


@pytest.mark.parametrize("x_mesh,want", [(400, 650), (200, 175), (37, 10),
                                         (101, 52)])
def test_partial_sums_one_a_tile(x_mesh, want):
    """The plain partial sums number the kernel's tiles: 650 at the
    canonical torus's 1600x400, 175 at 800x200, and partial tiles at odd
    sides (148x37, 404x101)."""
    cfg = SimConfig(**{**BASE, **SURFACES["torus"], "x_mesh": x_mesh,
                       "surface_length": 80})
    assert (cfg.ny, cfg.nx) == (4 * x_mesh, x_mesh)
    p = build_problem(cfg, "cpu")
    kc = prepare_constants(p, torch.float32, "cpu")
    y = torch.tensor(_state(tuple(p.y0.shape)), dtype=torch.float32)
    sums = fs.fused_step_tile_sums(y, torch.tensor(H), torch.tensor(0.0), kc,
                                   TABLEAUS["bs32"], 1e-4, 1e-6)
    assert -(-cfg.nx // fs.TILE_X) * -(-cfg.ny // 32) == want
    assert sums.shape == (want,)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(SLOT_CASES))
def test_tile_sums_add_to_the_plain_total(name, dtype):
    """The plain partial sums, in the kernel's tile order, add up to the
    plain version's total to rounding, for each tableau, frozen and not."""
    p, kc, y, h = _slot_inputs(name, dtype, "cpu")
    assert kc.has_freeze
    ny, nx = p.cfg.ny, p.cfg.nx
    for method in sorted(TABLEAUS):
        for fz in (0.0, 1.0):
            args = (y, h, torch.tensor(fz, dtype=dtype), kc,
                    TABLEAUS[method], 1e-4, 1e-6)
            sums = fs.fused_step_tile_sums(*args)
            _, total = fs.fused_step_reference(*args)
            tile_y = fs.tile_plan(TABLEAUS[method].stages,
                                  y.element_size())[1]
            assert sums.shape == (-(-nx // fs.TILE_X) * -(-ny // tile_y),)
            rel = 1e-5 if dtype == torch.float32 else 1e-12
            np.testing.assert_allclose(float(sums.sum()), float(total),
                                       rtol=rel)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("method", sorted(TABLEAUS))
@pytest.mark.parametrize("name", sorted(SLOT_CASES))
def test_cuda_partial_sums_bitwise(name, method, dtype):
    """Both schemes on every case, frozen and not: y_new bitwise the plain
    version's, two launches equal, one partial sum a tile, each bitwise
    the plain version's in the kernel's order (fused_step_tile_sums); the
    launch runs the kernel the dispatch names (erk_slots.kernel_name), and
    the register-resident kernel's shared bytes are slots_plan's."""
    from crdmodel_tpu_torch.ops import erk_slots, trace

    _, kc, y, h = _slot_inputs(name, dtype, "cuda")
    tab = TABLEAUS[method]
    for fz in (0.0, 1.0):
        args = (y, h, torch.tensor(fz, dtype=dtype, device="cuda"), kc, tab,
                1e-4, 1e-6)
        # a trace can miss kernels, or hold none: pooled traces
        names = trace.kernel_names(lambda: fs.fused_step(*args))
        assert any(erk_slots.kernel_name(tab) in n for n in names), names
        y_k, ss_k = fs.fused_step(*args)
        y_k2, ss_k2 = fs.fused_step(*args)
        y_r, _ = fs.fused_step_reference(*args)
        sums = fs.fused_step_tile_sums(*args)
        torch.cuda.synchronize()
        assert torch.equal(y_k, y_k2) and torch.equal(ss_k, ss_k2)
        assert torch.equal(y_k, y_r)
        assert ss_k.shape == sums.shape and torch.equal(ss_k, sums)
    if erk_slots.uses_slots(tab):
        info = erk_slots.kernel_info("crd_fused_erk_step_info", dtype,
                                     kc.kinetics_id)
        assert info["shared_bytes"] == erk_slots.slots_plan(
            y.element_size())[3]
        assert info["blocks_per_sm"] >= (2 if dtype == torch.float32 else 1)
