"""Kernel K2, the fused RKC2 step (crdmodel_tpu_torch/ops/fused_rkc.py).

On the CPU: the stage tables and the recurrence against the JAX package's;
the kernel's plain version against the JAX Pallas kernel run in interpret
mode (f32: the profile branch, the divergence-form branch on no-flux walls
with a scar, a torus obstacle and a flat 2-D diffusion field, and the
column-blocked kernel K2b at its own shape) and against the JAX XLA rkc2
stepper (f64); simulate() through the fused path against the JAX package's
fused run in interpret mode, on the torus and on the bounded tissue.
On a CUDA card (marker `cuda`): the CUDA kernel against the plain version,
both branches.
The JAX package is imported inside the tests that use it, so that the card
tests run where JAX is not installed:

    python -m pytest tests/test_torch_fused_rkc.py -m cuda --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.convert import inputs_from_numpy
from crdmodel_tpu_torch.core.problem import build_problem, make_rho_bound
from crdmodel_tpu_torch.integrate import rkc
from crdmodel_tpu_torch.ops import fused_kstep as fk
from crdmodel_tpu_torch.ops import fused_rkc as fr
from crdmodel_tpu_torch.core.grid import face_openness
from crdmodel_tpu_torch.ops.kernel_common import (SMEM_BYTES,
                                                  make_rhs_block,
                                                  prepare_constants,
                                                  prepare_divform_constants)

# tests/test_rkc.py's fused-kernel case: a grid fine enough that diffusion
# sets rho, so h*rho reaches the deep stage counts at a small h
BASE = dict(model="fhn", x_mesh=64, surface_width=20, surface_length=20,
            beta=1.25, beta_min=0.7, beta_max=1.7, t_boundary=1.0,
            t_final=2.0, dtype="float32", rtol=1e-5, atol=1e-8,
            method="rkc2")
SURFACES = {"torus": dict(surface="torus", vary_beta=1),    # beta field
            "flat": dict(surface="flat", vary_beta=0,       # beta scalar
                         surface_width=5, surface_length=5)}
# (t, seg_end, fz): a step in the frozen piece, and one after the release
SEGMENTS = ((0.3, 0.8, 1.0), (1.5, 2.0, 0.0))
# h*rho of a shallow and a deep step: s = 6 and s = 23
H_RHO = (15.0, 300.0)


def _state(shape, y0, seed=1):
    return y0 + 0.05 * np.random.default_rng(seed).standard_normal(shape)


def _cfg(surface, **over):
    return {**BASE, **SURFACES[surface], **over}


def test_stage_tables_match_jax():
    import jax.numpy as jnp

    from crdmodel_tpu.ops import pallas_rkc

    want = pallas_rkc.static_stage_tables(fr.S_MAX_KERNEL, jnp.float64)
    got = fr.static_stage_tables(fr.S_MAX_KERNEL, torch.float64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for s in (2, 3, 7, 15, 23):
        jmu1, jtab = pallas_rkc.rkc_stage_coeffs(jnp.int32(s), jnp.float64)
        mu1, tab = fr.rkc_stage_coeffs(s, torch.float64)
        np.testing.assert_allclose(float(mu1), float(jmu1), rtol=1e-15)
        np.testing.assert_allclose(tab.numpy(), np.asarray(jtab), rtol=1e-15,
                                   atol=1e-15)
        # the tables hold the recurrence's values (tests/test_rkc.py's limits)
        np.testing.assert_allclose(float(got[0][s]), float(mu1), rtol=1e-13)
        np.testing.assert_allclose(got[1][s].numpy(), tab.numpy(),
                                   rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("surface", sorted(SURFACES))
def test_plain_step_matches_jax_kernel(surface):
    """fused_rkc_step_reference through build_fused_rkc_step against the JAX
    Pallas kernel in interpret mode, f32, at a shallow and a deep stage
    count, frozen and released; tests/test_rkc.py's tolerances (f32
    drift across the Chebyshev recurrence)."""
    import jax
    import jax.numpy as jnp

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild_problem
    from crdmodel_tpu.core.problem import make_rho_bound as jmake_rho_bound
    from crdmodel_tpu.ops import pallas_rkc

    kw = _cfg(surface)
    jp = jbuild_problem(JSimConfig(**kw))
    jfused = pallas_rkc.build_fused_rkc_step(jp, jnp.float32, interpret=True)
    jrho = jmake_rho_bound(jp.cfg, jp.model, jp.geometry, jnp.float32)
    jstep = jax.jit(jfused.step_err)
    tp = build_problem(SimConfig(**kw), device="cpu")
    tfused = fr.build_fused_rkc_step(tp)
    y_np = _state(np.shape(jp.y0), np.asarray(jp.y0)).astype(np.float32)
    y_t, _ = inputs_from_numpy(y_np, {}, device="cpu", dtype=torch.float32)
    for t, seg_end, fz in SEGMENTS:
        jpar = {**jp.params, "_seg_end": jnp.float32(seg_end)}
        tpar = {**tp.params, "_seg_end": torch.tensor(seg_end)}
        rho = float(jrho(t, jnp.asarray(y_np), jpar))
        for h_rho in H_RHO:
            h = np.float32(h_rho / rho)
            s = int(rkc.choose_stages(torch.tensor(h), torch.tensor(rho,
                                                                dtype=torch.float32)))
            assert s == (6 if h_rho == 15.0 else 23)
            yp_new, ss_j, _ = jstep(jnp.float32(t), jfused.pad(jnp.asarray(y_np)),
                                    jnp.float32(h), jpar)
            y_new, ss, carry = tfused.step_err(torch.tensor(t), y_t,
                                               torch.tensor(h), tpar)
            assert carry == () and ss.dim() == 0
            np.testing.assert_allclose(y_new.numpy(),
                                       np.asarray(jfused.unpad(yp_new)),
                                       rtol=0, atol=1e-4)
            np.testing.assert_allclose(float(ss), float(ss_j), rtol=1e-3)


# the Goldbeter torus of data/GoldbeterModelArgs.ini (beta 0.4) at
# x_mesh=32 (the JAX kernel's column pad needs nx >= its halo of 24), with
# a freeze; states near its wave-segment ICs
GB_KW = dict(BASE, model="goldbeter", surface="torus", x_mesh=32,
             surface_length=40, beta=0.4, wave_inside=1, wave_length=0.2,
             wave_width=0.5)


# h*rho of the Goldbeter steps: s = 4 and s = 9. Its kinetics set rho, and
# a step of h*rho = 300 would leave the kinetics' time scale by far.
GB_H_RHO = (5.0, 40.0)


def _gb_state(y0, seed=11):
    return y0 * np.exp(0.05 * np.random.default_rng(seed).standard_normal(
        y0.shape))


def test_plain_goldbeter_step_matches_jax_kernel():
    """K2's plain version with the Goldbeter kinetics against the JAX
    Pallas kernel in interpret mode, f32, frozen and released, at a shallow
    and a deep stage count; the limits of test_plain_step_matches_jax_kernel
    scaled by the state."""
    import jax
    import jax.numpy as jnp

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild_problem
    from crdmodel_tpu.core.problem import make_rho_bound as jmake_rho_bound
    from crdmodel_tpu.ops import pallas_rkc

    jp = jbuild_problem(JSimConfig(**GB_KW))
    jfused = pallas_rkc.build_fused_rkc_step(jp, jnp.float32, interpret=True)
    jrho = jmake_rho_bound(jp.cfg, jp.model, jp.geometry, jnp.float32)
    jstep = jax.jit(jfused.step_err)
    tp = build_problem(SimConfig(**GB_KW), device="cpu")
    assert fr.is_rkc_supported(tp, torch.float32)
    assert prepare_constants(tp, torch.float32, "cpu").kinetics_id == 1
    tfused = fr.build_fused_rkc_step(tp)
    y_np = _gb_state(np.asarray(jp.y0)).astype(np.float32)
    y_t, _ = inputs_from_numpy(y_np, {}, device="cpu", dtype=torch.float32)
    scale = max(1.0, float(np.abs(y_np).max()))
    for t, seg_end, fz in SEGMENTS:
        jpar = {**jp.params, "_seg_end": jnp.float32(seg_end)}
        tpar = {**tp.params, "_seg_end": torch.tensor(seg_end)}
        rho = float(jrho(t, jnp.asarray(y_np), jpar))
        for h_rho in GB_H_RHO:
            h = np.float32(h_rho / rho)
            yp_new, ss_j, _ = jstep(jnp.float32(t),
                                    jfused.pad(jnp.asarray(y_np)),
                                    jnp.float32(h), jpar)
            y_new, ss, _ = tfused.step_err(torch.tensor(t), y_t,
                                           torch.tensor(h), tpar)
            np.testing.assert_allclose(y_new.numpy(),
                                       np.asarray(jfused.unpad(yp_new)),
                                       rtol=0, atol=1e-4 * scale)
            np.testing.assert_allclose(float(ss), float(ss_j), rtol=1e-3)


@pytest.mark.parametrize("surface", sorted(SURFACES))
def test_plain_step_f64_matches_jax_xla_stepper(surface):
    """In f64 the plain K2 (no carry, coefficients from the f64 tables) is
    the XLA rkc2 step of the JAX package (integrate/rkc.py, f0 = f(t, y))."""
    import jax
    import jax.numpy as jnp

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild_problem
    from crdmodel_tpu.core.problem import make_rho_bound as jmake_rho_bound
    from crdmodel_tpu.integrate.rkc import make_rkc2_step_err

    kw = _cfg(surface, dtype="float64")
    jp = jbuild_problem(JSimConfig(**kw))
    jrho = jmake_rho_bound(jp.cfg, jp.model, jp.geometry, jnp.float64)
    jstep, jinit = make_rkc2_step_err(jp.rhs, jrho, kw["rtol"], kw["atol"])
    tp = build_problem(SimConfig(**kw), device="cpu")
    kc = prepare_constants(tp, torch.float64, "cpu")
    mu1_tab, ctab_tab = fr.static_stage_tables(fr.S_MAX_KERNEL, torch.float64)
    trho = make_rho_bound(tp.cfg, tp.model, tp.geometry, torch.float64)
    y_np = _state(np.shape(jp.y0), np.asarray(jp.y0))
    y_t, _ = inputs_from_numpy(y_np, {}, device="cpu", dtype=torch.float64)
    for t, seg_end, fz in SEGMENTS:
        jpar = {**jp.params, "_seg_end": jnp.float64(seg_end)}
        tpar = {**tp.params, "_seg_end": torch.tensor(seg_end,
                                                      dtype=torch.float64)}
        rho = trho(t, y_t, tpar)
        for h_rho in H_RHO:
            h = h_rho / float(rho)
            y0 = jnp.asarray(y_np)
            jy, jss, _ = jax.jit(jstep)(jnp.float64(t), y0, jnp.float64(h),
                                        jpar, jinit(jnp.float64(t), y0, jpar))
            h_t = torch.tensor(h, dtype=torch.float64)
            y_new, ss = fr.fused_rkc_step_reference(
                y_t, h_t, torch.tensor(fz, dtype=torch.float64),
                rkc.choose_stages(h_t, rho), mu1_tab, ctab_tab, kc,
                kw["rtol"], kw["atol"])
            scale = max(1.0, float(np.abs(np.asarray(jy)).max()))
            np.testing.assert_allclose(y_new.numpy(), np.asarray(jy), rtol=0,
                                       atol=1e-12 * scale)
            np.testing.assert_allclose(float(ss.sum()), float(jss),
                                       rtol=1e-12)


# x_mesh=32: the JAX kernel's column pad needs nx >= its halo of 24
SIM_CFG = dict(model="fhn", surface="torus", x_mesh=32, surface_width=20,
               surface_length=40, beta=1.25, vary_beta=1, beta_min=0.7,
               beta_max=1.7, t_boundary=0.4, t_final=1.0, output_timestep=5,
               dtype="float32", rtol=1e-4, atol=1e-6, method="rkc2",
               use_pallas=True)


def test_fused_simulate_matches_jax_fused(monkeypatch):
    """simulate() on the CPU through the plain K2 against the JAX package's
    fused run in interpret mode; the limits of tests/test_torch_sim.py."""
    import jax

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild_problem
    from crdmodel_tpu.sim import make_run_fn

    from crdmodel_tpu_torch.integrate.erk import SYNC_EVERY, merge_stops
    from crdmodel_tpu_torch.sim import output_times, simulate

    jp = jbuild_problem(JSimConfig(**SIM_CFG))
    tj, sj = jax.jit(make_run_fn(jp, interpret=True)[0])(jp.y0, jp.params)

    calls = {"plain_k2": 0}
    plain = fr.fused_rkc_step_reference

    def counted(*args, **kw):
        calls["plain_k2"] += 1
        return plain(*args, **kw)

    def no_torch_path(*args, **kw):
        raise AssertionError("the fused run built the torch-path stepper")

    monkeypatch.setattr(fr, "fused_rkc_step_reference", counted)
    monkeypatch.setattr(rkc, "make_rkc2_step_err", no_torch_path)
    res = simulate(SimConfig(**SIM_CFG), device="cpu")

    assert res.fused and res.ok
    # every step, and the no-op iterations of the last block of each stop
    n_stops = len(merge_stops(output_times(res.cfg), (0.4,))[0])
    assert (res.total_steps() <= calls["plain_k2"]
            <= res.total_steps() + SYNC_EVERY * n_stops)
    gap = np.abs(res.stats.steps.numpy() - np.asarray(sj.steps))
    assert gap.max() <= 1 and gap.sum() <= 2
    np.testing.assert_allclose(res.trajectory[1:].numpy(), np.asarray(tj),
                               rtol=0, atol=1e-3)


@pytest.mark.parametrize("use_pallas", [None, False])
def test_selection_on_cpu(use_pallas):
    """Auto mode takes K2 only on CUDA; False forces the torch path."""
    from crdmodel_tpu_torch.sim import simulate

    res = simulate(SimConfig(**{**SIM_CFG, "use_pallas": use_pallas}),
                   device="cpu")
    assert not res.fused and res.ok


def test_gate():
    p = build_problem(SimConfig(**_cfg("torus")), "cpu")
    assert fr.is_rkc_supported(p, torch.float32)
    assert not fr.is_rkc_supported(p, torch.float64)
    assert not fr.is_rkc_supported(dataclasses.replace(p, forcing=object()),
                                   torch.float32)
    # a 2-D diffusion field takes the divergence branch
    assert fr.is_rkc_supported(
        dataclasses.replace(p, diffusion_field=np.ones((64, 64))),
        torch.float32)
    # a diffusion tensor takes no kernel with rkc2
    assert not fr.is_rkc_supported(
        dataclasses.replace(p, diffusion_tensor=(1.0, 0.25, 0.1)),
        torch.float32)
    no_bound = dataclasses.replace(p, model=dataclasses.replace(
        p.model, jac_bound=None))
    assert not fr.is_rkc_supported(no_bound, torch.float32)
    p_jd = build_problem(SimConfig(**_cfg("torus", just_diffusion=1)), "cpu")
    assert not fr.is_rkc_supported(p_jd, torch.float32)
    # every family with a device function
    for model, beta in (("goldbeter", 0.4), ("aliev_panfilov", 0.1)):
        other = build_problem(SimConfig(**_cfg("torus", model=model,
                                               beta=beta)), "cpu")
        assert fr.is_rkc_supported(other, torch.float32)


@pytest.mark.parametrize("itemsize", [4, 8])
def test_tile_plan_fits(itemsize):
    tx, ty, smem = fr.tile_plan(fr.S_MAX_KERNEL + 1, itemsize)
    assert smem <= SMEM_BYTES - 1024 and tx >= 8 and ty >= 8
    assert smem == 8 * (tx + 48) * (ty + 48) * itemsize


# the chunk depth D and the stage counts around its boundaries
D = fr.CHUNK
CHUNK_STAGES = (D - 1, D, D + 1, 2 * D, fr.S_MAX_KERNEL)


@pytest.mark.parametrize("s", CHUNK_STAGES)
def test_chunk_schedule_evaluates_each_stage_once(s):
    """K2's chunks cover its s + 1 RHS evaluations (F0 with Y1, Y2 .. Ys,
    F1) once each and in order, each chunk at most D of them, split
    evenly; every evaluation's input lies one ring further out than its
    own points, inside the chunk's region, and F1 lands on the tile."""
    chunks = fr.chunk_schedule(s)
    evals = [first + i for first, n in chunks for i in range(n)]
    assert evals == list(range(s + 1))
    sizes = [n for _, n in chunks]
    assert len(chunks) == -(-(s + 1) // D) and max(sizes) <= D
    assert max(sizes) - min(sizes) <= 1
    assert fr.grid_barriers(s) == len(chunks) - 1
    produced = []                   # the stage each evaluation forms
    for first, n in chunks:
        loaded = D - n              # the input's rings, loaded from memory
        for i in range(n):
            ring = D - n + i + 1    # the evaluation's points: ring and in
            assert ring - 1 >= loaded and ring <= D
            e = first + i
            if e < s:
                produced.append(e + 1)
        # the chunk's last evaluation lands on the tile: handed on, or F1
        assert ring == D
    assert produced == list(range(1, s + 1))


@pytest.mark.parametrize("itemsize", [4, 8])
def test_chunk_plan_fits_every_stage_count(itemsize):
    """K2's blocks: shared memory sized for D whatever s (2..S_MAX_KERNEL)
    fits an H100 block, and two blocks an SM in f32; the threads' slots
    cover the region."""
    tile, halo, slots, smem = fr.chunk_plan(itemsize)
    assert (tile, halo) == (fr.CHUNK_TILE, D)
    side = tile + 2 * halo
    assert slots * fr.CHUNK_THREADS >= side * side
    assert (slots - 1) * fr.CHUNK_THREADS < side * side
    assert smem == (fr.CHUNK_PLANES * (side * side + 2 * (side + 1))
                    + 5 * side + fr.CHUNK_THREADS // 32
                    + 2 * tile * tile) * itemsize
    for s in range(2, fr.S_MAX_KERNEL + 1):
        assert len(fr.chunk_schedule(s)) >= 1
        assert smem <= SMEM_BYTES - 1024
    if itemsize == 4:
        assert 2 * (smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("shape,tiles", [((1600, 400), 650),
                                         ((12800, 3200), 40000),
                                         ((16, 5), 1), ((33, 64), 4)])
def test_partial_sums_length_is_the_tile_count(shape, tiles):
    """ss has one partial sum a CHUNK_TILE-square tile of the grid."""
    assert fr.n_chunk_tiles(*shape) == tiles


def test_wrapper_refuses_other_devices():
    p = build_problem(SimConfig(**_cfg("flat")), "cpu")
    kc = prepare_constants(p, torch.float32, "cpu")
    mu1_tab, ctab_tab = fr.static_stage_tables(fr.S_MAX_KERNEL, torch.float32)
    y = torch.empty(p.y0.shape, device="meta")
    with pytest.raises(ValueError, match="no fused RKC step kernel"):
        fr.fused_rkc_step(y, torch.tensor(0.1), torch.tensor(0.0),
                          torch.tensor(5, dtype=torch.int32), mu1_tab,
                          ctab_tab, kc, 1e-5, 1e-8)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("surface", sorted(SURFACES))
def test_cuda_kernel_matches_plain(surface, dtype):
    # nx = 16 is smaller than the halo: the wrap goes round more than once.
    # A large D makes diffusion set rho, so that h, the coverage of s - 1
    # stages, stays small enough for the kinetics.
    p = build_problem(SimConfig(**_cfg(surface, x_mesh=16, diffusion=1000.0)),
                      device="cuda")
    kc = prepare_constants(p, dtype, "cuda")
    mu1_tab, ctab_tab = fr.static_stage_tables(fr.S_MAX_KERNEL, dtype, "cuda")
    y = torch.tensor(_state(tuple(p.y0.shape), p.y0.cpu().numpy()),
                     dtype=dtype, device="cuda")
    tol = 2e-5 if dtype == torch.float32 else 1e-12
    rho = float(make_rho_bound(p.cfg, p.model, p.geometry, dtype)(
        0.0, y, p.params))
    for s in (2, 5, 15, 23):
        h = torch.tensor(0.65 * (s - 1) ** 2 / rho, dtype=dtype, device="cuda")
        st = torch.tensor(s, dtype=torch.int32, device="cuda")
        for fz in (0.0, 1.0):
            fzt = torch.tensor(fz, dtype=dtype, device="cuda")
            args = (y, h, fzt, st, mu1_tab, ctab_tab, kc, 1e-5, 1e-8)
            before = fr.fused_rkc_step.launches
            y_k, ss_k = fr.fused_rkc_step(*args)
            y_k2, ss_k2 = fr.fused_rkc_step(*args)
            assert fr.fused_rkc_step.launches == before + 2
            y_r, ss_r = fr.fused_rkc_step_reference(*args)
            torch.cuda.synchronize()
            assert bool(torch.isfinite(y_r).all())
            assert torch.equal(y_k, y_k2) and torch.equal(ss_k, ss_k2)
            scale = max(1.0, float(y_r.abs().max()))
            assert float((y_k - y_r).abs().max()) <= tol * scale
            rel = abs(float(ss_k.sum()) - float(ss_r.sum())) / float(ss_r.sum())
            assert rel <= (1e-3 if dtype == torch.float32 else 1e-10)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card and nvcc")
def test_cuda_kernel_refuses_stage_counts_beyond_its_tables():
    p = build_problem(SimConfig(**_cfg("flat")), device="cuda")
    kc = prepare_constants(p, torch.float32, "cuda")
    mu1_tab, ctab_tab = fr.static_stage_tables(fr.S_MAX_KERNEL, torch.float32,
                                               "cuda")
    y = p.y0.contiguous()
    for s in (1, fr.S_MAX_KERNEL + 1):
        y_k, ss = fr.fused_rkc_step(
            y, torch.tensor(0.01, device="cuda"),
            torch.tensor(0.0, device="cuda"),
            torch.tensor(s, dtype=torch.int32, device="cuda"), mu1_tab,
            ctab_tab, kc, 1e-5, 1e-8)
        torch.cuda.synchronize()
        assert bool(torch.isnan(ss).all()) and torch.equal(y_k, y)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("model,beta", [("goldbeter", 0.4),
                                        ("aliev_panfilov", 0.1)])
def test_cuda_kernel_matches_plain_other_kinetics(model, beta, dtype):
    """K2 with the Goldbeter and Aliev–Panfilov kinetics: y_new bitwise
    equal to the plain version, two launches equal."""
    p = build_problem(SimConfig(**_cfg("torus", x_mesh=48, model=model,
                                       beta=beta, diffusion=1000.0)),
                      device="cuda")
    kc = prepare_constants(p, dtype, "cuda")
    mu1_tab, ctab_tab = fr.static_stage_tables(fr.S_MAX_KERNEL, dtype, "cuda")
    y0 = p.y0.cpu().numpy()
    y_np = (_gb_state(y0) if model == "goldbeter"
            else _state(y0.shape, y0))
    y = torch.tensor(y_np, dtype=dtype, device="cuda")
    rho = float(make_rho_bound(p.cfg, p.model, p.geometry, dtype)(
        0.0, y, p.params))
    for s in (2, 5, 15, 23):
        h = torch.tensor(0.65 * (s - 1) ** 2 / rho, dtype=dtype, device="cuda")
        st = torch.tensor(s, dtype=torch.int32, device="cuda")
        for fz in (0.0, 1.0):
            fzt = torch.tensor(fz, dtype=dtype, device="cuda")
            args = (y, h, fzt, st, mu1_tab, ctab_tab, kc, 1e-5, 1e-8)
            y_k, ss_k = fr.fused_rkc_step(*args)
            y_k2, ss_k2 = fr.fused_rkc_step(*args)
            y_r, ss_r = fr.fused_rkc_step_reference(*args)
            torch.cuda.synchronize()
            assert bool(torch.isfinite(y_r).all())
            assert torch.equal(y_k, y_k2) and torch.equal(ss_k, ss_k2)
            assert torch.equal(y_k, y_r)
            rel = abs(float(ss_k.sum()) - float(ss_r.sum())) / float(ss_r.sum())
            assert rel <= (1e-5 if dtype == torch.float32 else 1e-12)


def _scar(ny, nx, rows, cols):
    mask = np.ones((ny, nx), bool)
    mask[rows, cols] = False
    return mask


# The divergence branch's cases, tests/test_torch_fused_divform.py's with
# D scaled up so that diffusion sets rho and h, the coverage of 22 stages,
# stays small for the kinetics: name -> (config, build arguments). The JAX
# package's divform strip plans at these shapes hold its deep variant
# (s_cap 23, as the port's).
FLAT48 = dict(surface="flat", x_mesh=48, surface_width=20.0,
              surface_length=20.0)
DIVFORM_COMMON = dict(t_final=2.0, dtype="float32", rtol=1e-4, atol=1e-7,
                      wave_length=0.25, wave_width=0.5, method="rkc2",
                      t_boundary=0.4)
DIVFORM_CASES = {
    "ap_noflux_scar": (
        dict(FLAT48, model="aliev_panfilov", beta=0.1, diffusion=100.0,
             boundary="noflux"),
        dict(obstacle_mask=_scar(48, 48, slice(20, 30), slice(22, 34)))),
    "fhn_torus_obstacle": (
        dict(model="fhn", surface="torus", x_mesh=40, beta=1.25,
             diffusion=100.0),
        dict(obstacle_mask=_scar(160, 40, slice(60, 80), slice(10, 18)))),
    "fhn_flat_xy_field": (
        dict(FLAT48, model="fhn", beta=1.25),
        dict(diffusion_field=50.0 + 100.0 * np.random.default_rng(7).random(
            (48, 48)))),
}


# The scar's ydot is 0, yet its cells do not hold their start bitwise
# through an RKC2 step, in the JAX package neither: the recurrence
# (1 - mu - nu) y0 + mu Y_{j-1} + nu Y_{j-2} rounds at a stationary cell
# (after s = 23 on random states, up to 1.0e-5 of their scale measured, in
# the JAX kernel as in the port; cells at 0 stay 0), so they are held to
# SCAR_DRIFT of the state's scale, where a leaking scar would move by
# O(h ydot). The ERK kernels' y0 + (h b) 0 holds them bitwise.
SCAR_DRIFT = 5e-5


def _divform_state(shape, model, seed=3):
    rng = np.random.default_rng(seed)
    if model == "aliev_panfilov":
        return np.stack([rng.uniform(-0.1, 1.1, shape[1:]),
                         rng.uniform(0.0, 2.0, shape[1:])])
    return rng.uniform(-2.0, 2.0, shape)


@pytest.mark.parametrize("name", sorted(DIVFORM_CASES))
def test_plain_divform_step_matches_jax_kernel(name):
    """The divergence branch: fused_rkc_step_reference through
    build_fused_rkc_step against the JAX Pallas kernel's divform branch in
    interpret mode, f32, at s = 6 and s = 23, frozen and released: y within
    2e-5 of the state's scale (K4's limit: JAX contracts a*b + c into FMAs
    on the CPU; 1.3e-5 measured at s = 23), the error sum to 1e-3
    relative, and the scar cells at their start to SCAR_DRIFT."""
    import jax
    import jax.numpy as jnp

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild_problem
    from crdmodel_tpu.core.problem import make_rho_bound as jmake_rho_bound
    from crdmodel_tpu.ops import pallas_rkc

    kw, build = DIVFORM_CASES[name]
    kw = {**DIVFORM_COMMON, **kw}
    jp = jbuild_problem(JSimConfig(**kw), **build)
    assert pallas_rkc.is_rkc_supported(jp, jnp.float32)
    plan = pallas_rkc.variant_plan(
        jp.cfg.ny, jp.cfg.nx, 2,
        extra_live=pallas_rkc._divform_extra_live(jp))
    assert plan[0][0] - 1 == fr.S_MAX_KERNEL
    jfused = pallas_rkc.build_fused_rkc_step(jp, jnp.float32, interpret=True)
    jrho = jmake_rho_bound(jp.cfg, jp.model, jp.geometry, jnp.float32,
                           diffusion_field=jp.diffusion_field,
                           face_mask=jp.face_mask)
    jstep = jax.jit(jfused.step_err)
    tp = build_problem(SimConfig(**kw), "cpu", **build)
    assert fr.is_rkc_supported(tp, torch.float32)
    tfused = fr.build_fused_rkc_step(tp)
    y_np = _divform_state(np.shape(jp.y0), kw["model"]).astype(np.float32)
    y_t, _ = inputs_from_numpy(y_np, {}, device="cpu", dtype=torch.float32)
    scale = max(1.0, float(np.abs(y_np).max()))
    for t, seg_end, fz in SEGMENTS:
        jpar = {**jp.params, "_seg_end": jnp.float32(seg_end)}
        tpar = {**tp.params, "_seg_end": torch.tensor(seg_end)}
        rho = float(jrho(t, jnp.asarray(y_np), jpar))
        for h_rho, s_want in zip(H_RHO, (6, 23)):
            h = np.float32(h_rho / rho)
            s = int(rkc.choose_stages(torch.tensor(h),
                                      torch.tensor(rho, dtype=torch.float32)))
            assert s == s_want
            yp_new, ss_j, _ = jstep(jnp.float32(t),
                                    jfused.pad(jnp.asarray(y_np)),
                                    jnp.float32(h), jpar)
            y_new, ss, _ = tfused.step_err(torch.tensor(t), y_t,
                                           torch.tensor(h), tpar)
            want = np.asarray(jfused.unpad(yp_new))
            assert np.max(np.abs(y_new.numpy() - want)) <= 2e-5 * scale
            np.testing.assert_allclose(float(ss), float(ss_j), rtol=1e-3)
            if tp.obstacle_mask is not None:
                scar = ~tp.obstacle_mask
                for got in (y_new.numpy(), want):
                    assert np.max(np.abs(got[:, scar] - y_np[:, scar])) \
                        <= SCAR_DRIFT * scale


def test_plain_divform_step_f64_matches_jax_xla_stepper():
    """In f64 the plain K2's divergence branch is the XLA rkc2 step of the
    JAX package on the bounded case (no-flux walls and a scar)."""
    import jax
    import jax.numpy as jnp

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild_problem
    from crdmodel_tpu.core.problem import make_rho_bound as jmake_rho_bound
    from crdmodel_tpu.integrate.rkc import make_rkc2_step_err

    kw, build = DIVFORM_CASES["ap_noflux_scar"]
    kw = {**DIVFORM_COMMON, **kw, "dtype": "float64"}
    jp = jbuild_problem(JSimConfig(**kw), **build)
    jrho = jmake_rho_bound(jp.cfg, jp.model, jp.geometry, jnp.float64,
                           diffusion_field=jp.diffusion_field,
                           face_mask=jp.face_mask)
    jstep, jinit = make_rkc2_step_err(jp.rhs, jrho, kw["rtol"], kw["atol"])
    tp = build_problem(SimConfig(**kw), "cpu", **build)
    dc = prepare_divform_constants(tp, torch.float64, "cpu")
    mu1_tab, ctab_tab = fr.static_stage_tables(fr.S_MAX_KERNEL, torch.float64)
    trho = make_rho_bound(tp.cfg, tp.model, tp.geometry, torch.float64,
                          diffusion_field=tp.diffusion_field,
                          face_mask=tp.face_mask)
    y_np = _divform_state(np.shape(jp.y0), kw["model"])
    y_t, _ = inputs_from_numpy(y_np, {}, device="cpu", dtype=torch.float64)
    for t, seg_end, fz in SEGMENTS:
        jpar = {**jp.params, "_seg_end": jnp.float64(seg_end)}
        tpar = {**tp.params, "_seg_end": torch.tensor(seg_end,
                                                      dtype=torch.float64)}
        rho = trho(t, y_t, tpar)
        for h_rho in H_RHO:
            h = h_rho / float(rho)
            y0 = jnp.asarray(y_np)
            jy, jss, _ = jax.jit(jstep)(jnp.float64(t), y0, jnp.float64(h),
                                        jpar, jinit(jnp.float64(t), y0, jpar))
            h_t = torch.tensor(h, dtype=torch.float64)
            y_new, ss = fr.fused_rkc_step_reference(
                y_t, h_t, torch.tensor(fz, dtype=torch.float64),
                rkc.choose_stages(h_t, rho), mu1_tab, ctab_tab, dc,
                kw["rtol"], kw["atol"])
            scale = max(1.0, float(np.abs(np.asarray(jy)).max()))
            np.testing.assert_allclose(y_new.numpy(), np.asarray(jy), rtol=0,
                                       atol=1e-12 * scale)
            np.testing.assert_allclose(float(ss.sum()), float(jss),
                                       rtol=1e-12)


def test_plain_step_matches_jax_blocked_kernel(monkeypatch):
    """K2b's shape: the JAX package splits a row too wide for one TPU strip
    at its deep halo into column blocks with a halo refresh
    (pallas_rkc.py::_build_blocked); the port's K2 needs no blocks, its
    tiles do not depend on nx. tests/test_rkc.py's technique: a small VMEM
    budget makes choose_blocking take nb = 2 on a 256-wide torus. One step
    through the blocked kernel in interpret mode, on its shallow (s <= 7)
    and its deep branch, against the port's plain K2 step, with
    tests/test_rkc.py's tolerances."""
    import jax.numpy as jnp

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild_problem
    from crdmodel_tpu.core.problem import make_rho_bound as jmake_rho_bound
    from crdmodel_tpu.ops import pallas_rkc

    kw = dict(model="fhn", surface="torus", x_mesh=256, surface_width=20,
              surface_length=20, beta=1.25, t_boundary=1.0, t_final=2.0,
              dtype="float32", rtol=1e-5, atol=1e-8, method="rkc2")
    jp = jbuild_problem(JSimConfig(**kw))
    monkeypatch.setattr(pallas_rkc, "VMEM_BUDGET", 1536 * 1024)
    nb, plan = pallas_rkc.choose_blocking(jp.cfg.ny, jp.cfg.nx, 2)
    assert nb == 2 and plan[0][0] == pallas_rkc.P_RKC and len(plan) == 2
    jfused = pallas_rkc.build_fused_rkc_step(jp, jnp.float32, interpret=True)
    monkeypatch.undo()
    tp = build_problem(SimConfig(**kw), "cpu")
    tfused = fr.build_fused_rkc_step(tp)

    rng = np.random.default_rng(2)
    y_np = (np.asarray(jp.y0) + 0.05 * rng.standard_normal(
        np.shape(jp.y0))).astype(np.float32)
    yp = jfused.pad(jnp.asarray(y_np))
    assert yp.shape[1] == 2                   # (nvars, nb, ny, Wp)
    y_t, _ = inputs_from_numpy(y_np, {}, device="cpu", dtype=torch.float32)
    jrho = jmake_rho_bound(jp.cfg, jp.model, jp.geometry, jnp.float32)
    jpar = {**jp.params, "_seg_end": jnp.asarray(0.8, jnp.float32)}
    tpar = {**tp.params, "_seg_end": torch.tensor(0.8)}
    t = 0.3
    rho = float(jrho(t, jnp.asarray(y_np), jpar))
    for h_val, branch in ((15.0 / rho, "shallow"), (200.0 / rho, "deep")):
        s = int(rkc.choose_stages(torch.tensor(h_val, dtype=torch.float32),
                                  torch.tensor(rho, dtype=torch.float32)))
        assert (s <= 7) == (branch == "shallow"), (s, branch)
        y2p, ss2, _ = jfused.step_err(jnp.asarray(t, jnp.float32), yp,
                                      jnp.asarray(h_val, jnp.float32), jpar)
        y_new, ss, _ = tfused.step_err(torch.tensor(t), y_t,
                                       torch.tensor(h_val), tpar)
        np.testing.assert_allclose(y_new.numpy(),
                                   np.asarray(jfused.unpad(y2p)), rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(float(ss), float(ss2), rtol=1e-3)


# the bounded tissue of tests/test_torch_divform.py at 48x48, f32, through
# the fused path: no-flux walls, a square scar
BOUNDED_RKC = dict(model="aliev_panfilov", surface="flat", x_mesh=48,
                   surface_width=20, surface_length=20, diffusion=1.0,
                   beta=0.10, wave_length=0.25, wave_width=0.5, t_final=2.0,
                   output_timestep=4, dtype="float32", rtol=1e-4, atol=1e-7,
                   boundary="noflux", method="rkc2", use_pallas=True)


def test_bounded_fused_simulate_matches_jax_fused(monkeypatch):
    """simulate() on the CPU through the divergence branch of the plain K2,
    on the bounded tissue, against the JAX package's fused run in interpret
    mode; the limits of test_fused_simulate_matches_jax_fused, and the scar
    cells at their IC to SCAR_DRIFT."""
    import jax

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild_problem
    from crdmodel_tpu.sim import make_run_fn

    from crdmodel_tpu_torch.integrate.erk import SYNC_EVERY, merge_stops
    from crdmodel_tpu_torch.sim import output_times, simulate

    mask = _scar(48, 48, slice(20, 30), slice(22, 34))
    jp = jbuild_problem(JSimConfig(**BOUNDED_RKC), obstacle_mask=mask)
    tj, sj = jax.jit(make_run_fn(jp, interpret=True)[0])(jp.y0, jp.params)

    calls = {"plain_k2": 0}
    plain = fr.fused_rkc_step_reference

    def counted(*args, **kw):
        calls["plain_k2"] += 1
        assert args[6].kind == "divform"
        return plain(*args, **kw)

    def no_torch_path(*args, **kw):
        raise AssertionError("the fused run built the torch-path stepper")

    monkeypatch.setattr(fr, "fused_rkc_step_reference", counted)
    monkeypatch.setattr(rkc, "make_rkc2_step_err", no_torch_path)
    cfg = SimConfig(**BOUNDED_RKC)
    res = simulate(cfg, "cpu", problem=build_problem(cfg, "cpu",
                                                     obstacle_mask=mask))
    assert res.fused and res.ok
    n_stops = len(merge_stops(output_times(res.cfg), ())[0])
    assert (res.total_steps() <= calls["plain_k2"]
            <= res.total_steps() + SYNC_EVERY * n_stops)
    gap = np.abs(res.stats.steps.numpy() - np.asarray(sj.steps))
    assert gap.max() <= 1 and gap.sum() <= 2
    traj = res.trajectory.numpy()
    np.testing.assert_allclose(traj[1:], np.asarray(tj), rtol=0, atol=1e-3)
    assert np.max(np.abs(traj[:, :, ~mask] - traj[0][:, ~mask])) \
        <= SCAR_DRIFT


def test_divform_gate():
    """The divergence branch's gate (pallas_rkc.py:239-253): the flat and
    torus surfaces, aS == roll_y(aN) exactly; the wrapper refuses other
    constants."""
    kw, build = DIVFORM_CASES["ap_noflux_scar"]
    kw = {**DIVFORM_COMMON, **kw}
    p = build_problem(SimConfig(**kw), "cpu", **build)
    assert fr.is_rkc_supported(p, torch.float32)
    oE, oW, oN, oS = face_openness(p.cfg.ny, p.cfg.nx, "noflux")
    lopsided = dataclasses.replace(p, face_mask=(oE, oW, np.ones_like(oN),
                                                 oS), obstacle_mask=None)
    assert not fr.is_rkc_supported(lopsided, torch.float32)
    assert not fr.is_rkc_supported(p, torch.float64)
    no_bound = dataclasses.replace(p, model=dataclasses.replace(
        p.model, jac_bound=None))
    assert not fr.is_rkc_supported(no_bound, torch.float32)
    # the constants follow the operator
    tfused = fr.build_fused_rkc_step(p)
    y = p.y0.clone()
    params = {**p.params, "_seg_end": torch.tensor(1.0)}
    y_new, ss, _ = tfused.step_err(torch.tensor(0.5), y, torch.tensor(0.01),
                                   params)
    assert torch.isfinite(y_new).all() and torch.isfinite(ss)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(DIVFORM_CASES))
def test_cuda_divform_kernel_matches_plain(name, dtype):
    """The divergence branch on the card: y_new bitwise equal to the plain
    version at s = 2, 5, 15 and 23, fz 0 and 1, two launches equal."""
    kw, build = DIVFORM_CASES[name]
    kw = {**DIVFORM_COMMON, **kw}
    p = build_problem(SimConfig(**kw), "cuda", **build)
    dc = prepare_divform_constants(p, dtype, "cuda")
    mu1_tab, ctab_tab = fr.static_stage_tables(fr.S_MAX_KERNEL, dtype, "cuda")
    y = torch.tensor(_divform_state(tuple(p.y0.shape), kw["model"]),
                     dtype=dtype, device="cuda")
    rho = float(make_rho_bound(p.cfg, p.model, p.geometry, dtype,
                               diffusion_field=p.diffusion_field,
                               face_mask=p.face_mask)(0.0, y, p.params))
    for s in (2, 5, 15, 23):
        h = torch.tensor(0.65 * (s - 1) ** 2 / rho, dtype=dtype, device="cuda")
        st = torch.tensor(s, dtype=torch.int32, device="cuda")
        for fz in (0.0, 1.0):
            fzt = torch.tensor(fz, dtype=dtype, device="cuda")
            args = (y, h, fzt, st, mu1_tab, ctab_tab, dc, 1e-4, 1e-7)
            before = fr.fused_rkc_step.launches
            y_k, ss_k = fr.fused_rkc_step(*args)
            y_k2, ss_k2 = fr.fused_rkc_step(*args)
            assert fr.fused_rkc_step.launches == before + 2
            y_r, ss_r = fr.fused_rkc_step_reference(*args)
            torch.cuda.synchronize()
            assert bool(torch.isfinite(y_r).all())
            assert torch.equal(y_k, y_k2) and torch.equal(ss_k, ss_k2)
            assert torch.equal(y_k, y_r)
            rel = abs(float(ss_k.sum()) - float(ss_r.sum())) / float(ss_r.sum())
            assert rel <= (1e-5 if dtype == torch.float32 else 1e-12)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("x_mesh", [4, 96])
def test_cuda_kernel_chunk_boundaries(x_mesh, dtype):
    """K2 at the stage counts around its chunk boundaries (D - 1, D,
    D + 1, 2D, 23), on a torus smaller than a chunk's halo (4 columns) and
    on one larger than its region: y_new bitwise the plain version's, two
    launches equal, one partial sum a tile, each bitwise the plain
    version's in the one-pass kernel's order (CHUNK_THREADS threads over a
    tile, fused_kstep.tile_error_sums); the kernel's shared bytes are
    chunk_plan's."""
    p = build_problem(SimConfig(**_cfg("torus", x_mesh=x_mesh,
                                       diffusion=1000.0)), device="cuda")
    kc = prepare_constants(p, dtype, "cuda")
    mu1_tab, ctab_tab = fr.static_stage_tables(fr.S_MAX_KERNEL, dtype, "cuda")
    y = torch.tensor(_state(tuple(p.y0.shape), p.y0.cpu().numpy()),
                     dtype=dtype, device="cuda")
    _, ny, nx = y.shape
    rho = float(make_rho_bound(p.cfg, p.model, p.geometry, dtype)(
        0.0, y, p.params))
    for s in CHUNK_STAGES:
        h = torch.tensor(0.65 * (s - 1) ** 2 / rho, dtype=dtype, device="cuda")
        st = torch.tensor(s, dtype=torch.int32, device="cuda")
        for fz in (0.0, 1.0):
            fzt = torch.tensor(fz, dtype=dtype, device="cuda")
            args = (y, h, fzt, st, mu1_tab, ctab_tab, kc, 1e-5, 1e-8)
            y_k, ss_k = fr.fused_rkc_step(*args)
            y_k2, ss_k2 = fr.fused_rkc_step(*args)
            y_r, ss_r = fr.fused_rkc_step_reference(*args)
            torch.cuda.synchronize()
            assert ss_k.shape == (fr.n_chunk_tiles(ny, nx),)
            assert torch.equal(y_k, y_k2) and torch.equal(ss_k, ss_k2)
            assert torch.equal(y_k, y_r)
            _, est = fr.rkc_stages_reference(
                y, h, st, mu1_tab, ctab_tab, make_rhs_block(kc, fzt))
            assert torch.equal(ss_k, fk.tile_error_sums(
                est, y, 1e-5, 1e-8, fr.CHUNK_TILE, fr.CHUNK_TILE,
                fr.CHUNK_THREADS))
            rel = abs(float(ss_k.sum()) - float(ss_r.sum())) / float(ss_r.sum())
            assert rel <= (1e-5 if dtype == torch.float32 else 1e-12)
    info = fr.kernel_info(dtype, False, kc.kinetics_id)
    assert info["shared_bytes"] == fr.chunk_plan(y.element_size())[3]
    assert info["blocks_per_sm"] >= (2 if dtype == torch.float32 else 1)
