"""Kernel K2, the fused RKC2 step (crdmodel_tpu_torch/ops/fused_rkc.py).

On the CPU: the stage tables and the recurrence against the JAX package's;
the kernel's plain version against the JAX Pallas kernel run in interpret
mode (f32) and against the JAX XLA rkc2 stepper (f64); simulate() through
the fused path against the JAX package's fused run in interpret mode.
On a CUDA card (marker `cuda`): the CUDA kernel against the plain version.
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
from crdmodel_tpu_torch.ops import fused_rkc as fr
from crdmodel_tpu_torch.ops.kernel_common import SMEM_BYTES, prepare_constants

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
    assert not fr.is_rkc_supported(
        dataclasses.replace(p, diffusion_field=np.ones((64, 64))),
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
