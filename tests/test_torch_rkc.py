"""RKC2 on the port's torch path (crdmodel_tpu_torch/integrate/rkc.py, the
rho bound, the h cap and the auto-selection predicate) against the JAX
package on the CPU, in float64: the Chebyshev scalars, the spectral-radius
bound, one step, and whole runs of the FitzHugh–Nagumo cases of
tests/test_golden.py with method="rkc2"."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdmodel_tpu.config import SimConfig as JSimConfig
from crdmodel_tpu.config import config_from_ini as jconfig_from_ini
from crdmodel_tpu.core.problem import build_problem as jbuild_problem
from crdmodel_tpu.core.problem import make_rho_bound as jmake_rho_bound
from crdmodel_tpu.integrate import erk as jerk
from crdmodel_tpu.integrate import rkc as jrkc
from crdmodel_tpu.sim import _quiescent_autonomous as j_quiescent
from crdmodel_tpu.sim import output_times as joutput_times
from crdmodel_tpu.sim import simulate as jsimulate
from crdmodel_tpu_torch.config import SimConfig, config_from_ini
from crdmodel_tpu_torch.convert import inputs_from_numpy
from crdmodel_tpu_torch.core.problem import (build_problem, make_rhs,
                                             make_rho_bound)
from crdmodel_tpu_torch.integrate import erk, imex, rkc
from crdmodel_tpu_torch.sim import _quiescent_autonomous, output_times, simulate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FHN_INI = os.path.join(ROOT, "data", "FHNmodelArgs.ini")
# tests/test_golden.py CASES and BASE for the FHN cases
CASES = {
    "fhn_flat": dict(model="fhn", surface="flat", beta=1.25, t_boundary=0.4),
    "fhn_torus": dict(model="fhn", surface="torus", beta=1.25, vary_beta=1,
                      beta_min=0.7, beta_max=1.7, t_boundary=0.4),
}
BASE = dict(x_mesh=16, surface_width=20, surface_length=40,
            t_final=1.0, output_timestep=2, wave_length=0.1, wave_width=0.5,
            dtype="float64", rtol=1e-7, atol=1e-11, method="rkc2")


def _problems(case, **over):
    kw = {**BASE, **CASES[case], **over}
    return jbuild_problem(JSimConfig(**kw)), build_problem(SimConfig(**kw),
                                                           "cpu")


def _inputs(jp, seed, noise=0.5):
    """A numpy-seeded state near the IC, and the params, on both sides."""
    y = np.asarray(jp.y0) + noise * np.random.default_rng(seed).standard_normal(
        np.shape(jp.y0))
    jparams = {k: np.asarray(v) for k, v in jp.params.items()}
    y_t, p_t = inputs_from_numpy(y, jparams, device="cpu",
                                 dtype=torch.float64)
    return y, jparams, y_t, p_t


def _cheb_python(s, w0):
    """The recurrence in Python floats: IEEE f64, one rounding per op."""
    tm2, tm1, dm2, dm1, d2m2, d2m1 = 1.0, w0, 0.0, 1.0, 0.0, 0.0
    for _ in range(2, s + 1):
        t = 2 * w0 * tm1 - tm2
        d = 2 * w0 * dm1 - dm2 + 2 * tm1
        d2 = 2 * w0 * d2m1 - d2m2 + 4 * dm1
        tm2, tm1, dm2, dm1, d2m2, d2m1 = tm1, t, dm1, d, d2m1, d2
    return tm1, dm1, d2m1


def test_cheb_scalars_match_jax():
    """The port rounds as plain f64 arithmetic does, exactly; XLA's compiled
    loop rounds differently, by up to 8.2e-13 relative at large s (a
    recurrence of up to 256 steps), hence 2e-12 against JAX."""
    jcheb = jax.jit(jrkc._cheb_scalars)
    for s in range(2, rkc.S_MAX + 1):
        w0 = 1.0 + rkc.EPS_DAMP / (s * s)
        want = jcheb(jnp.int32(s), jnp.float64(w0))
        got = rkc._cheb_scalars(s, torch.tensor(w0, dtype=torch.float64))
        assert tuple(float(g) for g in got) == _cheb_python(s, w0)
        for g, w in zip(got, want):
            np.testing.assert_allclose(float(g), float(w), rtol=2e-12)


def test_choose_stages_and_h_max_match_jax():
    h_rho = np.concatenate([[0.0, 1e-3, 0.65, 1.0], np.geomspace(1e-2, 1e6, 400)])
    rho = np.full_like(h_rho, 37.5)
    h = h_rho / rho
    want = np.asarray(jrkc.choose_stages(jnp.asarray(h), jnp.asarray(rho)))
    got = rkc.choose_stages(torch.tensor(h), torch.tensor(rho))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and want.min() == 2
    assert want.max() == rkc.S_MAX
    np.testing.assert_allclose(
        rkc.h_max_for(torch.tensor(rho)).numpy(),
        np.asarray(jrkc.h_max_for(jnp.asarray(rho))), rtol=1e-15)


def test_stage_sync_not_ported():
    with pytest.raises(NotImplementedError, match="stage_sync"):
        rkc.make_rkc2_step_err(None, None, 1e-5, 1e-8, stage_sync=max)


@pytest.mark.parametrize("case", sorted(CASES))
def test_rho_bound_matches_jax(case):
    jp, tp = _problems(case)
    jrho = jmake_rho_bound(jp.cfg, jp.model, jp.geometry, jnp.float64)
    trho = make_rho_bound(tp.cfg, tp.model, tp.geometry, torch.float64)
    for seed in (None, 3, 4):
        if seed is None:
            y, jparams = np.asarray(jp.y0), {k: np.asarray(v)
                                             for k, v in jp.params.items()}
            y_t, p_t = tp.y0, tp.params
        else:
            y, jparams, y_t, p_t = _inputs(jp, seed)
        want = float(jrho(0.0, jnp.asarray(y), jparams))
        got = trho(torch.tensor(0.0), y_t, p_t)
        assert got.dim() == 0 and got.dtype == torch.float64
        np.testing.assert_allclose(float(got), want, rtol=1e-14)


def test_rho_bound_unported_operators():
    jp, tp = _problems("fhn_torus")
    args = (tp.cfg, tp.model, tp.geometry, torch.float64)
    # max_reduce is ported (the sharded run, ROADMAP queue 1, item 15): on
    # a one-shard state it reduces the one kinetics max to itself
    def one_shard(fn, y, b):
        return max(fn(yi, bi) for yi, bi in zip(y, b))

    reduced = make_rho_bound(*args, max_reduce=one_shard)
    assert float(reduced(0.0, [tp.y0], {"b": [tp.params["b"]]})) == float(
        make_rho_bound(*args)(0.0, tp.y0, tp.params))
    # the divergence form and the tensor are ported: their bounds are the
    # JAX package's
    for kw in (dict(diffusion_field=np.ones(16)),
               dict(diffusion_tensor=(1.0, 1.0, 0.0)),
               dict(diffusion_tensor=(1.0, 0.25, 0.15))):
        want = jmake_rho_bound(jp.cfg, jp.model, jp.geometry, jnp.float64,
                               **kw)
        got = make_rho_bound(*args, **kw)
        np.testing.assert_allclose(
            float(got(0.0, tp.y0, tp.params)),
            float(want(0.0, jp.y0, jp.params)), rtol=1e-14)
    jd = build_problem(SimConfig(**{**BASE, **CASES["fhn_torus"],
                                    "just_diffusion": 1}), "cpu")
    rho = make_rho_bound(jd.cfg, jd.model, jd.geometry, torch.float64)
    assert float(rho(0.0, jd.y0, jd.params)) > 0


def test_quiescent_predicate_matches_jax():
    canonical = (jconfig_from_ini(FHN_INI, model="fhn", surface="torus"),
                 config_from_ini(FHN_INI, model="fhn", surface="torus"))
    rest = dict(model="fhn", surface="flat", x_mesh=64, surface_width=4.0,
                surface_length=4.0, beta=1.25, t_final=2.0,
                output_timestep=1, dtype="float32", rtol=1e-4, atol=1e-6,
                wave_length=0.0, wave_width=0.0, method="rkc2")
    quiet = (JSimConfig(**rest), SimConfig(**rest))
    for (jc, tc), want in ((canonical, False), (quiet, True)):
        tp = build_problem(tc, "cpu")
        assert j_quiescent(jbuild_problem(jc)) is want
        assert _quiescent_autonomous(tp) is want
    # a uniform state off the rest point: its rate is far above tolerance
    jp, tp = jbuild_problem(quiet[0]), build_problem(quiet[1], "cpu")
    jp = dataclasses.replace(jp, y0=jnp.zeros_like(jp.y0))
    tp = dataclasses.replace(tp, y0=torch.zeros_like(tp.y0))
    assert not j_quiescent(jp) and not _quiescent_autonomous(tp)


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_step_matches_jax(case):
    """One step at the same (t, y, h, f0), with h*rho = 3, 30 and 300
    (s = 4, 8 and 23). A large D makes diffusion, not the kinetics, set
    rho, so that each h stays small enough for the kinetics."""
    jp, tp = _problems(case, diffusion=1000.0)
    jrho = jmake_rho_bound(jp.cfg, jp.model, jp.geometry, jnp.float64)
    trho = make_rho_bound(tp.cfg, tp.model, tp.geometry, torch.float64)
    jstep, jinit = jrkc.make_rkc2_step_err(jp.rhs, jrho, BASE["rtol"],
                                           BASE["atol"])
    tstep, tinit = rkc.make_rkc2_step_err(tp.rhs, trho, BASE["rtol"],
                                          BASE["atol"])
    y, jparams, y_t, p_t = _inputs(jp, 5, noise=0.05)
    for seg_end in (0.4, 1.0):
        jpar = {**jparams, "_seg_end": jnp.float64(seg_end)}
        tpar = {**p_t, "_seg_end": torch.tensor(seg_end, dtype=torch.float64)}
        t = 0.3 if seg_end == 0.4 else 0.5
        tt = torch.tensor(t, dtype=torch.float64)
        rho = float(trho(tt, y_t, tpar))
        for h in (3.0 / rho, 30.0 / rho, 300.0 / rho):
            jy, jss, jf1 = jax.jit(jstep)(
                jnp.float64(t), jnp.asarray(y), jnp.float64(h), jpar,
                jinit(jnp.float64(t), jnp.asarray(y), jpar))
            ty, tss, tf1 = tstep(tt, y_t, torch.tensor(h, dtype=torch.float64),
                                 tpar, tinit(tt, y_t, tpar))
            assert np.isfinite(np.asarray(jy)).all()
            scale = max(1.0, float(np.abs(np.asarray(jy)).max()))
            np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                                       atol=1e-13 * scale)
            np.testing.assert_allclose(float(tss), float(jss), rtol=1e-13)
            np.testing.assert_allclose(tf1.numpy(), np.asarray(jf1), rtol=1e-13,
                                       atol=1e-13 * np.abs(np.asarray(jf1)).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_path_run_matches_jax(case):
    kw = {**BASE, **CASES[case]}
    got = simulate(SimConfig(**kw), device="cpu")
    want = jsimulate(JSimConfig(**kw))
    assert got.ok and want.ok and not got.fused
    for name in ("steps", "accepted", "rejected", "status"):
        np.testing.assert_array_equal(
            getattr(got.stats, name).numpy(),
            np.asarray(getattr(want.stats, name)), err_msg=name)
    np.testing.assert_allclose(got.trajectory.numpy(),
                               np.asarray(want.trajectory), rtol=0, atol=1e-10)


@pytest.mark.parametrize("case", sorted(CASES))
def test_h_cap_matches_jax(case):
    """integrate_to_outputs with an h cap that binds (h*rho <= 0.05, well
    below the accuracy-limited step): per-interval step counts identical to
    the JAX package's, trajectories within 1e-10."""
    kw = {**BASE, **CASES[case], "rtol": 1e-5, "atol": 1e-8}
    jp, tp = _problems(case, rtol=1e-5, atol=1e-8)
    jrho = jmake_rho_bound(jp.cfg, jp.model, jp.geometry, jnp.float64)
    trho = make_rho_bound(tp.cfg, tp.model, tp.geometry, torch.float64)
    cap = 0.05

    def run(integrate, rhs, y0, params, rho, touts):
        return integrate(rhs, y0, params, 0.0, touts, rtol=kw["rtol"],
                         atol=kw["atol"], method="rkc2", rho_fn=rho,
                         breakpoints=(0.4,),
                         h_limit_fn=lambda t, y, p: cap / rho(t, y, p))

    jtraj, jstats = jax.jit(lambda y0, p: run(
        jerk.integrate_to_outputs, jp.rhs, y0, p, jrho,
        joutput_times(jp.cfg)))(jp.y0, jp.params)
    ttraj, tstats = run(erk.integrate_to_outputs, tp.rhs, tp.y0, tp.params,
                        trho, output_times(tp.cfg))
    free = simulate(SimConfig(**kw), device="cpu")
    assert int(tstats.steps.sum()) > 2 * free.total_steps()   # it binds
    for name in ("steps", "accepted", "rejected", "status"):
        np.testing.assert_array_equal(getattr(tstats, name).numpy(),
                                      np.asarray(getattr(jstats, name)),
                                      err_msg=name)
    np.testing.assert_allclose(ttraj.numpy(), np.asarray(jtraj), rtol=0,
                               atol=1e-10)


def test_make_stepper():
    _, tp = _problems("fhn_torus")
    rho = make_rho_bound(tp.cfg, tp.model, tp.geometry, torch.float64)
    *_, order = erk.make_stepper("rkc2", tp.rhs, 1e-5, 1e-8, rho_fn=rho)
    assert order == rkc.ERR_ORDER
    assert erk.make_stepper("bs32", tp.rhs, 1e-5, 1e-8)[2] == 3
    with pytest.raises(ValueError, match="rho_fn"):
        erk.make_stepper("rkc2", tp.rhs, 1e-5, 1e-8)
    with pytest.raises(ValueError, match="rhs_split"):
        erk.make_stepper("ark324", tp.rhs, 1e-5, 1e-8)
    split = make_rhs(tp.cfg, tp.model, tp.geometry, torch.float64, "cpu",
                     split=True)
    *_, order = erk.make_stepper("ark324", tp.rhs, 1e-5, 1e-8,
                                 rhs_split=split)
    assert order == imex.ERR_ORDER
