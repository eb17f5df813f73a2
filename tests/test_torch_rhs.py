"""The port's geometry, ICs, kinetics and RHS on the torch path (f64, CPU)
against the JAX package's (f64, CPU), on the ICs and on numpy-seeded
random states: FitzHugh–Nagumo and Goldbeter, the composed RHS and its
IMEX split."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdmodel_tpu.config import SimConfig as JSimConfig
from crdmodel_tpu.core import problem as jproblem
from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.convert import inputs_from_numpy
from crdmodel_tpu_torch.core import problem as tproblem

BASE = dict(model="fhn", x_mesh=16, surface_width=20, surface_length=40,
            t_final=1.0, output_timestep=2, wave_length=0.1, wave_width=0.5,
            beta=1.25, beta_min=0.7, beta_max=1.7, t_boundary=0.4,
            dtype="float64")
CASES = [dict(surface=s, vary_beta=vb, wave_inside=wi)
         for s in ("torus", "flat") for vb in (0, 1) for wi in (0, 1)
         if not (s == "flat" and wi == 1)]
IDS = [f"{c['surface']}-vb{c['vary_beta']}-wi{c['wave_inside']}"
       for c in CASES]
# (t, segment end): before tBoundary in the frozen segment, at tBoundary as
# the frozen segment's last stage and as the released segment's first, after
TIMES = [(0.1, 0.4), (0.4, 0.4), (0.4, 0.5), (0.7, 1.0)]


# Goldbeter (data/GoldbeterModelArgs.ini's beta window): the wave-segment
# ICs on both surfaces and the varyBeta=1 ICs of every icType
GB_BASE = dict(BASE, model="goldbeter", beta=0.4, beta_min=0.0,
               beta_max=1.0, wave_length=0.2, rng_seed=5)
GB_CASES = ([dict(surface="torus", vary_beta=0, wave_inside=wi)
             for wi in (0, 1)]
            + [dict(surface="flat", vary_beta=0)]
            + [dict(surface=s, vary_beta=1, ic_type=ic)
               for s in ("torus", "flat") for ic in (0, 1, 2)])
GB_IDS = [f"{c['surface']}-vb{c['vary_beta']}-"
          + (f"ic{c['ic_type']}" if c["vary_beta"] else f"wi{c.get('wave_inside', 0)}")
          for c in GB_CASES]


def _problems(kw, base=BASE):
    cfg = dict(base, **kw)
    return (jproblem.build_problem(JSimConfig(**cfg)),
            tproblem.build_problem(SimConfig(**cfg), device="cpu"))


def _jax_uniform(cfg):
    """The JAX package's icType=2 draws (crdmodel_tpu/core/problem.py:
    203-209), (2, ny, nx) float32 in [0, 1)."""
    import jax
    k0, k1 = jax.random.split(jax.random.PRNGKey(cfg.rng_seed))
    return np.stack([np.asarray(jax.random.uniform(k, (cfg.ny, cfg.nx),
                                                   dtype=jnp.float32))
                     for k in (k0, k1)])


def _assert_close(got, want, scale):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    err = np.max(np.abs(got - np.asarray(want)))
    assert err <= 1e-13 * max(1.0, scale), err


@pytest.mark.parametrize("kw", CASES, ids=IDS)
def test_setup_matches_jax(kw):
    jp, tp = _problems(kw)
    for got, want in zip(tp.geometry.stencil_coeffs(torch.float64, "cpu"),
                         jp.geometry.stencil_coeffs(jnp.float64)):
        assert tuple(got.shape) == tuple(np.shape(want))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tp.params["b"].numpy(),
                                  np.asarray(jp.params["b"]))
    np.testing.assert_array_equal(tp.y0.numpy(), np.asarray(jp.y0))
    assert tp.steady_state == jp.steady_state


@pytest.mark.parametrize("kw", CASES, ids=IDS)
@pytest.mark.parametrize("state", ["ic", "random"])
def test_rhs_matches_jax(kw, state):
    jp, tp = _problems(kw)
    y_np = np.asarray(jp.y0)
    if state == "random":
        rng = np.random.default_rng(7)
        y_np = rng.uniform(-2.0, 2.0, size=y_np.shape)
    y_t, p_t = inputs_from_numpy(
        y_np, {k: np.asarray(v) for k, v in jp.params.items()},
        device="cpu", dtype=torch.float64)
    for t, seg_end in TIMES:
        want = np.asarray(jp.rhs(jnp.float64(t), jnp.asarray(y_np),
                                 {**jp.params, "_seg_end": jnp.float64(seg_end)}))
        got = tp.rhs(torch.tensor(t, dtype=torch.float64), y_t,
                     {**p_t, "_seg_end": torch.tensor(seg_end,
                                                      dtype=torch.float64)})
        _assert_close(got, want, np.max(np.abs(want)))
    # the frozen rows hold still before tBoundary
    frozen = tp.rhs(torch.tensor(0.1, dtype=torch.float64), y_t,
                    {**p_t, "_seg_end": torch.tensor(0.4, dtype=torch.float64)})
    assert torch.all(frozen[:, [0, -1]] == 0)


@pytest.mark.parametrize("kw", GB_CASES, ids=GB_IDS)
def test_goldbeter_setup_matches_jax(kw):
    jp, tp = _problems(kw, GB_BASE)
    assert tp.steady_state == jp.steady_state
    np.testing.assert_array_equal(tp.params["b"].numpy(),
                                  np.asarray(jp.params["b"]))
    y0 = tp.y0
    if kw.get("ic_type") == 2:
        # the port draws from a torch.Generator: right range, other bits
        assert float(y0.min()) >= 0.0 and float(y0.max()) < 1.4
        y0 = tproblem.initial_state(tp.cfg, tp.model, tp.steady_state,
                                    torch.float64, "cpu",
                                    uniform=_jax_uniform(tp.cfg))
    np.testing.assert_array_equal(y0.numpy(), np.asarray(jp.y0))


def test_goldbeter_random_ics_follow_the_seed():
    cfg = SimConfig(**GB_BASE, surface="torus", vary_beta=1, ic_type=2)
    a, b = (tproblem.build_problem(c, "cpu").y0 for c in (cfg, cfg))
    c = tproblem.build_problem(SimConfig(**{**GB_BASE, "rng_seed": 6},
                                         surface="torus", vary_beta=1,
                                         ic_type=2), "cpu").y0
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("beta", ["scalar", "field"])
def test_goldbeter_kinetics_matches_jax(beta):
    from crdmodel_tpu.models import goldbeter as jgb
    from crdmodel_tpu_torch.models import goldbeter as tgb

    rng = np.random.default_rng(17)
    y = rng.uniform(0.0, 3.0, (2, 24, 10))
    b = 0.4 if beta == "scalar" else rng.uniform(0.0, 1.0, (24, 1))
    y_t, p_t = inputs_from_numpy(y, {"b": b}, device="cpu",
                                 dtype=torch.float64)
    for name in ("kinetics", "jac_bound"):
        want = np.asarray(getattr(jgb, name)(jnp.asarray(y), jnp.asarray(b)))
        got = getattr(tgb, name)(y_t, p_t["b"]).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-15,
                                   atol=1e-15 * np.abs(want).max())
    for beta_value in (0.1, 0.4, 0.85):
        assert tgb.steady_state(beta_value) == jgb.steady_state(beta_value)


@pytest.mark.parametrize("kw", [GB_CASES[1], GB_CASES[2], GB_CASES[3]],
                         ids=[GB_IDS[1], GB_IDS[2], GB_IDS[3]])
@pytest.mark.parametrize("t_boundary", [0.0, 0.4])
def test_goldbeter_rhs_and_split_match_jax(kw, t_boundary):
    """The composed RHS and both parts of the IMEX split against the JAX
    package's; rhs_ex + rhs_im is the composed RHS bitwise."""
    kw = dict(kw, t_boundary=t_boundary)
    jp, tp = _problems(kw, GB_BASE)
    jsplit = jproblem.make_rhs(jp.cfg, jp.model, jp.geometry, jnp.float64,
                               split=True)
    tsplit = tproblem.make_rhs(tp.cfg, tp.model, tp.geometry, torch.float64,
                               "cpu", split=True)
    y_np = np.random.default_rng(8).uniform(0.0, 3.0, np.shape(jp.y0))
    y_t, p_t = inputs_from_numpy(
        y_np, {k: np.asarray(v) for k, v in jp.params.items()},
        device="cpu", dtype=torch.float64)
    for t, seg_end in TIMES:
        jpar = {**jp.params, "_seg_end": jnp.float64(seg_end)}
        tpar = {**p_t, "_seg_end": torch.tensor(seg_end, dtype=torch.float64)}
        tt = torch.tensor(t, dtype=torch.float64)
        got = tp.rhs(tt, y_t, tpar)
        want = np.asarray(jp.rhs(jnp.float64(t), jnp.asarray(y_np), jpar))
        _assert_close(got, want, np.max(np.abs(want)))
        parts = [f(tt, y_t, tpar) for f in tsplit]
        assert torch.equal(parts[0] + parts[1], got)
        assert torch.all(parts[0][1] == 0)
        for part, jf in zip(parts, jsplit):
            want = np.asarray(jf(jnp.float64(t), jnp.asarray(y_np), jpar))
            _assert_close(part, want, np.max(np.abs(want)))


def test_just_diffusion_rhs_matches_jax():
    jp, tp = _problems(dict(surface="torus", vary_beta=0, just_diffusion=1))
    y_np = np.random.default_rng(3).uniform(-1.0, 1.0, np.shape(jp.y0))
    want = np.asarray(jp.rhs(0.0, jnp.asarray(y_np), jp.params))
    got = tp.rhs(torch.tensor(0.0, dtype=torch.float64),
                 torch.tensor(y_np), tp.params)
    _assert_close(got, want, np.max(np.abs(want)))


@pytest.mark.parametrize("cfg_kw,item", [
    (dict(surface="sphere"), "item 12"), (dict(model="barkley"), "item 6"),
    (dict(coupling="curvature", surface="torus"), None)])
def test_unported_inputs_raise(cfg_kw, item):
    """What is not ported raises NotImplementedError naming its ROADMAP
    item; coupling="curvature", which raised until item 10 was ported,
    builds, with the JAX package's D(theta) field to 1e-15 (item None),
    and so does the Barkley family, which raised until item 6 was ported,
    with the JAX package's initial state bitwise."""
    cfg = SimConfig(**{**BASE, "surface": "torus", **cfg_kw})
    if item == "item 6":
        jcfg = JSimConfig(**{**BASE, "surface": "torus", **cfg_kw})
        np.testing.assert_array_equal(
            tproblem.build_problem(cfg, device="cpu").y0.numpy(),
            np.asarray(jproblem.build_problem(jcfg).y0))
        return
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            tproblem.build_problem(cfg, device="cpu")
        return
    problem = tproblem.build_problem(cfg, device="cpu")
    jcfg = JSimConfig(**{**BASE, "surface": "torus", **cfg_kw})
    want = jproblem.build_problem(jcfg).diffusion_field
    assert problem.diffusion_field.shape == (cfg.nx,)
    np.testing.assert_allclose(problem.diffusion_field, want, rtol=0,
                               atol=1e-15)
