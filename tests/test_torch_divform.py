"""The port's divergence-form operator, no-flux walls, obstacles, diffusion
fields and Aliev–Panfilov kinetics on the torch path (CPU) against the JAX
package's (CPU): the face coefficients and openness masks bitwise; the RHS,
its IMEX split and the RKC2 bound in f64 to 1e-13; the Aliev–Panfilov
kinetics, bound, Jacobian and ICs; the adaptive driver on a bounded
cardiac-tissue case; and the routing of divergence-form problems to the
fused step K4 (ops/fused_divform.py) for the ERK methods, to K2's
divergence branch for rkc2, and off K1 and K3."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdmodel_tpu.config import SimConfig as JSimConfig
from crdmodel_tpu.core import grid as jgrid
from crdmodel_tpu.core import problem as jproblem
from crdmodel_tpu.sim import simulate as jsimulate
from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.convert import inputs_from_numpy
from crdmodel_tpu_torch.core import grid as tgrid
from crdmodel_tpu_torch.core import problem as tproblem
from crdmodel_tpu_torch.integrate.erk import TABLEAUS
from crdmodel_tpu_torch.ops import fused_divform as fd
from crdmodel_tpu_torch.ops import fused_imex, fused_rkc, fused_step
from crdmodel_tpu_torch.ops.kernel_common import needs_divform
from crdmodel_tpu_torch.sim import simulate

FLAT = dict(surface="flat", x_mesh=16, surface_width=20, surface_length=40)
TORUS = dict(surface="torus", x_mesh=16, surface_width=20, surface_length=40)
NY, NX = 32, 16                      # the grid of FLAT and TORUS


def _scar(ny=NY, nx=NX, rows=slice(12, 18), cols=slice(5, 9)):
    """A tissue mask with a rectangular inert scar."""
    mask = np.ones((ny, nx), bool)
    mask[rows, cols] = False
    return mask


def _dfield(kind):
    rng = np.random.default_rng(4)
    return {"scalar": 0.7,
            "x": 0.5 + 0.4 * rng.random(NX),
            "xy": 0.5 + 0.4 * rng.random((NY, NX))}[kind]


# (surface, boundary, obstacle, D): the face coefficients of each
GEOMETRY_CASES = (
    [(FLAT, "periodic", False, d) for d in ("scalar", "x", "xy")]
    + [(FLAT, b, False, "scalar") for b in ("noflux", "noflux_x",
                                            "noflux_y")]
    + [(FLAT, "noflux", True, "xy"), (FLAT, "periodic", True, "scalar")]
    + [(TORUS, "periodic", False, d) for d in ("scalar", "x", "xy")]
    + [(TORUS, "periodic", True, d) for d in ("scalar", "xy")])
GEOMETRY_IDS = [f"{s['surface']}-{b}-{'scar' if o else 'open'}-D{d}"
                for s, b, o, d in GEOMETRY_CASES]


@pytest.mark.parametrize("surface,boundary,obstacle,dkind", GEOMETRY_CASES,
                         ids=GEOMETRY_IDS)
def test_face_coefficients_match_jax_bitwise(surface, boundary, obstacle,
                                             dkind):
    kw = dict(model="fhn", boundary=boundary, **surface)
    tissue = _scar() if obstacle else None
    jo = jgrid.face_openness(NY, NX, boundary, tissue)
    to = tgrid.face_openness(NY, NX, boundary, tissue)
    assert (jo is None) == (to is None)
    for got, want in zip(to or (), jo or ()):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    jgeo = jgrid.make_geometry(JSimConfig(**kw))
    tgeo = tgrid.make_geometry(SimConfig(**kw))
    d = _dfield(dkind)
    for got, want in zip(tgeo.divergence_coeffs64(d, to),
                         jgeo.divergence_coeffs64(d, jo)):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tgeo.divergence_coeffs(d, torch.float32, "cpu", to),
                         jgeo.divergence_coeffs(d, jnp.float32, jo)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# problems of the divergence form, f64: (config, build arguments)
RHS_CASES = {
    "ap_flat_noflux_scar": (dict(model="aliev_panfilov", beta=0.1,
                                 boundary="noflux", **FLAT),
                            dict(obstacle_mask=_scar())),
    "fhn_torus_scar_freeze": (dict(model="fhn", beta=1.25, vary_beta=1,
                                   beta_min=0.7, beta_max=1.7,
                                   t_boundary=0.4, **TORUS),
                              dict(obstacle_mask=_scar())),
    "ap_flat_xy_field": (dict(model="aliev_panfilov", beta=0.1, **FLAT),
                         dict(diffusion_field=_dfield("xy"))),
    "goldbeter_torus_xy_field": (
        dict(model="goldbeter", beta=0.4, **TORUS),
        dict(diffusion_field=_dfield("xy"))),
}
COMMON = dict(t_final=1.0, output_timestep=2, wave_length=0.25,
              wave_width=0.5, dtype="float64")
# (t, segment end): frozen, the frozen segment's end, released
TIMES = [(0.1, 0.4), (0.4, 0.4), (0.7, 1.0)]


def _problems(case, **over):
    kw, build = RHS_CASES[case]
    kw = {**COMMON, **kw, **over}
    return (jproblem.build_problem(JSimConfig(**kw), **build),
            tproblem.build_problem(SimConfig(**kw), "cpu", **build))


def _random_state(jp, seed):
    y0 = np.asarray(jp.y0)
    rng = np.random.default_rng(seed)
    if jp.cfg.model == "goldbeter":
        return rng.uniform(0.1, 2.5, y0.shape)
    return rng.uniform(-0.2, 1.2, y0.shape)


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert np.max(np.abs(got - want)) <= 1e-13 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("case", sorted(RHS_CASES))
@pytest.mark.parametrize("state", ["ic", "random"])
def test_rhs_split_and_rho_match_jax(case, state):
    jp, tp = _problems(case)
    assert needs_divform(tp)
    np.testing.assert_array_equal(tp.y0.numpy(), np.asarray(jp.y0))
    for name in ("diffusion_field", "obstacle_mask"):
        want = getattr(jp, name)
        got = getattr(tp, name)
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(got, want)
    args = dict(diffusion_field=jp.diffusion_field, face_mask=jp.face_mask,
                obstacle_mask=jp.obstacle_mask)
    jsplit = jproblem.make_rhs(jp.cfg, jp.model, jp.geometry, jnp.float64,
                               split=True, **args)
    tsplit = tproblem.make_rhs(tp.cfg, tp.model, tp.geometry, torch.float64,
                               "cpu", split=True, **args)
    jrho = jproblem.make_rho_bound(jp.cfg, jp.model, jp.geometry,
                                   jnp.float64,
                                   diffusion_field=jp.diffusion_field,
                                   face_mask=jp.face_mask)
    trho = tproblem.make_rho_bound(tp.cfg, tp.model, tp.geometry,
                                   torch.float64,
                                   diffusion_field=tp.diffusion_field,
                                   face_mask=tp.face_mask)
    y_np = np.asarray(jp.y0) if state == "ic" else _random_state(jp, 9)
    y_t, p_t = inputs_from_numpy(
        y_np, {k: np.asarray(v) for k, v in jp.params.items()},
        device="cpu", dtype=torch.float64)
    for t, seg_end in TIMES:
        jpar = {**jp.params, "_seg_end": jnp.float64(seg_end)}
        tpar = {**p_t, "_seg_end": torch.tensor(seg_end, dtype=torch.float64)}
        tt = torch.tensor(t, dtype=torch.float64)
        got = tp.rhs(tt, y_t, tpar)
        _close(got, jp.rhs(jnp.float64(t), jnp.asarray(y_np), jpar))
        parts = [f(tt, y_t, tpar) for f in tsplit]
        assert torch.equal(parts[0] + parts[1], got)
        for part, jf in zip(parts, jsplit):
            _close(part, jf(jnp.float64(t), jnp.asarray(y_np), jpar))
        if tp.obstacle_mask is not None:
            scar = torch.tensor(~tp.obstacle_mask)
            assert torch.all(got[:, scar] == 0)
            assert all(torch.all(p[:, scar] == 0) for p in parts)
    want = float(jrho(0.0, jnp.asarray(y_np), jp.params))
    np.testing.assert_allclose(float(trho(0.0, y_t, p_t)), want, rtol=1e-13)


def test_build_problem_refuses_bad_inputs():
    cfg = SimConfig(**{**COMMON, **FLAT, "model": "fhn"})
    with pytest.raises(ValueError, match="all-False"):
        tproblem.build_problem(cfg, "cpu", obstacle_mask=np.zeros((NY, NX)))
    with pytest.raises(ValueError, match="broadcast"):
        tproblem.build_problem(cfg, "cpu", obstacle_mask=np.ones((3, 5)))
    with pytest.raises(ValueError, match="non-negative"):
        tproblem.build_problem(cfg, "cpu", diffusion_field=-np.ones(NX))
    # coupling="curvature", which raised until ROADMAP item 10 was ported,
    # builds its theta-only field; with a diffusion tensor it is refused
    coupled = SimConfig(**{**COMMON, **TORUS, "model": "fhn",
                           "coupling": "curvature"})
    field = tproblem.build_problem(coupled, "cpu").diffusion_field
    assert field.shape == (coupled.nx,) and np.all(field > 0)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tproblem.build_problem(coupled, "cpu",
                               diffusion_tensor=(1.0, 1.0, 0.0))


@pytest.mark.parametrize("beta", ["scalar", "field"])
def test_aliev_panfilov_kinetics_match_jax(beta):
    from crdmodel_tpu.models import aliev_panfilov as jap
    from crdmodel_tpu_torch.models import aliev_panfilov as tap

    rng = np.random.default_rng(21)
    y = np.stack([rng.uniform(-0.2, 1.2, (24, 10)),
                  rng.uniform(0.0, 2.5, (24, 10))])
    b = 0.1 if beta == "scalar" else rng.uniform(0.05, 0.15, (24, 1))
    y_t, p_t = inputs_from_numpy(y, {"b": b}, device="cpu",
                                 dtype=torch.float64)
    for name in ("kinetics", "jac_bound"):
        want = np.asarray(getattr(jap, name)(jnp.asarray(y), jnp.asarray(b)))
        got = getattr(tap, name)(y_t, p_t["b"]).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-15,
                                   atol=1e-15 * np.abs(want).max())
    assert tap.steady_state(0.1) == jap.steady_state(0.1)


@pytest.mark.parametrize("beta", ["scalar", "field"])
def test_aliev_panfilov_jacobian_matches_autodiff(beta):
    """The closed-form Jacobian (port-only, the fused IMEX kernel's) against
    torch.func.jacfwd of the kinetics and JAX's AD Jacobian, f64, 1e-13;
    it depends on b."""
    from crdmodel_tpu.models import aliev_panfilov as jap
    from crdmodel_tpu_torch.models import aliev_panfilov as tap

    rng = np.random.default_rng(22)
    y = np.stack([rng.uniform(-0.2, 1.2, (6, 5)),
                  rng.uniform(0.0, 2.5, (6, 5))])
    b = 0.1 if beta == "scalar" else rng.uniform(0.05, 0.15, (6, 1))
    got = tap.jacobian(torch.tensor(y),
                       torch.tensor(b, dtype=torch.float64)).numpy()
    assert got.shape == (2, 2, 6, 5)
    b_full = np.broadcast_to(b, y.shape[1:])
    for j in range(6):
        for i in range(5):
            point = torch.tensor(y[:, j, i])
            b_ij = torch.tensor(b_full[j, i])
            want_t = torch.func.jacfwd(lambda p: tap.kinetics(p, b_ij))(point)
            want_j = np.asarray(jax.jacfwd(lambda p: jap.kinetics(
                p, jnp.float64(b_full[j, i])))(jnp.asarray(y[:, j, i])))
            for want in (want_t.numpy(), want_j):
                np.testing.assert_allclose(got[:, :, j, i], want, rtol=1e-13,
                                           atol=1e-13)
    other = tap.jacobian(torch.tensor(y), torch.tensor(0.13)).numpy()
    assert not np.allclose(other, got)


@pytest.mark.parametrize("surface,wave_inside",
                         [(FLAT, 0), (TORUS, 0), (TORUS, 1)],
                         ids=["flat", "torus-wi0", "torus-wi1"])
def test_aliev_panfilov_ics_match_jax(surface, wave_inside):
    kw = dict(COMMON, model="aliev_panfilov", beta=0.1,
              wave_inside=wave_inside, **surface)
    jp = jproblem.build_problem(JSimConfig(**kw))
    tp = tproblem.build_problem(SimConfig(**kw), "cpu")
    np.testing.assert_array_equal(tp.y0.numpy(), np.asarray(jp.y0))
    assert tp.steady_state == jp.steady_state
    assert set(np.unique(tp.y0.numpy())) == {0.0, 1.0, 2.0}


# the bounded cardiac-tissue program of scripts/bench_suite.py::
# bounded_tissue at 48x48: no-flux walls and a square scar
BOUNDED = dict(model="aliev_panfilov", surface="flat", x_mesh=48,
               surface_width=20, surface_length=20, diffusion=1.0, beta=0.10,
               wave_length=0.25, wave_width=0.5, t_final=2.0,
               output_timestep=4, dtype="float64", rtol=1e-4, atol=1e-7,
               boundary="noflux")
BOUNDED_SCAR = (slice(20, 30), slice(22, 34))


def _bounded_mask():
    return _scar(48, 48, *BOUNDED_SCAR)


@pytest.mark.parametrize("method", ["bs32", "rkc2", "ark324"])
def test_bounded_tissue_driver_matches_jax(method):
    """The torch path on the bounded case against the JAX package's XLA
    path, f64, at tests/test_golden.py's tolerances: identical accepted and
    rejected step sequences, trajectories within 1e-10, and the scar
    holding its IC bitwise. (At rtol 1e-4 the steps stay identical, but the
    large steps amplify the ulp differences of JAX's contracted a*b + c to
    1e-9 by t = 2.) On the card ark324 takes the torch path too (K3
    declines the divergence form); rkc2 takes K2's divergence branch
    (tests/test_torch_fused_rkc.py)."""
    kw = dict(BOUNDED, method=method, rtol=1e-7, atol=1e-11)
    if method == "ark324":
        # its Newton stages cost ~10x a bs32 step: half the horizon
        kw.update(t_final=1.0, output_timestep=2)
    mask = _bounded_mask()
    jp = jproblem.build_problem(JSimConfig(**kw), obstacle_mask=mask)
    want = jsimulate(JSimConfig(**kw), problem=jp)
    cfg = SimConfig(**kw)
    got = simulate(cfg, "cpu",
                   problem=tproblem.build_problem(cfg, "cpu",
                                                  obstacle_mask=mask))
    assert got.ok and want.ok and not got.fused
    for name in ("steps", "accepted", "rejected", "status"):
        np.testing.assert_array_equal(
            getattr(got.stats, name).numpy(),
            np.asarray(getattr(want.stats, name)), err_msg=name)
    traj = got.trajectory.numpy()
    np.testing.assert_allclose(traj, np.asarray(want.trajectory), rtol=0,
                               atol=1e-10)
    scar = (slice(None), slice(None)) + BOUNDED_SCAR
    assert np.array_equal(traj[scar], np.broadcast_to(
        traj[0][(slice(None),) + BOUNDED_SCAR], traj[scar].shape))


def test_bounded_tissue_fused_simulate_takes_plain_k4(monkeypatch):
    """simulate() with use_pallas=True on the CPU runs K4's plain version at
    every step and takes the torch path's steps; f32."""
    from crdmodel_tpu_torch import integrate
    from crdmodel_tpu_torch.integrate.erk import SYNC_EVERY, merge_stops
    from crdmodel_tpu_torch.sim import output_times

    kw = dict(BOUNDED, dtype="float32", use_pallas=True)
    mask = _bounded_mask()
    calls = {"plain_k4": 0}
    plain = fd.fused_divform_step_reference

    def counted(*args, **kwargs):
        calls["plain_k4"] += 1
        return plain(*args, **kwargs)

    def no_torch_path(*args, **kwargs):
        raise AssertionError("the fused run built the torch-path stepper")

    cfg = SimConfig(**kw)
    with monkeypatch.context() as m:
        m.setattr(fd, "fused_divform_step_reference", counted)
        m.setattr(integrate.erk, "make_default_step_err", no_torch_path)
        res = simulate(cfg, "cpu", problem=tproblem.build_problem(
            cfg, "cpu", obstacle_mask=mask))
    cfg_t = dataclasses.replace(cfg, use_pallas=False)
    ref = simulate(cfg_t, "cpu", problem=tproblem.build_problem(
        cfg_t, "cpu", obstacle_mask=mask))
    assert res.fused and res.ok and not ref.fused
    n_stops = len(merge_stops(output_times(cfg), ())[0])
    assert (res.total_steps() <= calls["plain_k4"]
            <= res.total_steps() + SYNC_EVERY * n_stops)
    for name in ("steps", "accepted", "rejected"):
        np.testing.assert_array_equal(getattr(res.stats, name).numpy(),
                                      getattr(ref.stats, name).numpy())
    np.testing.assert_allclose(res.trajectory.numpy(),
                               ref.trajectory.numpy(), rtol=0, atol=1e-5)


def _gate_problems():
    """tests/test_divform_kernel.py's divergence-form cases, f32."""
    mask = np.ones((48, 48), bool)
    mask[10:20, 10:20] = False
    flat = dict(model="fhn", surface="flat", x_mesh=48, surface_width=20.0,
                surface_length=20.0, beta=1.25, dtype="float32")
    torus = dict(model="fhn", surface="torus", x_mesh=40, beta=1.25,
                 dtype="float32")
    tor = SimConfig(**torus)
    return [
        (SimConfig(**flat, boundary="noflux"), {}),
        (SimConfig(**flat), dict(obstacle_mask=mask)),
        (tor, dict(diffusion_field=np.full((tor.ny, tor.nx), 0.1))),
        (SimConfig(**flat), dict(diffusion_field=np.full(48, 0.1))),
        (SimConfig(**{**flat, "model": "aliev_panfilov", "beta": 0.1},
                   boundary="noflux"), dict(obstacle_mask=mask)),
    ], tor


def test_gates_route_divform_cases_off_profile_kernels():
    """Mirrors tests/test_divform_kernel.py's gate test: K1 and K3 decline
    the divergence form, K4 takes it for the ERK methods and K2's
    divergence branch for rkc2 (crdmodel_tpu/ops/pallas_rkc.py:239-253)."""
    tab = TABLEAUS["bs32"]
    f32 = torch.float32
    cases, tor = _gate_problems()
    for cfg, kw in cases:
        p = tproblem.build_problem(cfg, "cpu", **kw)
        assert needs_divform(p)
        assert not fused_step.is_supported(p, tab, f32)
        assert not fused_imex.is_imex_supported(p, f32)
        assert fused_rkc.is_rkc_supported(p, f32)
        assert fd.is_divform_supported(p, tab, f32)
        assert fd.is_divform_supported(p, TABLEAUS["dopri54"], f32)
        assert not fd.is_divform_supported(p, tab, torch.float64)
    # theta-only torus fields keep the profile kernels, through the remap
    p = tproblem.build_problem(tor, "cpu", diffusion_field=np.full(40, 0.1))
    assert not needs_divform(p)
    assert fused_step.is_supported(p, tab, f32)
    assert not fd.is_divform_supported(p, tab, f32)
    # constant-D periodic problems keep the profile kernels
    p = tproblem.build_problem(dataclasses.replace(cases[0][0],
                                                   boundary="periodic"), "cpu")
    assert not needs_divform(p)


def test_theta_field_through_k1_matches_torch_path():
    """A theta-only torus diffusion field goes through K1's plain version
    with the profile remap (kernel_common.kernel_stencil_coeffs): one step
    agrees with the torch path's divergence operator to f32 rounding (the
    regrouping is not bitwise) and differs from the constant-D step."""
    from crdmodel_tpu_torch.integrate.erk import make_default_step_err

    cfg = SimConfig(model="fhn", surface="torus", x_mesh=16,
                    surface_width=20, surface_length=40, beta=1.25,
                    dtype="float32", rtol=1e-4, atol=1e-6)
    theta = 2 * np.pi * np.arange(cfg.nx) / cfg.nx
    dfield = 0.6 + 0.3 * np.cos(theta)
    p = tproblem.build_problem(cfg, "cpu", diffusion_field=dfield)
    assert not needs_divform(p)
    assert fused_step.is_supported(p, TABLEAUS["bs32"], torch.float32)
    y = torch.tensor(np.random.default_rng(5).uniform(-2, 2, p.y0.shape),
                     dtype=torch.float32)
    h = torch.tensor(0.05)
    params = {**p.params, "_seg_end": torch.tensor(1.0)}
    got, _ = fused_step.build_fused_step(p, TABLEAUS["bs32"])(
        torch.tensor(0.0), y, h, params)
    tstep, init = make_default_step_err(TABLEAUS["bs32"], p.rhs, 1e-4, 1e-6)
    want = tstep(torch.tensor(0.0), y, h, params,
                 init(torch.tensor(0.0), y, params))[0]
    assert float((got - want).abs().max()) <= 2e-5 * float(y.abs().max())
    const = tproblem.build_problem(cfg, "cpu")
    plain, _ = fused_step.build_fused_step(const, TABLEAUS["bs32"])(
        torch.tensor(0.0), y, h, params)
    assert float((plain - want).abs().max()) > 1e-3
