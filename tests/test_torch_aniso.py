"""The port's anisotropic tensor operator on the torch path (CPU) against the
JAX package's (CPU): the tensor coefficients bitwise (float64 numpy); the
operator, the RHS, its IMEX split and the RKC2 bound in f64 to 1e-13; the
build-time validation; the adaptive driver on a small fibered sheet with
bs32, rkc2 and ark324; and the routing of tensor problems to the fused
step K5 (ops/fused_aniso.py) for the ERK methods and to the torch path for
rkc2 and ark324."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdmodel_tpu.config import SimConfig as JSimConfig
from crdmodel_tpu.core import grid as jgrid
from crdmodel_tpu.core import problem as jproblem
from crdmodel_tpu.ops import stencil as jstencil
from crdmodel_tpu.sim import simulate as jsimulate
from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.convert import inputs_from_numpy
from crdmodel_tpu_torch.core import grid as tgrid
from crdmodel_tpu_torch.core import problem as tproblem
from crdmodel_tpu_torch.integrate.erk import TABLEAUS
from crdmodel_tpu_torch.ops import fused_aniso as fa
from crdmodel_tpu_torch.ops import fused_divform, fused_imex, fused_rkc
from crdmodel_tpu_torch.ops import fused_step
from crdmodel_tpu_torch.ops import stencil as tstencil
from crdmodel_tpu_torch.sim import fused_eligible, simulate

FLAT = dict(surface="flat", x_mesh=16, surface_width=20, surface_length=40)
TORUS = dict(surface="torus", x_mesh=16, surface_width=20, surface_length=40)
NY, NX = 32, 16                      # the grid of FLAT and TORUS


def fiber_tensor(ny, nx, d_par=1.0, d_perp=0.2, angle0=0.0,
                 angle1=np.pi / 3):
    """examples/anisotropic_fibers.py::fiber_tensor on an (ny, nx) grid:
    D = R diag(d_par, d_perp) R^T, the fibre angle rotating linearly in x."""
    th = np.broadcast_to(np.linspace(angle0, angle1, nx)[None, :], (ny, nx))
    c, s = np.cos(th), np.sin(th)
    return (d_par * c * c + d_perp * s * s, d_par * s * s + d_perp * c * c,
            (d_par - d_perp) * c * s)


def _tensor(kind, ny=NY, nx=NX):
    """A constant tensor, random SPD fields (|Dxy| up to 0.9 of the
    determinant bound) or the rotating fibres."""
    if kind == "const":
        return (1.0, 0.25, 0.15)
    if kind == "fibre":
        return fiber_tensor(ny, nx)
    rng = np.random.default_rng(31)
    dxx = 0.5 + rng.random((ny, nx))
    dyy = 0.3 + rng.random((ny, nx))
    dxy = 0.9 * np.sqrt(dxx * dyy) * (2.0 * rng.random((ny, nx)) - 1.0)
    return dxx, dyy, dxy


def test_fiber_tensor_is_the_examples():
    from crdmodel_tpu_torch.config import SimConfig as TSimConfig
    from examples.anisotropic_fibers import fiber_tensor as example

    cfg = TSimConfig(model="aliev_panfilov", **FLAT)
    for got, want in zip(fiber_tensor(NY, NX), example(cfg, 1.0, 0.2, 0.0,
                                                       np.pi / 3)):
        np.testing.assert_array_equal(got, want)


COEFF_CASES = ([(FLAT, b, k) for b in ("periodic", "noflux", "noflux_x",
                                        "noflux_y")
                for k in ("const", "random", "fibre")]
               + [(TORUS, "periodic", k) for k in ("const", "random",
                                                   "fibre")])
COEFF_IDS = [f"{s['surface']}-{b}-{k}" for s, b, k in COEFF_CASES]


@pytest.mark.parametrize("surface,boundary,kind", COEFF_CASES, ids=COEFF_IDS)
def test_tensor_coeffs64_match_jax_bitwise(surface, boundary, kind):
    kw = dict(model="aliev_panfilov", boundary=boundary, **surface)
    jgeo = jgrid.make_geometry(JSimConfig(**kw))
    tgeo = tgrid.make_geometry(SimConfig(**kw))
    tensor = _tensor(kind)
    (jf, jdxy, jinv4) = jgeo.tensor_coeffs64(*tensor, boundary=boundary)
    (tf, tdxy, tinv4) = tgeo.tensor_coeffs64(*tensor, boundary=boundary)
    for got, want in zip((*tf, tdxy, tinv4), (*jf, jdxy, jinv4)):
        assert np.shape(got) == np.shape(want)
        np.testing.assert_array_equal(got, want)
    # the cast tensors are the float64 arrays cast once
    faces32, dxy32, inv4_32 = tgeo.tensor_coeffs(*tensor, torch.float32,
                                                  "cpu", boundary=boundary)
    for got, want in zip((*faces32, dxy32, inv4_32), (*tf, tdxy, tinv4)):
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want, np.float32))
    if boundary != "periodic":
        # the walls close: zero wall faces, zero Dxy wall layers
        aE, _, aN, _ = tf
        if boundary in ("noflux", "noflux_x"):
            assert not aE[:, -1].any() and not tdxy[:, [0, -1]].any()
        if boundary in ("noflux", "noflux_y"):
            assert not aN[-1].any() and not tdxy[[0, -1]].any()


def test_tensor_coeffs_refuse_bad_input():
    for mod, cls in ((tgrid, SimConfig), (jgrid, JSimConfig)):
        flat = mod.make_geometry(cls(model="fhn", **FLAT))
        torus = mod.make_geometry(cls(model="fhn", **TORUS))
        with pytest.raises(ValueError, match="SPD"):
            flat.tensor_coeffs64(1.0, 0.25, 0.6)           # Dxy^2 > Dxx Dyy
        with pytest.raises(ValueError, match="SPD"):
            flat.tensor_coeffs64(-1.0, 0.25, 0.0)
        with pytest.raises(ValueError, match="closed"):
            torus.tensor_coeffs64(1.0, 0.25, 0.1, boundary="noflux")


@pytest.mark.parametrize("surface,boundary,kind",
                         [(FLAT, "periodic", "random"),
                          (FLAT, "noflux", "fibre"),
                          (TORUS, "periodic", "random"),
                          (TORUS, "periodic", "fibre")],
                         ids=["flat-random", "flat-noflux-fibre",
                              "torus-random", "torus-fibre"])
def test_anisotropic_laplacian_matches_jax(surface, boundary, kind):
    """ops/stencil.py::anisotropic_laplacian in f64 on a random field, to
    1e-13 of the result's scale."""
    kw = dict(model="aliev_panfilov", boundary=boundary, **surface)
    tensor = _tensor(kind)
    jf, jdxy, jinv4 = jgrid.make_geometry(JSimConfig(**kw)).tensor_coeffs64(
        *tensor, boundary=boundary)
    tf, tdxy, tinv4 = tgrid.make_geometry(SimConfig(**kw)).tensor_coeffs(
        *tensor, torch.float64, "cpu", boundary=boundary)
    u = np.random.default_rng(8).uniform(-1.0, 1.0, (NY, NX))
    want = np.asarray(jstencil.anisotropic_laplacian(
        jnp.asarray(u), tuple(jnp.asarray(a) for a in jf), jnp.asarray(jdxy),
        jnp.asarray(jinv4)))
    got = tstencil.anisotropic_laplacian(torch.tensor(u), tf, tdxy,
                                         tinv4).numpy()
    assert np.max(np.abs(got - want)) <= 1e-13 * np.abs(want).max()
    # conservative: the lattice sum vanishes (flat; the torus conserves in
    # its ring weight)
    if surface is FLAT:
        assert abs(got.sum()) <= 1e-10 * np.abs(got).sum()


# tensor problems, f64: (config, tensor kind)
RHS_CASES = {
    "ap_flat_fibre_freeze": (dict(model="aliev_panfilov", beta=0.05,
                                  t_boundary=0.4, **FLAT), "fibre"),
    "ap_flat_noflux_random": (dict(model="aliev_panfilov", beta=0.05,
                                   boundary="noflux", **FLAT), "random"),
    "fhn_torus_random_ramp": (dict(model="fhn", beta=1.25, vary_beta=1,
                                   beta_min=0.7, beta_max=1.7,
                                   t_boundary=0.4, **TORUS), "random"),
    "goldbeter_torus_const": (dict(model="goldbeter", beta=0.4, **TORUS),
                              "const"),
}
COMMON = dict(t_final=1.0, output_timestep=2, wave_length=0.25,
              wave_width=0.5, dtype="float64")
# (t, segment end): frozen, the frozen segment's end, released
TIMES = [(0.1, 0.4), (0.4, 0.4), (0.7, 1.0)]


def _problems(case, **over):
    kw, kind = RHS_CASES[case]
    kw = {**COMMON, **kw, **over}
    tensor = _tensor(kind)
    return (jproblem.build_problem(JSimConfig(**kw), diffusion_tensor=tensor),
            tproblem.build_problem(SimConfig(**kw), "cpu",
                                   diffusion_tensor=tensor))


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert np.max(np.abs(got - want)) <= 1e-13 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("case", sorted(RHS_CASES))
@pytest.mark.parametrize("state", ["ic", "random"])
def test_rhs_split_and_rho_match_jax(case, state):
    jp, tp = _problems(case)
    np.testing.assert_array_equal(tp.y0.numpy(), np.asarray(jp.y0))
    assert tp.diffusion_field is None and tp.face_mask is None
    for got, want in zip(tp.diffusion_tensor, jp.diffusion_tensor):
        np.testing.assert_array_equal(got, want)
    jsplit = jproblem.make_rhs(jp.cfg, jp.model, jp.geometry, jnp.float64,
                               split=True,
                               diffusion_tensor=jp.diffusion_tensor)
    tsplit = tproblem.make_rhs(tp.cfg, tp.model, tp.geometry, torch.float64,
                               "cpu", split=True,
                               diffusion_tensor=tp.diffusion_tensor)
    jrho = jproblem.make_rho_bound(jp.cfg, jp.model, jp.geometry,
                                   jnp.float64,
                                   diffusion_tensor=jp.diffusion_tensor)
    trho = tproblem.make_rho_bound(tp.cfg, tp.model, tp.geometry,
                                   torch.float64,
                                   diffusion_tensor=tp.diffusion_tensor)
    if state == "ic":
        y_np = np.asarray(jp.y0)
    else:
        y_np = np.random.default_rng(9).uniform(0.1, 1.2, np.shape(jp.y0))
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
    want = float(jrho(0.0, jnp.asarray(y_np), jp.params))
    np.testing.assert_allclose(float(trho(0.0, y_t, p_t)), want, rtol=1e-13)


def test_build_problem_validates_the_tensor():
    cfg = SimConfig(**{**COMMON, **FLAT, "model": "aliev_panfilov"})
    tensor = _tensor("const")
    with pytest.raises(ValueError, match="mutually exclusive"):
        tproblem.build_problem(cfg, "cpu", diffusion_tensor=tensor,
                               diffusion_field=0.5)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tproblem.build_problem(SimConfig(**{**COMMON, **TORUS,
                                            "model": "fhn",
                                            "coupling": "curvature"}),
                               "cpu", diffusion_tensor=tensor)
    with pytest.raises(ValueError, match=r"\(Dxx, Dyy, Dxy\)"):
        tproblem.build_problem(cfg, "cpu", diffusion_tensor=(1.0, 0.5))
    with pytest.raises(ValueError, match="obstacle_mask"):
        tproblem.build_problem(cfg, "cpu", diffusion_tensor=tensor,
                               obstacle_mask=np.ones((NY, NX), bool))
    with pytest.raises(ValueError, match="SPD"):
        tproblem.build_problem(cfg, "cpu", diffusion_tensor=(1.0, 0.25, 0.6))
    # the box takes the full 3x3 tensor
    with pytest.raises(ValueError, match=r"\(Dxx, Dyy, Dzz, Dxy, Dxz, Dyz\)"):
        tproblem.build_problem(
            dataclasses.replace(cfg, surface="box", z_mesh=4,
                                surface_depth=2.0),
            "cpu", diffusion_tensor=tensor)
    with pytest.raises(NotImplementedError, match="item 12"):
        tproblem.build_problem(dataclasses.replace(cfg, surface="sphere"),
                               "cpu", diffusion_tensor=tensor)
    # no-flux walls come from cfg.boundary, not from face masks
    p = tproblem.build_problem(dataclasses.replace(cfg, boundary="noflux"),
                               "cpu", diffusion_tensor=tensor)
    assert p.face_mask is None and p.diffusion_field is None


# a small fibered cardiac sheet: Aliev-Panfilov, flat 64x32, the rotating
# fibres
SHEET = dict(model="aliev_panfilov", surface="flat", x_mesh=32,
             surface_width=20, surface_length=40, diffusion=1.0, beta=0.05,
             wave_length=0.1, wave_width=0.2, t_final=2.0, output_timestep=2,
             dtype="float64", rtol=1e-7, atol=1e-11)


@pytest.mark.parametrize("method", ["bs32", "rkc2", "ark324"])
def test_fibered_sheet_driver_matches_jax(method):
    """The torch path on the fibered sheet against the JAX package's XLA
    path, f64, at tests/test_torch_divform.py's tolerances: identical
    accepted and rejected step sequences and trajectories within 1e-10."""
    kw = dict(SHEET, method=method)
    if method == "ark324":
        kw.update(t_final=1.0)       # its Newton stages cost ~10x a step
    tensor = fiber_tensor(64, 32)
    jp = jproblem.build_problem(JSimConfig(**kw), diffusion_tensor=tensor)
    want = jsimulate(JSimConfig(**kw), problem=jp)
    cfg = SimConfig(**kw)
    got = simulate(cfg, "cpu", problem=tproblem.build_problem(
        cfg, "cpu", diffusion_tensor=tensor))
    assert got.ok and want.ok and not got.fused
    for name in ("steps", "accepted", "rejected", "status"):
        np.testing.assert_array_equal(
            getattr(got.stats, name).numpy(),
            np.asarray(getattr(want.stats, name)), err_msg=name)
    np.testing.assert_allclose(got.trajectory.numpy(),
                               np.asarray(want.trajectory), rtol=0,
                               atol=1e-10)


def test_gates_route_tensors():
    """A tensor problem goes to K5 for the ERK methods on the flat surface
    and to the torch path for rkc2 and ark324; every other kernel declines
    it (crdmodel_tpu/sim.py:189-191, 226-227, 240-251)."""
    f32 = torch.float32
    kw = dict(SHEET, dtype="float32", use_pallas=True)
    tensor = fiber_tensor(64, 32)
    p = tproblem.build_problem(SimConfig(**kw), "cpu",
                               diffusion_tensor=tensor)
    for name in ("bs32", "dopri54"):
        tab = TABLEAUS[name]
        assert fa.is_aniso_supported(p, tab, f32)
        assert not fused_step.is_supported(p, tab, f32)
        assert not fused_divform.is_divform_supported(p, tab, f32)
    assert not fused_rkc.is_rkc_supported(p, f32)
    assert not fused_imex.is_imex_supported(p, f32)
    assert fused_eligible(p)
    for method in ("rkc2", "ark324"):
        cfg = SimConfig(**{**kw, "method": method})
        assert not fused_eligible(tproblem.build_problem(
            cfg, "cpu", diffusion_tensor=tensor))
    # K5's refusals: f64, the torus (its inv4 is a profile), forcing,
    # kinetics without a device function's shape
    tab = TABLEAUS["bs32"]
    assert not fa.is_aniso_supported(p, tab, torch.float64)
    assert not fa.is_aniso_supported(dataclasses.replace(p, forcing=object()),
                                     tab, f32)
    two_diffusing = dataclasses.replace(p, model=dataclasses.replace(
        p.model, diffusive_vars=(0, 1), diffusion_ratios=(1.0, 1.0)))
    assert not fa.is_aniso_supported(two_diffusing, tab, f32)
    torus = tproblem.build_problem(
        SimConfig(**{**COMMON, **TORUS, "model": "fhn", "dtype": "float32",
                     "use_pallas": True}), "cpu",
        diffusion_tensor=_tensor("random"))
    assert not fa.is_aniso_supported(torus, tab, f32)
    assert not fused_step.is_supported(torus, tab, f32)
    assert not fused_eligible(torus)
    # without a tensor K5 declines
    plain = tproblem.build_problem(SimConfig(**kw), "cpu")
    assert not fa.is_aniso_supported(plain, tab, f32)


def test_fused_simulate_takes_plain_k5(monkeypatch):
    """simulate() with use_pallas=True on the CPU runs K5's plain version
    at every step; f32, within f32 rounding of the torch path, which
    rounds the mixed terms in another order (ROADMAP queue 3)."""
    from crdmodel_tpu_torch import integrate
    from crdmodel_tpu_torch.integrate.erk import SYNC_EVERY, merge_stops
    from crdmodel_tpu_torch.sim import output_times

    kw = dict(SHEET, dtype="float32", rtol=1e-4, atol=1e-7, t_final=1.0,
              use_pallas=True)
    tensor = fiber_tensor(64, 32)
    calls = {"plain_k5": 0}
    plain = fa.fused_aniso_step_reference

    def counted(*args, **kwargs):
        calls["plain_k5"] += 1
        return plain(*args, **kwargs)

    def no_torch_path(*args, **kwargs):
        raise AssertionError("the fused run built the torch-path stepper")

    cfg = SimConfig(**kw)
    with monkeypatch.context() as m:
        m.setattr(fa, "fused_aniso_step_reference", counted)
        m.setattr(integrate.erk, "make_default_step_err", no_torch_path)
        res = simulate(cfg, "cpu", problem=tproblem.build_problem(
            cfg, "cpu", diffusion_tensor=tensor))
    cfg_t = dataclasses.replace(cfg, use_pallas=False)
    ref = simulate(cfg_t, "cpu", problem=tproblem.build_problem(
        cfg_t, "cpu", diffusion_tensor=tensor))
    assert res.fused and res.ok and not ref.fused
    n_stops = len(merge_stops(output_times(cfg), ())[0])
    assert (res.total_steps() <= calls["plain_k5"]
            <= res.total_steps() + SYNC_EVERY * n_stops)
    gap = np.abs(res.stats.steps.numpy() - ref.stats.steps.numpy())
    assert gap.max() <= 1
    np.testing.assert_allclose(res.trajectory.numpy(),
                               ref.trajectory.numpy(), rtol=0, atol=1e-5)
