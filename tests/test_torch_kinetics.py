"""The six kinetics families beyond the base three on the port's torch
path (crdmodel_tpu_torch/models/barkley.py, oregonator.py, grayscott.py,
brusselator.py, lambdaomega.py, sir.py), against the JAX package on the
CPU in f64: the kinetics, jac_bound and steady states at numpy-seeded
states with a scalar beta and a beta field, the port-only closed-form
Jacobians against jax.jacfwd of the JAX kinetics, the initial states on
the flat surface, the torus and the box, and the composed RHS, each to
1e-13; the registry; the kernel gates (K1, K2's profile branch and K3
take the six families unforced; every other kernel, K2's divergence
branch and a forced run decline them). And the port's FitzHugh–Nagumo and
Goldbeter RHS against the C++ transcription of the reference's f()
(tests/ref_oracle) at the canonical configs of data/*.ini.
"""

import numpy as np
import pytest
import torch

from crdmodel_tpu_torch.config import SimConfig, config_from_ini
from crdmodel_tpu_torch.core.problem import build_problem
from crdmodel_tpu_torch.models import get_model
from crdmodel_tpu_torch.ops.kernel_common import (ALL_FAMILIES,
                                                  KINETICS_IDS,
                                                  NEW_FAMILIES,
                                                  kernel_ready_kinetics)

FAMILIES = sorted(NEW_FAMILIES)
BETAS = {"barkley": 0.05, "oregonator": 1.5, "grayscott": 0.03,
         "brusselator": 1.9, "lambdaomega": 0.5, "sir": 1.5}
# a state range each family's runs visit (variable by variable)
RANGES = {"barkley": ((0.0, 0.0), (1.0, 0.6)),
          "oregonator": ((0.002, 0.0), (0.9, 0.6)),
          "grayscott": ((0.2, 0.0), (1.0, 0.5)),
          "brusselator": ((0.5, 1.0), (1.5, 2.5)),
          "lambdaomega": ((-1.0, -1.0), (1.0, 1.0)),
          "sir": ((0.5, 0.0, 0.0), (1.0, 0.5, 0.5))}
BASE = dict(x_mesh=16, surface_width=20, surface_length=40, t_final=1.0,
            output_timestep=2, wave_length=0.1, wave_width=0.5,
            dtype="float64", rtol=1e-7, atol=1e-11)


def _state(model, shape, seed=7):
    rng = np.random.default_rng(seed)
    lo, hi = RANGES[model]
    return np.stack([rng.uniform(a, b, shape) for a, b in zip(lo, hi)])


def _close(got, want, tol=1e-13):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.max(np.abs(want))))
    assert float(np.max(np.abs(got - want))) <= tol * scale


def test_registry_holds_all_nine_families():
    from crdmodel_tpu.models.base import get_model as jget_model
    for name in ALL_FAMILIES:
        model, jmodel = get_model(name), jget_model(name)
        assert model.name == name and name in KINETICS_IDS
        for field in ("nvars", "var_names", "diffusive_vars",
                      "diffusion_ratios"):
            assert getattr(model, field) == getattr(jmodel, field), field
        assert model.jacobian is not None and model.jac_bound is not None
    with pytest.raises(KeyError):
        get_model("nope")


@pytest.mark.parametrize("model", FAMILIES)
def test_kinetics_match_jax(model):
    """kinetics, jac_bound and steady_state at a numpy-seeded state, with
    a scalar beta and with a (ny, 1) beta field, to 1e-13."""
    import jax.numpy as jnp

    from crdmodel_tpu.models.base import get_model as jget_model
    tm, jm = get_model(model), jget_model(model)
    y = _state(model, (12, 10))
    b_field = BETAS[model] * (1.0 + 0.2 * np.linspace(-1, 1, 12)[:, None])
    for b in (np.float64(BETAS[model]), b_field):
        yt, bt = torch.tensor(y), torch.tensor(b)
        _close(tm.kinetics(yt, bt), jm.kinetics(jnp.asarray(y),
                                                jnp.asarray(b)))
        _close(tm.jac_bound(yt, bt), jm.jac_bound(jnp.asarray(y),
                                                  jnp.asarray(b)))
    for beta in (BETAS[model], 0.5 * BETAS[model]):
        np.testing.assert_allclose(tm.steady_state(beta),
                                   jm.steady_state(beta), rtol=1e-15)


@pytest.mark.parametrize("model", FAMILIES)
def test_jacobian_matches_jacfwd(model):
    """The closed-form Jacobian (ReactionModel.jacobian, which K3 and its
    plain version evaluate) against jax.jacfwd of the JAX kinetics at each
    point, to 1e-13."""
    import jax
    import jax.numpy as jnp

    from crdmodel_tpu.models.base import get_model as jget_model
    jm = jget_model(model)
    y = _state(model, (64,), seed=3)
    b = BETAS[model]
    want = jax.vmap(jax.jacfwd(lambda p: jm.kinetics(p, b)),
                    in_axes=1, out_axes=2)(jnp.asarray(y))
    got = get_model(model).jacobian(torch.tensor(y),
                                    torch.tensor(b, dtype=torch.float64))
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


def _problems(kw):
    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild_problem
    return (jbuild_problem(JSimConfig(**kw)),
            build_problem(SimConfig(**kw), device="cpu"))


@pytest.mark.parametrize("surface", ["flat", "torus", "box"])
@pytest.mark.parametrize("model", FAMILIES)
def test_initial_state_and_rhs_match_jax(model, surface):
    """initial_state (the box's the extruded 2-D seed) bitwise, and the
    composed RHS at a numpy-seeded state to 1e-13."""
    import jax.numpy as jnp
    kw = dict(BASE, model=model, surface=surface, beta=BETAS[model],
              t_boundary=0.4)
    if surface == "box":
        kw.update(z_mesh=4, surface_depth=2.0)
    jp, tp = _problems(kw)
    np.testing.assert_array_equal(tp.y0.numpy(), np.asarray(jp.y0))
    assert tp.steady_state == tuple(jp.steady_state)
    y = _state(model, np.shape(jp.y0)[1:], seed=5)
    for t in (0.0, 0.5):
        want = jp.rhs(jnp.float64(t), jnp.asarray(y), jp.params)
        got = tp.rhs(torch.tensor(t, dtype=torch.float64), torch.tensor(y),
                     tp.params)
        _close(got, want)


def _gate_problems(model, **build):
    """(cfg, problem) of `model` on the flat surface with a scalar beta,
    f32, where the gates' other rules pass."""
    cfg = SimConfig(**dict(BASE, model=model, surface="flat",
                           beta=BETAS.get(model, 1.25), dtype="float32",
                           rtol=1e-5, atol=1e-8))
    return build_problem(cfg, device="cpu", **build)


@pytest.mark.parametrize("model", FAMILIES + ["fhn"])
def test_kernel_gates(model):
    """K1, K2's profile branch, K3, K8, K9 and K10 take the new families
    unforced; K4, K5, K6, K7, K11, K14 and K2's divergence branch decline
    them (each gate's other rules met, as the FitzHugh–Nagumo case shows:
    it passes all); with a structured forcing K1, K2, K3, K8, K9 and K10
    decline them too."""
    import dataclasses

    from crdmodel_tpu_torch.core.forcing import (SeparableForcing,
                                                 Stimulus, pulse_train)
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import (fused_aniso, fused_box3d,
                                        fused_box3d_rkc, fused_divform,
                                        fused_imex, fused_kstep, fused_rkc,
                                        fused_shard_divform,
                                        fused_shard_imex, fused_shard_rkc,
                                        fused_shard_step, fused_step)
    f32, bs32 = torch.float32, TABLEAUS["bs32"]
    new = model in NEW_FAMILIES
    flat = _gate_problems(model)
    assert fused_step.is_supported(flat, bs32, f32)
    assert fused_step.is_supported(flat, TABLEAUS["dopri54"], f32)
    assert fused_rkc.is_rkc_supported(flat, f32)
    assert fused_imex.is_imex_supported(flat, f32)
    assert fused_kstep.is_kstep_supported(flat, bs32, f32, 2) != new
    assert fused_shard_step.is_shard_supported(flat, bs32, f32, 64, 64)
    for gate in (fused_shard_rkc.is_shard_rkc_supported,
                 fused_shard_imex.is_shard_imex_supported):
        assert gate(flat, f32, 64, 64)
    walls = build_problem(dataclasses.replace(flat.cfg, boundary="noflux"),
                          device="cpu")
    assert fused_divform.is_divform_supported(walls, bs32, f32) != new
    assert fused_shard_divform.is_shard_divform_supported(
        walls, bs32, f32, 64, 64) != new
    assert fused_rkc.is_rkc_supported(walls, f32) != new
    tensor = _gate_problems(model, diffusion_tensor=(1.0, 0.5, 0.1))
    assert fused_aniso.is_aniso_supported(tensor, bs32, f32) != new
    box = build_problem(dataclasses.replace(flat.cfg, surface="box",
                                            z_mesh=4, surface_depth=2.0,
                                            boundary="noflux"),
                        device="cpu")
    assert fused_box3d.is_box3d_supported(box, bs32, f32) != new
    assert fused_box3d_rkc.is_box3d_rkc_supported(box, f32) != new
    forcing = SeparableForcing(Stimulus(
        waveform=pulse_train([0.1], 0.2, 1.0),
        row=np.ones(flat.cfg.ny)))
    forced = _gate_problems(model, forcing=forcing)
    assert fused_step.is_supported(forced, bs32, f32) != new
    assert fused_rkc.is_rkc_supported(forced, f32) != new
    assert fused_imex.is_imex_supported(forced, f32) != new
    assert fused_shard_step.is_shard_supported(forced, bs32, f32, 64,
                                               64) != new
    for gate in (fused_shard_rkc.is_shard_rkc_supported,
                 fused_shard_imex.is_shard_imex_supported):
        assert gate(forced, f32, 64, 64) != new


def test_gate_holds_the_model_to_its_trait():
    """A model registered under a family's name with another shape than
    its device code's trait is declined."""
    import dataclasses
    problem = _gate_problems("grayscott")
    assert kernel_ready_kinetics(problem, ALL_FAMILIES)
    other = dataclasses.replace(problem.model, diffusion_ratios=(1.0, 0.25))
    assert not kernel_ready_kinetics(
        dataclasses.replace(problem, model=other), ALL_FAMILIES)
    assert not kernel_ready_kinetics(problem)   # the base families' rule


@pytest.mark.parametrize("surface", ["torus", "flat"])
@pytest.mark.parametrize("model,ini", [("fhn", "data/FHNmodelArgs.ini"),
                                       ("goldbeter",
                                        "data/GoldbeterModelArgs.ini")])
def test_rhs_matches_reference_oracle(model, ini, surface):
    """The port's FitzHugh–Nagumo and Goldbeter RHS against the C++
    transcription of the reference's four f() routines
    (tests/ref_oracle/refrhs.cpp), at the canonical configs of the repo's
    data/*.ini cut to x_mesh=16, on their ICs at t = 0 and Tf (frozen and
    released edge rows) and at a random state, per variable to 2e-13 of
    its scale, as tests/test_reference_rhs.py::_compare holds the JAX
    package's."""
    import os

    from tests.ref_oracle import load_refrhs, reference_rhs
    if load_refrhs() is None:
        pytest.skip("g++ unavailable; oracle not built")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = config_from_ini(os.path.join(root, ini), model=model,
                          surface=surface, x_mesh=16, dtype="float64",
                          t_boundary=0.5)
    problem = build_problem(cfg, device="cpu")
    rng = np.random.default_rng(2)
    states = [problem.y0.numpy(),
              rng.uniform(0.05, 3.0, problem.y0.shape) if model == "goldbeter"
              else rng.uniform(-2.5, 2.5, problem.y0.shape)]
    for state in states:
        for t in (0.0, cfg.t_final):
            got = problem.rhs(torch.tensor(t, dtype=torch.float64),
                              torch.tensor(state), problem.params).numpy()
            want = reference_rhs(cfg, t, state)
            for v in range(2):
                scale = np.max(np.abs(want[v])) + 1e-30
                np.testing.assert_allclose(got[v] / scale, want[v] / scale,
                                           rtol=0, atol=2e-13)
