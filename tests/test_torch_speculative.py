"""Speculative K-step batching on the torch path and ARK_NORMAL stepping
(crdmodel_tpu_torch/integrate/erk.py::integrate_interval_batched,
integrate_interval_free, hermite_interpolate and integrate_to_outputs'
branches), held against the JAX package in float64 on the CPU: the same
per-interval steps, accepted and rejected steps and status, and
trajectories within 1e-12, on the configurations of
tests/test_speculative.py and tests/test_stepmode.py's kind.
"""

import dataclasses

import numpy as np
import pytest
import torch

from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.core.problem import build_problem
from crdmodel_tpu_torch.integrate.erk import (hermite_interpolate,
                                              integrate_to_outputs)
from crdmodel_tpu_torch.parallel.mesh import make_mesh
from crdmodel_tpu_torch.parallel.sharded import simulate_sharded
from crdmodel_tpu_torch.sim import output_times, simulate

# tests/test_speculative.py::_cfg and its Goldbeter flat case
FHN = dict(model="fhn", surface="torus", x_mesh=16, surface_width=20,
           surface_length=40, beta=1.25, t_final=2.0, output_timestep=2,
           t_boundary=0.7, dtype="float64", rtol=1e-6, atol=1e-10)
GB_FLAT = dict(model="goldbeter", surface="flat", x_mesh=12,
               surface_width=20, surface_length=40, beta=0.85, t_final=1.0,
               output_timestep=2, dtype="float64", rtol=1e-6, atol=1e-10)
TRAJ_TOL = 1e-12


def _jax_run(kw):
    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.sim import simulate as jsimulate
    return jsimulate(JSimConfig(**kw))


def _assert_same_run(kw):
    """The port's torch-path run of kw against JAX's: per-interval stats
    equal, trajectories within TRAJ_TOL."""
    jres = _jax_run(kw)
    res = simulate(SimConfig(**kw), device="cpu")
    for field in ("steps", "accepted", "rejected", "status"):
        assert getattr(res.stats, field).tolist() == \
            np.asarray(getattr(jres.stats, field)).tolist(), field
    err = float(np.max(np.abs(res.trajectory.numpy()
                              - np.asarray(jres.trajectory))))
    assert err <= TRAJ_TOL, err
    return res


@pytest.mark.parametrize("k", [2, 4, 8])
def test_batched_fhn_torus_matches_jax(k):
    res = _assert_same_run(dict(FHN, speculative_k=k))
    assert res.ok and not res.fused


def test_batched_goldbeter_flat_matches_jax():
    assert _assert_same_run(dict(GB_FLAT, speculative_k=4)).ok


def test_batched_sticky_failure_matches_jax():
    """max_steps=3: the batch loop stops at the budget, the tail takes its
    own budget and fails; the failure sticks to every later interval."""
    res = _assert_same_run(dict(FHN, speculative_k=4, max_steps=3))
    status = res.stats.status.numpy()
    assert not res.ok
    first_bad = int(np.argmax(status != 0))
    assert np.all(status[first_bad:] != 0)


def test_batched_ark324_matches_jax():
    """ark324 on the torch path batches its own steps (the IMEX stepper's
    empty carry), as JAX's XLA-side speculation does."""
    _assert_same_run(dict(FHN, method="ark324", speculative_k=3))


@pytest.mark.parametrize("output_timestep", [2, 40])
def test_normal_fhn_torus_matches_jax(output_timestep):
    """ARK_NORMAL with the freeze breakpoint (t = 0.7) inside the run: a
    non-output stop with 2 outputs, an output on the breakpoint with 40,
    where late steps cross two outputs (intervals of no step)."""
    res = _assert_same_run(dict(FHN, step_mode="normal",
                                output_timestep=output_timestep))
    assert res.ok
    if output_timestep == 40:
        steps = res.stats.steps.numpy()
        assert np.any(steps == 0) and np.any(steps[:14] > 0)


@pytest.mark.parametrize("method", ["bs32", "dopri54", "rkc2", "ark324"])
def test_normal_methods_match_jax(method):
    """ARK_NORMAL on every integrator family of the torch path."""
    _assert_same_run(dict(FHN, method=method, step_mode="normal",
                          output_timestep=5))


def test_normal_goldbeter_flat_matches_jax():
    _assert_same_run(dict(GB_FLAT, step_mode="normal", output_timestep=4))


def test_normal_through_fused_kernels():
    """ARK_NORMAL through the plain K1, K2 and K3 on the CPU: status ok,
    within the integrator's tolerance of the torch path's f64 run."""
    kw = dict(FHN, dtype="float32", rtol=1e-5, atol=1e-8, step_mode="normal",
              output_timestep=5, use_pallas=True)
    for method in ("bs32", "rkc2", "ark324"):
        res = simulate(SimConfig(**dict(kw, method=method)), device="cpu")
        ref = simulate(SimConfig(**dict(kw, method=method, dtype="float64",
                                        use_pallas=False)), device="cpu")
        assert res.ok and res.fused, method
        err = float((res.trajectory.double() - ref.trajectory).abs().max())
        assert err <= 1e-3, (method, err)


def test_hermite_degenerate_bracket():
    """A degenerate bracket (t_hi == t_lo, a clamped stop) or one ending
    before tout gives y_hi; inside it the cubic Hermite matches the
    endpoints and a cubic exactly."""
    def rhs(t, y, params):
        return 3.0 * t * t * torch.ones_like(y)      # y = t^3

    y = lambda t: t ** 3 * torch.ones(2, 3, 4, dtype=torch.float64)  # noqa
    t = lambda v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
    y_hi = y(t(0.5))
    for t_lo, t_hi, tout in ((0.5, 0.5, 0.5), (0.2, 0.4, 0.5)):
        out = hermite_interpolate(rhs, t(t_lo), y(t(t_lo)), t(t_hi), y_hi,
                                  t(tout), {})
        assert torch.equal(out, y_hi)
    out = hermite_interpolate(rhs, t(0.1), y(t(0.1)), t(0.9), y(t(0.9)),
                              t(0.35), {})
    assert float((out - y(t(0.35))).abs().max()) <= 1e-15
    for tout in (0.1, 0.9):
        out = hermite_interpolate(rhs, t(0.1), y(t(0.1)), t(0.9), y(t(0.9)),
                                  t(tout), {})
        assert float((out - y(t(tout))).abs().max()) <= 1e-16


def test_normal_rejects_speculation():
    """step_mode='normal' with speculative batching raises ValueError, as
    in the JAX package; an unknown step mode too."""
    problem = build_problem(SimConfig(**FHN), "cpu")
    args = (problem.rhs, problem.y0, problem.params, 0.0,
            output_times(problem.cfg))
    with pytest.raises(ValueError, match="normal"):
        integrate_to_outputs(*args, rtol=1e-6, atol=1e-10,
                             step_mode="normal", spec_k=4)
    with pytest.raises(ValueError, match="normal"):
        integrate_to_outputs(*args, rtol=1e-6, atol=1e-10,
                             step_mode="normal", kstep_call=lambda *a: a)
    with pytest.raises(ValueError, match="step_mode"):
        integrate_to_outputs(*args, rtol=1e-6, atol=1e-10,
                             step_mode="free")
    for name in ("n_members", "sync_fn"):
        with pytest.raises(NotImplementedError, match="item 14"):
            integrate_to_outputs(*args, rtol=1e-6, atol=1e-10,
                                 **{name: 2 if name == "n_members"
                                    else (lambda go: go)})


def test_normal_with_speculative_k_steps_per_step():
    """sim.make_run_fn never batches ARK_NORMAL: speculative_k is ignored
    there, as in the JAX package (crdmodel_tpu/sim.py:296)."""
    res = simulate(SimConfig(**dict(FHN, step_mode="normal",
                                    speculative_k=4)), device="cpu")
    ref = simulate(SimConfig(**dict(FHN, step_mode="normal")), device="cpu")
    assert res.stats.steps.tolist() == ref.stats.steps.tolist()
    assert torch.equal(res.trajectory, ref.trajectory)


def test_sharded_normal_not_ported():
    """simulate_sharded takes no ARK_NORMAL yet (ROADMAP queue 1, item 15)
    and ignores speculative_k, as JAX's sharded driver does."""
    cfg = SimConfig(**dict(FHN, step_mode="normal"))
    mesh = make_mesh(shape=(2, 2), devices=["cpu"] * 4)
    with pytest.raises(NotImplementedError, match="item 15"):
        simulate_sharded(cfg, mesh=mesh)
    spec = simulate_sharded(dataclasses.replace(cfg, step_mode="tstop",
                                                speculative_k=4), mesh=mesh)
    per_step = simulate(dataclasses.replace(cfg, step_mode="tstop"),
                        device="cpu")
    assert spec.stats.steps.tolist() == per_step.stats.steps.tolist()
