"""simulate() through the fused path on the CPU (use_pallas=True runs the
kernel's plain version) against the JAX package's fused run in interpret
mode, f32, on a small torus; the same step-count and trajectory limits as
tests/test_forcing.py::TestFusedForcing. The Goldbeter torus through K1
too, with its trajectory held to the JAX package's own f32 spread."""

import jax
import numpy as np
import pytest

import crdmodel_tpu_torch.ops.fused_step as fs
from crdmodel_tpu.config import SimConfig as JSimConfig
from crdmodel_tpu.core.problem import build_problem as jbuild_problem
from crdmodel_tpu.sim import make_run_fn
from crdmodel_tpu_torch import integrate
from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.sim import simulate

CFG = dict(model="fhn", surface="torus", x_mesh=16, surface_width=20,
           surface_length=40, beta=1.25, vary_beta=1, beta_min=0.7,
           beta_max=1.7, t_boundary=0.4, t_final=1.0, output_timestep=5,
           dtype="float32", rtol=1e-4, atol=1e-6, use_pallas=True)


def test_fused_simulate_matches_jax_fused(monkeypatch):
    jp = jbuild_problem(JSimConfig(**CFG))
    tj, sj = jax.jit(make_run_fn(jp, interpret=True)[0])(jp.y0, jp.params)

    calls = {"plain_k1": 0}
    plain = fs.fused_step_reference

    def counted(*args, **kw):
        calls["plain_k1"] += 1
        return plain(*args, **kw)

    def no_torch_path(*args, **kw):
        raise AssertionError("the fused run built the torch-path stepper")

    monkeypatch.setattr(fs, "fused_step_reference", counted)
    monkeypatch.setattr(integrate.erk, "make_default_step_err", no_torch_path)
    res = simulate(SimConfig(**CFG), device="cpu")

    assert res.fused and res.ok
    assert calls["plain_k1"] >= res.total_steps()
    gap = np.abs(res.stats.steps.numpy() - np.asarray(sj.steps))
    assert gap.max() <= 1 and gap.sum() <= 2
    np.testing.assert_allclose(res.trajectory[1:].numpy(), np.asarray(tj),
                               rtol=0, atol=1e-3)
    np.testing.assert_array_equal(res.trajectory[0].numpy(),
                                  np.asarray(jp.y0))


# the Goldbeter torus of data/GoldbeterModelArgs.ini (beta 0.4, wave
# segment inside) at x_mesh=16, with a freeze
GB_CFG = dict(CFG, model="goldbeter", beta=0.4, vary_beta=0, wave_inside=1,
              wave_length=0.2, wave_width=0.5)


def test_fused_goldbeter_simulate_matches_jax_fused(monkeypatch):
    """Goldbeter bs32 through the plain K1 against the JAX package's fused
    run in interpret mode: the steps within the limits above, and the
    trajectory within 2x the JAX fused run's distance to its f64 run, plus
    1e-4, of the f64 run (chip_smoke.py's probe limit). The wave front
    amplifies f32 rounding: the JAX fused and f64 runs differ by ~1e-3."""
    from crdmodel_tpu.sim import simulate as jsimulate

    jp = jbuild_problem(JSimConfig(**GB_CFG))
    tj, sj = jax.jit(make_run_fn(jp, interpret=True)[0])(jp.y0, jp.params)
    j64 = np.asarray(jsimulate(JSimConfig(**{
        **GB_CFG, "dtype": "float64", "use_pallas": False})).trajectory[1:])

    def no_torch_path(*args, **kw):
        raise AssertionError("the fused run built the torch-path stepper")

    monkeypatch.setattr(integrate.erk, "make_default_step_err", no_torch_path)
    res = simulate(SimConfig(**GB_CFG), device="cpu")

    assert res.fused and res.ok
    gap = np.abs(res.stats.steps.numpy() - np.asarray(sj.steps))
    assert gap.max() <= 1 and gap.sum() <= 2
    limit = 2.0 * np.abs(np.asarray(tj) - j64).max() + 1e-4
    assert np.abs(res.trajectory[1:].numpy() - j64).max() <= limit


@pytest.mark.parametrize("use_pallas,fused", [(None, False), (False, False)])
def test_selection_on_cpu(use_pallas, fused):
    """Auto mode takes the kernel only on CUDA; False forces the torch path."""
    res = simulate(SimConfig(**{**CFG, "use_pallas": use_pallas}),
                   device="cpu")
    assert res.fused == fused and res.ok
