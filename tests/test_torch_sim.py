"""simulate() through the fused path on the CPU (use_pallas=True runs the
kernel's plain version) against the JAX package's fused run in interpret
mode, f32, on a small torus; the same step-count and trajectory limits as
tests/test_forcing.py::TestFusedForcing."""

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


@pytest.mark.parametrize("use_pallas,fused", [(None, False), (False, False)])
def test_selection_on_cpu(use_pallas, fused):
    """Auto mode takes the kernel only on CUDA; False forces the torch path."""
    res = simulate(SimConfig(**{**CFG, "use_pallas": use_pallas}),
                   device="cpu")
    assert res.fused == fused and res.ok
