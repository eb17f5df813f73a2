"""Whole runs of the six kinetics families beyond the base three on the
port's torch path (f64, CPU) against the JAX package's runs of the same
configs (f64, CPU): the twelve golden fixtures of tests/test_golden.py
(each family flat and torus) reproduced with bs32, and the step
statistics (steps, accepted, rejected, status a stop) equal to
crdmodel_tpu.sim.simulate's with bs32 and rkc2, the trajectories to 1e-10;
ark324's in tests/test_torch_kinetics_imex.py."""

import os

import numpy as np
import pytest

from crdmodel_tpu.config import SimConfig as JSimConfig
from crdmodel_tpu.sim import simulate as jsimulate
from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.sim import simulate

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
# tests/test_golden.py's CASES and BASE of the six families
PHYSICS = {
    "barkley": dict(beta=0.05, diffusion=1.0),
    "grayscott": dict(beta=0.03, diffusion=2e-5, t_final=20.0),
    "oregonator": dict(beta=1.5, diffusion=1.0),
    "brusselator": dict(beta=1.9, diffusion=0.2),
    "sir": dict(beta=1.5, diffusion=1.0),
    "lambdaomega": dict(beta=0.5, diffusion=0.5),
}
CASES = {f"{m}_{s}": dict(PHYSICS[m], model=m, surface=s)
         for m in PHYSICS for s in ("flat", "torus")}
BASE = dict(x_mesh=16, surface_width=20, surface_length=40,
            t_final=1.0, output_timestep=2, wave_length=0.1, wave_width=0.5,
            dtype="float64", rtol=1e-7, atol=1e-11)


def assert_same_run(kw):
    """The port's torch-path run of kw and the JAX package's: equal step
    statistics and stops, trajectories to 1e-10. Returns the port's."""
    got = simulate(SimConfig(**kw), device="cpu")
    want = jsimulate(JSimConfig(**kw))
    assert got.ok and want.ok and not got.fused
    for name in ("steps", "accepted", "rejected", "status"):
        np.testing.assert_array_equal(
            getattr(got.stats, name).numpy(),
            np.asarray(getattr(want.stats, name)), err_msg=name)
    np.testing.assert_array_equal(got.touts, want.touts)
    np.testing.assert_allclose(got.trajectory.numpy(),
                               np.asarray(want.trajectory), rtol=0,
                               atol=1e-10)
    return got


@pytest.mark.parametrize("case", sorted(CASES))
def test_golden_fixture_and_bs32_run(case):
    """The fixture (tests/golden/<case>.npz, the JAX package's bs32 run)
    within tests/test_golden.py's tolerance, and the run equal to JAX's."""
    got = assert_same_run({**BASE, **CASES[case]})
    with np.load(os.path.join(GOLDEN_DIR, f"{case}.npz")) as z:
        want = z["trajectory"]
    np.testing.assert_allclose(got.trajectory.numpy(), want, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_rkc2_run_matches_jax(case):
    assert_same_run({**BASE, **CASES[case], "method": "rkc2"})
