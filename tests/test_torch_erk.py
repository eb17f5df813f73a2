"""The port's adaptive ERK driver on the torch path (f64, CPU) against the
JAX package's run of the same config (f64, CPU), on the FitzHugh–Nagumo,
Goldbeter and Aliev–Panfilov cases of tests/test_golden.py, and against
their stored fixtures."""

import os

import numpy as np
import pytest
import torch

from crdmodel_tpu.config import SimConfig as JSimConfig
from crdmodel_tpu.sim import simulate as jsimulate
from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.integrate.erk import merge_stops
from crdmodel_tpu_torch.sim import simulate

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
# tests/test_golden.py CASES and BASE for the FHN, Goldbeter and
# Aliev–Panfilov cases
CASES = {
    "fhn_flat": dict(model="fhn", surface="flat", beta=1.25, t_boundary=0.4),
    "fhn_torus": dict(model="fhn", surface="torus", beta=1.25, vary_beta=1,
                      beta_min=0.7, beta_max=1.7, t_boundary=0.4),
    "goldbeter_flat": dict(model="goldbeter", surface="flat", beta=0.85),
    "goldbeter_torus": dict(model="goldbeter", surface="torus", beta=0.4,
                            wave_inside=1),
    "aliev_panfilov_flat": dict(model="aliev_panfilov", surface="flat",
                                beta=0.15, diffusion=1.0),
    "aliev_panfilov_torus": dict(model="aliev_panfilov", surface="torus",
                                 beta=0.15, diffusion=1.0),
}
BASE = dict(x_mesh=16, surface_width=20, surface_length=40,
            t_final=1.0, output_timestep=2, wave_length=0.1, wave_width=0.5,
            dtype="float64", rtol=1e-7, atol=1e-11)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("method", ["bs32", "dopri54"])
def test_torch_path_matches_jax(case, method):
    kw = {**BASE, **CASES[case], "method": method}
    got = simulate(SimConfig(**kw), device="cpu")
    want = jsimulate(JSimConfig(**kw))
    assert got.ok and want.ok and not got.fused
    for name in ("steps", "accepted", "rejected", "status"):
        np.testing.assert_array_equal(
            getattr(got.stats, name).numpy(),
            np.asarray(getattr(want.stats, name)), err_msg=name)
    np.testing.assert_array_equal(got.touts, want.touts)
    np.testing.assert_allclose(got.trajectory.numpy(),
                               np.asarray(want.trajectory), rtol=0, atol=1e-10)


@pytest.mark.parametrize("case", sorted(CASES))
def test_golden_fixture(case):
    with np.load(os.path.join(GOLDEN_DIR, f"{case}.npz")) as z:
        want = z["trajectory"]
    got = simulate(SimConfig(**{**BASE, **CASES[case]}), device="cpu")
    assert got.ok
    np.testing.assert_allclose(got.trajectory.numpy(), want,
                               rtol=1e-5, atol=1e-6)


def test_sticky_status_and_max_steps():
    """max_steps exhaustion sets status 1 on its interval, and the failure
    sticks: later intervals take no steps."""
    cfg = SimConfig(**{**BASE, **CASES["fhn_torus"], "max_steps": 3,
                       "output_timestep": 3})
    res = simulate(cfg, device="cpu")
    np.testing.assert_array_equal(res.stats.status.numpy(), [1, 1, 1])
    np.testing.assert_array_equal(res.stats.steps.numpy(), [3, 0, 0])
    assert not res.ok


def test_merge_stops():
    stops, is_out = merge_stops([0.5, 1.0], [0.4, 1.0, 0.0])
    np.testing.assert_array_equal(stops, [0.4, 0.5, 1.0])
    np.testing.assert_array_equal(is_out, [False, True, True])


def test_sync_block_changes_nothing():
    """Iterations past the end of an interval are no-ops: the result does
    not depend on how often the host reads the loop condition."""
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.integrate.erk import integrate_to_outputs
    from crdmodel_tpu_torch.sim import output_times
    cfg = SimConfig(**{**BASE, **CASES["fhn_torus"]})
    p = build_problem(cfg, device="cpu")
    runs = [integrate_to_outputs(p.rhs, p.y0, p.params, 0.0,
                                 output_times(cfg), rtol=cfg.rtol,
                                 atol=cfg.atol, breakpoints=(0.4,),
                                 sync_every=n) for n in (1, 5)]
    (t1, s1), (t5, s5) = runs
    assert torch.equal(t1, t5)
    for a, b in zip(s1, s5):
        assert torch.equal(a, b)
