"""ark324 runs of the six kinetics families beyond the base three on the
port's torch path (f64, CPU; the Newton's Jacobian by forward-mode AD, as
the JAX package's XLA path takes it) against the JAX package's runs of the
same configs: step statistics (steps, accepted, rejected, status a stop)
equal, trajectories to 1e-10, on tests/test_golden.py's twelve cases. The
Oregonator's takes some 2000 stiff steps a unit of time, each a few ms on
the torch path's CPU Newton, so its cases run to Tf = 0.1."""

import pytest

from test_torch_kinetics_runs import BASE, CASES, assert_same_run

HORIZON = {"oregonator_flat": 0.1, "oregonator_torus": 0.1}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ark324_run_matches_jax(case):
    kw = {**BASE, **CASES[case], "method": "ark324"}
    if case in HORIZON:
        kw["t_final"] = HORIZON[case]
    assert_same_run(kw)
