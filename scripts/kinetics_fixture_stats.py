"""Record the port's torch-path step statistics of the six other kinetics
families' golden fixtures.

    python scripts/kinetics_fixture_stats.py

Runs tests/test_golden.py's twelve cases of barkley, grayscott,
oregonator, brusselator, sir and lambdaomega (flat and torus; f64) with
bs32, rkc2 (K2's h cap: the coverage of S_MAX_KERNEL stages, as the fused
path takes it) and ark324 through the port's torch path on the CPU, and
writes each run's steps, accepted, rejected and status a stop to
tests/golden/torch_kinetics_fixture_stats.npz under "<case>/<method>/
<field>". chip_smoke.py's kinetics_fixtures phase holds the kernel runs
of the same configs on the card to them. The torch path takes the JAX
package's step sequences on these configs exactly
(tests/test_torch_kinetics_runs.py, test_torch_kinetics_imex.py). Takes
some ten minutes on 8 CPU cores, most of it the Oregonator's ark324.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from crdmodel_tpu_torch.config import SimConfig  # noqa: E402
from crdmodel_tpu_torch.core.problem import (build_problem,  # noqa: E402
                                             make_rho_bound)
from crdmodel_tpu_torch.integrate import rkc  # noqa: E402
from crdmodel_tpu_torch.integrate.erk import integrate_to_outputs  # noqa: E402
from crdmodel_tpu_torch.ops.fused_rkc import S_MAX_KERNEL  # noqa: E402
from crdmodel_tpu_torch.sim import output_times, simulate  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "golden",
                   "torch_kinetics_fixture_stats.npz")
# tests/test_golden.py:30-57 and BASE
PHYSICS = {
    "barkley": dict(beta=0.05, diffusion=1.0),
    "grayscott": dict(beta=0.03, diffusion=2e-5, t_final=20.0),
    "oregonator": dict(beta=1.5, diffusion=1.0),
    "brusselator": dict(beta=1.9, diffusion=0.2),
    "sir": dict(beta=1.5, diffusion=1.0),
    "lambdaomega": dict(beta=0.5, diffusion=0.5),
}
BASE = dict(x_mesh=16, surface_width=20, surface_length=40, t_final=1.0,
            output_timestep=2, wave_length=0.1, wave_width=0.5,
            dtype="float64", rtol=1e-7, atol=1e-11)
FIELDS = ("steps", "accepted", "rejected", "status")


def torch_path_stats(cfg):
    """The torch path's stats of cfg on the CPU; rkc2 with K2's h cap."""
    if cfg.method != "rkc2":
        return simulate(cfg, device="cpu").stats
    problem = build_problem(cfg, device="cpu")
    rho_fn = make_rho_bound(cfg, problem.model, problem.geometry,
                            torch.float64)

    def h_limit(t, y, params):
        rho = rho_fn(t, y, params)
        return (rkc.STAB_FACTOR * (S_MAX_KERNEL - 1) ** 2
                / torch.clamp_min(rho, 1e-30))

    return integrate_to_outputs(
        problem.rhs, problem.y0, problem.params, 0.0, output_times(cfg),
        rtol=cfg.rtol, atol=cfg.atol, method="rkc2", rho_fn=rho_fn,
        h_limit_fn=h_limit)[1]


def main():
    out = {}
    for model, phys in PHYSICS.items():
        for surface in ("flat", "torus"):
            for method in ("bs32", "rkc2", "ark324"):
                cfg = SimConfig(**{**BASE, **phys, "model": model,
                                   "surface": surface, "method": method})
                stats = torch_path_stats(cfg)
                for field in FIELDS:
                    out[f"{model}_{surface}/{method}/{field}"] = (
                        getattr(stats, field).numpy())
                print(model, surface, method, stats.steps.tolist(),
                      flush=True)
    np.savez_compressed(OUT, **out)
    print("wrote", OUT)


if __name__ == "__main__":
    main()
