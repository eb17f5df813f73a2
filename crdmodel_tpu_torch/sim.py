"""High-level single-device simulation driver (counterpart of
crdmodel_tpu/sim.py).

`simulate(cfg, device)` builds the problem on `device`, integrates it over
the Nt output intervals and returns the trajectory with the IC as row 0.

Kernel selection (the counterpart of crdmodel_tpu/sim.py:77-115, 233-291):
the ERK tableaus go through the fused step (ops/fused_step.py) when
`cfg.use_pallas` is True, or when it is None on a CUDA device above
PALLAS_AUTO_POINTS grid points, and ops/fused_step.py::is_supported
accepts the problem; everything else takes the torch path
(integrate/erk.py::make_default_step_err). On a CPU device the fused path
runs the kernel's plain version, the counterpart of the JAX package's
interpret=True.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from crdmodel_tpu_torch.config import PALLAS_AUTO_POINTS, SimConfig
from crdmodel_tpu_torch.core.problem import (Problem, build_problem,
                                             solver_breakpoints)
from crdmodel_tpu_torch.integrate.erk import (TABLEAUS, SolveStats,
                                              integrate_to_outputs)
from crdmodel_tpu_torch.ops import fused_step

STATUS_NAMES = {0: "ok", 1: "max-steps-exceeded", 2: "dt-underflow"}


@dataclasses.dataclass
class SimResult:
    cfg: SimConfig
    problem: Problem
    trajectory: torch.Tensor   # (Nt+1, nvars, ny, nx), IC first
    touts: np.ndarray          # (Nt+1,), starting at T0
    stats: SolveStats
    wall_time: float
    fused: bool                # True when the fused step took every step

    @property
    def ok(self) -> bool:
        return bool(torch.all(self.stats.status == 0))

    def field(self, var: int = 0) -> np.ndarray:
        """(nt, ny, nx) array of one variable."""
        return self.trajectory[:, var].cpu().numpy()

    def total_steps(self) -> int:
        return int(self.stats.steps.sum())

    def describe(self) -> str:
        s = self.stats
        if self.ok:
            status = "ok"
        else:
            worst = int(s.status.max())
            status = f"FAILED ({STATUS_NAMES.get(worst, worst)})"
        return (f"{self.cfg.program_name}: grid {self.cfg.ny}x{self.cfg.nx}, "
                f"Tf={self.cfg.t_final}, steps={self.total_steps()} "
                f"(acc {int(s.accepted.sum())}, rej {int(s.rejected.sum())}), "
                f"status={status}, wall={self.wall_time:.3f}s")


def output_times(cfg: SimConfig) -> np.ndarray:
    """The Nt output times T0+dTout..Tf, dTout=(Tf-T0)/Nt, clamped to Tf
    (reference src/FHNmodel_torus.cpp:416-429)."""
    nt = cfg.output_timestep
    dtout = cfg.t_final / nt
    return np.minimum((1 + np.arange(nt, dtype=np.float64)) * dtout,
                      cfg.t_final)


def fused_eligible(problem: Problem) -> bool:
    """Whether the fused step takes this problem's steps."""
    cfg = problem.cfg
    if cfg.use_pallas is False:
        return False
    if cfg.use_pallas is None and (problem.device.type != "cuda"
                                   or cfg.ny * cfg.nx < PALLAS_AUTO_POINTS):
        return False
    return fused_step.is_supported(problem, TABLEAUS[cfg.method],
                                   problem.y0.dtype)


def make_run_fn(problem: Problem):
    """run(y0, params) -> (traj, stats), its output times, and whether it
    takes the fused path."""
    cfg = problem.cfg
    if cfg.method not in TABLEAUS:
        item = 7 if cfg.method == "rkc2" else 8
        raise NotImplementedError(f"method={cfg.method!r} is not ported yet "
                                  f"(ROADMAP queue 1, item {item})")
    if cfg.speculative_k > 1:
        raise NotImplementedError("speculative_k is not ported yet (ROADMAP "
                                  "queue 1, item 14; kernel K14)")
    touts = output_times(cfg)
    breakpoints = solver_breakpoints(cfg)
    kw = {}
    fused = fused_eligible(problem)
    if fused:
        tableau = TABLEAUS[cfg.method]
        step_err = fused_step.build_fused_step(problem, tableau)
        kw = dict(step_err=lambda t, y, h, p, carry: (*step_err(t, y, h, p), ()),
                  err_order=tableau.err_order)

    def run(y0, params):
        return integrate_to_outputs(
            problem.rhs, y0, params, 0.0, touts, rtol=cfg.rtol,
            atol=cfg.atol, method=cfg.method, max_steps=cfg.max_steps,
            breakpoints=breakpoints, step_mode=cfg.step_mode, **kw)

    return run, touts, fused


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def simulate(cfg: SimConfig, device, problem: Optional[Problem] = None) -> SimResult:
    """Run `cfg` on `device` (no default: the caller says where the run
    lives). wall_time covers the integration, device work included."""
    problem = problem if problem is not None else build_problem(cfg, device)
    run, touts, fused = make_run_fn(problem)
    _sync(problem.device)
    t_start = time.perf_counter()
    traj, stats = run(problem.y0, problem.params)
    _sync(problem.device)
    wall = time.perf_counter() - t_start
    return SimResult(
        cfg=cfg, problem=problem,
        trajectory=torch.cat([problem.y0[None], traj], dim=0),
        touts=np.concatenate([[0.0], touts]), stats=stats, wall_time=wall,
        fused=fused)
