"""High-level single-device simulation driver (counterpart of
crdmodel_tpu/sim.py).

`simulate(cfg, device="cuda")` builds the problem on `device`, integrates
it over the Nt output intervals and returns the trajectory with the IC as
row 0.

Kernel selection (the counterpart of crdmodel_tpu/sim.py:77-144, 180-291):
a method goes through its fused step kernel when `cfg.use_pallas` is True,
or when it is None on a CUDA device above PALLAS_AUTO_POINTS grid points
(on the box, PALLAS_BOX3D_AUTO_POINTS nz*ny*nx points), and the kernel's
gate accepts the problem. The 3-D box is routed first, since its operator
always takes the divergence form: the ERK tableaus through K6
(ops/fused_box3d.py::is_box3d_supported), rkc2 through K7
(ops/fused_box3d_rkc.py::is_box3d_rkc_supported, a tensor included); K3
declines the box, so ark324 there takes the torch path. Elsewhere the ERK
tableaus go through K1
(ops/fused_step.py::is_supported), through K4 when the operator exists
only in the divergence form (kernel_common.needs_divform: no-flux walls,
obstacles, 2-D or flat diffusion fields; ops/fused_divform.py::
is_divform_supported), or through K5 with a diffusion tensor on the flat
surface (ops/fused_aniso.py::is_aniso_supported); rkc2 through K2, on
the profile or the divergence-form operator (ops/fused_rkc.py::
is_rkc_supported, and under auto selection only when the run is not
provably quiescent, _quiescent_autonomous), ark324 through K3
(ops/fused_imex.py::is_imex_supported). K3 declines divergence-form
problems, and K2 and K3 decline diffusion tensors. Everything else takes
the torch path (integrate/erk.py::make_stepper). On a CPU device the fused
path runs the kernel's plain version, the counterpart of the JAX
package's interpret=True.

speculative_k = K > 1 (crdmodel_tpu/sim.py:270-300): on K1's route with
step_mode "tstop", the K-step kernel K14 takes K frozen-h sub-steps a
launch (ops/fused_kstep.py::is_kstep_supported) and K1 each interval's
tail; where no ERK kernel takes the steps (the torch path, and ark324 on
K3 or off it) the loop batches K steps of its stepper
(integrate/erk.py::integrate_interval_batched); rkc2, step_mode "normal"
and K4, K5 and K6 step one step at a time. Unlike the JAX package, whose
interpret=True never selects K14, a CPU device with use_pallas=True runs
K14's plain version.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from crdmodel_tpu_torch.config import (PALLAS_AUTO_POINTS,
                                      PALLAS_BOX3D_AUTO_POINTS, SimConfig)
from crdmodel_tpu_torch.core.problem import (Problem, build_problem,
                                             make_rhs, make_rho_bound,
                                             solver_breakpoints)
from crdmodel_tpu_torch.integrate import imex, rkc
from crdmodel_tpu_torch.integrate.erk import (TABLEAUS, SolveStats,
                                              integrate_to_outputs)
from crdmodel_tpu_torch.ops import (fused_aniso, fused_box3d,
                                    fused_box3d_rkc, fused_divform,
                                    fused_imex, fused_kstep, fused_rkc,
                                    fused_step)
from crdmodel_tpu_torch.ops.kernel_common import needs_divform

STATUS_NAMES = {0: "ok", 1: "max-steps-exceeded", 2: "dt-underflow"}


@dataclasses.dataclass
class SimResult:
    cfg: SimConfig
    problem: Problem
    trajectory: torch.Tensor   # (Nt+1, nvars, ny, nx) or, on the box,
                               # (Nt+1, nvars, nz, ny, nx); IC first
    touts: np.ndarray          # (Nt+1,), starting at T0
    stats: SolveStats
    wall_time: float
    fused: bool                # True when the fused step took every step
                               # (with speculative_k, K14 and K1 the tail)

    @property
    def ok(self) -> bool:
        return bool(torch.all(self.stats.status == 0))

    def field(self, var: int = 0) -> np.ndarray:
        """(nt, ny, nx) array of one variable; (nt, nz, ny, nx) on the
        box."""
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
        grid = "x".join(str(n) for n in self.trajectory.shape[2:])
        return (f"{self.cfg.program_name}: grid {grid}, "
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


def _quiescent_autonomous(problem: Problem) -> bool:
    """True when the run provably never leaves its uniform rest state
    (crdmodel_tpu/sim.py:118-144): autonomous (no forcing), scalar beta,
    spatially uniform ICs, and the kinetics rate at that state below
    tolerance-rate over an output interval. Auto selection keeps such rkc2
    runs off the fused kernel, whose stage-budget h cap would only add
    steps there. The threshold is the JAX package's, not re-derived on a
    GPU."""
    cfg = problem.cfg
    if problem.forcing is not None or cfg.vary_beta == 1:
        return False
    y0 = problem.y0.cpu().numpy()
    flat = y0.reshape(y0.shape[0], -1)
    if np.any(flat.max(axis=1) != flat.min(axis=1)):
        return False
    point = torch.tensor(flat[:, :1].reshape(y0.shape[0], 1, 1),
                         dtype=getattr(torch, cfg.dtype))
    rate = problem.model.kinetics(
        point, torch.tensor(cfg.beta, dtype=point.dtype)).numpy().reshape(-1)
    w = 1.0 / (cfg.rtol * np.abs(flat[:, 0]) + cfg.atol)
    dtout = cfg.t_final / cfg.output_timestep
    return float(np.max(np.abs(rate) * w)) * dtout < 1e-2


def fused_eligible(problem: Problem) -> bool:
    """Whether a fused step kernel takes this problem's steps."""
    cfg = problem.cfg
    if cfg.use_pallas is False:
        return False
    box = problem.geometry.kind == "box"
    points, threshold = ((cfg.nz * cfg.ny * cfg.nx,
                          PALLAS_BOX3D_AUTO_POINTS) if box
                         else (cfg.ny * cfg.nx, PALLAS_AUTO_POINTS))
    if cfg.use_pallas is None and (problem.device.type != "cuda"
                                   or points < threshold):
        return False
    dtype = problem.y0.dtype
    if cfg.method == "rkc2":
        if cfg.use_pallas is None and _quiescent_autonomous(problem):
            return False
        if box:
            return fused_box3d_rkc.is_box3d_rkc_supported(problem, dtype)
        return fused_rkc.is_rkc_supported(problem, dtype)
    if cfg.method == "ark324":
        return fused_imex.is_imex_supported(problem, dtype)
    tableau = TABLEAUS[cfg.method]
    if box:
        return fused_box3d.is_box3d_supported(problem, tableau, dtype)
    if problem.diffusion_tensor is not None:
        return fused_aniso.is_aniso_supported(problem, tableau, dtype)
    if needs_divform(problem):
        return fused_divform.is_divform_supported(problem, tableau, dtype)
    return fused_step.is_supported(problem, tableau, dtype)


def make_run_fn(problem: Problem):
    """run(y0, params) -> (traj, stats), its output times, and whether it
    takes the fused path."""
    cfg = problem.cfg
    touts = output_times(cfg)
    breakpoints = solver_breakpoints(cfg)
    dtype = problem.y0.dtype
    rho_fn = None
    if cfg.method == "rkc2":
        rho_fn = make_rho_bound(cfg, problem.model, problem.geometry, dtype,
                                diffusion_field=problem.diffusion_field,
                                diffusion_tensor=problem.diffusion_tensor,
                                face_mask=problem.face_mask)
    rhs_split = None
    if cfg.method == "ark324":
        # IMEX: implicit pointwise reaction + explicit diffusion
        rhs_split = make_rhs(cfg, problem.model, problem.geometry, dtype,
                             problem.device, split=True,
                             diffusion_field=problem.diffusion_field,
                             face_mask=problem.face_mask,
                             obstacle_mask=problem.obstacle_mask,
                             diffusion_tensor=problem.diffusion_tensor)
    kw = {}
    fused = fused_eligible(problem)
    box = problem.geometry.kind == "box"
    k = int(cfg.speculative_k)
    kstep = None
    if fused and cfg.method == "rkc2":
        # all Chebyshev stages in one launch; h capped to the kernel's
        # stage budget
        build_rkc = (fused_box3d_rkc.build_fused_box3d_rkc_step if box
                     else fused_rkc.build_fused_rkc_step)
        frkc = build_rkc(problem, dtype, rho_fn=rho_fn)
        kw = dict(step_err=frkc.step_err, err_order=rkc.ERR_ORDER,
                  h_limit_fn=frkc.h_limit)
    elif fused:
        if cfg.method == "ark324":
            # the explicit stencils and the Newton stages in one launch
            step_err = fused_imex.build_fused_imex_step(problem)
            err_order = imex.ERR_ORDER
        else:
            tableau = TABLEAUS[cfg.method]
            if box:
                build = fused_box3d.build_fused_box3d_step
            elif problem.diffusion_tensor is not None:
                build = fused_aniso.build_fused_aniso_step
            elif needs_divform(problem):
                build = fused_divform.build_fused_divform_step
            else:
                build = fused_step.build_fused_step
                if (k > 1 and cfg.step_mode == "tstop"
                        and fused_kstep.is_kstep_supported(problem, tableau,
                                                           dtype, k)):
                    kstep = fused_kstep.build_fused_kstep(problem, tableau, k)
            step_err = build(problem, tableau)
            err_order = tableau.err_order
        kw = dict(step_err=lambda t, y, h, p, carry: (*step_err(t, y, h, p), ()),
                  err_order=err_order)
        if kstep is not None:
            kw["kstep_call"] = kstep.call
    # speculation batches the steps of the torch path, of K3, or of K14;
    # rkc2 (its h cap wants per-step control), ARK_NORMAL and K4-K6 step
    # one step at a time
    erk_kernel = fused and cfg.method not in ("rkc2", "ark324")
    if cfg.method == "rkc2" or cfg.step_mode == "normal" or (
            erk_kernel and kstep is None):
        spec_k = 0
    else:
        spec_k = k

    def run(y0, params):
        return integrate_to_outputs(
            problem.rhs, y0, params, 0.0, touts, rtol=cfg.rtol,
            atol=cfg.atol, method=cfg.method, max_steps=cfg.max_steps,
            breakpoints=breakpoints, step_mode=cfg.step_mode, rho_fn=rho_fn,
            rhs_split=rhs_split, spec_k=spec_k, **kw)

    return run, touts, fused


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def simulate(cfg: SimConfig, device="cuda",
             problem: Optional[Problem] = None) -> SimResult:
    """Run `cfg` on `device` (the card unless the caller asks for the CPU).
    wall_time covers the integration, device work included."""
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
