"""High-level single-device simulation driver (counterpart of
crdmodel_tpu/sim.py).

`simulate(cfg, device="cuda")` builds the problem on `device`, integrates
it over the Nt output intervals and returns the trajectory with the IC as
row 0. `simulate_streaming` (the driver of `python -m crdmodel_tpu_torch
run`, cli.py) integrates the same stops one at a time, hands each output
to a writer and prints the reference's banner (print_banner) and progress
line; it selects its stepper as simulate() does, with the JAX streaming
driver's gaps (select_stepper(streaming=True)).

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

A forcing (build_problem(forcing=); crdmodel_tpu/sim.py:77-85's
allow_forcing=True gates): K1, K2 (both branches, gated and smooth
waveforms), K3 and K4 take a structured one, core/forcing.py::
SeparableForcing with rank-1 stimuli, their amplitudes computed on the
device each step; a free-form callable, a full 2-D `spatial` stimulus,
and any forcing on K5, K6, K7 or K14 decline to the torch path, which
evaluates the forcing at the true stage times. The pulse edges are
integrator breakpoints (solver_breakpoints).

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
                                              StopLoop, integrate_to_outputs)
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


def kernel_eligible(problem: Problem) -> bool:
    """The device and size part of the selection (crdmodel_tpu/sim.py:
    77-115's _pallas_eligible): explicit use_pallas wins; auto takes the
    kernels on a CUDA device at PALLAS_AUTO_POINTS grid points and more
    (on the box PALLAS_BOX3D_AUTO_POINTS nz*ny*nx points)."""
    cfg = problem.cfg
    if cfg.use_pallas is not None:
        return bool(cfg.use_pallas)
    box = problem.geometry.kind == "box"
    points, threshold = ((cfg.nz * cfg.ny * cfg.nx,
                          PALLAS_BOX3D_AUTO_POINTS) if box
                         else (cfg.ny * cfg.nx, PALLAS_AUTO_POINTS))
    return problem.device.type == "cuda" and points >= threshold


def fused_eligible(problem: Problem, streaming: bool = False) -> bool:
    """Whether a fused step kernel takes this problem's steps.

    streaming=True applies the two gaps of the JAX streaming driver's own
    selection (crdmodel_tpu/sim.py:463-550), which the port's streaming
    drivers mirror: rkc2 skips the quiescence check, and a diffusion tensor
    on the box takes no kernel (that driver offers a tensor to K5 alone,
    which declines the box, and gives rkc2's tensor none), where simulate()
    runs K6's and K7's tensor modes."""
    cfg = problem.cfg
    if not kernel_eligible(problem):
        return False
    box = problem.geometry.kind == "box"
    if streaming and box and problem.diffusion_tensor is not None:
        return False
    dtype = problem.y0.dtype
    if cfg.method == "rkc2":
        if (not streaming and cfg.use_pallas is None
                and _quiescent_autonomous(problem)):
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


def select_stepper(problem: Problem, streaming: bool = False) -> tuple:
    """(StopLoop keywords, fused): the stepper of a run and whether a fused
    kernel takes its steps (fused_eligible). streaming=True is the
    streaming drivers' selection: fused_eligible's two gaps, and
    speculative_k ignored (crdmodel_tpu/sim.py:559-567: no K14, no
    batching)."""
    cfg = problem.cfg
    dtype = problem.y0.dtype
    kw = {}
    if cfg.method == "rkc2":
        kw["rho_fn"] = make_rho_bound(
            cfg, problem.model, problem.geometry, dtype,
            diffusion_field=problem.diffusion_field,
            diffusion_tensor=problem.diffusion_tensor,
            face_mask=problem.face_mask)
    if cfg.method == "ark324":
        # IMEX: implicit pointwise reaction + explicit diffusion
        kw["rhs_split"] = make_rhs(
            cfg, problem.model, problem.geometry, dtype, problem.device,
            split=True, diffusion_field=problem.diffusion_field,
            face_mask=problem.face_mask, obstacle_mask=problem.obstacle_mask,
            diffusion_tensor=problem.diffusion_tensor,
            forcing=problem.forcing)
    fused = fused_eligible(problem, streaming)
    box = problem.geometry.kind == "box"
    k = 0 if streaming else int(cfg.speculative_k)
    kstep = None
    if fused and cfg.method == "rkc2":
        # all Chebyshev stages in one launch; h capped to the kernel's
        # stage budget
        build_rkc = (fused_box3d_rkc.build_fused_box3d_rkc_step if box
                     else fused_rkc.build_fused_rkc_step)
        frkc = build_rkc(problem, dtype, rho_fn=kw["rho_fn"])
        kw.update(step_err=frkc.step_err, err_order=rkc.ERR_ORDER,
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
        kw.update(step_err=lambda t, y, h, p, carry:
                  (*step_err(t, y, h, p), ()), err_order=err_order)
        if kstep is not None:
            kw["kstep_call"] = kstep.call
    # speculation batches the steps of the torch path, of K3, or of K14;
    # rkc2 (its h cap wants per-step control), ARK_NORMAL and K4-K6 step
    # one step at a time
    erk_kernel = fused and cfg.method not in ("rkc2", "ark324")
    if cfg.method == "rkc2" or cfg.step_mode == "normal" or (
            erk_kernel and kstep is None):
        k = 0
    kw["spec_k"] = k
    return kw, fused


def make_run_fn(problem: Problem):
    """run(y0, params) -> (traj, stats), its output times, and whether it
    takes the fused path."""
    cfg = problem.cfg
    touts = output_times(cfg)
    breakpoints = solver_breakpoints(cfg, problem.forcing)
    kw, fused = select_stepper(problem)
    spec_k = kw.pop("spec_k")

    def run(y0, params):
        return integrate_to_outputs(
            problem.rhs, y0, params, 0.0, touts, rtol=cfg.rtol,
            atol=cfg.atol, method=cfg.method, max_steps=cfg.max_steps,
            breakpoints=breakpoints, step_mode=cfg.step_mode, spec_k=spec_k,
            **kw)

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


def print_banner(cfg: SimConfig, problem: Problem):
    """Startup parameter dump (crdmodel_tpu/sim.py:358-388, reference
    src/FHNmodel_torus.cpp:246-276)."""
    dim = "3D" if cfg.surface == "box" else "2D"
    print(f"\n{dim} {cfg.model.upper()} model PDE problem on a {cfg.surface}:")
    print(f"   nx = {cfg.nx}\n   ny = {cfg.ny}")
    if cfg.surface == "box":
        print(f"   nz = {cfg.nz}\n   Surface depth = {cfg.surface_depth}")
    print(f"   Diff = {cfg.diffusion}")
    print(f"   Tfinal = {cfg.t_final}")
    print(f"   Output timesteps = {cfg.output_timestep}")
    if cfg.surface == "torus":
        print(f"   Major circumference = {cfg.surface_length}")
        print(f"   Minor circumference = {cfg.surface_width}")
    else:
        print(f"   Surface length = {cfg.surface_length}")
        print(f"   Surface width = {cfg.surface_width}")
    print(f"   Absorbing boundary turn off time = {cfg.t_boundary}")
    print(f"   Wavelength = {cfg.wave_length * 100:g}%")
    print(f"   Wavewidth = {cfg.wave_width * 100:g}%")
    print(f"   rtol = {cfg.rtol}\n   atol = {cfg.atol}")
    print(f"   method = {cfg.method}, dtype = {cfg.dtype}")
    print(f"   Include all variables in output = {cfg.include_all_vars}")
    if cfg.just_diffusion:
        print("   Diffusion Only")
    elif cfg.vary_beta:
        print(f"   Beta varied over surface [{cfg.beta_min}, {cfg.beta_max}]")
    else:
        s = ", ".join(f"{v:g}" for v in problem.steady_state)
        print(f"   Beta = {cfg.beta}\n   Stable state values: {s}")
    print()


def snapshot_policy(snapshot_mode: Optional[str], host_offload: bool,
                    on_snapshot, checkpoint_every) -> str:
    """The capture policy of a streaming run, with the JAX package's
    ValueErrors (crdmodel_tpu/sim.py:443-453)."""
    if snapshot_mode is None:
        snapshot_mode = "host" if host_offload else "device"
    if snapshot_mode not in ("device", "host", "none"):
        raise ValueError(f"snapshot_mode={snapshot_mode!r}; expected "
                         "'device', 'host', or 'none'")
    if snapshot_mode == "none" and on_snapshot is not None:
        raise ValueError("snapshot_mode='none' captures nothing; "
                         "on_snapshot would never fire")
    if snapshot_mode == "none" and checkpoint_every:
        raise ValueError("snapshot_mode='none' is incompatible with "
                         "checkpointing (the payload stores snapshots)")
    return snapshot_mode


def refuse_checkpoints(**given) -> None:
    """Raise for the checkpoint arguments, which are not ported yet."""
    used = sorted(name for name, value in given.items() if value)
    if used:
        raise NotImplementedError(
            f"{', '.join(used)}: checkpoints are not ported yet (ROADMAP "
            "queue 1, item 14)")


def simulate_streaming(cfg: SimConfig, device="cuda",
                       problem: Optional[Problem] = None, on_snapshot=None,
                       progress: bool = False,
                       checkpoint_every: Optional[int] = None,
                       checkpoint_path: Optional[str] = None,
                       host_offload: bool = False,
                       snapshot_mode: Optional[str] = None,
                       _resume: Optional[dict] = None) -> SimResult:
    """Interval-by-interval driver (crdmodel_tpu/sim.py:391-617): the
    solve advances one stop at a time on `device` (the card unless the
    caller asks for the CPU), each stop the call integrate_to_outputs makes
    (integrate/erk.py::StopLoop), so with step_mode "tstop" and
    speculative_k 0 a streaming run takes simulate()'s steps and records
    its trajectory bitwise (where both select the same stepper:
    fused_eligible's streaming gaps aside). After each output it calls `on_snapshot(k, y)` with
    the snapshot as a host numpy array (for incremental file writes, like
    the reference's per-step fprintf loop) and, with progress=True, prints
    the reference's `% | elapsed | remaining` line
    (src/FHNmodel_torus.cpp:457-477). A failed interval ends the run
    without recording its row (sticky failure, drive_stream_loop).

    snapshot_mode (default "device", or "host" with host_offload=True):
      "device" — snapshots accumulate on the device;
      "host"   — each snapshot is copied into pinned host memory and the
                 trajectory is a host tensor, so device memory stays bounded
                 by the solver state whatever Nt. Without on_snapshot the
                 copy runs on a side stream after an event recorded at the
                 end of the interval, and is waited for one interval later
                 (HostOffload), so it can overlap the next interval; with
                 on_snapshot the copy finishes at once (the writer reads it);
      "none"   — capture nothing: the trajectory holds only the final
                 state, on the device (throughput and soak runs).
    wall_time covers the integration and on_snapshot's calls.

    checkpoint_every, checkpoint_path and _resume raise
    NotImplementedError (ROADMAP queue 1, item 14)."""
    snapshot_mode = snapshot_policy(snapshot_mode, host_offload, on_snapshot,
                                    checkpoint_every)
    refuse_checkpoints(checkpoint_every=checkpoint_every,
                       checkpoint_path=checkpoint_path, _resume=_resume)
    problem = problem if problem is not None else build_problem(cfg, device)
    touts = output_times(cfg)
    kw, fused = select_stepper(problem, streaming=True)
    _sync(problem.device)
    t_start = time.perf_counter()
    loop = StopLoop(problem.rhs, problem.y0, problem.params, 0.0, touts,
                    rtol=cfg.rtol, atol=cfg.atol, method=cfg.method,
                    max_steps=cfg.max_steps,
                    breakpoints=solver_breakpoints(cfg, problem.forcing),
                    step_mode=cfg.step_mode, **kw)
    emit = None
    if on_snapshot is not None:
        def emit(k, snap):
            on_snapshot(k, snap.cpu().numpy())
    traj, tout_axis, stats = run_stream(loop, touts, snapshot_mode, emit,
                                        progress, t_start)
    _sync(problem.device)
    return SimResult(cfg=cfg, problem=problem, trajectory=traj,
                     touts=tout_axis, stats=stats,
                     wall_time=time.perf_counter() - t_start, fused=fused)


def drive_stream_loop(stops, nt, dtype, step_to, current_t, on_output,
                      progress, t_start):
    """The streaming bookkeeping of both streaming drivers
    (crdmodel_tpu/sim.py:620-670, without checkpoint resumption): a
    breakpoint stop at or behind the current time (after a free ARK_NORMAL
    interval) is skipped; a failed interval (nonzero status) emits no
    output row and ends the loop (the reference breaks before writing,
    src/FHNmodel_torus.cpp:430-435); after each output, the reference's
    `% | elapsed | remaining` progress line.

      step_to(i, first, k_out) -> int status   (advance to stop i)
      current_t() -> float                     (for the breakpoint skip)
      on_output(k_out_done)                    (snapshot / stream row)

    stops: (stop time, is_output) pairs. Returns the completed output
    count."""
    k_out = 0
    first = True
    for i, (stop, is_out) in enumerate(stops):
        if not is_out and float(torch.tensor(stop, dtype=dtype)) <= \
                current_t():
            continue
        status = step_to(i, first, k_out)
        first = False
        if status != 0:
            print("\nSolver failure, stopping integration")
            break
        if not is_out:
            continue
        on_output(k_out + 1)
        if progress:
            elapsed = time.perf_counter() - t_start
            eta = (nt - (k_out + 1)) * elapsed / (k_out + 1)
            print(f"\r   {100 * (k_out + 1) // nt:3d} % | "
                  f"{int(elapsed // 60):3d} min {int(elapsed % 60):2d} sec "
                  f"elapsed | {int(eta // 60):3d} min {int(eta % 60):2d} sec "
                  f"remaining", end="", flush=True)
        k_out += 1
    if progress:
        print("\n   ----------------------")
    return k_out


class HostOffload:
    """Snapshots copied into one pinned host buffer of `rows` rows behind
    the solve (snapshot_mode "host" without a writer). Each copy runs on a
    side stream after an event recorded on the solve's stream at the end
    of its interval, so the next interval's launches are not held up by
    it; the device tensor stays referenced until its copy is waited for,
    when the next snapshot is taken (or at finish). On the CPU each
    snapshot is copied into the buffer at once."""

    def __init__(self, device: torch.device, rows: int):
        self.device = device
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)
        self.rows = rows
        self.buffer = None      # (rows, *snapshot shape), allocated at first
        self.n = 0
        self.pending = None     # (device tensor, event of its copy)

    def _wait(self):
        if self.pending is not None:
            self.pending[1].synchronize()
            self.pending = None

    def __call__(self, snap: torch.Tensor) -> None:
        if self.buffer is None:
            self.buffer = torch.empty((self.rows, *snap.shape),
                                      dtype=snap.dtype,
                                      pin_memory=self.stream is not None)
        row = self.buffer[self.n]
        self.n += 1
        if self.stream is None:
            row.copy_(snap)
            return
        self._wait()
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(ready)
            row.copy_(snap, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self.stream)
        self.pending = (snap, copied)

    def finish(self) -> torch.Tensor:
        """The rows taken, as a view of the pinned buffer."""
        self._wait()
        return self.buffer[:self.n]


def run_stream(loop: StopLoop, touts, snapshot_mode: str, emit, progress,
               t_start, row=None):
    """Drive `loop` stop by stop (drive_stream_loop) and collect its
    outputs (crdmodel_tpu/sim.py:694-843, without checkpoints). The IC row
    is the loop's state before the first stop. row(snap) -> the trajectory
    row of a snapshot loop.output gives (the identity by default; the
    sharded driver gathers its shards); emit(k, snap), when given, receives
    output k. Returns (trajectory, output times, SolveStats), the stats as
    int32 tensors on the loop's device."""
    row = row if row is not None else (lambda snap: snap)
    nt = len(touts)
    # per output interval: steps, accepted, rejected, status
    acc = np.zeros((4, nt), dtype=np.int64)
    snaps = []
    offload = (HostOffload(loop.device, nt + 1)
               if snapshot_mode == "host" and emit is None else None)

    def record(k, snap):
        if snapshot_mode == "none":
            return
        r = row(snap)
        if offload is not None:
            offload(r)
        else:
            snaps.append(r.cpu() if snapshot_mode == "host" else r)
        if emit is not None:
            emit(k, snap)

    def step_to(i, first, k_out):
        stats = loop.advance(i, first)
        ns, na, nr, status = (int(s) for s in stats)
        acc[:3, k_out] += (ns, na, nr)
        acc[3, k_out] = max(acc[3, k_out], status)
        return status

    out_stops = np.flatnonzero(loop.is_output)
    record(0, loop.capture(loop.y))
    drive_stream_loop(list(zip(loop.stop_times, loop.is_output)), nt,
                      loop.dtype, step_to, lambda: float(loop.t),
                      lambda k: record(k, loop.output(out_stops[k - 1])),
                      progress, t_start)
    if snapshot_mode == "none":
        traj = row(loop.capture(loop.y))[None]
        tout_axis = np.asarray([float(loop.t)])
    else:
        traj = offload.finish() if offload is not None else torch.stack(snaps)
        tout_axis = np.concatenate([[0.0], touts[:traj.shape[0] - 1]])
    stats = SolveStats(*(torch.tensor(a, dtype=torch.int32,
                                      device=loop.device) for a in acc))
    return traj, tout_axis, stats
