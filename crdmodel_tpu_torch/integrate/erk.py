"""Adaptive embedded explicit Runge–Kutta integrator on the device
(counterpart of crdmodel_tpu/integrate/erk.py).

SUNDIALS-semantics WRMS error control,

  wrms(e; y) = sqrt( mean_i ( e_i / (rtol*|y_i| + atol) )^2 ),  accept if <= 1,

under ARKode's PID step-size controller, with the last step of every
interval clamped onto its stop time (TSTOP).

The JAX package runs the adaptive loop inside `lax.while_loop`. Here the
control state (t, h, the error history, the counters and the status) lives
in 0-d tensors on the device and every decision is a `torch.where`, line
for line with crdmodel_tpu/integrate/erk.py:329-386. The loop body is a
masked no-op once the interval is done, so the host reads the loop
condition only once every `sync_every` iterations: a block of iterations
may run past the end, and those iterations change nothing.

Ported: scalar mode with step_mode="tstop", the ERK tableaus, RKC2
(integrate/rkc.py, with the h cap h_limit_fn), the ark324 IMEX pair
(integrate/imex.py), and the sharded run's reduce_fn: with a state that is
a parallel/shards.Shards, the steppers' sums stay per shard and reduce_fn
adds them on the control device (parallel/sharded.py), so every shard
takes the same steps. Not ported yet (ROADMAP queue 1, item 14): member
batching, speculative K-step batching, ARK_NORMAL mode and sync_fn
(ensembles).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from crdmodel_tpu_torch.integrate import imex, rkc


@dataclasses.dataclass(frozen=True)
class Tableau:
    name: str
    order: int        # order of the propagating solution
    err_order: int    # order of the local error estimate (= embedded order + 1)
    a: np.ndarray     # (s, s) strictly lower triangular
    b: np.ndarray     # (s,)  propagating weights
    bhat: np.ndarray  # (s,)  embedded weights
    c: np.ndarray     # (s,)

    @property
    def stages(self) -> int:
        return len(self.b)

    @property
    def fsal(self) -> bool:
        """First-same-as-last: last stage of an accepted step equals the
        first stage of the next (a[-1] == b and c[-1] == 1)."""
        return bool(np.allclose(self.a[-1], self.b) and np.isclose(self.c[-1], 1.0))


def _tab(name, order, err_order, a, b, bhat, c):
    return Tableau(name, order, err_order,
                   np.array(a, dtype=np.float64),
                   np.array(b, dtype=np.float64),
                   np.array(bhat, dtype=np.float64),
                   np.array(c, dtype=np.float64))


BS32 = _tab(
    "bs32", 3, 3,
    a=[[0, 0, 0, 0],
       [1 / 2, 0, 0, 0],
       [0, 3 / 4, 0, 0],
       [2 / 9, 1 / 3, 4 / 9, 0]],
    b=[2 / 9, 1 / 3, 4 / 9, 0],
    bhat=[7 / 24, 1 / 4, 1 / 3, 1 / 8],
    c=[0, 1 / 2, 3 / 4, 1],
)

# ARKode's default explicit 4th-order table (Zonneveld 1963)
ZONNEVELD43 = _tab(
    "zonneveld43", 4, 4,
    a=[[0, 0, 0, 0, 0],
       [1 / 2, 0, 0, 0, 0],
       [0, 1 / 2, 0, 0, 0],
       [0, 0, 1, 0, 0],
       [5 / 32, 7 / 32, 13 / 32, -1 / 32, 0]],
    b=[1 / 6, 1 / 3, 1 / 3, 1 / 6, 0],
    bhat=[-1 / 2, 7 / 3, 7 / 3, 13 / 6, -16 / 3],
    c=[0, 1 / 2, 1 / 2, 1, 3 / 4],
)

DOPRI54 = _tab(
    "dopri54", 5, 5,
    a=[[0, 0, 0, 0, 0, 0, 0],
       [1 / 5, 0, 0, 0, 0, 0, 0],
       [3 / 40, 9 / 40, 0, 0, 0, 0, 0],
       [44 / 45, -56 / 15, 32 / 9, 0, 0, 0, 0],
       [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0, 0, 0],
       [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656, 0, 0],
       [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0]],
    b=[35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0],
    bhat=[5179 / 57600, 0, 7571 / 16695, 393 / 640, -92097 / 339200,
          187 / 2100, 1 / 40],
    c=[0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1, 1],
)

TABLEAUS = {"bs32": BS32, "zonneveld43": ZONNEVELD43, "dopri54": DOPRI54}

# step-size controller: ARKode's default PID with its constants
SAFETY = 0.96
PID_K1 = 0.58
PID_K2 = 0.21
PID_K3 = 0.1
ERR_BIAS = 1.5
ETA_MIN = 0.1
ETA_MAX_FIRST = 10000.0   # ARKode etamx1
ETA_MAX = 10.0
ETA_REJECT_MAX = 0.9

# loop iterations between two reads of the loop condition on the host
SYNC_EVERY = 16


class SolveStats(NamedTuple):
    steps: torch.Tensor     # internal steps attempted per output interval
    accepted: torch.Tensor
    rejected: torch.Tensor
    status: torch.Tensor    # 0 ok; 1 max-steps exceeded; 2 dt underflow


def wrms_norm(e, y, rtol, atol, global_size=None, reduce_fn=None):
    """SUNDIALS weighted RMS norm of error e with weights from solution y.
    reduce_fn(x) -> 0-d sum of the squared scaled errors x (the sharded
    run's cross-shard sum); None sums x on its device."""
    w = 1.0 / (rtol * torch.abs(y) + atol)
    sq = torch.square(e * w)
    ss = torch.sum(sq) if reduce_fn is None else reduce_fn(sq)
    n = global_size if global_size is not None else e.numel()
    return torch.sqrt(ss / n)


def _initial_step(rhs, t0, y0, f0, params, tout, rtol, atol, err_order,
                  global_size, reduce_fn=None):
    """Hairer-style automatic initial step size, as a 0-d tensor in y0's
    dtype (crdmodel_tpu/integrate/erk.py:148)."""
    def nrm(v, ref):
        return wrms_norm(v, ref, rtol, atol, global_size, reduce_fn)

    d0 = nrm(y0, y0)
    d1 = nrm(f0, y0)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6,
                     0.01 * d0 / torch.clamp_min(d1, 1e-35))
    h0 = torch.minimum(h0, torch.abs(tout - t0))
    y1 = y0 + h0 * f0
    f1 = rhs(t0 + h0, y1, params)
    d2 = nrm(f1 - f0, y0) / torch.clamp_min(h0, 1e-35)
    dmax = torch.maximum(d1, d2)
    h1 = torch.where(dmax <= 1e-15,
                     torch.clamp_min(h0 * 1e-3, 1e-6),
                     (0.01 / torch.clamp_min(dmax, 1e-35)) ** (1.0 / err_order))
    h = torch.minimum(100.0 * h0, h1)
    h = torch.minimum(h, torch.abs(tout - t0))
    return torch.where(torch.isfinite(h) & (h > 0), h, 1e-6).to(y0.dtype)


def make_default_step_err(tableau: Tableau, rhs: Callable, rtol, atol):
    """Torch-path stepper: (step_err, init_carry).

      step_err(t, y, h, params, carry) -> (y_new, err_ss, new_carry)
      init_carry(t, y, params) -> carry

    err_ss is the sum of squared WRMS-scaled errors. For FSAL tableaus
    (BS3(2), DOPRI5(4)) the carry holds f(t, y), the previous accepted
    step's last stage; the fused kernel (ops/fused_step.py) has no carry.
    """
    s = tableau.stages
    # Python floats: `h * a` stays in the state's dtype
    a, c = tableau.a.tolist(), tableau.c.tolist()
    b = tableau.b.tolist()
    d = (tableau.b - tableau.bhat).tolist()

    def stages(t, y, h, params, k1):
        ks = [k1]
        for i in range(1, s):
            yi = y
            for j in range(i):
                if a[i][j] != 0.0:
                    yi = yi + (h * a[i][j]) * ks[j]
            ks.append(rhs(t + c[i] * h, yi, params))
        y_new = y
        err = torch.zeros_like(y)
        for i in range(s):
            if b[i] != 0.0:
                y_new = y_new + (h * b[i]) * ks[i]
            if d[i] != 0.0:
                err = err + (h * d[i]) * ks[i]
        return y_new, err, ks[-1]

    def err_ss(err_vec, y):
        scaled = err_vec * (1.0 / (rtol * torch.abs(y) + atol))
        return torch.sum(scaled * scaled)

    if tableau.fsal:
        def init_carry(t, y, params):
            return rhs(t, y, params)

        def step_err(t, y, h, params, carry):
            y_new, err_vec, k_last = stages(t, y, h, params, carry)
            return y_new, err_ss(err_vec, y), k_last
    else:
        def init_carry(t, y, params):
            return ()

        def step_err(t, y, h, params, carry):
            y_new, err_vec, _ = stages(t, y, h, params, rhs(t, y, params))
            return y_new, err_ss(err_vec, y), ()

    return step_err, init_carry


def integrate_interval(step_err, t0, y0, h_init, err_prev_init, tout, params,
                       *, err_order, max_steps, global_size, carry0=(),
                       first_interval=False, status0=None,
                       h_limit_fn=None, sync_every=SYNC_EVERY,
                       reduce_fn=None):
    """Integrate from (t0, y0) to tout with adaptive steps.

    t0, h_init, err_prev_init and tout are 0-d tensors in y0's dtype on
    y0's device; status0 a 0-d int32 tensor or None. Returns
    (t, y, h, err_prev, (nstep, nacc, nrej, status)), all tensors. A nonzero
    status0 makes the interval a no-op (sticky failure). first_interval
    relaxes the growth cap to ETA_MAX_FIRST until the first accepted step
    (ARKode's etamx1). h_limit_fn(t, y, params) -> 0-d tensor: a hard cap
    on every attempted step, applied after the clamp onto tout (the fused
    RKC kernel's stage budget, ops/fused_rkc.py). reduce_fn(err_ss) -> the
    0-d global sum of step_err's partial sums (crdmodel_tpu/integrate/
    erk.py:342); None takes err_ss as the sum. With a Shards state, y's
    dtype and device are those of shard 0, which holds the control state.
    """
    dtype, device = y0.dtype, y0.device
    inv_q = 1.0 / float(err_order)
    eps = float(torch.finfo(dtype).eps)

    def body(state):
        t, y, h, ep, epp, fc, nstep, nacc, nrej, status = state
        active = (t < tout) & (status == 0) & (nstep < max_steps)
        hs = torch.where(t + h >= tout, tout - t, h)
        if h_limit_fn is not None:
            hs = torch.minimum(hs, h_limit_fn(t, y, params).to(dtype))
        last = hs >= tout - t

        y_new, err_ss, fc_new = step_err(t, y, hs, params, fc)
        if reduce_fn is not None:
            err_ss = reduce_fn(err_ss)
        err = torch.sqrt(err_ss / global_size).to(dtype)
        err = torch.where(torch.isfinite(err), err, torch.inf)
        raw_accept = err <= 1.0
        accept = raw_accept & active

        # ARKode-style PID step-size update (biased error history)
        err_c = torch.clamp_min(err, 1e-10)
        eta = (SAFETY
               * (ERR_BIAS * err_c) ** (-PID_K1 * inv_q)
               * (ERR_BIAS * ep) ** (PID_K2 * inv_q)
               * (ERR_BIAS * epp) ** (-PID_K3 * inv_q))
        if first_interval:
            # etamx1 applies to the first accepted step's update only
            eta_max = torch.where(nacc == 0, ETA_MAX_FIRST, ETA_MAX).to(dtype)
            eta_acc = torch.minimum(torch.clamp_min(eta, ETA_MIN), eta_max)
        else:
            eta_acc = torch.clamp(eta, ETA_MIN, ETA_MAX)
        eta_rej = torch.clamp(eta, ETA_MIN, ETA_REJECT_MAX)
        # a step clamped only to land on tout says nothing about the
        # error-limited step size: keep the unclamped h for the next interval
        h_grow = hs * eta_acc
        h_acc = torch.where(last, torch.maximum(h, h_grow), h_grow)
        h_next = torch.where(active,
                             torch.where(raw_accept, h_acc, hs * eta_rej), h)

        t_next = torch.where(accept, torch.where(last, tout, t + hs), t)
        y_next = torch.where(accept, y_new, y)
        ep_next = torch.where(accept, err_c, ep)
        epp_next = torch.where(accept, ep, epp)
        if not isinstance(fc, tuple):     # () is the empty carry
            fc = torch.where(accept, fc_new, fc)

        # dt underflow: the step no longer advances time
        hmin = 16.0 * eps * torch.clamp_min(torch.abs(t), 1.0)
        status = torch.where(active & ~raw_accept & (h_next < hmin), 2,
                             status)
        return (t_next, y_next, h_next, ep_next, epp_next, fc,
                nstep + active.to(torch.int32),
                nacc + accept.to(torch.int32),
                nrej + (active & ~raw_accept).to(torch.int32),
                status)

    zero = torch.zeros((), dtype=torch.int32, device=device)
    status = zero if status0 is None else status0
    state = (t0, y0, h_init, err_prev_init, torch.ones_like(err_prev_init),
             carry0, zero, zero, zero, status)

    def go(state):
        t, nstep, status = state[0], state[6], state[9]
        return bool(((t < tout) & (status == 0) & (nstep < max_steps)).item())

    while go(state):
        for _ in range(sync_every):
            state = body(state)
    t, y, h, ep, _, _, nstep, nacc, nrej, status = state
    # max-steps exhaustion without reaching tout
    status = torch.where((t < tout) & (status == 0), 1, status)
    return t, y, h, ep, (nstep, nacc, nrej, status)


def make_stepper(method, rhs, rtol, atol, rho_fn=None, rhs_split=None):
    """(step_err, init_carry, err_order) of a method name: the ERK tableaus,
    rkc2 and ark324 (crdmodel_tpu/integrate/erk.py:737-762). rhs_split:
    (f_ex, f_im), the explicit and implicit parts summing to rhs, which
    ark324 needs (core/problem.py::make_rhs(split=True))."""
    if method == "rkc2":
        if rho_fn is None:
            raise ValueError("method 'rkc2' needs rho_fn")
        step_err, init_carry = rkc.make_rkc2_step_err(rhs, rho_fn, rtol, atol)
        return step_err, init_carry, rkc.ERR_ORDER
    if method == "ark324":
        if rhs_split is None:
            raise ValueError("method 'ark324' needs rhs_split=(f_ex, f_im)")
        step_err, init_carry = imex.make_imex_step_err(
            rhs_split[0], rhs_split[1], rtol, atol)
        return step_err, init_carry, imex.ERR_ORDER
    tableau = TABLEAUS[method] if isinstance(method, str) else method
    step_err, init_carry = make_default_step_err(tableau, rhs, rtol, atol)
    return step_err, init_carry, tableau.err_order


def merge_stops(touts, breakpoints, t0=0.0):
    """Merge static breakpoint times into the output-time list.

    Returns (stop_times (n,), is_output (n,) bool): integration halts exactly
    at every stop; non-output stops are RHS-discontinuity breakpoints whose
    sub-interval stats belong to the next real output interval.
    """
    touts_np = np.asarray(touts, dtype=np.float64)
    stops = [(float(t), True) for t in touts_np]
    t_end = stops[-1][0]
    for bp in breakpoints:
        bp = float(bp)
        if bp <= t0 or bp >= t_end:
            continue
        if any(np.isclose(bp, t) for t, _ in stops):
            continue
        stops.append((bp, False))
    stops.sort(key=lambda p: p[0])
    return (np.array([t for t, _ in stops], dtype=np.float64),
            np.array([o for _, o in stops], dtype=bool))


def integrate_to_outputs(rhs, y0, params, t0, touts, *, rtol, atol,
                         method="bs32", max_steps=200_000, global_size=None,
                         breakpoints=(), step_err=None, init_carry=None,
                         err_order=None, step_mode="tstop", n_members=0,
                         spec_k=0, kstep_call=None, rho_fn=None,
                         h_limit_fn=None, rhs_split=None, sync_fn=None,
                         sync_every=SYNC_EVERY, reduce_fn=None,
                         y_loop0=None, capture=None):
    """Integrate through each output time and return the state at each
    (reference src/FHNmodel_torus.cpp:413-478).

    touts: increasing output times (t0 excluded). Returns (traj, stats):
    traj (len(touts), *y0.shape); stats tensors per output interval.
    breakpoints: times where the RHS is discontinuous in t; integration
    stops exactly there and the sub-interval's stats join the next output
    interval. step_err/init_carry: a caller-supplied stepper (the fused
    kernels, ops/fused_step.py, ops/fused_rkc.py and ops/fused_imex.py) in
    place of the torch-path stepper; h0 is always estimated on the plain y0
    through the composed rhs. rho_fn: the spectral-radius bound the rkc2
    stepper needs (core/problem.py::make_rho_bound). h_limit_fn(t, y,
    params): a hard cap on every attempted step, h0 included. rhs_split:
    the (f_ex, f_im) pair the ark324 stepper needs. reduce_fn: the
    sharded run's cross-shard sum (integrate_interval), also of h0's norms.
    y_loop0/capture: the state the loop carries when a fused kernel keeps
    its own layout (the shard kernels' halo-padded buffers), and the map
    back to what the trajectory records; by default y0 and the identity.
    """
    unported = {"n_members": n_members, "spec_k": spec_k,
                "kstep_call": kstep_call, "sync_fn": sync_fn}
    for name, value in unported.items():
        if value:
            raise NotImplementedError(f"{name} is not ported yet (ROADMAP "
                                      "queue 1, item 14)")
    if step_mode != "tstop":
        raise NotImplementedError(f"step_mode={step_mode!r} is not ported "
                                  "yet (ROADMAP queue 1, item 14)")
    dtype, device = y0.dtype, y0.device
    if global_size is None:
        global_size = y0.numel()
    if y_loop0 is None:
        y_loop0 = y0
    if capture is None:
        capture = lambda y: y   # noqa: E731
    if step_err is None:
        step_err, init_carry, err_order = make_stepper(method, rhs, rtol,
                                                       atol, rho_fn, rhs_split)
    else:
        if err_order is None:
            err_order = TABLEAUS[method].err_order
        if init_carry is None:
            init_carry = lambda t, y, params: ()   # noqa: E731

    stop_times, is_output = merge_stops(touts, breakpoints, float(t0))
    seg_ids = np.cumsum(is_output) - is_output.astype(int)
    stops = torch.tensor(stop_times, dtype=dtype, device=device)

    def seg_params(tout):
        # the RHS tells the segments apart by their end (the boundary freeze)
        return {**params, "_seg_end": tout}

    t = torch.tensor(t0, dtype=dtype, device=device)
    f0 = rhs(t, y0, seg_params(stops[0]))
    h = _initial_step(rhs, t, y0, f0, seg_params(stops[0]), stops[0],
                      rtol, atol, err_order, global_size, reduce_fn)
    if h_limit_fn is not None:
        h = torch.minimum(h, h_limit_fn(t, y_loop0,
                                        seg_params(stops[0])).to(dtype))
    y = y_loop0
    errp = torch.ones((), dtype=dtype, device=device)
    status = torch.zeros((), dtype=torch.int32, device=device)
    traj, per_stop = [], []
    for k in range(len(stop_times)):
        p = seg_params(stops[k])
        # fresh stepper cache per segment: the RHS may differ across a
        # breakpoint (freeze release)
        t, y, h, errp, stats = integrate_interval(
            step_err, t, y, h, errp, stops[k], p, err_order=err_order,
            max_steps=max_steps, global_size=global_size,
            carry0=init_carry(t, y, p), first_interval=(k == 0),
            status0=status, h_limit_fn=h_limit_fn, sync_every=sync_every,
            reduce_fn=reduce_fn)
        status = stats[-1]
        per_stop.append(torch.stack(stats))
        if is_output[k]:
            traj.append(capture(y))

    per_stop = torch.stack(per_stop)          # (n_stops, 4)
    seg = torch.as_tensor(seg_ids, device=device)
    nseg = len(touts)
    counts = torch.zeros((nseg, 3), dtype=torch.int32, device=device)
    counts.index_add_(0, seg, per_stop[:, :3])
    status = torch.zeros(nseg, dtype=torch.int32, device=device).scatter_reduce(
        0, seg, per_stop[:, 3], reduce="amax")
    return torch.stack(traj), SolveStats(steps=counts[:, 0],
                                         accepted=counts[:, 1],
                                         rejected=counts[:, 2],
                                         status=status)
