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

Ported: scalar mode in both step modes, "tstop" (the last step of every
interval clamped onto its stop) and "normal" (ARKode's ARK_NORMAL: steps
run freely past each output and the snapshot is cubic Hermite dense
output, integrate_interval_free and hermite_interpolate); the ERK
tableaus, RKC2 (integrate/rkc.py, with the h cap h_limit_fn), the ark324
IMEX pair (integrate/imex.py); speculative K-step batching, on the torch
path (integrate_interval_batched) and through a K-step kernel
(integrate_interval_kernel_batched, ops/fused_kstep.py, kernel K14); and
the sharded run's reduce_fn: with a state that is a parallel/shards.Shards,
the steppers' sums stay per shard and reduce_fn adds them on the control
device (parallel/sharded.py), so every shard takes the same steps. Not
ported yet (ROADMAP queue 1, item 14): member batching and sync_fn
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


def integrate_interval_free(step_err, t0, y0, h_init, err_prev_init, tout,
                            params, *, err_order, max_steps, global_size,
                            carry0=(), bracket0=None, first_interval=False,
                            status0=None, h_limit_fn=None, t_cap=None,
                            sync_every=SYNC_EVERY, reduce_fn=None):
    """ARK_NORMAL interval (crdmodel_tpu/integrate/erk.py:408-516): step
    freely until t >= tout, the last accepted step overshooting it, and
    keep the last accepted step's start (t_lo, y_lo) as the bracket the
    caller interpolates in at tout (ARKode steps past tout and interpolates
    back, src/FHNmodel_torus.cpp:423 with ARK_NORMAL).

    bracket0: (t_lo, y_lo) carried in from the previous interval; when t0
    already lies past tout (one step crossed several outputs) no step runs
    and it still brackets tout. t_cap: a 0-d tensor, the next breakpoint
    after tout (+inf where none lies ahead), which no step may cross; a
    step clamped only by it keeps the unclamped h as controller memory.
    The other arguments are integrate_interval's. Returns (t, y, h,
    err_prev, (t_lo, y_lo), (nstep, nacc, nrej, status)).
    """
    dtype, device = y0.dtype, y0.device
    inv_q = 1.0 / float(err_order)
    eps = float(torch.finfo(dtype).eps)
    if bracket0 is None:
        bracket0 = (t0, y0)

    def body(state):
        t, y, h, ep, epp, fc, br_t, br_y, nstep, nacc, nrej, status = state
        active = (t < tout) & (status == 0) & (nstep < max_steps)
        hs = h
        if h_limit_fn is not None:
            hs = torch.minimum(hs, h_limit_fn(t, y, params).to(dtype))
        if t_cap is not None:
            at_cap = t + hs >= t_cap
            hs = torch.where(at_cap, t_cap - t, hs)

        y_new, err_ss, fc_new = step_err(t, y, hs, params, fc)
        if reduce_fn is not None:
            err_ss = reduce_fn(err_ss)
        err = torch.sqrt(err_ss / global_size).to(dtype)
        err = torch.where(torch.isfinite(err), err, torch.inf)
        raw_accept = err <= 1.0
        accept = raw_accept & active

        err_c = torch.clamp_min(err, 1e-10)
        eta = (SAFETY
               * (ERR_BIAS * err_c) ** (-PID_K1 * inv_q)
               * (ERR_BIAS * ep) ** (PID_K2 * inv_q)
               * (ERR_BIAS * epp) ** (-PID_K3 * inv_q))
        if first_interval:
            eta_max = torch.where(nacc == 0, ETA_MAX_FIRST, ETA_MAX).to(dtype)
            h_grow = hs * torch.minimum(torch.clamp_min(eta, ETA_MIN),
                                        eta_max)
        else:
            h_grow = hs * torch.clamp(eta, ETA_MIN, ETA_MAX)
        if t_cap is not None:
            # cap-clamped steps say nothing about the error-limited h
            h_grow = torch.where(at_cap, torch.maximum(h, h_grow), h_grow)
        h_next = torch.where(
            active, torch.where(raw_accept, h_grow,
                                hs * torch.clamp(eta, ETA_MIN,
                                                 ETA_REJECT_MAX)), h)

        # the bracket: the state at the start of the accepted step
        br_t = torch.where(accept, t, br_t)
        br_y = torch.where(accept, y, br_y)
        t_next = torch.where(accept, t + hs, t)
        y_next = torch.where(accept, y_new, y)
        ep_next = torch.where(accept, err_c, ep)
        epp_next = torch.where(accept, ep, epp)
        if not isinstance(fc, tuple):     # () is the empty carry
            fc = torch.where(accept, fc_new, fc)

        hmin = 16.0 * eps * torch.clamp_min(torch.abs(t), 1.0)
        status = torch.where(active & ~raw_accept & (h_next < hmin), 2,
                             status)
        return (t_next, y_next, h_next, ep_next, epp_next, fc, br_t, br_y,
                nstep + active.to(torch.int32),
                nacc + accept.to(torch.int32),
                nrej + (active & ~raw_accept).to(torch.int32), status)

    zero = torch.zeros((), dtype=torch.int32, device=device)
    status = zero if status0 is None else status0
    state = (t0, y0, h_init, err_prev_init, torch.ones_like(err_prev_init),
             carry0, bracket0[0], bracket0[1], zero, zero, zero, status)

    def go(state):
        t, nstep, status = state[0], state[8], state[11]
        return bool(((t < tout) & (status == 0) & (nstep < max_steps)).item())

    while go(state):
        for _ in range(sync_every):
            state = body(state)
    t, y, h, ep, _, _, br_t, br_y, nstep, nacc, nrej, status = state
    status = torch.where((t < tout) & (status == 0), 1, status)
    return t, y, h, ep, (br_t, br_y), (nstep, nacc, nrej, status)


def hermite_interpolate(rhs, t_lo, y_lo, t_hi, y_hi, tout, params):
    """Cubic Hermite dense output on [t_lo, t_hi] at tout, ARKode's default
    interpolation degree (crdmodel_tpu/integrate/erk.py:519-537); the end
    slopes are two rhs evaluations. A degenerate bracket (t_hi == t_lo, as
    after a clamped interval) or one that ends before tout gives y_hi."""
    dtype = y_hi.dtype
    d = (t_hi - t_lo).to(dtype)
    ok = (d > 0) & (t_hi >= tout)
    d_safe = torch.where(ok, d, torch.ones_like(d))
    s = torch.clamp((tout.to(dtype) - t_lo) / d_safe, 0.0, 1.0)
    f_lo = rhs(t_lo, y_lo, params)
    f_hi = rhs(t_hi, y_hi, params)
    h00 = (1 + 2 * s) * (1 - s) ** 2
    h10 = s * (1 - s) ** 2
    h01 = s * s * (3 - 2 * s)
    h11 = s * s * (s - 1)
    y_out = (h00 * y_lo + h01 * y_hi
             + (h10 * d_safe) * f_lo + (h11 * d_safe) * f_hi)
    return torch.where(ok, y_out, y_hi)


def _pick(stack, index):
    """stack[index] for a 0-d integer tensor index, without a host read."""
    return stack.index_select(0, index.reshape(1).to(torch.long))[0]


def _batch_control(evec, K, t, h, ep, epp, status, active, inv_q, eps):
    """The controller of a speculative K-step batch
    (crdmodel_tpu/integrate/erk.py:584-626, 677-720): from the K sub-step
    error norms evec, the accepted prefix and, masked by `active`, the
    batch's h, error history, status and counts. Returns (prefix, all_ok,
    (h, ep, epp, status), (attempted, accepted, rejected))."""
    dtype = evec.dtype
    evec = torch.where(torch.isfinite(evec), evec, torch.inf)
    acc = torch.cumprod((evec <= 1.0).to(torch.int32), 0)
    prefix = torch.sum(acc, dtype=torch.int32)
    all_ok = prefix == K

    e_last = torch.clamp_min(_pick(evec, torch.clamp_min(prefix - 1, 0)),
                             1e-10)
    e_prev = torch.where(prefix > 1,
                         _pick(evec, torch.clamp_min(prefix - 2, 0)), ep)
    e_rej = torch.clamp_min(_pick(evec, torch.clamp_max(prefix, K - 1)),
                            1e-10)
    e_ctl = torch.where(all_ok, e_last, e_rej)
    e1 = torch.where(all_ok, e_prev, e_last)
    eta = (SAFETY * (ERR_BIAS * e_ctl) ** (-PID_K1 * inv_q)
           * (ERR_BIAS * torch.clamp_min(e1, 1e-10)) ** (PID_K2 * inv_q)
           * (ERR_BIAS * torch.clamp_min(ep, 1e-10)) ** (-PID_K3 * inv_q))
    # growth cap: one oversized h rejects a whole batch, so stay
    # conservative near the controller's equilibrium but ramp fast while
    # the errors are far below target
    grow_cap = torch.where(e_ctl < 0.1, ETA_MAX, 1.4).to(dtype)
    eta_acc = torch.minimum(torch.clamp_min(0.95 * eta, ETA_MIN), grow_cap)
    eta_rej = torch.clamp(eta, ETA_MIN, ETA_REJECT_MAX)
    h_next = h * torch.where(all_ok, eta_acc, eta_rej)

    ep_next = torch.where(prefix > 0, e_last, ep)
    epp_next = torch.where(prefix > 0, torch.where(prefix > 1, e_prev, ep),
                           epp)
    hmin = 16.0 * eps * torch.clamp_min(torch.abs(t), 1.0)
    status_next = torch.where(~all_ok & (h_next < hmin), 2, status)
    rejected = (~all_ok).to(torch.int32)
    zero = torch.zeros_like(prefix)
    control = (torch.where(active, h_next, h),
               torch.where(active, ep_next, ep),
               torch.where(active, epp_next, epp),
               torch.where(active, status_next, status))
    counts = (torch.where(active, prefix + rejected, zero),
              torch.where(active, prefix, zero),
              torch.where(active, rejected, zero))
    return prefix, all_ok, control, counts


def _batch_go(K, tout, max_steps):
    """The batch loops' condition: a whole batch fits before tout."""
    def go(t, h, nstep, status):
        return (t + K * h <= tout) & (t < tout) & (status == 0) & (
            nstep < max_steps)
    return go


def _batch_block(K, sync_every):
    """Batch iterations between two host reads of the loop condition: a
    block runs past the interval's end by up to its length less one, each
    such iteration a masked batch of K sub-steps."""
    return max(1, sync_every // K)


def integrate_interval_batched(step_err, K, t0, y0, h_init, errs0, tout,
                               params, *, err_order, max_steps, global_size,
                               carry0=(), status0=None,
                               sync_every=SYNC_EVERY, reduce_fn=None):
    """Speculative K-step batches on the torch path
    (crdmodel_tpu/integrate/erk.py:540-640): each batch takes K sub-steps
    with a frozen h, the FSAL carry threaded through, and commits the
    longest accepted prefix by one index into the stacked states. Each
    sub-step is validated against the WRMS test, so the tolerance contract
    is the per-step loop's; only the h sequence differs (one controller
    update a batch, _batch_control). Batches run while t + K h stays inside
    the interval; the per-step loop finishes it (integrate_interval), with
    no etamx1 and no h cap, and its own step budget, as in the JAX package.

    errs0 = (ep, epp), the controller's error history. Returns like
    integrate_interval.
    """
    dtype, device = y0.dtype, y0.device
    inv_q = 1.0 / float(err_order)
    eps = float(torch.finfo(dtype).eps)
    go = _batch_go(K, tout, max_steps)

    def body(state):
        t, y, h, ep, epp, fc, nstep, nacc, nrej, status = state
        active = go(t, h, nstep, status)
        ys, fcs, es = [y], [fc], []
        for j in range(K):
            yn, ss, fcn = step_err(t + j * h, ys[-1], h, params, fcs[-1])
            ys.append(yn)
            fcs.append(fcn)
            es.append(ss if reduce_fn is None else reduce_fn(ss))
        evec = torch.sqrt(torch.stack(es) / global_size).to(dtype)
        prefix, _, (h_n, ep, epp, status), (ns, na, nr) = _batch_control(
            evec, K, t, h, ep, epp, status, active, inv_q, eps)
        # commit the longest accepted prefix (none in a masked iteration)
        take = torch.where(active, prefix, torch.zeros_like(prefix))
        y = _pick(torch.stack(ys), take)
        if not isinstance(fc, tuple):     # () is the empty carry
            fc = _pick(torch.stack(fcs), take)
        t = torch.where(active, t + prefix.to(dtype) * h, t)
        return (t, y, h_n, ep, epp, fc, nstep + ns, nacc + na, nrej + nr,
                status)

    zero = torch.zeros((), dtype=torch.int32, device=device)
    status = zero if status0 is None else status0
    state = (t0, y0, h_init, errs0[0], errs0[1], carry0, zero, zero, zero,
             status)
    block = _batch_block(K, sync_every)
    while bool(go(state[0], state[2], state[6], state[9]).item()):
        for _ in range(block):
            state = body(state)
    t, y, h, ep, _, fc, nstep, nacc, nrej, status = state

    # the tail: the per-step loop lands on tout
    t, y, h, ep, (ns2, na2, nr2, status) = integrate_interval(
        step_err, t, y, h, ep, tout, params, err_order=err_order,
        max_steps=max_steps, global_size=global_size, carry0=fc,
        status0=status, sync_every=sync_every, reduce_fn=reduce_fn)
    return t, y, h, ep, (nstep + ns2, nacc + na2, nrej + nr2, status)


def integrate_interval_kernel_batched(kcall, K, t0, y0, h_init, errs0, tout,
                                      params, *, err_order, max_steps,
                                      global_size, status0=None,
                                      tail_step_err=None, tail_carry0=(),
                                      sync_every=SYNC_EVERY):
    """integrate_interval_batched through a K-step kernel
    (crdmodel_tpu/integrate/erk.py:643-734; ops/fused_kstep.py, K14).

    kcall(t, y, h, n_commit, params, full) -> (y_committed, partials
    (n_blocks, K)): K frozen-h sub-steps in one launch, committing sub-step
    n_commit (a 0-d int32 tensor), with each sub-step's partial error sums.
    The K error norms come from one sum over the block axis. A batch issues
    two launches and reads nothing on the host: the speculative one
    (n_commit = K; -1 in a masked iteration, which returns at once) and a
    recovery one (full=False) that recomputes the accepted prefix after a
    mid-batch rejection (n_commit = prefix), returns at once when the whole
    batch was accepted (-1), and copies y in a masked iteration (-2); one
    torch.where picks the batch's result. The per-step loop through
    tail_step_err (the single-step kernel, K1) lands on tout.
    """
    dtype, device = y0.dtype, y0.device
    inv_q = 1.0 / float(err_order)
    eps = float(torch.finfo(dtype).eps)
    go = _batch_go(K, tout, max_steps)
    i32 = dict(dtype=torch.int32, device=device)
    spec_n, skip, copy = (torch.tensor(v, **i32) for v in (K, -1, -2))

    def body(state):
        t, y, h, ep, epp, nstep, nacc, nrej, status = state
        active = go(t, h, nstep, status)
        y_k, sss = kcall(t, y, h, torch.where(active, spec_n, skip), params,
                         True)
        evec = torch.sqrt(torch.sum(sss, dim=0) / global_size).to(dtype)
        prefix, all_ok, (h_n, ep, epp, status), (ns, na, nr) = \
            _batch_control(evec, K, t, h, ep, epp, status, active, inv_q,
                           eps)
        n_rec = torch.where(active, torch.where(all_ok, skip, prefix), copy)
        y_rec, _ = kcall(t, y, h, n_rec, params, False)
        y = torch.where(active & all_ok, y_k, y_rec)
        t = torch.where(active, t + prefix.to(dtype) * h, t)
        return (t, y, h_n, ep, epp, nstep + ns, nacc + na, nrej + nr,
                status)

    zero = torch.zeros((), **i32)
    status = zero if status0 is None else status0
    state = (t0, y0, h_init, errs0[0], errs0[1], zero, zero, zero, status)
    block = _batch_block(K, sync_every)
    while bool(go(state[0], state[2], state[5], state[8]).item()):
        for _ in range(block):
            state = body(state)
    t, y, h, ep, _, nstep, nacc, nrej, status = state

    t, y, h, ep, (ns2, na2, nr2, status) = integrate_interval(
        tail_step_err, t, y, h, ep, tout, params, err_order=err_order,
        max_steps=max_steps, global_size=global_size, carry0=tail_carry0,
        status0=status, sync_every=sync_every)
    return t, y, h, ep, (nstep + ns2, nacc + na2, nrej + nr2, status)


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


def make_normal_stream_plan(stops, breakpoints) -> dict:
    """Per-stop ARK_NORMAL plan: {float(stop): (free, cap)}
    (crdmodel_tpu/sim.py:673-691). stops: (stop time, is_output) pairs.

    free: integrate the interval freely (overshoot + dense output): output
    stops that are not breakpoints. Breakpoints (and outputs coinciding
    with one) stay exact clamped stops: the RHS is discontinuous there and
    interpolating across one would be wrong. cap: the next breakpoint
    strictly after this stop, which a free interval's overshoot must not
    cross (+inf when none lies ahead)."""
    bps = sorted(float(b) for b in breakpoints)
    plan = {}
    for stop, is_out in stops:
        s = float(stop)
        is_bp = any(np.isclose(s, b) for b in bps)
        cap = min([b for b in bps if b > s and not np.isclose(b, s)],
                  default=np.inf)
        plan[s] = (bool(is_out) and not is_bp, cap)
    return plan


class StopLoop:
    """The integration of integrate_to_outputs stop by stop: its set-up
    (the stops, the stepper, h0) and its per-stop body, shared by
    integrate_to_outputs and the streaming drivers (sim.py::
    simulate_streaming, parallel/sharded.py::simulate_sharded_streaming),
    so that a streaming run makes the same calls and takes the same steps.

    The arguments are integrate_to_outputs'. After construction, stop_times
    and is_output are merge_stops' (breakpoints merged into the outputs),
    and the loop state (t, y, h, errp, status and, in ARK_NORMAL, the
    bracket br_t, br_y) is that before the first stop: t0, y_loop0, h0
    estimated on the plain y0 through the composed rhs.
    """

    def __init__(self, rhs, y0, params, t0, touts, *, rtol, atol,
                 method="bs32", max_steps=200_000, global_size=None,
                 breakpoints=(), step_err=None, init_carry=None,
                 err_order=None, step_mode="tstop", n_members=0, spec_k=0,
                 kstep_call=None, rho_fn=None, h_limit_fn=None,
                 rhs_split=None, sync_fn=None, sync_every=SYNC_EVERY,
                 reduce_fn=None, y_loop0=None, capture=None):
        unported = {"n_members": n_members, "sync_fn": sync_fn}
        for name, value in unported.items():
            if value:
                raise NotImplementedError(f"{name} is not ported yet "
                                          "(ROADMAP queue 1, item 14)")
        if step_mode not in ("tstop", "normal"):
            raise ValueError(f"step_mode must be tstop|normal, got "
                             f"{step_mode!r}")
        if step_mode == "normal" and (spec_k or kstep_call is not None):
            raise ValueError("step_mode='normal' does not support "
                             "speculative K-step batching (its h sequence "
                             "is already output-schedule-free)")
        dtype, device = y0.dtype, y0.device
        if global_size is None:
            global_size = y0.numel()
        if y_loop0 is None:
            y_loop0 = y0
        self.capture = capture if capture is not None else (lambda y: y)
        if step_err is None:
            step_err, init_carry, err_order = make_stepper(
                method, rhs, rtol, atol, rho_fn, rhs_split)
        else:
            if err_order is None:
                err_order = TABLEAUS[method].err_order
            if init_carry is None:
                init_carry = lambda t, y, params: ()   # noqa: E731
        self.rhs, self.params = rhs, params
        self.step_err, self.init_carry = step_err, init_carry
        self.h_limit_fn, self.reduce_fn = h_limit_fn, reduce_fn
        self.kstep_call, self.spec_k = kstep_call, spec_k
        self.normal = step_mode == "normal"
        self.dtype, self.device = dtype, device
        self.common = dict(err_order=err_order, max_steps=max_steps,
                           global_size=global_size, sync_every=sync_every)

        self.stop_times, self.is_output = merge_stops(touts, breakpoints,
                                                      float(t0))
        self.stops = torch.tensor(self.stop_times, dtype=dtype, device=device)
        t = torch.tensor(t0, dtype=dtype, device=device)
        p0 = self.seg_params(0)
        f0 = rhs(t, y0, p0)
        h = _initial_step(rhs, t, y0, f0, p0, self.stops[0], rtol, atol,
                          err_order, global_size, reduce_fn)
        if h_limit_fn is not None:
            h = torch.minimum(h, h_limit_fn(t, y_loop0, p0).to(dtype))
        self.t, self.y, self.h = t, y_loop0, h
        self.errp = torch.ones((), dtype=dtype, device=device)
        self.status = torch.zeros((), dtype=torch.int32, device=device)
        if self.normal:
            plan = make_normal_stream_plan(
                zip(self.stop_times, self.is_output), breakpoints)
            self.use_free, self.caps = zip(*(plan[float(s)]
                                             for s in self.stop_times))
            self.br_t, self.br_y = t, self.y

    def seg_params(self, k: int) -> dict:
        # the RHS tells the segments apart by their end (the boundary freeze)
        return {**self.params, "_seg_end": self.stops[k]}

    def advance(self, k: int, first: bool) -> tuple:
        """Integrate to stop k; `first` relaxes the growth cap until the
        first accepted step (integrate_interval's first_interval). Returns
        the stop's (nstep, nacc, nrej, status), 0-d tensors."""
        dtype, device = self.dtype, self.device
        t, y, h, errp, status = self.t, self.y, self.h, self.errp, self.status
        tout, p = self.stops[k], self.seg_params(k)
        # fresh stepper cache per segment: the RHS may differ across a
        # breakpoint (freeze release)
        fc0 = self.init_carry(t, y, p)
        spec_k = int(self.spec_k or 0)
        if self.normal and self.use_free[k]:
            t, y, h, errp, (self.br_t, self.br_y), stats = \
                integrate_interval_free(
                    self.step_err, t, y, h, errp, tout, p, carry0=fc0,
                    bracket0=(self.br_t, self.br_y), first_interval=first,
                    status0=status, h_limit_fn=self.h_limit_fn,
                    t_cap=torch.tensor(self.caps[k], dtype=dtype,
                                       device=device),
                    reduce_fn=self.reduce_fn, **self.common)
        elif self.kstep_call is not None and spec_k > 1:
            t, y, h, errp, stats = integrate_interval_kernel_batched(
                self.kstep_call, spec_k, t, y, h,
                (errp, torch.ones_like(errp)), tout, p, status0=status,
                tail_step_err=self.step_err, tail_carry0=fc0, **self.common)
        elif spec_k > 1:
            t, y, h, errp, stats = integrate_interval_batched(
                self.step_err, spec_k, t, y, h,
                (errp, torch.ones_like(errp)), tout, p, carry0=fc0,
                status0=status, reduce_fn=self.reduce_fn, **self.common)
        else:
            t, y, h, errp, stats = integrate_interval(
                self.step_err, t, y, h, errp, tout, p, carry0=fc0,
                first_interval=first, status0=status,
                h_limit_fn=self.h_limit_fn, reduce_fn=self.reduce_fn,
                **self.common)
            if self.normal:
                # a clamped stop: the bracket is degenerate, the snapshot y
                self.br_t, self.br_y = t, y
        self.t, self.y, self.h, self.errp = t, y, h, errp
        self.status = stats[-1]
        return stats

    def output(self, k: int):
        """The state recorded at output stop k: capture(y) or, in
        ARK_NORMAL, cubic Hermite dense output on the plain fields (two rhs
        evaluations)."""
        if self.normal:
            return hermite_interpolate(self.rhs, self.br_t,
                                       self.capture(self.br_y), self.t,
                                       self.capture(self.y), self.stops[k],
                                       self.seg_params(k))
        return self.capture(self.y)


def integrate_to_outputs(rhs, y0, params, t0, touts, **kw):
    """Integrate through each output time and return the state at each
    (reference src/FHNmodel_torus.cpp:413-478).

    touts: increasing output times (t0 excluded). Returns (traj, stats):
    traj (len(touts), *y0.shape); stats tensors per output interval.
    Keyword arguments (StopLoop's): rtol, atol, method ("bs32"),
    max_steps (200000), global_size, breakpoints: times where the RHS is
    discontinuous in t; integration stops exactly there and the
    sub-interval's stats join the next output interval. step_err/init_carry/
    err_order: a caller-supplied stepper (the fused kernels,
    ops/fused_step.py, ops/fused_rkc.py and ops/fused_imex.py) in place of
    the torch-path stepper; h0 is always estimated on the plain y0 through
    the composed rhs. rho_fn: the spectral-radius bound the rkc2 stepper
    needs (core/problem.py::make_rho_bound). h_limit_fn(t, y, params): a
    hard cap on every attempted step, h0 included. rhs_split: the (f_ex,
    f_im) pair the ark324 stepper needs. reduce_fn: the sharded run's
    cross-shard sum (integrate_interval), also of h0's norms. y_loop0/
    capture: the state the loop carries when a fused kernel keeps its own
    layout (the shard kernels' halo-padded buffers), and the map back to
    what the trajectory records; by default y0 and the identity.
    sync_every: integrate_interval's.

    spec_k > 1: speculative K-step batches, through kstep_call (a K-step
    kernel, integrate_interval_kernel_batched; step_err is then its tail
    stepper) or on step_err (integrate_interval_batched).
    step_mode="normal": ARKode's ARK_NORMAL (crdmodel_tpu/integrate/
    erk.py:944-1020): steps run freely past each output, whose snapshot is
    cubic Hermite dense output on the plain fields (capture), while
    breakpoints stay exact stops: a stop on a breakpoint is clamped and no
    step crosses the next breakpoint. It takes no speculative batching.
    n_members and sync_fn raise NotImplementedError (ROADMAP queue 1,
    item 14).
    """
    loop = StopLoop(rhs, y0, params, t0, touts, **kw)
    device = loop.device
    traj, per_stop = [], []
    for k in range(len(loop.stop_times)):
        per_stop.append(torch.stack(loop.advance(k, first=(k == 0))))
        if loop.is_output[k]:
            traj.append(loop.output(k))

    per_stop = torch.stack(per_stop)          # (n_stops, 4)
    is_output = loop.is_output
    seg_ids = np.cumsum(is_output) - is_output.astype(int)
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
