"""Structured time-dependent forcing: stimulation protocols as data
(counterpart of crdmodel_tpu/core/forcing.py).

build_problem(cfg, forcing=fn) accepts any fn(t, state, params) -> dstate,
which the torch path evaluates at the true stage times. This module adds
the structured form the fused kernels evaluate in-kernel:
`SeparableForcing`, a sum of stimuli

    F_i(t, x, y) = waveform_i(t) * row_i(y) * col_i(x)     on variable var_i

(an electrode patch, a Gaussian stimulation site, a global pacing drive are
all rank-1 in space). The amplitudes waveform_i(t + c_s h) of a step's
stages are computed outside the kernel, on the device, and the kernel reads
them with the rank-1 profiles (ops/kernel_common.py::stage_amplitudes). A
stimulus with a full 2-D `spatial` field is accepted too; the kernels
decline it and the torch path evaluates it.

THE WAVEFORM CONTRACT. waveform(t, seg_end=None) takes a 0-d tensor on the
state's device (the integrator's time, in the state's dtype) and returns
one; it also works elementwise on a 1-d tensor of times, so that all of a
step's stage amplitudes cost a few launches, not one a stage. It never
reads a tensor to the host: no .item(), float() or Python `if` on a tensor.
The integrator keeps its control state on the device and reads it once
every integrate/erk.py::SYNC_EVERY iterations; a waveform that synchronises
would silently undo that. `pulse_train` below is one; a smooth drive is
any such expression, e.g. lambda t, seg_end=None: 0.1 * torch.sin(t).

S1-S2 pacing (the restitution / vulnerability protocol of cardiac
excitable media; the reference has no stimulation machinery, its only time
dependence is the t < tBoundary freeze, src/FHNmodel_torus.cpp:643-653) is
`s1s2_protocol`. SeparableForcing implements the generic forcing contract,
so every driver that handles forcing handles it; the freeze and the tissue
mask act on it like on every other RHS term.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Stimulus:
    """One forcing term: waveform(t) (the contract above) times a spatial
    profile, added to variable `var`'s RHS.

    Spatial form, one of:
      * row/col: rank-1 profiles ((ny,) / (nx,) numpy arrays, either may
        be None = uniform), which the fused kernels take;
      * spatial: a full (ny, nx) field, the torch path only.

    zprof: an optional (nz,) depth profile for the 3-D box (None = uniform
    through the slab), a rank-1 factor beside row/col. Box surfaces only.
    """
    waveform: Callable
    var: int = 0
    row: Optional[object] = None
    col: Optional[object] = None
    spatial: Optional[object] = None
    zprof: Optional[object] = None

    @property
    def separable(self) -> bool:
        return self.spatial is None


class SeparableForcing:
    """forcing(t, state, params) built from Stimulus terms.

    On a mesh the profiles are the shard's local slices, which a sharded
    driver registers in params ("_stim_row_{i}" (nyl, 1), "_stim_col_{i}"
    (1, nxl), or "_stim_{i}" (nyl, nxl) for a full field); __call__ takes
    those over the stimuli's arrays (crdmodel_tpu/core/forcing.py:
    SeparableForcing). The profiles of the whole grid are made into
    tensors once for each dtype and device.
    """

    def __init__(self, *stimuli: Stimulus):
        if not stimuli:
            raise ValueError("SeparableForcing needs at least one Stimulus")
        self.stimuli = tuple(stimuli)
        self._tensors = {}
        self._pulses = None      # (indices, PulseWindows) of the trains

    @property
    def separable(self) -> bool:
        return all(s.separable for s in self.stimuli)

    @property
    def breakpoints(self) -> tuple:
        """Known discontinuity times of the waveforms (e.g. pulse edges)."""
        pts = set()
        for s in self.stimuli:
            pts.update(getattr(s.waveform, "breakpoints", ()))
        return tuple(sorted(pts))

    def _tensor(self, key, array, shape, dtype, device):
        """`array` (float64 numpy) reshaped to `shape` as a tensor, made once
        for each (key, dtype, device)."""
        k = (key, dtype, device)
        if k not in self._tensors:
            self._tensors[k] = torch.tensor(
                np.asarray(array, np.float64).reshape(shape), dtype=dtype,
                device=device)
        return self._tensors[k]

    def _profile(self, i, s, state, params):
        dtype, device = state.dtype, state.device
        if isinstance(params, dict):
            if f"_stim_{i}" in params:
                return params[f"_stim_{i}"].to(dtype)
            if f"_stim_row_{i}" in params:
                pr = params[f"_stim_row_{i}"].to(dtype)
                pc = params[f"_stim_col_{i}"].to(dtype)
                return pr * pc
        if s.spatial is not None:
            return self._tensor(
                ("spatial", i),
                np.broadcast_to(np.asarray(s.spatial), state.shape[-2:]),
                state.shape[-2:], dtype, device)
        pr = (self._tensor(("row", i), s.row, (-1, 1), dtype, device)
              if s.row is not None else None)
        pc = (self._tensor(("col", i), s.col, (1, -1), dtype, device)
              if s.col is not None else None)
        if pr is None and pc is None:
            return torch.ones((), dtype=dtype, device=device)
        if pr is None:
            return pc
        if pc is None:
            return pr
        return pr * pc

    def _apply_z(self, i, s, prof, dtype, device):
        """Multiply in the optional (nz,) depth profile (3-D box states:
        prof broadcasts over z, zprof rides axis -3)."""
        if s.zprof is None:
            return prof
        return self._tensor(("z", i), s.zprof, (-1, 1, 1), dtype,
                            device) * prof

    def amplitudes(self, times, seg_end, dtype):
        """(n_stim, len(times)) amplitudes of the stimuli at the 1-d tensor
        `times`, contiguous, in `dtype`: the pulse trains (pulse_train's
        `pulses`) in one pass of their PulseWindows, at seg_end where it is
        given (the segment gate) else at the times; every other waveform
        on its own, a segment-gated one at seg_end. A step's amplitudes so
        cost a fixed few launches for all of its trains."""
        if self._pulses is None:
            idx = tuple(i for i, s in enumerate(self.stimuli)
                        if hasattr(s.waveform, "pulses"))
            self._pulses = (idx, PulseWindows(
                [self.stimuli[i].waveform.pulses for i in idx])
                if idx else None)
        idx, windows = self._pulses
        n, k = times.shape[0], len(self.stimuli)
        on = None
        if idx:
            ref = torch.as_tensor(times if seg_end is None else seg_end)
            on = windows(ref, gated=seg_end is not None).to(dtype)
            on = on.reshape(len(idx), -1).expand(len(idx), n)
            if len(idx) == k:
                return on.contiguous()
        rows = []
        for i, s in enumerate(self.stimuli):
            if i in idx:
                rows.append(on[idx.index(i)])
                continue
            if seg_end is not None and getattr(s.waveform, "segment_gated",
                                               False):
                a = s.waveform(times, seg_end=seg_end)
            else:
                a = s.waveform(times)
            rows.append(torch.as_tensor(a).to(dtype).expand(times.shape))
        return torch.stack(rows)

    def __call__(self, t, state, params):
        nvars = state.shape[0]
        dtype, device = state.dtype, state.device
        seg = params.get("_seg_end") if isinstance(params, dict) else None
        per_var = {}
        for i, s in enumerate(self.stimuli):
            if seg is not None and getattr(s.waveform, "segment_gated",
                                           False):
                amp = torch.as_tensor(s.waveform(t, seg_end=seg)).to(dtype)
            else:
                amp = torch.as_tensor(s.waveform(t)).to(dtype)
            contrib = amp * self._apply_z(
                i, s, self._profile(i, s, state, params), dtype, device)
            per_var[s.var] = (contrib if s.var not in per_var
                              else per_var[s.var] + contrib)
        zero = torch.zeros_like(state[0])
        return torch.stack([zero + per_var[v] if v in per_var else zero
                            for v in range(nvars)])


class PulseWindows:
    """The windows [t0, t0 + duration) of k pulse trains, evaluated in one
    pass whatever their number of pulses: (k, m) tensors of the windows'
    starts and ends (m the most pulses of a train, the rest padded with
    windows that start at +inf), made once for each dtype and device.
    Calling it on a tensor `ref` costs a fixed few launches and no host
    read: (ref > t0) & (ref <= t0 + dur) with the segment gate, (ref >=
    t0) & (ref < t0 + dur) without it (pulse_train), any over a train's
    windows, times its amplitude; t0 + dur is rounded once to the dtype,
    as a Python float is where it meets a tensor."""

    def __init__(self, trains):
        m = max(len(starts) for starts, _, _ in trains)
        self.lo = np.full((len(trains), m), np.inf)
        self.hi = np.full((len(trains), m), np.inf)
        for i, (starts, dur, _) in enumerate(trains):
            self.lo[i, :len(starts)] = starts
            self.hi[i, :len(starts)] = [t0 + dur for t0 in starts]
        self.amp = np.array([amp for _, _, amp in trains])
        self._tensors = {}

    def __call__(self, ref, gated):
        """(k, *ref.shape): each train's amplitude where the tensor `ref`
        lies in one of its windows, else 0."""
        dtype = ref.dtype if ref.is_floating_point() else torch.float32
        key = (dtype, ref.device)
        if key not in self._tensors:
            self._tensors[key] = tuple(
                torch.tensor(a, dtype=dtype, device=ref.device)
                for a in (self.lo, self.hi, self.amp))
        lo, hi, amp = self._tensors[key]
        shape = (lo.shape[0],) + (1,) * ref.dim() + (lo.shape[1],)
        lo, hi, r = lo.view(shape), hi.view(shape), ref[..., None]
        hit = (r > lo) & (r <= hi) if gated else (r >= lo) & (r < hi)
        return amp.view(shape[:-1]) * hit.any(-1).to(dtype)


def pulse_train(t_starts: Sequence[float], duration: float,
                amplitude: float = 1.0):
    """waveform(t, seg_end=None): `amplitude` inside any [t0, t0+duration)
    window, else 0: square stimulation pulses, on the device, elementwise,
    in a fixed few launches whatever the number of pulses (PulseWindows).

    SEGMENT GATING (the freeze's device, core/problem.py): the edges are
    registered as integrator breakpoints, so segments never straddle
    them, and when the caller supplies the segment end (the drivers pass
    params["_seg_end"]) the pulse is on iff the whole segment lies inside
    a window (seg_end in (t0, t0+dur]); the amplitude is then constant over
    a step and the pulse's integral over every segment exact. Without the
    gate a stage evaluated exactly at a left edge (the last stage of the
    segment before the pulse lands on t0) would see the jump and reject
    the controller into dt-underflow (crdmodel_tpu/core/forcing.py::
    pulse_train). With seg_end the result takes t's shape. The train's
    data stays on the waveform as `pulses` = (starts, duration,
    amplitude), so that SeparableForcing.amplitudes evaluates all of a
    forcing's trains in one pass."""
    starts = tuple(float(t0) for t0 in t_starts)
    dur = float(duration)
    amp = float(amplitude)
    windows = PulseWindows(((starts, dur, amp),))

    def waveform(t, seg_end=None):
        ref = torch.as_tensor(t if seg_end is None else seg_end)
        out = windows(ref, gated=seg_end is not None)[0]
        if seg_end is not None and isinstance(t, torch.Tensor):
            out = out.expand(torch.broadcast_shapes(t.shape, out.shape))
        return out

    # pulse edges are RHS discontinuities in t: the drivers register them
    # as integrator breakpoints (core/problem.py::solver_breakpoints)
    waveform.breakpoints = tuple(sorted(
        {t0 for t0 in starts} | {t0 + dur for t0 in starts}))
    waveform.segment_gated = True
    waveform.pulses = (starts, dur, amp)
    return waveform


def rect_profile(n: int, lo: int, hi: int) -> np.ndarray:
    """0/1 profile over [lo, hi) of an n-point axis."""
    p = np.zeros(n)
    p[lo:hi] = 1.0
    return p


def gaussian_profile(n: int, center: float, sigma: float) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    return np.exp(-0.5 * ((i - center) / sigma) ** 2)


def s1s2_protocol(cfg, amplitude: float, s1_times: Sequence[float],
                  s2_time: float, duration: float,
                  s1_rows=None, s2_cols=None, var: int = 0
                  ) -> SeparableForcing:
    """The standard S1-S2 cross-field stimulation protocol:

      S1: pacing pulses at `s1_times` on a row band (default the bottom
          eighth of the domain: a line electrode);
      S2: one premature pulse at `s2_time` on a column band (default the
          left half): the cross-gradient that elicits a spiral when timed
          into the vulnerable window.
    """
    ny, nx = cfg.ny, cfg.nx
    s1_rows = s1_rows if s1_rows is not None else (0, max(1, ny // 8))
    s2_cols = s2_cols if s2_cols is not None else (0, max(1, nx // 2))
    s1 = Stimulus(waveform=pulse_train(s1_times, duration, amplitude),
                  var=var, row=rect_profile(ny, *s1_rows))
    s2 = Stimulus(waveform=pulse_train([s2_time], duration, amplitude),
                  var=var, col=rect_profile(nx, *s2_cols))
    return SeparableForcing(s1, s2)
