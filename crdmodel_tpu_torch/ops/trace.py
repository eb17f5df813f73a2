"""Kernel names and device times from torch.profiler traces, padded and
pooled.

A trace's device timestamps, put on the host's clock, are off by up to a
few ms, differently in each trace, on the H100 (kernels placed up to 4.1
ms before their own launch; scripts/trace_probe.py), and the profiler
keeps only the kernels that fall inside its window. A window of a few
launches (1-2 ms) so lost all of its kernels now and then, or some of
them (one empty and one short trace in each 40-150 such probe traces).
So every trace here opens `PAD_S` before the first call and closes
`PAD_S` after the last kernel has finished (`window`): no kernel of 390
probe traces padded by 5, 20 or 50 ms fell outside. Both queries still
take up to `attempts` traces of the same calls and pool what they hold,
and raise only if every trace comes back empty (kernel_names) or too
short (device_ms).

  window          a padded torch.profiler trace around a block of calls
  traced_kernels  the device kernels of one finished trace
  kernel_names    the names of the kernels that n calls of fn ran
  device_ms       the median device time of the kernels whose name holds
                  a tag (or of a call's `group` of them), over at least n
                  calls of fn

Only for a CUDA card: torch.profiler is imported inside the functions.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time

import numpy as np

ATTEMPTS = 4
PAD_S = 0.02    # s of idle trace before the first call and after the last


def traced_kernels(prof) -> list:
    """The device kernels of a torch.profiler trace: its chrome-trace events
    of category "kernel", with their names and durations in µs."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    return [e for e in events if e.get("cat") == "kernel"]


@contextlib.contextmanager
def window(cpu: bool = False):
    """A torch.profiler trace of the CUDA kernels (and the host's ops with
    cpu) of the body, with `PAD_S` of idle window before the body and
    after its last kernel has finished; yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    torch.cuda.synchronize()        # no earlier work in the window
    with profile(activities=activities) as prof:
        time.sleep(PAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(PAD_S)


def _trace(fn, calls: int) -> list:
    """The device kernels of one trace of `calls` calls of fn."""
    with window() as prof:
        for _ in range(calls):
            fn()
    return traced_kernels(prof)


def kernel_names(fn, n: int = 3, attempts: int = ATTEMPTS) -> list:
    """The names of the device kernels that calls of fn ran, from the first
    of up to `attempts` traces that holds any: n calls, then three times
    as many in each next trace (the short traces are the ones that come
    back empty). Raises AssertionError if every trace is empty."""
    calls = n
    for _ in range(attempts):
        names = [e["name"] for e in _trace(fn, calls)]
        if names:
            return names
        calls *= 3
    raise AssertionError(f"{attempts} traces of {n} to {calls // 3} calls "
                         "held no kernel")


def device_ms(fn, tag: str, n: int = 60, attempts: int = ATTEMPTS,
              group: int = 1) -> float:
    """The median device duration in ms of the kernels whose name holds
    `tag` over at least n calls of fn: a kernel's own time where the host's
    issue of each call takes longer than the kernel. Each trace takes n +
    n // 2 + 2 calls after one untraced call, and the kernels of up to
    `attempts` traces are pooled until they number n; raises
    AssertionError if they never do. With `group` > 1, each call launches
    that many such kernels, and a call's time is the mean over a trace's
    calls of their sum (the traces on the H100 gained or lost a kernel of
    such steps now and then, so pairing them in launch order misled): the
    median over the traces, at least n calls' worth."""
    import torch

    fn()
    torch.cuda.synchronize()
    calls = n + n // 2 + 2
    durations = []
    for _ in range(attempts):
        kernels = [e["dur"] for e in _trace(fn, calls) if tag in e["name"]]
        if group == 1:
            durations += kernels
        elif kernels:
            durations += [sum(kernels) / calls] * calls
        if len(durations) >= n:
            return float(np.median(durations)) / 1e3
    raise AssertionError(f"traced {len(durations)} {tag} kernels of "
                         f"{attempts * calls} calls")
