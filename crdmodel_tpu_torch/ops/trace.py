"""Kernel names and device times from torch.profiler traces that are
checked whole.

On the H100 a torch.profiler trace can lose kernels in two ways
(scripts/trace_probe.py):

- Its device timestamps, put on the host's clock, are off by a few ms,
  differently in each trace, and the profiler keeps only the kernels that
  fall inside its window, so a window of a few launches lost some or all
  of its kernels now and then. Every trace here opens `PAD_S` before the
  first call and closes `PAD_S` after the last kernel has finished.
- Once the card has been busy outside the profiler, each trace loses the
  kernels of its first launches, while it keeps every launch on the
  host's side: one more launch about every 20 s of a busy card (0 to 8
  over 186 s on an H100 80GB HBM3 with torch 2.11 and CUDA 12.8), so a
  short trace late in a long process comes back empty. Padding and an
  empty profiler session before the trace do not bring them back.

So every trace opens with `prime` launches of a one-element fill (the
primers) and checks itself: each launch after the primers (matched by
its correlation id) must have its kernel in the trace. A trace that
lost any is taken again with `PRIME_GROWTH` times as many primers, up to
`attempts` traces, and a query raises only if none came back whole.

  own_kernels     the kernels of a trace's launches after its primers, and
                  how many of those launches lost their kernel
  traced          run a body in a checked trace: (its kernels, its result)
  kernel_names    the names of the kernels that n calls of fn ran
  device_ms       the median device time of the kernels whose name holds
                  a tag (or of a call's `group` of them) over n calls of fn
  device_events   the kernels and memory copies of one trace, unchecked

Only for a CUDA card: torch and torch.profiler are imported inside the
functions that trace; own_kernels reads a trace's events and runs
anywhere.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time

import numpy as np

ATTEMPTS = 4
PAD_S = 0.02        # s of idle trace before the first call and after the last
PRIME = 64          # primer launches that open a trace's first attempt
PRIME_GROWTH = 8    # the primers of each next attempt, as a multiple

# the host-side calls that launch one kernel each
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                "cudaLaunchCooperativeKernel", "cuLaunchKernel",
                "cuLaunchKernelEx")


def own_kernels(events: list, prime: int) -> tuple:
    """The kernels of a trace's chrome-trace `events` that its launches
    after the first `prime` ones ran (category "kernel", in trace order),
    and how many of those launches have no kernel in the trace. Launches
    and kernels are matched by their correlation ids, which grow with the
    launches; a trace that holds fewer than `prime` launches lost all of
    them."""
    launches = sorted(e["args"]["correlation"] for e in events
                      if e.get("name") in LAUNCH_CALLS
                      and "correlation" in e.get("args", {}))
    if len(launches) < prime:
        return [], 1
    primers = set(launches[:prime])
    kernels = [e for e in events if e.get("cat") == "kernel"
               and e.get("args", {}).get("correlation") not in primers]
    ran = {e["args"].get("correlation") for e in kernels}
    return kernels, sum(c not in ran for c in launches[prime:])


@contextlib.contextmanager
def _window(cpu: bool, prime: int):
    """A torch.profiler trace of the CUDA kernels (and the host's ops with
    cpu) of the body: `prime` primer launches, then `PAD_S` of idle
    window before the body and after its last kernel has finished; yields
    the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    spin = torch.empty(1, device="cuda")
    torch.cuda.synchronize()        # no earlier work in the window
    with profile(activities=activities) as prof:
        for _ in range(prime):
            spin.zero_()
        torch.cuda.synchronize()
        time.sleep(PAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(PAD_S)


def _events(prof) -> list:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return json.load(fh)["traceEvents"]


def traced(body, cpu: bool = False, attempts: int = ATTEMPTS) -> tuple:
    """Run body() inside a padded, primed torch.profiler trace (with the
    host's ops too with cpu) until a trace holds the kernel of every
    launch that body made: (those kernels, body's result). Each next
    attempt runs body again, with PRIME_GROWTH times as many primers;
    raises AssertionError if no trace of `attempts` came back whole.
    `traced.taken` counts the traces taken, `traced.retaken` those taken
    again after one that lost kernels."""
    prime = PRIME
    for attempt in range(attempts):
        with _window(cpu, prime) as prof:
            result = body()
        kernels, lost = own_kernels(_events(prof), prime)
        traced.taken += 1
        traced.retaken += attempt > 0
        if not lost:
            return kernels, result
        prime *= PRIME_GROWTH
    raise AssertionError(f"{attempts} traces, the last with "
                         f"{prime // PRIME_GROWTH} primers, each lost the "
                         f"kernels of some launches ({lost} in the last)")


traced.taken = 0
traced.retaken = 0


def kernel_names(fn, n: int = 3, attempts: int = ATTEMPTS) -> list:
    """The names of the device kernels that n calls of fn ran, from a
    trace that holds them all (traced). Raises AssertionError if the calls
    launched no kernel."""
    kernels, _ = traced(lambda: [fn() for _ in range(n)],
                        attempts=attempts)
    if not kernels:
        raise AssertionError(f"{n} calls launched no kernel")
    return [e["name"] for e in kernels]


def device_ms(fn, tag: str, n: int = 60, attempts: int = ATTEMPTS,
              group: int = 1) -> float:
    """The median device duration in ms of the kernels whose name holds
    `tag` over n + n // 2 + 2 calls of fn, after one untraced call, from a
    trace that holds every kernel of them (traced): a kernel's own time
    where the host's issue of each call takes longer than the kernel.
    With `group` > 1, each call launches that many such kernels, and the
    time is a call's: their sum over the trace a call. Raises
    AssertionError if the calls launched fewer than n tagged kernels."""
    import torch

    fn()
    torch.cuda.synchronize()
    calls = n + n // 2 + 2
    kernels, _ = traced(lambda: [fn() for _ in range(calls)],
                        attempts=attempts)
    durations = [e["dur"] for e in kernels if tag in e["name"]]
    if len(durations) < n:
        raise AssertionError(f"{calls} calls launched {len(durations)} "
                             f"{tag} kernels")
    if group == 1:
        return float(np.median(durations)) / 1e3
    return float(sum(durations)) / calls / 1e3


def device_events(body, prime: int = PRIME) -> tuple:
    """(the device's kernel and memory-copy events of one padded, primed
    trace of body(), in trace order; body's result). Unlike traced, the
    trace is not checked whole: for measurements that read copies beside
    the kernels, such as a copy's overlap with the kernels of another
    stream."""
    with _window(False, prime) as prof:
        result = body()
    events = [e for e in _events(prof)
              if e.get("cat") in ("kernel", "gpu_memcpy")]
    return events, result
