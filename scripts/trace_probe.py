"""How often a torch.profiler trace on the card loses its kernels, and where
the kernels it keeps lie in the trace's window.

Each round takes one trace per pad: `--launches` calls of a small in-place
multiply inside the profiler, with `pad` seconds of sleep inside the window
before the first call and after the last synchronize. For every trace it
records the kernel events, the cudaLaunchKernel events, the window's span
(the "PyTorch Profiler" event) and, for each kernel, its start less its
launch's start (matched by correlation id) and its distance to the window's
ends. Writes one JSON line a trace to --out and prints, for each pad, the
traces, the empty ones, the ones that lost some kernels, and the offsets.

    python3 scripts/trace_probe.py --rounds 100 --out chiprun_out/probe.jsonl
    python3 scripts/trace_probe.py --rounds 50 --pads 0.02 --interval 8 \
        --busy      # the offsets over 7 minutes of a busy card
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile


def one_trace(fn, launches: int, pad: float, drain: bool = False,
              prime: int = 0) -> dict:
    torch.cuda.synchronize()
    if drain:
        with profile(activities=[ProfilerActivity.CUDA]):
            pass
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(prime):
            torch.cuda._sleep(1)
        if prime:
            torch.cuda.synchronize()
        if pad:
            time.sleep(pad)
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
        if pad:
            time.sleep(pad)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    window = [e for e in events if e.get("cat") == "Trace"]
    launch = {e["args"].get("correlation"): e for e in events
              if e.get("name") == "cudaLaunchKernel"}
    # the first `prime` launches are the spin kernels, the rest fn's
    order = sorted(launch)
    own = set(order[prime:])
    kernels = [e for e in events if e.get("cat") == "kernel"
               and e["args"].get("correlation") not in set(order[:prime])]
    kept = {e["args"].get("correlation") for e in kernels}
    start = window[0]["ts"] if window else None
    end = window[0]["ts"] + window[0]["dur"] if window else None
    return dict(
        pad=pad, drain=drain, prime=prime, launches=len(own),
        kernels=len(kernels),
        primes_kept=sum(e.get("cat") == "kernel"
                        and e["args"].get("correlation") in set(order[:prime])
                        for e in events),
        # how many of fn's launches, in launch order, lost their kernel
        # before the first that kept it
        lost_front=next((i for i, c in enumerate(order[prime:])
                         if c in kept), len(own)),
        names=sorted({e.get("name", "") for e in events
                      if e.get("cat") in ("cuda_runtime", "cuda_driver")}),
        kernel_minus_launch_us=[
            e["ts"] - launch[e["args"]["correlation"]]["ts"]
            for e in kernels if e["args"].get("correlation") in launch],
        foreign_kernels=sum(e["args"].get("correlation") not in launch
                            for e in kernels),
        window_us=(end - start) if window else None,
        after_start_us=[e["ts"] - start for e in kernels] if window else [],
        before_end_us=[end - e["ts"] - e["dur"] for e in kernels]
        if window else [])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--launches", type=int, default=3)
    ap.add_argument("--pads", default="0,0.005,0.05",
                    help="seconds of sleep at each end of the window")
    ap.add_argument("--interval", type=float, default=0.0,
                    help="seconds of idle host between rounds, to follow "
                         "the offsets over the process's life")
    ap.add_argument("--busy", action="store_true",
                    help="keep the card busy with matrix products through "
                         "each interval in place of idling")
    ap.add_argument("--drain", action="store_true",
                    help="also take each pad's trace right after an empty "
                         "profiler session")
    ap.add_argument("--primes", default="0",
                    help="numbers of spin kernels launched at the start of "
                         "the window, before fn's; one trace each")
    ap.add_argument("--out", default="chiprun_out/trace_probe.jsonl")
    args = ap.parse_args()
    variants = [(float(p), d, int(m)) for p in args.pads.split(",")
                for d in ((False, True) if args.drain else (False,))
                for m in args.primes.split(",")]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    print("torch", torch.__version__, "cuda", torch.version.cuda)
    x = torch.ones(1 << 22, device="cuda")

    a = torch.rand(4096, 4096, device="cuda")
    b = torch.rand(4096, 4096, device="cuda")

    def fn():
        x.mul_(1.0)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    rows = []
    t0 = time.perf_counter()
    with open(args.out, "w") as fh:
        for r in range(args.rounds):
            for pad, drain, prime in variants:
                row = one_trace(fn, args.launches, pad, drain, prime)
                row.update(round=r, t_s=time.perf_counter() - t0)
                fh.write(json.dumps(row) + "\n")
                rows.append(row)
            fh.flush()
            if args.interval and args.busy:
                until = time.perf_counter() + args.interval
                while time.perf_counter() < until:
                    for _ in range(20):
                        a = a @ b
                        a.div_(a.abs().amax() + 1.0)
                    torch.cuda.synchronize()
            elif args.interval:
                time.sleep(args.interval)
    for pad, drain, prime in variants:
        sel = [r for r in rows if (r["pad"], r["drain"], r["prime"])
               == (pad, drain, prime)]
        offs = np.array([o for r in sel for o in r["kernel_minus_launch_us"]]
                        or [np.nan])
        first = [r["after_start_us"] for r in sel if r["after_start_us"]]
        last = [r["before_end_us"] for r in sel if r["before_end_us"]]
        print(json.dumps(dict(
            pad=pad, drain=drain, prime=prime, traces=len(sel),
            empty=sum(r["kernels"] == 0 for r in sel),
            partial=sum(0 < r["kernels"] < r["launches"] for r in sel),
            max_lost_front=max(r["lost_front"] for r in sel),
            primes_kept_min=min(r["primes_kept"] for r in sel),
            empty_rounds=[r["round"] for r in sel if r["kernels"] == 0][:40],
            foreign=sum(r["foreign_kernels"] for r in sel),
            kernel_minus_launch_us=dict(
                min=float(np.nanmin(offs)), median=float(np.nanmedian(offs)),
                max=float(np.nanmax(offs))),
            min_after_start_us=float(min(min(f) for f in first))
            if first else None,
            min_before_end_us=float(min(min(b) for b in last))
            if last else None)))
    # the offsets over the process's life: the median kernel-minus-launch
    # offset and the nearest kernel to each window end, by tenth of the run
    span = max(r["t_s"] for r in rows) or 1.0
    for tenth in range(10):
        sel = [r for r in rows if tenth <= 10 * r["t_s"] / span < tenth + 1
               or (tenth == 9 and r["t_s"] == span)]
        offs = [o for r in sel for o in r["kernel_minus_launch_us"]]
        print(json.dumps(dict(
            t_s=[min((r["t_s"] for r in sel), default=None),
                 max((r["t_s"] for r in sel), default=None)],
            traces=len(sel), empty=sum(r["kernels"] == 0 for r in sel),
            lost_front=[r["lost_front"] for r in sel],
            median_kernel_minus_launch_us=float(np.median(offs))
            if offs else None,
            min_after_start_us=min((min(r["after_start_us"]) for r in sel
                                    if r["after_start_us"]), default=None),
            min_before_end_us=min((min(r["before_end_us"]) for r in sel
                                   if r["before_end_us"]), default=None))))


if __name__ == "__main__":
    main()
