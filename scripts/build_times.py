"""Per-source nvcc seconds of the port's CUDA build.

    python3 scripts/build_times.py [--jobs N[,N...]] [--out FILE]

Compiles every crdmodel_tpu_torch/csrc/*.cu with ops/_build.py's flags
as the build does (one nvcc a source, build_jobs() of them at once, in
the sources' order), into a temporary directory, and prints one JSON
line: each source's seconds from the common start to its nvcc's end, the
slowest source (the build's compile wall), the machine's CPU count and
the card's name and power limit. With --jobs, one such build and line a
value of nvcc processes at once (e.g. 8,24: a CPU's worth against every
source at once). Needs nvcc; builds nothing the package loads.
"""

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from crdmodel_tpu_torch.ops import _build  # noqa: E402


def time_build(nvcc, cus, jobs):
    """{source: seconds from the common start to its nvcc's end} of one
    compile of `cus`, `jobs` nvcc processes at once in the sources' order."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()

        def compile_one(src):
            rc = subprocess.run(
                [nvcc, *_build.NVCC_FLAGS, "-c", "-o",
                 os.path.join(tmp, os.path.basename(src) + ".o"), src],
                stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL).returncode
            if rc != 0:
                sys.exit(f"nvcc failed on {src}")
            return os.path.basename(src), time.perf_counter() - t0

        with concurrent.futures.ThreadPoolExecutor(jobs) as pool:
            return dict(pool.map(compile_one, cus))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the lines here")
    ap.add_argument("--jobs", default=None,
                    help="nvcc processes at once, one build a value, "
                         "joined by commas (default: the build's, "
                         "build_jobs())")
    args = ap.parse_args()
    nvcc = _build._nvcc()
    cus = [s for s in _build._sources() if s.endswith(".cu")]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    lines = []
    for jobs in ([int(j) for j in args.jobs.split(",")] if args.jobs
                 else [_build.build_jobs()]):
        seconds = time_build(nvcc, cus, jobs)
        slowest = max(seconds, key=seconds.get)
        lines.append(json.dumps({
            "jobs": jobs, "nvcc_seconds": dict(sorted(
                seconds.items(), key=lambda kv: -kv[1])),
            "slowest": slowest, "wall_s": seconds[slowest],
            "cpus": os.cpu_count(), "card": card}))
        print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
