"""Per-source nvcc seconds of the port's CUDA build.

    python3 scripts/build_times.py [--out FILE]

Compiles every crdmodel_tpu_torch/csrc/*.cu with ops/_build.py's flags,
all at once as the build does (one nvcc a source, in parallel), into a
temporary directory, and prints one JSON line: each source's seconds from
the common start to its nvcc's end, the slowest source (the build's
compile wall), the machine's CPU count and the card's name and power
limit. Needs nvcc; builds nothing the package loads.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from crdmodel_tpu_torch.ops import _build  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the line here")
    args = ap.parse_args()
    nvcc = _build._nvcc()
    cus = [s for s in _build._sources() if s.endswith(".cu")]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = {os.path.basename(src): subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-c", "-o",
             os.path.join(tmp, os.path.basename(src) + ".o"), src],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            for src in cus}
        seconds, pending = {}, dict(procs)
        while pending:
            for name, proc in list(pending.items()):
                if proc.poll() is not None:
                    if proc.returncode != 0:
                        sys.exit(f"nvcc failed on {name}")
                    seconds[name] = time.perf_counter() - t0
                    del pending[name]
            time.sleep(0.05)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    slowest = max(seconds, key=seconds.get)
    line = json.dumps({"nvcc_seconds": dict(sorted(seconds.items(),
                                                   key=lambda kv: -kv[1])),
                       "slowest": slowest, "wall_s": seconds[slowest],
                       "cpus": os.cpu_count(), "card": card})
    print(line)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")


if __name__ == "__main__":
    main()
