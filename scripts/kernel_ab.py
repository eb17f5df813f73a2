"""Time the port's K14 and K2 kernels of one tree on the card, or of two
trees in turns in one call.

    python3 scripts/kernel_ab.py [--tree DIR] [--label NAME] [--runs]
    python3 scripts/kernel_ab.py --compare OTHER_DIR [--runs]

One tree: imports crdmodel_tpu_torch and chip_smoke.py from DIR (default:
this checkout), builds its kernels and prints one JSON line a measurement:
K14 (bs32, f32, the canonical FHN torus's (2,1600,400), a random state) at
K = 2, 5, 10 (device time from profiler traces, a sub-step's share, and a
burst's time a launch from CUDA events); K2 (f32, unfrozen) at
(2,1600,400) and at the wide sheet's (2,12800,3200) for s = 5, 9, 23
(CUDA events around bursts). With --runs also the wide FHN sheet's run
through simulate() (wall, steps, K2's mean device time a launch from a
traced second run) and the canonical FHN torus with speculative_k = 5
over Tf = 5 (chip_smoke.profile_run: device-busy time, kernels a step,
idle share). Only the wrappers' public signatures are used, so an older
tree of the port times the same way.

--compare OTHER_DIR runs OTHER_DIR, this checkout, this checkout,
OTHER_DIR (each in its own process) and prints the lines of all four,
each tagged with its tree, then a summary line with each measurement's
mean over the two runs of a tree. Compare two trees only within one call:
card and host speed vary between calls. Needs a CUDA card; imports nothing
of JAX.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K14_KS = (2, 5, 10)
K2_STAGES = (5, 9, 23)
K2_SAMPLES = {"canonical": (60, 10), "wide": (5, 3)}


def emit(label, name, **fields):
    print(json.dumps({"tree": label, "measure": name, **fields}), flush=True)


def time_one_tree(tree, label, runs):
    sys.path.insert(0, tree)
    os.chdir(tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from crdmodel_tpu_torch.config import config_from_ini
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import _build, fused_kstep, fused_rkc
    from crdmodel_tpu_torch.ops.kernel_common import prepare_constants

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: kernel_ab.py needs an NVIDIA GPU")
    card = cs.card_line()
    emit(label, "build", seconds=_build.build(), card=card,
         ptxas_fused_kstep=cs.ptxas_summary("fused_kstep.cu"),
         ptxas_fused_rkc=cs.ptxas_summary("fused_rkc.cu"))

    cfg = config_from_ini(cs.INI, model="fhn", surface="torus")
    problem = build_problem(cfg, device="cuda")
    kc = prepare_constants(problem, torch.float32, "cuda")
    y = torch.tensor(cs.random_state(cfg, tuple(problem.y0.shape),
                                     np.random.default_rng(cs.SEED + 15)),
                     dtype=torch.float32, device="cuda")
    h = torch.tensor(cs.H, dtype=torch.float32, device="cuda")
    fz = torch.zeros((), dtype=torch.float32, device="cuda")
    tab = TABLEAUS["bs32"]
    for k in K14_KS:
        n = torch.tensor(k, dtype=torch.int32, device="cuda")

        def launch():
            return fused_kstep.fused_kstep(y, h, fz, n, kc, tab, k, cfg.rtol,
                                           cfg.atol)

        ms = cs.device_ms(launch, "fused_kstep_kernel")
        emit(label, "k14", shape=list(y.shape), k=k, kernel_us=ms * 1e3,
             kernel_us_per_substep=ms * 1e3 / k,
             burst_us=cs.median_ms(launch) * 1e3, card=card)
    del y

    mu1, ctab = fused_rkc.static_stage_tables(fused_rkc.S_MAX_KERNEL,
                                              torch.float32, "cuda")
    for shape, c in (("canonical", dataclasses.replace(cfg, method="rkc2")),
                     ("wide", cs.wide_sheet())):
        problem = build_problem(c, device="cuda")
        kc = prepare_constants(problem, torch.float32, "cuda")
        y = problem.y0.contiguous()
        rho = cs.problem_rho(problem, y)
        for s in K2_STAGES:
            hs, st = cs.rkc_step_inputs(s, rho, torch.float32)
            args = (y, hs, fz, st, mu1, ctab, kc, c.rtol, c.atol)
            ms = cs.median_ms(lambda: fused_rkc.fused_rkc_step(*args),
                              *K2_SAMPLES[shape])
            emit(label, "k2", shape=list(y.shape), s=s, kernel_us=ms * 1e3,
                 card=card)
        del y, problem, kc

    if not runs:
        return
    wide = cs.wide_sheet()
    cs.run_program(dataclasses.replace(wide, t_final=0.05), {})   # warm-up
    res = cs.run_program(wide, {})
    steps, wall = res.total_steps(), res.wall_time
    del res
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cs.run_program(wide, {})
        torch.cuda.synchronize()
    k2 = [e["dur"] for e in cs.traced_kernels(prof)
          if "fused_rkc" in e["name"]]
    emit(label, "wide_run", steps=steps, wall_s=wall,
         k2_launches_traced=len(k2), k2_mean_device_us=float(np.mean(k2)),
         card=card)
    fields = cs.profile_run(dataclasses.replace(cfg, speculative_k=5), {},
                            5.0, "fused_kstep_kernel")
    emit(label, "kstep_run", **{k: fields[k] for k in (
        "steps", "wall_s", "untraced_wall_s", "device_busy_ms",
        "kernels_per_step", "device_idle_share", "kernel_launches",
        "kernel_mean_us")}, card=card)


def compare(other, runs):
    order = [(other, "other"), (HERE, "this"), (HERE, "this"),
             (other, "other")]
    lines = []
    for tree, label in order:
        cmd = [sys.executable, os.path.abspath(__file__), "--tree", tree,
               "--label", label] + (["--runs"] if runs else [])
        proc = subprocess.run(cmd, capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            sys.exit(f"kernel_ab.py --tree {tree} failed "
                     f"({proc.returncode})")
        lines += [rec for rec in (json.loads(line) for line in
                                  proc.stdout.splitlines()
                                  if line.startswith("{"))
                  if "tree" in rec]
    summary = {}
    for rec in lines:
        key = "/".join(str(rec[f]) for f in ("measure", "k", "s", "shape")
                       if f in rec)
        for f in ("kernel_us", "kernel_us_per_substep", "wall_s",
                  "k2_mean_device_us", "device_busy_ms", "kernels_per_step"):
            if f in rec:
                summary.setdefault(f"{key}/{f}", {}).setdefault(
                    rec["tree"], []).append(rec[f])
    print(json.dumps({"summary": {
        k: {t: sum(v) / len(v) for t, v in trees.items()}
        for k, trees in summary.items()}}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--label", default="this")
    ap.add_argument("--compare", metavar="OTHER_DIR")
    ap.add_argument("--runs", action="store_true")
    args = ap.parse_args()
    if args.compare:
        compare(os.path.abspath(args.compare), args.runs)
    else:
        time_one_tree(os.path.abspath(args.tree), args.label, args.runs)


if __name__ == "__main__":
    main()
