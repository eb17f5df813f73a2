"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from crdmodel_tpu_torch/csrc, holds each against its
plain PyTorch version on the card (K1, the fused ERK step, with the
FitzHugh-Nagumo and Goldbeter kinetics; K2, the fused RKC2 step; K3, the
fused IMEX ark324 step), times each, then runs the port's main paths
through simulate(): the canonical FitzHugh-Nagumo torus program
(data/FHNmodelArgs.ini: 400x1600, f32, Tf=50) with its own method bs32
(through K1) and with method rkc2 (through K2), and the canonical Goldbeter
torus program (data/GoldbeterModelArgs.ini: 100x400, f32, Tf=4) with its
own method bs32 (through K1) and with method ark324 (through K3). Each run
is checked against the JAX package's CPU runs recorded in
tests/golden/torch_canonical_{fhn,goldbeter}[_method]_probes.npz. Exits
non-zero on any failure, and prints as its last line {"ok": true,
"device": {...}} only when every phase passed. Imports nothing of JAX.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
INI = os.path.join(ROOT, "data", "FHNmodelArgs.ini")
GB_INI = os.path.join(ROOT, "data", "GoldbeterModelArgs.ini")
PROBES = {(model, method): os.path.join(
              ROOT, "tests", "golden",
              f"torch_canonical_{model}{tag}_probes.npz")
          for model, method, tag in (
              ("fhn", "bs32", ""), ("fhn", "rkc2", "_rkc2"),
              ("goldbeter", "bs32", ""), ("goldbeter", "ark324", "_ark324"))}
SEED = 1234
H = 2e-3        # about 1/rho(L) on the canonical grid: stage errors resolved
K2_STAGES = (2, 5, 15, 23)   # K2's stage counts checked, up to S_MAX_KERNEL
K2_TIMED_STAGES = (5, 23)    # an accuracy-limited and a stability-bound step
# K3's steps: the canonical Goldbeter ark324 run's typical step (4/1561),
# and one where the implicit part carries the step
K3_H = (2.5e-3, 2e-2)
K3_BIG_MESH = 800   # (2,3200,800): the JAX suite's "Goldbeter torus
                    # 800x3200 Tf=1 ark324" row (scripts/bench_suite.py:124)
N_TIMED = 60    # timed samples (median reported)
BURST = 10      # back-to-back calls per sample
# kernel vs plain version: f64 parity tool, f32 production tolerance
LIMITS = {torch.float64: (1e-12, 1e-10), torch.float32: (2e-5, 1e-3)}


def phase(name, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def median_ms(fn, n=N_TIMED, per_sample=BURST):
    """Median over n samples of the time of one call of fn, from CUDA
    events around a burst of back-to-back calls (one call alone on an idle
    card would also time the host issuing it)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_sample):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / per_sample)
    return float(np.median(times))


def random_state(cfg, shape, rng):
    """A random state on the card's main-path shape: FHN's u and v in
    [-2, 2], Goldbeter's concentrations in [0.1, 2.5]."""
    if cfg.model == "goldbeter":
        return rng.uniform(0.1, 2.5, shape)
    return rng.uniform(-2.0, 2.0, shape)


def check_kernel(cases):
    """K1 against its plain version at the main paths' shapes, for each
    config of `cases` (the FHN torus first); returns the max errors and the
    two times at the canonical FHN bs32 shape."""
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import fused_step as fs
    from crdmodel_tpu_torch.ops.kernel_common import prepare_constants

    rng = np.random.default_rng(SEED)
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    timing = None
    for cfg in cases:
        problem = build_problem(cfg, device="cuda")
        y_np = random_state(cfg, tuple(problem.y0.shape), rng)
        for dtype in (torch.float32, torch.float64):
            kc = prepare_constants(problem, dtype, "cuda")
            y = torch.tensor(y_np, dtype=dtype, device="cuda")
            h = torch.tensor(H, dtype=dtype, device="cuda")
            y_scale = max(1.0, float(y.abs().max()))
            tol_y, tol_ss = LIMITS[dtype]
            for method in ("bs32", "dopri54"):
                tab = TABLEAUS[method]
                for fz in (0.0, 1.0):
                    fzt = torch.tensor(fz, dtype=dtype, device="cuda")
                    args = (y, h, fzt, kc, tab, cfg.rtol, cfg.atol)
                    y_k, ss_k = fs.fused_step(*args)
                    y_k2, ss_k2 = fs.fused_step(*args)
                    y_r, ss_r = fs.fused_step_reference(*args)
                    torch.cuda.synchronize()
                    if not (torch.equal(y_k, y_k2) and torch.equal(ss_k, ss_k2)):
                        raise AssertionError("two launches differ")
                    err = float((y_k - y_r).abs().max())
                    sk, sr = float(ss_k.sum()), float(ss_r.sum())
                    rel = abs(sk - sr) / sr
                    phase("k1_check", model=cfg.model, surface=cfg.surface,
                          beta="field" if kc.b_is_field else "scalar",
                          dtype=str(dtype), method=method, fz=fz,
                          max_abs_err=err, limit=tol_y * y_scale,
                          ss_rel_err=rel, ss_limit=tol_ss)
                    if not (np.isfinite(sk) and err <= tol_y * y_scale
                            and rel <= tol_ss):
                        raise AssertionError("K1 disagrees with its plain "
                                             "version")
                    worst[dtype] = max(worst[dtype], err)
            if cfg is cases[0] and dtype == torch.float32:
                args = (y, h, torch.zeros((), dtype=dtype, device="cuda"),
                        kc, TABLEAUS[cfg.method], cfg.rtol, cfg.atol)
                timing = (median_ms(lambda: fs.fused_step(*args)),
                          median_ms(lambda: fs.fused_step_reference(*args)))
    return worst, timing


def check_rkc_kernel(cfg_torus, cfg_flat):
    """K2 against its plain version at the main path's shape, for each of
    K2_STAGES with h the stability coverage of s - 1 stages; returns the f32
    max error and {s: (kernel ms, plain ms)} at the canonical shape."""
    from crdmodel_tpu_torch.core.problem import build_problem, make_rho_bound
    from crdmodel_tpu_torch.ops import fused_rkc as fr
    from crdmodel_tpu_torch.ops.kernel_common import prepare_constants

    rng = np.random.default_rng(SEED + 1)
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    timing = {}
    for cfg in (cfg_torus, cfg_flat):
        problem = build_problem(cfg, device="cuda")
        y_np = rng.uniform(-2.0, 2.0, tuple(problem.y0.shape))
        for dtype in (torch.float32, torch.float64):
            kc = prepare_constants(problem, dtype, "cuda")
            mu1, ctab = fr.static_stage_tables(fr.S_MAX_KERNEL, dtype, "cuda")
            y = torch.tensor(y_np, dtype=dtype, device="cuda")
            rho = float(make_rho_bound(cfg, problem.model, problem.geometry,
                                       dtype)(0.0, y, problem.params))
            y_scale = max(1.0, float(y.abs().max()))
            tol_y, tol_ss = LIMITS[dtype]
            for s in K2_STAGES:
                h = torch.tensor(0.65 * (s - 1) ** 2 / rho, dtype=dtype,
                                 device="cuda")
                st = torch.tensor(s, dtype=torch.int32, device="cuda")
                for fz in (0.0, 1.0):
                    fzt = torch.tensor(fz, dtype=dtype, device="cuda")
                    args = (y, h, fzt, st, mu1, ctab, kc, cfg.rtol, cfg.atol)
                    y_k, ss_k = fr.fused_rkc_step(*args)
                    y_k2, ss_k2 = fr.fused_rkc_step(*args)
                    y_r, ss_r = fr.fused_rkc_step_reference(*args)
                    torch.cuda.synchronize()
                    if not (torch.equal(y_k, y_k2) and torch.equal(ss_k, ss_k2)):
                        raise AssertionError("two K2 launches differ")
                    err = float((y_k - y_r).abs().max())
                    sk, sr = float(ss_k.sum()), float(ss_r.sum())
                    rel = abs(sk - sr) / sr
                    phase("k2_check", surface=cfg.surface,
                          beta="field" if kc.b_is_field else "scalar",
                          dtype=str(dtype), s=s, fz=fz, max_abs_err=err,
                          limit=tol_y * y_scale, ss_rel_err=rel,
                          ss_limit=tol_ss)
                    if not (np.isfinite(sk) and err <= tol_y * y_scale
                            and rel <= tol_ss):
                        raise AssertionError("K2 disagrees with its plain "
                                             "version")
                    worst[dtype] = max(worst[dtype], err)
                if (cfg is cfg_torus and dtype == torch.float32
                        and s in K2_TIMED_STAGES):
                    args = (y, h, torch.zeros((), dtype=dtype, device="cuda"),
                            st, mu1, ctab, kc, cfg.rtol, cfg.atol)
                    timing[s] = (
                        median_ms(lambda: fr.fused_rkc_step(*args)),
                        median_ms(lambda: fr.fused_rkc_step_reference(*args)))
    return worst, timing


def check_imex_kernel(cases, timed):
    """K3 against its plain version at the main paths' shapes, for each
    config of `cases` (each with tBoundary > 0, so that fz 0 and 1 differ),
    both dtypes, fz 0 and 1 and each h of K3_H, with two launches bitwise
    equal; returns the max errors and {shape: (kernel ms, plain ms)} from
    the ICs of each config of `timed`, f32, at h = K3_H[0]."""
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.ops import fused_imex as fi
    from crdmodel_tpu_torch.ops.kernel_common import prepare_constants

    rng = np.random.default_rng(SEED + 2)
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    for cfg in cases:
        problem = build_problem(cfg, device="cuda")
        y_np = random_state(cfg, tuple(problem.y0.shape), rng)
        for dtype in (torch.float32, torch.float64):
            kc = prepare_constants(problem, dtype, "cuda")
            y = torch.tensor(y_np, dtype=dtype, device="cuda")
            tol_y, tol_ss = LIMITS[dtype]
            for h_val in K3_H:
                h = torch.tensor(h_val, dtype=dtype, device="cuda")
                for fz in (0.0, 1.0):
                    fzt = torch.tensor(fz, dtype=dtype, device="cuda")
                    args = (y, h, fzt, kc, cfg.rtol, cfg.atol)
                    y_k, ss_k = fi.fused_imex_step(*args)
                    y_k2, ss_k2 = fi.fused_imex_step(*args)
                    y_r, ss_r = fi.fused_imex_step_reference(*args)
                    torch.cuda.synchronize()
                    if not (torch.equal(y_k, y_k2) and torch.equal(ss_k, ss_k2)):
                        raise AssertionError("two K3 launches differ")
                    err = float((y_k - y_r).abs().max())
                    y_scale = max(1.0, float(y.abs().max()),
                                  float(y_r.abs().max()))
                    sk, sr = float(ss_k.sum()), float(ss_r.sum())
                    rel = abs(sk - sr) / sr
                    phase("k3_check", model=cfg.model, surface=cfg.surface,
                          beta="field" if kc.b_is_field else "scalar",
                          shape=list(y.shape), dtype=str(dtype), h=h_val,
                          fz=fz, max_abs_err=err, limit=tol_y * y_scale,
                          ss=sr, ss_rel_err=rel, ss_limit=tol_ss)
                    if not (np.isfinite(sk) and err <= tol_y * y_scale
                            and rel <= tol_ss):
                        raise AssertionError("K3 disagrees with its plain "
                                             "version")
                    worst[dtype] = max(worst[dtype], err)

    timing = {}
    for cfg in timed:
        problem = build_problem(cfg, device="cuda")
        kc = prepare_constants(problem, torch.float32, "cuda")
        y = problem.y0.contiguous()
        args = (y, torch.tensor(K3_H[0], device="cuda"),
                torch.zeros((), device="cuda"), kc, cfg.rtol, cfg.atol)
        timing[tuple(y.shape)] = (
            median_ms(lambda: fi.fused_imex_step(*args)),
            median_ms(lambda: fi.fused_imex_step_reference(*args)))
    return worst, timing


def run_main_path(cfg, probes, kernel, min_step_tol, name, label):
    """The canonical program `cfg` through simulate() on the card, with
    every kernel's launch count set to 0 just before and read just after;
    `kernel` is the wrapper whose kernel the path must take. Checks against
    the JAX CPU runs in `probes`; prints phase `name` with the config
    `label`; returns the launch count of `kernel`.

    The step count must lie within min_step_tol of the JAX f32 run's, or
    within that run's own distance to the JAX f64 run where that is larger:
    where the error estimate sits at the f32 rounding floor, the count
    follows the rounding (as the probe limit follows the f32-f64 gap)."""
    from crdmodel_tpu_torch.core.problem import solver_breakpoints
    from crdmodel_tpu_torch.integrate.erk import SYNC_EVERY, merge_stops
    from crdmodel_tpu_torch.config import PALLAS_AUTO_POINTS
    from crdmodel_tpu_torch.ops import fused_imex, fused_rkc, fused_step
    from crdmodel_tpu_torch.sim import output_times, simulate

    wrappers = (fused_step.fused_step, fused_rkc.fused_rkc_step,
                fused_imex.fused_imex_step)
    # warm-up on a short horizon (first launches of every torch op)
    simulate(dataclasses.replace(cfg, t_final=min(1.0, 0.1 * cfg.t_final),
                                 output_timestep=1), device="cuda")
    for w in wrappers:
        w.launches = 0
    res = simulate(cfg, device="cuda")
    counts = {w.__name__: w.launches for w in wrappers}
    launches = counts[kernel.__name__]

    traj = res.trajectory
    steps = res.total_steps()
    n_stops = len(merge_stops(output_times(cfg), solver_breakpoints(cfg))[0])
    ref_steps = int(probes["steps_f32"].sum())
    step_tol = max(min_step_tol,
                   abs(ref_steps - int(probes["steps_f64"].sum())) / ref_steps)
    var, j, i = (torch.as_tensor(probes[k], device=traj.device)
                 for k in ("probe_var", "probe_j", "probe_i"))
    got = traj[:, var, j, i].double().cpu().numpy()
    gap = float(np.abs(got - probes["probes_f64"]).max())
    f32_gap = float(np.abs(probes["probes_f32"] - probes["probes_f64"]).max())
    probe_limit = 2.0 * f32_gap + 1e-4
    wall = res.wall_time
    points = cfg.nx * cfg.ny
    selection = (f"auto (use_pallas=None): the fused path above "
                 f"PALLAS_AUTO_POINTS={PALLAS_AUTO_POINTS} points"
                 if cfg.use_pallas is None else
                 f"use_pallas={cfg.use_pallas}; {points} points, auto "
                 f"selection would take the "
                 f"{'fused' if points >= PALLAS_AUTO_POINTS else 'torch'} "
                 f"path")
    phase(name, config=label, selection=selection,
          grid=[cfg.ny, cfg.nx], method=cfg.method, dtype=cfg.dtype,
          status=res.describe(), fused=res.fused, steps=steps,
          accepted=int(res.stats.accepted.sum()),
          rejected=int(res.stats.rejected.sum()),
          jax_f32_cpu_steps=ref_steps,
          jax_f64_cpu_steps=int(probes["steps_f64"].sum()),
          step_limit=step_tol, kernel=kernel.__name__,
          launches=counts,
          launch_bound=[steps, steps + SYNC_EVERY * n_stops],
          wall_s=wall, us_per_step=wall / steps * 1e6,
          points_steps_per_s=cfg.nx * cfg.ny * steps / wall,
          probe_max_abs_err_vs_jax_f64=gap, probe_limit=probe_limit,
          jax_f32_probe_gap=f32_gap, card=card_line())
    checks = {
        "status ok": res.ok,
        "fused path": res.fused,
        "shape": tuple(traj.shape) == (cfg.output_timestep + 1, 2, cfg.ny,
                                       cfg.nx),
        "finite": bool(torch.isfinite(traj).all()),
        f"every step through {kernel.__name__}":
            steps <= launches <= steps + SYNC_EVERY * n_stops,
        f"steps within {step_tol:.2%} of JAX f32":
            abs(steps - ref_steps) <= step_tol * ref_steps,
        "probes vs JAX f64": gap <= probe_limit,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"main path {cfg.method} failed: {failed}")
    return launches


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: chip_smoke.py needs an NVIDIA GPU")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("card", nvidia_smi=card, torch=torch.__version__,
          cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), tf32="off (matmul and cudnn)")

    from crdmodel_tpu_torch.config import config_from_ini
    from crdmodel_tpu_torch.ops import _build, fused_imex, fused_rkc, fused_step

    phase("build", seconds=_build.build(), library=_build.library_path())

    cfg = config_from_ini(INI, model="fhn", surface="torus")
    cfg_flat = dataclasses.replace(cfg, surface="flat", vary_beta=0)
    cfg_gb = config_from_ini(GB_INI, model="goldbeter", surface="torus",
                             use_pallas=True)
    # Goldbeter with a freeze (the ini has tBoundary=0), torus with a
    # scalar beta and flat with the beta ramp
    gb_torus = dataclasses.replace(cfg_gb, t_boundary=1.0)
    gb_flat = dataclasses.replace(cfg_gb, surface="flat", vary_beta=1,
                                  t_boundary=1.0)
    worst, (k_ms, plain_ms) = check_kernel(
        [cfg, cfg_flat, gb_torus, gb_flat])
    phase("k1_timing", shape=[2, cfg.ny, cfg.nx], method=cfg.method,
          dtype="float32", kernel_us=k_ms * 1e3, plain_us=plain_ms * 1e3,
          card=card)
    worst2, timing2 = check_rkc_kernel(cfg, cfg_flat)
    for s, (k2_ms, k2_plain_ms) in timing2.items():
        phase("k2_timing", shape=[2, cfg.ny, cfg.nx], s=s, dtype="float32",
              kernel_us=k2_ms * 1e3, plain_us=k2_plain_ms * 1e3, card=card)
    cfg_big = config_from_ini(GB_INI, model="goldbeter", surface="torus",
                              x_mesh=K3_BIG_MESH)
    worst3, timing3 = check_imex_kernel([gb_torus, gb_flat, cfg, cfg_flat],
                                        [cfg_gb, cfg_big])
    for shape, (k3_ms, k3_plain_ms) in timing3.items():
        phase("k3_timing", shape=list(shape), h=K3_H[0], dtype="float32",
              kernel_us=k3_ms * 1e3, plain_us=k3_plain_ms * 1e3, card=card)

    probes = {}
    for key, path in PROBES.items():
        with np.load(path) as z:
            probes[key] = {k: z[k] for k in z.files}
    fhn_label = "data/FHNmodelArgs.ini fhn torus"
    gb_label = "data/GoldbeterModelArgs.ini goldbeter torus"
    launches = run_main_path(cfg, probes["fhn", "bs32"],
                             fused_step.fused_step, 0.01, "main_path",
                             fhn_label)
    # at least 2%: the JAX package's own fused and XLA rkc2 step counts
    # differ by 1.6% (docs/PERF_NOTES.md), and the card's fused run is held
    # against a CPU run of the XLA stepper; the JAX f32 and f64 rkc2 runs
    # differ by 2.8%
    cfg_rkc = dataclasses.replace(cfg, method="rkc2")
    launches2 = run_main_path(cfg_rkc, probes["fhn", "rkc2"],
                              fused_rkc.fused_rkc_step, 0.02,
                              "main_path_rkc2", fhn_label)
    run_main_path(cfg_gb, probes["goldbeter", "bs32"], fused_step.fused_step,
                  0.01, "main_path_goldbeter", gb_label)
    launches3 = run_main_path(
        dataclasses.replace(cfg_gb, method="ark324"),
        probes["goldbeter", "ark324"], fused_imex.fused_imex_step, 0.01,
        "main_path_goldbeter_ark324", gb_label)

    k2_s = max(timing2)     # the stability-bound step: the larger time
    k3_shape = (2, cfg_gb.ny, cfg_gb.nx)    # the ark324 main path's shape
    print(json.dumps({"kernels": [{
        "name": "fused_erk_step", "route": "cuda",
        "source": "crdmodel_tpu_torch/csrc/fused_step.cu",
        "replaces": "crdmodel_tpu/ops/pallas_step.py:117",
        "launches": launches, "max_abs_err": worst[torch.float32],
        "ms": k_ms, "plain_ms": plain_ms}, {
        "name": "fused_rkc_step", "route": "cuda",
        "source": "crdmodel_tpu_torch/csrc/fused_rkc.cu",
        "replaces": "crdmodel_tpu/ops/pallas_rkc.py:365",
        "launches": launches2, "max_abs_err": worst2[torch.float32],
        "ms": timing2[k2_s][0], "plain_ms": timing2[k2_s][1]}, {
        "name": "fused_imex_step", "route": "cuda",
        "source": "crdmodel_tpu_torch/csrc/fused_imex.cu",
        "replaces": "crdmodel_tpu/ops/pallas_imex.py:155",
        "launches": launches3, "max_abs_err": worst3[torch.float32],
        "ms": timing3[k3_shape][0], "plain_ms": timing3[k3_shape][1]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
