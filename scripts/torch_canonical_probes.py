"""Reference probes of the canonical runs, for the PyTorch port.

Runs the JAX package on the CPU, in float32 and in float64, on one of the
two canonical programs: data/FHNmodelArgs.ini (--model fhn, the default:
400x1600 torus, beta ramp, tBoundary=38, Tf=50, rtol 1e-5) or
data/GoldbeterModelArgs.ini (--model goldbeter: 100x400 torus, beta 0.4,
wave-segment ICs, Tf=4, rtol 1e-5), with the ini's method (bs32) or with
--method, and writes tests/golden/torch_canonical_<model>_probes.npz
(bs32) or tests/golden/torch_canonical_<model>_<method>_probes.npz.
With --config bounded_ap it runs instead the bounded cardiac-tissue
program of scripts/bench_suite.py::bounded_tissue (Aliev-Panfilov on a
flat 1600x400 sheet, no-flux walls, a circular scar, bs32, Tf=8) and
writes tests/golden/torch_bounded_ap_probes.npz, or with --method rkc2
tests/golden/torch_bounded_ap_rkc2_probes.npz. With --config aniso_sheet
it runs the fibered cardiac sheet: the configuration of
tests_tpu/test_aniso_tpu.py (Aliev-Panfilov on a flat periodic 1600x400
sheet, bs32, Tf=1) with the rotating-fibre tensor of
examples/anisotropic_fibers.py (d_par 1, d_perp 0.2, the fibre angle
rotating from 0 to pi/3 across x), and writes
tests/golden/torch_aniso_sheet_probes.npz. Each file holds:

  steps_f32, accepted_f32, rejected_f32   per output interval, JAX f32 run
  steps_f64, accepted_f64, rejected_f64   the same for the f64 run
  probe_var, probe_j, probe_i             64 probe points (seeded numpy)
  probes_f32, probes_f64                  (Nt+1, 64): the field at each
                                          probe point at every output time,
                                          IC first
  touts                                   (Nt+1,) output times, 0 first

and the bounded-tissue file also

  obstacle_mask                           (ny, nx) bool, True = tissue
  scar_j, scar_i, scar_ic                 16 scar cells (seeded numpy) and
                                          the JAX IC (f64) of both
                                          variables there, (2, 16)

and the fibered-sheet file also

  dxx, dyy, dxy                           (ny, nx) float64: the tensor

chip_smoke.py holds the port's runs on the card against these numbers. On
the CPU the JAX package takes its XLA path (no Pallas kernel). Each FHN run
takes a few minutes on a CPU, each Goldbeter run seconds, each bounded-
tissue run a few minutes:

    python scripts/torch_canonical_probes.py [--model goldbeter]
        [--method rkc2|ark324]
    python scripts/torch_canonical_probes.py --config bounded_ap
        [--method rkc2]
    python scripts/torch_canonical_probes.py --config aniso_sheet
"""

import argparse
import dataclasses
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from crdmodel_tpu.config import SimConfig, config_from_ini  # noqa: E402
from crdmodel_tpu.core.problem import build_problem  # noqa: E402
from crdmodel_tpu.sim import simulate  # noqa: E402
from examples.anisotropic_fibers import fiber_tensor  # noqa: E402
from scripts.bench_suite import bounded_tissue  # noqa: E402

INIS = {"fhn": os.path.join(ROOT, "data", "FHNmodelArgs.ini"),
        "goldbeter": os.path.join(ROOT, "data", "GoldbeterModelArgs.ini")}
GOLDEN = os.path.join(ROOT, "tests", "golden")
N_PROBES = 64
N_SCAR = 16
PROBE_SEED = 20261016

# the fibered sheet: tests_tpu/test_aniso_tpu.py's configuration, and the
# rotating-fibre tensor of examples/anisotropic_fibers.py
ANISO_SHEET = dict(model="aliev_panfilov", surface="flat", x_mesh=400,
                   surface_width=20, surface_length=80, diffusion=1.0,
                   beta=0.05, wave_length=0.1, wave_width=0.2, t_final=1.0,
                   output_timestep=2, dtype="float32", rtol=1e-4, atol=1e-7)
FIBERS = dict(d_par=1.0, d_perp=0.2, angle0=0.0, angle1=np.pi / 3)


def out_path(name: str, method: str) -> str:
    """The probe file of a program and method; bs32 has no method tag."""
    tag = "" if method == "bs32" else f"_{method}"
    return os.path.join(GOLDEN, f"torch_{name}{tag}_probes.npz")


def probe_points(nvars, ny, nx):
    """N_PROBES fixed grid points, half on each variable."""
    rng = np.random.default_rng(PROBE_SEED)
    var = np.repeat(np.arange(nvars), N_PROBES // nvars)
    j = rng.integers(0, ny, N_PROBES)
    i = rng.integers(0, nx, N_PROBES)
    return var, j, i


def scar_cells(obstacle_mask):
    """N_SCAR fixed cells of the scar (obstacle_mask False)."""
    jj, ii = np.nonzero(~obstacle_mask)
    pick = np.random.default_rng(PROBE_SEED).choice(jj.size, N_SCAR,
                                                    replace=False)
    return jj[pick], ii[pick]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="canonical",
                    choices=("canonical", "bounded_ap", "aniso_sheet"))
    ap.add_argument("--model", default="fhn", choices=sorted(INIS))
    ap.add_argument("--method", default="bs32",
                    choices=("bs32", "rkc2", "ark324"))
    args = ap.parse_args()
    build_kw = {}
    out = {}
    if args.config == "bounded_ap":
        base, build_kw = bounded_tissue()
        base = dataclasses.replace(base, method=args.method)
        path = out_path("bounded_ap", args.method)
    elif args.config == "aniso_sheet":
        base = SimConfig(**ANISO_SHEET)
        tensor = fiber_tensor(base, **FIBERS)
        build_kw = dict(diffusion_tensor=tensor)
        out.update(dxx=tensor[0], dyy=tensor[1], dxy=tensor[2])
        path = out_path("aniso_sheet", base.method)
    else:
        model, method = args.model, args.method
        base = config_from_ini(INIS[model], model=model, surface="torus")
        base = dataclasses.replace(base, method=method)
        path = out_path(f"canonical_{model}", method)
    var, j, i = probe_points(2, base.ny, base.nx)
    out.update(probe_var=var, probe_j=j, probe_i=i)
    if "obstacle_mask" in build_kw:
        mask = build_kw["obstacle_mask"]
        sj, si = scar_cells(mask)
        y0 = np.asarray(build_problem(dataclasses.replace(
            base, dtype="float64"), **build_kw).y0)
        out.update(obstacle_mask=mask, scar_j=sj, scar_i=si,
                   scar_ic=y0[:, sj, si])
    for dtype, tag in (("float32", "f32"), ("float64", "f64")):
        cfg = dataclasses.replace(base, dtype=dtype)
        t0 = time.perf_counter()
        res = simulate(cfg, problem=build_problem(cfg, **build_kw))
        wall = time.perf_counter() - t0
        assert res.ok, res.describe()
        traj = np.asarray(res.trajectory)
        out[f"probes_{tag}"] = traj[:, var, j, i].astype(np.float64)
        out[f"steps_{tag}"] = np.asarray(res.stats.steps)
        out[f"accepted_{tag}"] = np.asarray(res.stats.accepted)
        out[f"rejected_{tag}"] = np.asarray(res.stats.rejected)
        out["touts"] = np.asarray(res.touts)
        print(f"{tag}: {res.describe()} (CPU wall {wall:.1f} s)", flush=True)
    np.savez_compressed(path, **out)
    gap = np.abs(out["probes_f32"] - out["probes_f64"]).max()
    print(f"wrote {path}; max |f32 - f64| over the probes = {gap:.3e}")


if __name__ == "__main__":
    main()
