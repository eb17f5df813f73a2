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
tests/golden/torch_aniso_sheet_probes.npz. With --config box it runs the
volumetric cardiac slab of scripts/bench_suite.py::volumetric_box
(Aliev-Panfilov on a 32x512x512 box, 8.4M points, no-flux walls, bs32,
Tf=0.5) and writes tests/golden/torch_box_probes.npz; --config box_scar
adds the cylindrical scar column of scripts/bench_box3d.py:47-52 (radius
48 cells around (256, 256), through every plane) and writes
tests/golden/torch_box_scar_probes.npz. With --method rkc2 on a box the
run takes the h cap of the box kernels' stage budget, STAB_FACTOR
(C - 1)^2 / rho with C = 7 (crdmodel_tpu/ops/pallas_box3d_rkc.py:644-650),
through integrate_to_outputs' h_limit_fn, so that the XLA path takes the
step sequence of the fused kernels (uncapped it takes some 20% fewer
steps), and writes tests/golden/torch_box[_scar]_rkc2_probes.npz. With
--speculative-k K (K > 1) the run takes K-step speculative batches (on the
CPU the JAX package's XLA-side speculation, integrate/erk.py::
integrate_interval_batched) and the file name gains _k<K>; with
--step-mode normal it steps freely past each output and interpolates back
(ARK_NORMAL, integrate/erk.py::integrate_interval_free), and the name
gains _normal: e.g. tests/golden/torch_canonical_fhn_k5_probes.npz,
tests/golden/torch_canonical_goldbeter_k10_probes.npz,
tests/golden/torch_canonical_fhn_normal_probes.npz. With --config
curvature_fhn it runs the JAX suite's curvature-coupled row
(scripts/bench_suite.py::curvature_fhn: the canonical FHN torus with
coupling="curvature", Tf=5, Nt=2) and writes
tests/golden/torch_curvature_fhn_probes.npz; with --config s1s2 the
configuration and protocol of examples/s1s2_pacing.py (Aliev-Panfilov on
a flat 256x256 no-flux sheet, rkc2, S1 at t=1 on the bottom eighth, S2 at
t=60 on the left half, amplitude 3, duration 1, Tf=120, Nt=24), with the
h cap of the 2-D fused RKC kernel's stage budget (S_MAX_KERNEL = 23
stages), and writes tests/golden/torch_s1s2_rkc2_probes.npz. --forcing
paces the canonical and bounded-tissue programs (pacing() below: the FHN
torus with a two-pulse S1 on a row band plus a smooth drive, the
Goldbeter torus with a pulse train on a column band, the bounded tissue
with s1s2_protocol) and the file name gains _paced, e.g.
tests/golden/torch_canonical_fhn_paced_probes.npz. Each file holds:

  steps_f32, accepted_f32, rejected_f32   per output interval, JAX f32 run
  steps_f64, accepted_f64, rejected_f64   the same for the f64 run
  probe_var, probe_j, probe_i             64 probe points (seeded numpy);
                                          on a box also probe_k
  probes_f32, probes_f64                  (Nt+1, 64): the field at each
                                          probe point at every output time,
                                          IC first
  touts                                   (Nt+1,) output times, 0 first

and the bounded-tissue and scarred-box files also

  obstacle_mask                           (ny, nx) or (nz, ny, nx) bool,
                                          True = tissue
  scar_j, scar_i, scar_ic                 16 scar cells (seeded numpy; on a
                                          box also scar_k) and the JAX IC
                                          (f64) of both variables there,
                                          (2, 16)

and the fibered-sheet file also

  dxx, dyy, dxy                           (ny, nx) float64: the tensor

and a forced run's file also its stimuli as plain data (stim_data), from
which the port rebuilds the same forcing (crdmodel_tpu_torch/convert.py::
forcing_from_numpy; a sinusoid's torch twin by hand):

  stim_var                                (n,) the variable each drives
  stim_row, stim_col                      (n, ny), (n, nx) float64 profiles
  stim_pulse_starts                       (n, k) pulse starts, NaN-padded
                                          (all NaN: not a pulse train)
  stim_pulse_duration, _amplitude         (n,) the pulse trains'
  stim_sine                               (n, 2) amplitude and period of
                                          a sinusoid drive amp sin(2 pi
                                          t / period), else NaN

chip_smoke.py holds the port's runs on the card against these numbers. On
the CPU the JAX package takes its XLA path (no Pallas kernel). Each FHN run
takes a few minutes on a CPU, each Goldbeter run seconds, each bounded-
tissue run a few minutes; a box run moves an 8.4M-point state through
some 120 to 420 steps and takes far longer:

    python scripts/torch_canonical_probes.py [--model goldbeter]
        [--method rkc2|ark324] [--speculative-k K] [--step-mode normal]
    python scripts/torch_canonical_probes.py --config bounded_ap
        [--method rkc2]
    python scripts/torch_canonical_probes.py --config aniso_sheet
    python scripts/torch_canonical_probes.py --config box|box_scar
        [--method rkc2]
    python scripts/torch_canonical_probes.py --config curvature_fhn|s1s2
    python scripts/torch_canonical_probes.py --forcing [--model goldbeter
        --method ark324] [--config bounded_ap]
"""

import argparse
import dataclasses
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from crdmodel_tpu.config import SimConfig, config_from_ini  # noqa: E402
from crdmodel_tpu.core.forcing import (SeparableForcing,  # noqa: E402
                                       Stimulus, gaussian_profile,
                                       pulse_train, rect_profile,
                                       s1s2_protocol)
from crdmodel_tpu.core.problem import (build_problem,  # noqa: E402
                                       make_rho_bound, solver_breakpoints)
from crdmodel_tpu.integrate import rkc  # noqa: E402
from crdmodel_tpu.integrate.erk import integrate_to_outputs  # noqa: E402
from crdmodel_tpu.sim import SimResult, output_times, simulate  # noqa: E402
from examples.anisotropic_fibers import fiber_tensor  # noqa: E402
from scripts.bench_suite import (bounded_tissue,  # noqa: E402
                                 volumetric_box)

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
# the box kernels' RKC2 stage cap (crdmodel_tpu/ops/pallas_box3d_rkc.py:65)
BOX_RKC_STAGES = 7
# the 2-D fused RKC kernels' stage cap (crdmodel_tpu/ops/pallas_rkc.py
# S_MAX_KERNEL, crdmodel_tpu_torch/ops/fused_rkc.py S_MAX_KERNEL)
RKC_STAGES = 23
# the smooth drive of the paced FHN torus: amplitude and period of
# amp sin(2 pi t / period) on a Gaussian column band
FHN_DRIVE = (0.1, 12.5)


def sine_wave(amplitude, period):
    """amp sin(2 pi t / period), the smooth drive; chip_smoke.py builds its
    torch twin from the file's stim_sine."""
    def waveform(t):
        return amplitude * jnp.sin((2.0 * np.pi / period) * t)
    waveform.sine = (amplitude, period)
    return waveform


def pulses(starts, duration, amplitude):
    """pulse_train, with its parameters kept for stim_data."""
    w = pulse_train(starts, duration, amplitude)
    w.pulses = (tuple(starts), duration, amplitude)
    return w


def s1s2_example():
    """examples/s1s2_pacing.py's configuration and protocol, exactly."""
    cfg = SimConfig(model="aliev_panfilov", surface="flat", x_mesh=256,
                    surface_width=25.0, surface_length=25.0, diffusion=1.0,
                    beta=0.075, wave_length=0.0, wave_width=0.0,
                    t_final=120.0, output_timestep=24, boundary="noflux",
                    method="rkc2", dtype="float32", rtol=1e-4, atol=1e-6)
    return cfg, s1s2_forcing(cfg, 3.0, [1.0], 60.0, 1.0)


def s1s2_forcing(cfg, amplitude, s1_times, s2_time, duration):
    """s1s2_protocol with its pulse trains' parameters kept."""
    frc = s1s2_protocol(cfg, amplitude=amplitude, s1_times=s1_times,
                        s2_time=s2_time, duration=duration)
    starts = (s1_times, [s2_time])
    return SeparableForcing(*(dataclasses.replace(
        st, waveform=pulses(t0, duration, amplitude))
        for st, t0 in zip(frc.stimuli, starts)))


def pacing(cfg):
    """The --forcing protocol of a program (PACING)."""
    if cfg.model == "fhn":
        # two S1 pulses on a row band, and a smooth drive on a Gaussian
        # column band
        return SeparableForcing(
            Stimulus(waveform=pulses([2.0, 20.0], 1.0, 1.0), var=0,
                     row=rect_profile(cfg.ny, cfg.ny // 8, cfg.ny // 4)),
            Stimulus(waveform=sine_wave(*FHN_DRIVE), var=0,
                     col=gaussian_profile(cfg.nx, cfg.nx / 4.0,
                                          cfg.nx / 16.0)))
    if cfg.model == "goldbeter":
        return SeparableForcing(
            Stimulus(waveform=pulses([0.5, 2.0], 0.25, 0.5), var=0,
                     col=rect_profile(cfg.nx, 0, cfg.nx // 4)))
    return s1s2_forcing(cfg, 3.0, [0.5], 4.0, 0.5)


def stim_data(forcing, ny, nx):
    """A SeparableForcing's stimuli as the plain arrays of the file."""
    sts = forcing.stimuli
    k = max([len(getattr(st.waveform, "pulses", ((),))[0]) for st in sts])
    starts = np.full((len(sts), max(k, 1)), np.nan)
    dur, amp = np.full(len(sts), np.nan), np.full(len(sts), np.nan)
    sine = np.full((len(sts), 2), np.nan)
    for n, st in enumerate(sts):
        if hasattr(st.waveform, "pulses"):
            t0, dur[n], amp[n] = st.waveform.pulses
            starts[n, :len(t0)] = t0
        else:
            sine[n] = st.waveform.sine
    return dict(
        stim_var=np.array([st.var for st in sts]),
        stim_row=np.stack([np.ones(ny) if st.row is None
                           else np.asarray(st.row, np.float64)
                           for st in sts]),
        stim_col=np.stack([np.ones(nx) if st.col is None
                           else np.asarray(st.col, np.float64)
                           for st in sts]),
        stim_pulse_starts=starts, stim_pulse_duration=dur,
        stim_pulse_amplitude=amp, stim_sine=sine)


def out_path(name: str, method: str, speculative_k: int = 0,
             step_mode: str = "tstop") -> str:
    """The probe file of a program and method; bs32 has no method tag, the
    per-step TSTOP run no stepping tag."""
    tag = "" if method == "bs32" else f"_{method}"
    if speculative_k > 1:
        tag += f"_k{speculative_k}"
    if step_mode != "tstop":
        tag += f"_{step_mode}"
    return os.path.join(GOLDEN, f"torch_{name}{tag}_probes.npz")


def probe_points(nvars, shape):
    """N_PROBES fixed grid points of a (ny, nx) or (nz, ny, nx) grid, half
    on each variable: (var, index arrays in the grid's axis order)."""
    rng = np.random.default_rng(PROBE_SEED)
    var = np.repeat(np.arange(nvars), N_PROBES // nvars)
    j = rng.integers(0, shape[-2], N_PROBES)
    i = rng.integers(0, shape[-1], N_PROBES)
    if len(shape) == 2:
        return var, (j, i)
    return var, (rng.integers(0, shape[0], N_PROBES), j, i)


def scar_cells(obstacle_mask):
    """N_SCAR fixed cells of the scar (obstacle_mask False), as index
    arrays in the mask's axis order."""
    cells = np.nonzero(~obstacle_mask)
    pick = np.random.default_rng(PROBE_SEED).choice(cells[0].size, N_SCAR,
                                                    replace=False)
    return tuple(c[pick] for c in cells)


def box_scar(cfg):
    """The scar column of scripts/bench_box3d.py:47-52: an inert cylinder
    of radius 48 cells around (256, 256), through every plane."""
    yy, xx = np.meshgrid(np.arange(cfg.ny), np.arange(cfg.nx), indexing="ij")
    scar = (yy - 256) ** 2 + (xx - 256) ** 2 < 48 ** 2
    return dict(obstacle_mask=np.broadcast_to(~scar,
                                              (cfg.nz, cfg.ny, cfg.nx)))


def run_capped_rkc2(cfg, problem, stages=BOX_RKC_STAGES):
    """rkc2 on the XLA path with the h cap of a fused RKC kernel's stage
    budget of `stages` (the box kernels' BOX_RKC_STAGES, the 2-D kernels'
    RKC_STAGES): the step sequence of the fused RKC kernels."""
    rho_fn = make_rho_bound(cfg, problem.model, problem.geometry,
                            jnp.dtype(cfg.dtype),
                            diffusion_field=problem.diffusion_field,
                            diffusion_tensor=problem.diffusion_tensor,
                            face_mask=problem.face_mask)

    def h_limit(t, y, params):
        return (rkc.STAB_FACTOR * (stages - 1) ** 2
                / jnp.maximum(rho_fn(t, y, params), 1e-30))

    touts = output_times(cfg)

    def run(y0, params):
        return integrate_to_outputs(
            problem.rhs, y0, params, 0.0, touts, rtol=cfg.rtol,
            atol=cfg.atol, method="rkc2", max_steps=cfg.max_steps,
            breakpoints=solver_breakpoints(cfg, problem.forcing),
            rho_fn=rho_fn, step_mode=cfg.step_mode, h_limit_fn=h_limit)

    t0 = time.perf_counter()
    traj, stats = jax.jit(run)(problem.y0, problem.params)
    traj = np.asarray(traj)
    wall = time.perf_counter() - t0
    return SimResult(cfg=cfg, problem=problem,
                     trajectory=np.concatenate([np.asarray(problem.y0)[None],
                                                traj]),
                     touts=np.concatenate([[0.0], touts]), stats=stats,
                     wall_time=wall)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="canonical",
                    choices=("canonical", "bounded_ap", "aniso_sheet",
                             "box", "box_scar", "curvature_fhn", "s1s2"))
    ap.add_argument("--model", default="fhn", choices=sorted(INIS))
    ap.add_argument("--method", default="bs32",
                    choices=("bs32", "rkc2", "ark324"))
    ap.add_argument("--speculative-k", type=int, default=0)
    ap.add_argument("--step-mode", default="tstop",
                    choices=("tstop", "normal"))
    ap.add_argument("--forcing", action="store_true",
                    help="pace the canonical or bounded-tissue program")
    args = ap.parse_args()
    stepping = dict(speculative_k=args.speculative_k,
                    step_mode=args.step_mode)
    build_kw = {}
    out = {}
    forcing = None
    capped = None
    if args.config == "curvature_fhn":
        base = dataclasses.replace(
            config_from_ini(INIS["fhn"], model="fhn", surface="torus"),
            coupling="curvature", t_final=5.0, output_timestep=2,
            **stepping)
        path = out_path("curvature_fhn", base.method, **stepping)
    elif args.config == "s1s2":
        base, forcing = s1s2_example()
        capped = RKC_STAGES
        path = out_path("s1s2", base.method, **stepping)
    elif args.config == "bounded_ap":
        base, build_kw = bounded_tissue()
        base = dataclasses.replace(base, method=args.method, **stepping)
        path = out_path("bounded_ap", args.method, **stepping)
    elif args.config == "aniso_sheet":
        base = SimConfig(**ANISO_SHEET, **stepping)
        tensor = fiber_tensor(base, **FIBERS)
        build_kw = dict(diffusion_tensor=tensor)
        out.update(dxx=tensor[0], dyy=tensor[1], dxy=tensor[2])
        path = out_path("aniso_sheet", base.method, **stepping)
    elif args.config in ("box", "box_scar"):
        base = dataclasses.replace(volumetric_box(), method=args.method,
                                   **stepping)
        if args.config == "box_scar":
            build_kw = box_scar(base)
        path = out_path(args.config, args.method, **stepping)
    else:
        model, method = args.model, args.method
        base = config_from_ini(INIS[model], model=model, surface="torus")
        base = dataclasses.replace(base, method=method, **stepping)
        path = out_path(f"canonical_{model}", method, **stepping)
    if args.forcing:
        if args.config not in ("canonical", "bounded_ap"):
            sys.exit("--forcing paces the canonical and bounded_ap configs")
        forcing = pacing(base)
        path = path.replace("_probes.npz", "_paced_probes.npz")
    if forcing is not None:
        build_kw = dict(build_kw, forcing=forcing)
        out.update(stim_data(forcing, base.ny, base.nx))
    box = base.surface == "box"
    shape = (base.nz, base.ny, base.nx) if box else (base.ny, base.nx)
    axes = ("k", "j", "i")[-len(shape):]
    var, idx = probe_points(2, shape)
    out.update(probe_var=var, **{f"probe_{a}": v for a, v in zip(axes, idx)})
    if "obstacle_mask" in build_kw:
        mask = np.asarray(build_kw["obstacle_mask"])
        cells = scar_cells(mask)
        y0 = np.asarray(build_problem(dataclasses.replace(
            base, dtype="float64"), **build_kw).y0)
        out.update(obstacle_mask=mask,
                   scar_ic=y0[(slice(None), *cells)],
                   **{f"scar_{a}": v for a, v in zip(axes, cells)})
    for dtype, tag in (("float32", "f32"), ("float64", "f64")):
        cfg = dataclasses.replace(base, dtype=dtype)
        t0 = time.perf_counter()
        problem = build_problem(cfg, **build_kw)
        if box and cfg.method == "rkc2":
            res = run_capped_rkc2(cfg, problem)
        elif capped is not None:
            res = run_capped_rkc2(cfg, problem, capped)
        else:
            res = simulate(cfg, problem=problem)
        wall = time.perf_counter() - t0
        assert res.ok, res.describe()
        traj = np.asarray(res.trajectory)
        out[f"probes_{tag}"] = traj[(slice(None), var, *idx)].astype(
            np.float64)
        out[f"steps_{tag}"] = np.asarray(res.stats.steps)
        out[f"accepted_{tag}"] = np.asarray(res.stats.accepted)
        out[f"rejected_{tag}"] = np.asarray(res.stats.rejected)
        out["touts"] = np.asarray(res.touts)
        print(f"{tag}: {res.describe()} (CPU wall {wall:.1f} s)", flush=True)
    if args.config == "s1s2":
        # the example's re-entry oracle on the f32 run's last frame
        out["final_max_u"] = float(traj[-1, 0].max())
    np.savez_compressed(path, **out)
    gap = np.abs(out["probes_f32"] - out["probes_f64"]).max()
    print(f"wrote {path}; max |f32 - f64| over the probes = {gap:.3e}")


if __name__ == "__main__":
    main()
