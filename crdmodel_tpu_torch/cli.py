"""Command-line interface of the port (counterpart of crdmodel_tpu/cli.py):
the `run` and `curvature` subcommands.

  python -m crdmodel_tpu_torch run <ini> --model fhn --surface torus [options]
  python -m crdmodel_tpu_torch curvature <ini> --model fhn --surface torus
      [--outdir DIR] [--profiles]

`run` mirrors the reference pipeline (util/ShellScripts/run*.sh: mpirun ->
plot -> MapOutputToTorus): the banner (sim.py::print_banner), the
streaming solve with its `% | elapsed | remaining` line
(sim.py::simulate_streaming; with --devices N, parallel/sharded.py::
simulate_sharded_streaming), the reference-format per-rank text files
(io/trajectory.py), the JSON manifest (utils/profiling.py), and on request
the npz, the movie frames and the ParaView torus mapping (the box: npz and
.vti volumes). Its flags are the JAX package's, so every JAX `run` command
line parses the same way, plus --device (default cuda: the card; a missing
card is an error, never a switch to the CPU). The checkpoint flags parse
and raise NotImplementedError (ROADMAP queue 1, item 14). The JAX
package's other subcommands (plot, gentorus, sweep, steadystate,
stability, tips, maps) are not ported yet (ROADMAP queue 1, item 5b).

The exit code is 0 when the run is ok, else 1.

`curvature` writes the torus mesh with its Gaussian curvature and
coupling-strength cell arrays (viz/curvature.py; the reference's
util/GenCurvatureCoupling.py) under the reference's file name, and with
--profiles the K(theta) and C(theta) plot (util/PlotGaussianAndCoupling.py,
needs matplotlib). It computes with numpy only and needs no device.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

from crdmodel_tpu_torch.config import MODEL_NAMES


def _add_model_args(p):
    p.add_argument("ini", help="reference-format ini file")
    # the JAX package's families: one the port has not ported yet parses
    # and is refused by build_problem (models/base.py::get_model)
    p.add_argument("--model", choices=sorted(MODEL_NAMES), required=True)
    p.add_argument("--surface", choices=["flat", "torus", "sphere", "box"],
                   required=True)
    p.add_argument("--dtype", default=None,
                   help="float32 (default) or float64")
    p.add_argument("--method", default=None,
                   help="bs32 | zonneveld43 | dopri54 | rkc2 | ark324")
    p.add_argument("--set", action="append", metavar="FIELD=VALUE",
                   help="override any SimConfig field (repeatable), e.g. "
                        "--set rtol=1e-4 --set use_pallas=true")


_BOOL_WORDS = {"true": True, "yes": True, "on": True,
               "false": False, "no": False, "off": False,
               "none": None, "null": None}


def _coerce_override(key: str, ann, val: str):
    """Cast a --set string to the SimConfig field's ANNOTATED type (the
    default value's type is useless for Optional fields whose default is
    None, e.g. use_pallas). Accepts true/false words for bools and `none`
    for Optionals."""
    import typing
    word = val.strip().lower()
    optional = False
    if typing.get_origin(ann) is typing.Union:
        args = [a for a in typing.get_args(ann) if a is not type(None)]
        optional = len(args) < len(typing.get_args(ann))
        ann = args[0] if args else str
    if optional and word in ("none", "null", ""):
        return None
    if ann is bool:
        if word in _BOOL_WORDS and _BOOL_WORDS[word] is not None:
            return _BOOL_WORDS[word]
        try:
            return bool(int(float(val)))
        except ValueError:
            raise ValueError(
                f"--set {key}: expected a bool (true/false/1/0), got {val!r}")
    if ann is int:
        return int(float(val))
    if ann is float:
        return float(val)
    return val


def _cfg_from_args(args, **extra):
    import dataclasses as _dc
    import typing

    from crdmodel_tpu_torch.config import SimConfig, config_from_ini
    if not os.path.exists(args.ini):
        sys.exit(f"error: config file not found: {args.ini}")
    overrides = dict(extra)
    if args.dtype:
        overrides["dtype"] = args.dtype
    if getattr(args, "method", None):
        overrides["method"] = args.method
    # generic --set field=value overrides for any SimConfig field
    hints = typing.get_type_hints(SimConfig)
    fields = {f.name for f in _dc.fields(SimConfig)}
    for kv in getattr(args, "set", None) or []:
        if "=" not in kv:
            sys.exit(f"error: --set expects field=value, got {kv!r}")
        key, val = kv.split("=", 1)
        if key not in fields:
            sys.exit(f"error: unknown config field {key!r} "
                     f"(known: {', '.join(sorted(fields))})")
        try:
            overrides[key] = _coerce_override(key, hints[key], val)
        except ValueError as e:
            sys.exit(f"error: {e}")
    return config_from_ini(args.ini, model=args.model, surface=args.surface,
                           **overrides)


def _device(name: str):
    """The run's torch device; a CUDA device that is not there is an
    error."""
    import torch
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit(f"error: --device {name}: no CUDA device is available "
                 "(torch.cuda.is_available() is False); pass --device cpu "
                 "to run on the CPU")
    return device


def cmd_run(args):
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.io import trajectory
    from crdmodel_tpu_torch.sim import print_banner, refuse_checkpoints
    from crdmodel_tpu_torch.utils import RunManifest, trace

    refuse_checkpoints(checkpoint=args.checkpoint,
                       checkpoint_every=args.checkpoint_every,
                       resume=args.resume,
                       checkpoint_backend=args.checkpoint_backend)
    cfg = _cfg_from_args(args)
    device = _device(args.device)
    problem = build_problem(cfg, device)
    print_banner(cfg, problem)
    os.makedirs(args.outdir, exist_ok=True)

    trace_ctx = trace(args.trace) if args.trace else contextlib.nullcontext()
    with trace_ctx:
        res = _run_simulation(args, cfg, problem)
    if args.trace:
        print(f"   wrote profiler trace to {args.trace} "
              f"(view: tensorboard --logdir {args.trace})")
    print(res.describe())
    manifest = os.path.join(args.outdir, f"{cfg.program_name}_manifest.json")

    if args.snapshot_mode == "none":
        # throughput/soak mode: nothing was captured, so there are no
        # field outputs to write — stats + manifest only
        mpath = RunManifest.from_result(res).save(manifest)
        print(f"   wrote {mpath} (snapshot-mode none: no field outputs)")
        return 0 if res.ok else 1

    npz = os.path.join(args.outdir, f"{cfg.program_name}.npz")
    if cfg.surface == "box":
        # the per-rank text contract is 2-D; volumes go out as npz + VTK
        # ImageData instead
        trajectory.save_npz(res, npz)
        print(f"   wrote {npz}")
    else:
        writes = dict(trajectory.WRITES)
        t0 = time.perf_counter()
        paths = trajectory.write_reference_files(res, args.outdir,
                                                 nprocs=args.nprocs_files)
        seconds = time.perf_counter() - t0
        mb = sum(os.path.getsize(p) for p in paths) / 1e6
        writers = sorted(w for w, n in trajectory.WRITES.items()
                         if n > writes.get(w, 0))
        print(f"   wrote reference-format files to {args.outdir}/ "
              f"({mb:.1f} MB in {seconds:.2f} s, writer "
              f"{'+'.join(writers)})")
    mpath = RunManifest.from_result(res).save(manifest)
    print(f"   wrote {mpath}")
    if args.npz and cfg.surface != "box":
        trajectory.save_npz(res, npz)
        print(f"   wrote {npz}")
    if args.plot:
        from crdmodel_tpu_torch.viz import plot_movie, volume_slice
        source = volume_slice(res) if cfg.surface == "box" else res
        out = plot_movie(source, cfg, args.outdir)
        print(f"   wrote {len(out['frames'])} frames"
              + (f" and {out['movie']}" if out["movie"]
                 else " (no movie encoder)"))
    if args.map_torus and cfg.surface == "box":
        # the 3-D analogue of the step-vtp pipeline: a .vti volume per
        # snapshot + ParaView collection (viz/volume.py)
        from crdmodel_tpu_torch.viz import save_volume_series
        pvd = save_volume_series(res, args.outdir)
        print(f"   wrote {pvd}")
    elif args.map_torus and cfg.surface == "torus":
        from crdmodel_tpu_torch.viz import (generate_torus_vtp,
                                            map_output_to_torus)
        generate_torus_vtp(cfg, args.outdir)
        pvd = map_output_to_torus(res, args.outdir)
        print(f"   wrote {pvd}")
    return 0 if res.ok else 1


def _run_simulation(args, cfg, problem):
    from crdmodel_tpu_torch.sim import simulate_streaming

    if args.devices and args.devices > 1:
        # one shard on each of N cards (with --device cpu, N shards on the
        # CPU), streamed one stop at a time
        from crdmodel_tpu_torch.parallel.sharded import \
            simulate_sharded_streaming
        return simulate_sharded_streaming(
            cfg, n_devices=args.devices, problem=problem,
            progress=not args.quiet, host_offload=args.host_offload,
            snapshot_mode=args.snapshot_mode, device=problem.device)
    return simulate_streaming(cfg, device=problem.device, problem=problem,
                              progress=not args.quiet,
                              host_offload=args.host_offload,
                              snapshot_mode=args.snapshot_mode)


def cmd_curvature(args):
    """The torus's curvature/coupling .vtp (crdmodel_tpu/cli.py:241-250)."""
    from crdmodel_tpu_torch.viz.curvature import (
        generate_curvature_coupling_vtp, plot_curvature_profiles)
    cfg = _cfg_from_args(args)
    path = generate_curvature_coupling_vtp(cfg, args.outdir)
    print(f"Saving output to file {path}")
    if args.profiles:
        p = plot_curvature_profiles(
            os.path.join(args.outdir, "curvature_profiles.png"))
        print(f"Saving profiles to {p}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="crdmodel_tpu_torch",
                                 description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="simulate + write outputs (replaces "
                       "util/ShellScripts/run*.sh)")
    _add_model_args(p)
    p.add_argument("--outdir", default="outputs")
    p.add_argument("--nprocs-files", type=int, default=1,
                   help="virtual rank count for reference-format files")
    p.add_argument("--npz", action="store_true")
    p.add_argument("--plot", action="store_true")
    p.add_argument("--map-torus", action="store_true")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device of the run: cuda (default, the card) "
                        "or cpu")
    p.add_argument("--devices", type=int, default=0,
                   help="shard the run over N devices (2D spatial mesh): "
                        "one shard a card, or N shards with --device cpu")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file path (with --checkpoint-every); "
                        "not ported yet")
    p.add_argument("--checkpoint-every", type=int, default=None,
                   metavar="N", help="checkpoint every N output intervals; "
                                     "not ported yet")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler trace (TensorBoard's "
                        "profiler format) covering the simulation")
    p.add_argument("--host-offload", action="store_true",
                   help="copy each snapshot to pinned host memory as "
                        "produced (bounded device memory for long runs; "
                        "the copy runs on a side stream behind the next "
                        "interval)")
    p.add_argument("--snapshot-mode", default=None,
                   choices=("device", "host", "none"),
                   help="snapshot capture policy (default: device, or "
                        "host with --host-offload). 'none' captures "
                        "nothing — throughput/soak mode: the run prints "
                        "stats and writes the manifest but no field "
                        "outputs")
    p.add_argument("--checkpoint-backend", default=None,
                   choices=("npz", "orbax"),
                   help="sharded checkpoint format; not ported yet")
    p.add_argument("--resume", default=None,
                   help="resume from a checkpoint file; not ported yet")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("curvature",
                       help="curvature/coupling vtp (GenCurvatureCoupling.py)")
    _add_model_args(p)
    p.add_argument("--outdir", default=".")
    p.add_argument("--profiles", action="store_true",
                   help="also plot K/C profiles (PlotGaussianAndCoupling.py)")
    p.set_defaults(fn=cmd_curvature)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
