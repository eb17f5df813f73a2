"""Time the port's redesigned kernels (K14 and K2; K4 and K11; K1 and K8;
K9 and K10; K6 and K12; K7 and K13; K3 and K5) of one tree on the card, or
of two trees in turns in one call.

    python3 scripts/kernel_ab.py [--tree DIR] [--label NAME] [--runs]
        [--measure all|kstep_rkc|divform|profile|shard_rkc_imex|box|
                   imex_aniso|unforced|families[,...]]
    python3 scripts/kernel_ab.py --compare OTHER_DIR [--runs] [--measure ...]

One tree: imports crdmodel_tpu_torch and chip_smoke.py from DIR (default:
this checkout), builds its kernels and prints one JSON line a measurement.
--measure kstep_rkc: K14 (bs32, f32, the canonical FHN torus's
(2,1600,400), a random state) at K = 2, 5, 10 (device time from profiler
traces, a sub-step's share, and a burst's time a launch from CUDA events);
K2 (f32, unfrozen) at (2,1600,400) and at the wide sheet's (2,12800,3200)
for s = 5, 9, 23 (CUDA events around bursts); with --runs also the wide
FHN sheet's run through simulate() (wall, steps, K2's mean device time a
launch from a traced second run) and the canonical FHN torus with
speculative_k = 5 over Tf = 5 (chip_smoke.profile_run: device-busy time,
kernels a step, idle share). --measure divform: K4 (bs32, f32, the
bounded tissue's (2,1600,400) from its ICs: a burst's time a launch from
CUDA events and the device time from profiler traces, as chip_smoke's
k4_timing), K11 (bs32, f32, shard 0 of the bounded tissue's and of the torus
fibres' 2x2 meshes, (2,816,216): device time and burst, as k11_timing),
and beside them K1, K5 and K8 (K5 on erk_tile.cuh), as chip_smoke's k1,
k5 and k8_timing (K1 and K5 also their device time);
the registers and blocks an SM of K4's and K11's bs32 kernels where the
tree has their queries; with --runs also the bounded tissue's bs32 run
over Tf = 1 on one device and on a 2x2 mesh of shards on cuda:0
(profile_run: device-busy time, kernels a step, idle share, wall, K4's
or K11's launches and mean device time). --measure profile: K1 (bs32,
f32, the canonical FHN torus's (2,1600,400), a random state, as
chip_smoke's k1_timing; and the canonical Goldbeter torus's (2,400,100)
from its ICs, device time only) and K8 (bs32, f32, shard 0 of the
canonical torus's 2x2 mesh, (2,816,216), from the ICs, as k8_timing),
each its device time from profiler traces and a burst's time a launch,
with the registers, blocks an SM and shared bytes of their bs32 kernels
where the tree has the queries; beside them K2 (the same shape, s = 5 and 23), K9
(shard 0 of the 10.24M-point torus's 2x2 mesh, s = 5 and 23) and K14 (K
= 5), which share K1's operator (rhs_common.cuh::ProfileRhs), each its
device time; with --runs also the canonical FHN torus per step over Tf =
5 on one device and on a 2x2 mesh of shards on cuda:0 (profile_run, K1's
or K8's launches and mean device time). --measure shard_rkc_imex: K9
(f32, shard 0 of the 10.24M-point FHN torus's 2x2 mesh, (2,3248,848),
from the ICs, s = 5, 9, 12, 13 and 23) and K10 (f32, Goldbeter from the ICs,
shard 0 of the 2.56M-point torus's 2x2 mesh, (2,1616,416), and of the
canonical torus's, (2,216,66)), each its device time from profiler
traces and a burst's time a launch, with the registers, blocks an SM and
shared bytes of the launched kernel and K9's chunks and grid barriers
where the tree has the queries; beside them K2 (s = 5 and 23 at the
canonical torus's (2,1600,400), its divergence branch at the bounded
tissue's, s = 23 at the wide sheet's (2,12800,3200)), K3 (Goldbeter at
(2,400,100) and (2,3200,800)) and K14 (K = 5), device times; with --runs
also the sharded 10.24M FHN rkc2 run and the sharded 2.56M Goldbeter
ark324 run over Tf = 1 on a 2x2 mesh of shards on cuda:0 (profile_run,
K9's or K10's launches and mean device time), a fourth untraced run of
the first that records K9's stage count at each launch (a host read of
s a launch: its histogram), and the steps (attempted, accepted,
rejected) of those two runs and of the canonical Goldbeter ark324 run on
a 2x2 mesh. --measure box: K6 (bs32, f32, the volumetric slab's
(2,32,512,512) from its ICs) and K12 (bs32, f32, shard 0 of the slab's
2x2 mesh, (2,32,272,272)) in the four operator modes (the no-flux slab,
the scar column, the 3-D field, the transmural tensor), each its device
time from profiler traces and a burst's time a launch, with the
registers, blocks an SM, shared bytes and plan of the stream kernel where
the tree has them, and in this tree's scheme the stream kernel on other
plans (z chunks from one to four) in the profile and tissue modes; K7
(f32, the slab from its ICs) and K13 (f32, shard 0 of its 2x2 mesh) at
s = 5 and 7 in the same modes, each the device time of a step (its chunk
launches summed) and a burst's time a step, with the chunks, plan,
registers, blocks an SM and shared bytes of the chunk kernel where the
tree has it; with --runs also the slab's bs32 run, its scar run, its
bs32 run on a 2x2 mesh of shards on cuda:0, its rkc2 run (K7) and its
rkc2 run on the 2x2 mesh (K13) over their whole Tf = 0.5 (profile_run:
device-busy time, kernels a step, idle share, walls, the box kernel's
launches and mean device time) and each run's attempted, accepted and
rejected steps from one more untraced run, and one untraced run of each
rkc2 program that records K7's and K13's stage count at each step (a
host read of s a step: its histogram). --measure imex_aniso: K3 (f32,
Goldbeter from the ICs at the canonical torus's (2,400,100) and the
2.56M-point torus's (2,3200,800), h = K3_H[0]) on the tree's plan and, in
a tree whose plan sizes the tiles to the grid, at (2,400,100) also on the
32x32 plan (case forced_32x32); K5 (bs32, f32, (2,1600,400) from the ICs
of k5_check's three cases: the fibres, a constant tensor inside no-flux
walls, random fields with the beta ramp); each its device time from
profiler traces (either tree's kernel: K3's by "fused_imex", K5's by
"AnisoRhs"), a burst's time a launch, the kernels it ran, and the plan,
registers, blocks an SM and shared bytes where the tree has the queries,
with ptxas's report of both sources; with --runs also the canonical
Goldbeter ark324 run, the single-device 2.56M-point Goldbeter ark324 run
over Tf = 1 and the fibered sheet's bs32 run (profile_run: device-busy
time, kernels a step, idle share, walls, the kernel's launches and mean
device time) and each run's attempted, accepted and rejected steps from
one more untraced run. --measure unforced: K1 (the canonical FHN torus's
(2,1600,400), a random state, bs32 and dopri54), K4 (the bounded
tissue's, bs32 and dopri54), K2 (s = 5 and 23, the profile branch there
and the divergence branch on the bounded tissue) and K3 (the canonical
Goldbeter torus's (2,400,100)), and the shard kernels on shards 0 and
3 of 2x2 meshes: K8 (the canonical FHN torus's (2,816,216), bs32 and
dopri54), K9 (its (2,848,248), s = 5 and 23), K10 (the Goldbeter
torus's (2,216,66)) and K11 (the bounded tissue's and, in its aniso mode,
the torus fibres' (2,816,216), bs32 and dopri54), each with a freeze, fz
0 and 1, f32 and f64, without a forcing; and the box kernels at the
volumetric slab's shape in the profile and tensor modes: K6 (bs32 and
dopri54), K7 (s = 5 and 7) and on shards 0 and 3 of its 2x2 mesh K12 and
K13 alike (time_unforced_box): a digest of each launch's y_new
(a shard kernel's block of it) and partial sums (sha256 of their bytes),
which the summary holds equal across the two trees
(`bitwise_across_trees`), and the device time of the f32 launches at fz
0 (a shard kernel's on shard 0). --measure families: K1 (bs32 and
dopri54), K2 (s = 5 and 23) and K3 of the six kinetics families beyond
the base three at the JAX soak matrix's shape (800x3200 torus, 2.56M
points; chip_smoke.py::soak_cfg), from a random state inside each
family's range (chip_smoke.py::family_state), unfrozen, f32 and f64
(chip_smoke.py::kin_steps): a digest of each launch's y_new and partial
sums, and the device time of the f32 launches. --measure all (the
default) takes the first two; names joined by commas take each. Only the
wrappers' public signatures are used, so an older tree of the port times
the same way.

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
# K9's: K2's, and the sharded 10.24M-point run's most common stage counts
K9_STAGES = (5, 9, 12, 13, 23)
K2_SAMPLES = {"canonical": (60, 10), "wide": (5, 3)}
# the profiler tag of K4's and K11's kernels in either tree: both schemes'
# kernels take the operator functor (DivformRhs, MixedDivformRhs)
TAG = "DivformRhs"
# and of K1's and K8's (ProfileRhs, which K2, K9 and K14 also take)
PROFILE_TAG = "ProfileRhs"
RUN_FIELDS = ("steps", "wall_s", "untraced_wall_s", "device_busy_ms",
              "kernels_per_step", "device_idle_share", "kernel_launches",
              "kernel_mean_us")


def emit(label, name, **fields):
    print(json.dumps({"tree": label, "measure": name, **fields}), flush=True)


def time_one_tree(tree, label, runs, measure):
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from crdmodel_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: kernel_ab.py needs an NVIDIA GPU")
    card = cs.card_line()
    emit(label, "build", seconds=_build.build(), card=card,
         **{f"ptxas_{src}": cs.ptxas_summary(src + ".cu") for src in (
             "fused_kstep", "fused_rkc", "fused_divform",
             "fused_shard_divform", "fused_step", "fused_shard_step")},
         **{f"ptxas_slots_{src}": slots_ptxas(cs, src + ".cu") for src in (
             "fused_divform", "fused_shard_divform", "fused_step",
             "fused_shard_step")})
    measures = set(measure.split(","))
    if measures & {"all", "kstep_rkc"}:
        time_kstep_rkc(cs, label, card, runs)
    if measures & {"all", "divform"}:
        time_divform(cs, label, card, runs)
    if "profile" in measures:
        time_profile(cs, label, card, runs)
    if "shard_rkc_imex" in measures:
        time_shard_rkc_imex(cs, label, card, runs)
    if "box" in measures:
        time_box(cs, label, card, runs)
    if "imex_aniso" in measures:
        time_imex_aniso(cs, label, card, runs)
    if "unforced" in measures:
        time_unforced(cs, label, card)
    if "families" in measures:
        time_families(cs, label, card)


def digest_of(y_new, ss):
    """sha256 of a launch's y_new and partial sums, after the launch."""
    import hashlib

    import torch
    torch.cuda.synchronize()
    return hashlib.sha256(y_new.cpu().numpy().tobytes()
                          + ss.cpu().numpy().tobytes()).hexdigest()[:16]


def time_families(cs, label, card):
    """--measure families: the six families' K1 (bs32, dopri54), K2 (s = 5,
    23) and K3 launches at the soak shape, a digest of each and (f32) its
    device time."""
    import numpy as np
    import torch

    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.ops.kernel_common import prepare_constants

    runs = (("bs32", None), ("dopri54", None), ("rkc2", 5), ("rkc2", 23),
            ("ark324", None))
    for model in cs.KIN_FAMILIES:
        problem = build_problem(cs.soak_cfg(model, "bs32"), device="cuda")
        y_np = cs.family_state(model, tuple(problem.y0.shape),
                               np.random.default_rng(cs.SEED))
        for dtype in (torch.float32, torch.float64):
            kc = prepare_constants(problem, dtype, "cuda")
            y = torch.tensor(y_np, dtype=dtype, device="cuda")
            rho = cs.problem_rho(problem, y)
            for method, s_val in runs:
                call, _, _, args, tag = cs.kin_steps(kc, y, rho, method,
                                                     s_val)
                fields = {}
                if dtype == torch.float32:
                    fields["device_us"] = cs.device_ms(
                        lambda: call(*args), tag) * 1e3
                emit(label, "families",
                     case=f"{model}/{method}/s{s_val}/{dtype}",
                     digest=digest_of(*call(*args)), **fields, card=card)
        del problem


def time_unforced(cs, label, card):
    """--measure unforced: K1-K4 and K8-K11 without a forcing, a digest and
    (f32, fz 0) the device time of each launch."""
    import numpy as np
    import torch

    from crdmodel_tpu_torch.config import config_from_ini
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import (fused_divform, fused_imex,
                                        fused_rkc, fused_step)
    from crdmodel_tpu_torch.ops.kernel_common import (
        prepare_constants, prepare_divform_constants)

    digest = digest_of

    def state(cfg, problem, seed):
        return cs.random_state(cfg, tuple(problem.y0.shape),
                               np.random.default_rng(seed))

    fhn = dataclasses.replace(config_from_ini(cs.INI, model="fhn",
                                              surface="torus"),
                              t_boundary=1.0)
    cfg_ap, ap_build = cs.bounded_tissue()
    ap = dataclasses.replace(cfg_ap, t_boundary=1.0)
    gb = dataclasses.replace(config_from_ini(cs.GB_INI, model="goldbeter",
                                             surface="torus"),
                             t_boundary=1.0)
    p_fhn = build_problem(fhn, "cuda")
    p_ap = build_problem(ap, "cuda", **ap_build)
    p_gb = build_problem(gb, "cuda")
    y_fhn, y_ap, y_gb = (state(fhn, p_fhn, cs.SEED), state(ap, p_ap, cs.SEED),
                         state(gb, p_gb, cs.SEED))
    for dtype in (torch.float32, torch.float64):
        kcs = {"k1": prepare_constants(p_fhn, dtype, "cuda"),
               "k4": prepare_divform_constants(p_ap, dtype, "cuda")}
        ys = {"k1": torch.tensor(y_fhn, dtype=dtype, device="cuda"),
              "k4": torch.tensor(y_ap, dtype=dtype, device="cuda")}
        hs = {"k1": cs.H, "k4": cs.K4_H}
        steps = {"k1": fused_step.fused_step,
                 "k4": fused_divform.fused_divform_step}
        tags = {"k1": PROFILE_TAG, "k4": TAG}
        for fz in (0.0, 1.0):
            fzt = torch.tensor(fz, dtype=dtype, device="cuda")
            for name in ("k1", "k4"):
                cfg = fhn if name == "k1" else ap
                h = torch.tensor(hs[name], dtype=dtype, device="cuda")
                for method in ("bs32", "dopri54"):
                    args = (ys[name], h, fzt, kcs[name], TABLEAUS[method],
                            cfg.rtol, cfg.atol)
                    fields = {}
                    if dtype == torch.float32 and not fz:
                        fields["device_us"] = cs.device_ms(
                            lambda: steps[name](*args), tags[name]) * 1e3
                    emit(label, f"unforced_{name}",
                         case=f"{method}/fz{fz:g}/{dtype}",
                         digest=digest(*steps[name](*args)), **fields,
                         card=card)
            mu1, ctab = fused_rkc.static_stage_tables(fused_rkc.S_MAX_KERNEL,
                                                      dtype, "cuda")
            for branch, problem, y_np, cfg in (
                    ("profile", p_fhn, y_fhn, fhn),
                    ("divform", p_ap, y_ap, ap)):
                kc = (prepare_divform_constants if branch == "divform"
                      else prepare_constants)(problem, dtype, "cuda")
                y = torch.tensor(y_np, dtype=dtype, device="cuda")
                rho = cs.problem_rho(problem, y)
                for s_val in (5, 23):
                    h, st = cs.rkc_step_inputs(s_val, rho, dtype)
                    args = (y, h, fzt, st, mu1, ctab, kc, cfg.rtol, cfg.atol)
                    fields = {}
                    if dtype == torch.float32 and not fz:
                        fields["device_us"] = cs.device_ms(
                            lambda: fused_rkc.fused_rkc_step(*args),
                            "fused_rkc") * 1e3
                    emit(label, "unforced_k2",
                         case=f"{branch}/s{s_val}/fz{fz:g}/{dtype}",
                         digest=digest(*fused_rkc.fused_rkc_step(*args)),
                         **fields, card=card)
            kc = prepare_constants(p_gb, dtype, "cuda")
            y = torch.tensor(y_gb, dtype=dtype, device="cuda")
            args = (y, torch.tensor(cs.K3_H[0], dtype=dtype, device="cuda"),
                    fzt, kc, gb.rtol, gb.atol)
            fields = {}
            if dtype == torch.float32 and not fz:
                fields["device_us"] = cs.device_ms(
                    lambda: fused_imex.fused_imex_step(*args),
                    "fused_imex") * 1e3
            emit(label, "unforced_k3", case=f"fz{fz:g}/{dtype}",
                 digest=digest(*fused_imex.fused_imex_step(*args)), **fields,
                 card=card)
    time_unforced_shards(cs, label, card, digest, state, fhn, gb, ap,
                         ap_build)
    time_unforced_box(cs, label, card, digest)


def time_unforced_shards(cs, label, card, digest, state, fhn, gb, ap,
                         ap_build):
    """--measure unforced's shard kernels K8-K11 on shards 0 and 3 of a 2x2
    mesh on cuda:0: a digest of each launch's block of y_new and partial
    sums, and the device time of the f32 launches at fz 0 on shard 0."""
    import torch

    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import fused_shard_divform as f11
    from crdmodel_tpu_torch.ops import fused_shard_imex as f10
    from crdmodel_tpu_torch.ops import fused_shard_rkc as f9
    from crdmodel_tpu_torch.ops import fused_shard_step as f8
    from crdmodel_tpu_torch.ops.fused_rkc import static_stage_tables

    mesh = cs.shard_mesh(cs.SHARD_MESH)
    torus, torus_build = cs.torus_fibres(cs.aniso_sheet()[0])
    torus = dataclasses.replace(torus, t_boundary=1.0)
    problems = {"fhn": build_problem(fhn, "cuda"),
                "gb": build_problem(gb, "cuda"),
                "ap": build_problem(ap, "cuda", **ap_build),
                "torus": build_problem(torus, "cuda", **torus_build)}
    states = {k: state(p.cfg, p, cs.SEED) for k, p in problems.items()}

    def run(name, case, fn, args_of, bufs, consts, dtype, tag, halo):
        for fz in (0.0, 1.0):
            fzt = torch.tensor(fz, dtype=dtype, device="cuda")
            for k in (0, 3):
                args = args_of(bufs[k], fzt, consts[k])
                fields = {}
                if dtype == torch.float32 and not fz and k == 0:
                    fields["device_us"] = cs.device_ms(lambda: fn(*args),
                                                       tag) * 1e3
                y_new, ss = fn(*args)
                emit(label, f"unforced_{name}",
                     case=f"{case}/shard{k}/fz{fz:g}/{dtype}",
                     digest=digest(f8.interior(y_new, halo).contiguous(), ss),
                     **fields, card=card)

    for dtype in (torch.float32, torch.float64):
        p = problems["fhn"]
        bufs, consts = cs.shard_inputs(p, mesh, states["fhn"], dtype, f8.HALO)
        h = torch.tensor(cs.H, dtype=dtype, device="cuda")
        for method in ("bs32", "dopri54"):
            run("k8", method, f8.fused_shard_step,
                lambda b, fz, sc, tab=TABLEAUS[method]: (
                    b, h, fz, sc, tab, fhn.rtol, fhn.atol),
                bufs, consts, dtype, "fused_erk", f8.HALO)
        bufs, consts = cs.shard_inputs(p, mesh, states["fhn"], dtype,
                                       f9.P_RKC)
        mu1, ctab = static_stage_tables(f9.S_MAX_KERNEL, dtype, "cuda")
        rho = cs.problem_rho(p, torch.tensor(states["fhn"], dtype=dtype,
                                             device="cuda"))
        for s_val in (5, 23):
            hs, st = cs.rkc_step_inputs(s_val, rho, dtype)
            run("k9", f"s{s_val}", f9.fused_shard_rkc_step,
                lambda b, fz, sc, hs=hs, st=st: (
                    b, hs, fz, st, mu1, ctab, sc, fhn.rtol, fhn.atol),
                bufs, consts, dtype, "fused_rkc", f9.P_RKC)
        p = problems["gb"]
        bufs, consts = cs.shard_inputs(p, mesh, states["gb"], dtype,
                                       f10.HALO)
        h = torch.tensor(cs.K3_H[0], dtype=dtype, device="cuda")
        run("k10", "goldbeter", f10.fused_shard_imex_step,
            lambda b, fz, sc: (b, h, fz, sc, gb.rtol, gb.atol), bufs, consts,
            dtype, "fused_imex", f10.HALO)
        for case, key, aniso, cfg in (("bounded_ap", "ap", False, ap),
                                      ("torus_fibres", "torus", True, torus)):
            bufs, consts = cs.shard_divform_inputs(
                problems[key], mesh, states[key], dtype, aniso)
            h = torch.tensor(cs.K4_H if not aniso else cs.K5_H, dtype=dtype,
                             device="cuda")
            for method in ("bs32", "dopri54"):
                run("k11", f"{case}/{method}", f11.fused_shard_divform_step,
                    lambda b, fz, sc, tab=TABLEAUS[method], h=h, cfg=cfg: (
                        b, h, fz, sc, tab, cfg.rtol, cfg.atol),
                    bufs, consts, dtype, "fused_erk", f11.HALO)


def time_unforced_box(cs, label, card, digest):
    """--measure unforced's box kernels at the volumetric slab's shape in
    the profile mode (the noflux slab) and the tensor mode (the transmural
    tensor), each with a freeze: K6 (bs32, dopri54) and K7 (s = 5 and 7)
    at (2, 32, 512, 512), K12 (bs32, dopri54) and K13 (s = 5 and 7) on
    shards 0 and 3 of the slab's 2x2 mesh on cuda:0; fz 0 and 1, f32 and
    f64: a digest of each launch's y_new (a shard kernel's block of it)
    and partial sums, and the device time of the f32 launches at fz 0 (a
    shard kernel's on shard 0)."""
    import numpy as np
    import torch

    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import box_stream
    from crdmodel_tpu_torch.ops import fused_box3d as f6
    from crdmodel_tpu_torch.ops import fused_box3d_rkc as f7
    from crdmodel_tpu_torch.ops import fused_shard_box3d as f12
    from crdmodel_tpu_torch.ops import fused_shard_box3d_rkc as f13
    from crdmodel_tpu_torch.ops.fused_rkc import static_stage_tables
    from crdmodel_tpu_torch.ops.kernel_common import (
        make_shard_box_constants, prepare_box_constants)

    cfg_box = cs.volumetric_box()
    mesh = cs.shard_mesh(cs.SHARD_MESH)
    modes = {label: (c, kw) for label, c, kw in cs.box_modes(cfg_box)}

    def emit_launch(name, case, fn, args, tag, timed, group=1, halo=None):
        fields = {}
        if timed:
            fields["device_us"] = cs.device_ms(lambda: fn(*args), tag,
                                               group=group) * 1e3
        y_new, ss = fn(*args)
        if halo is not None:
            y_new = f12.interior(y_new, halo).contiguous()
        emit(label, f"unforced_{name}", case=case,
             digest=digest(y_new, ss), **fields, card=card)

    for mode in ("noflux_slab", "transmural_tensor"):
        cfg, build_kw = modes[mode]
        cfg = dataclasses.replace(cfg, t_boundary=0.1)
        problem = build_problem(cfg, "cuda", **build_kw)
        y_np = cs.random_state(cfg, tuple(problem.y0.shape),
                               np.random.default_rng(cs.SEED))
        for dtype in (torch.float32, torch.float64):
            bc = prepare_box_constants(problem, dtype, "cuda")
            y = torch.tensor(y_np, dtype=dtype, device="cuda")
            bufs, consts = cs.shard_inputs(problem, mesh, y_np, dtype,
                                           f12.HALO, make_shard_box_constants)
            h = torch.tensor(cs.BOX_H, dtype=dtype, device="cuda")
            mu1, ctab = static_stage_tables(f7.C_RKC, dtype, "cuda")
            rho = cs.problem_rho(problem, y)
            rkc_group = (box_stream.rkc_launches(f7.C_RKC)
                         if box_stream.rkc_uses_stream(bc.kind) else 1)
            for fz in (0.0, 1.0):
                fzt = torch.tensor(fz, dtype=dtype, device="cuda")
                timed = dtype == torch.float32 and not fz
                for method in ("bs32", "dopri54"):
                    tab = TABLEAUS[method]
                    emit_launch("k6", f"{mode}/{method}/fz{fz:g}/{dtype}",
                                f6.fused_box3d_step,
                                (y, h, fzt, bc, tab, cfg.rtol, cfg.atol),
                                box_stream.kernel_name(tab), timed)
                    for k in (0, 3):
                        emit_launch(
                            "k12",
                            f"{mode}/{method}/shard{k}/fz{fz:g}/{dtype}",
                            f12.fused_shard_box3d_step,
                            (bufs[k], h, fzt, consts[k], tab, cfg.rtol,
                             cfg.atol),
                            box_stream.kernel_name(tab, shard=True),
                            timed and k == 0, halo=f12.HALO)
                for s_val in (5, 7):
                    hs, st = cs.rkc_step_inputs(s_val, rho, dtype)
                    emit_launch("k7", f"{mode}/s{s_val}/fz{fz:g}/{dtype}",
                                f7.fused_box3d_rkc_step,
                                (y, hs, fzt, st, mu1, ctab, bc, cfg.rtol,
                                 cfg.atol),
                                box_stream.rkc_kernel_name(bc.kind), timed,
                                rkc_group)
                    for k in (0, 3):
                        emit_launch(
                            "k13", f"{mode}/s{s_val}/shard{k}/fz{fz:g}/"
                            f"{dtype}",
                            f13.fused_shard_box3d_rkc_step,
                            (bufs[k], hs, fzt, st, mu1, ctab, consts[k],
                             cfg.rtol, cfg.atol),
                            box_stream.rkc_kernel_name(bc.kind, shard=True),
                            timed and k == 0, rkc_group, halo=f12.HALO)
            del bc, y, bufs, consts
        del problem


def slots_ptxas(cs, source):
    """ptxas's most registers and spills over the register-resident
    scheme's kernels of csrc/<source>, or None where it has none."""
    try:
        return cs.ptxas_summary(source, "fused_erk_slots_kernel")
    except ValueError:      # no such kernel: max() of nothing
        return None


def time_kstep_rkc(cs, label, card, runs):
    import numpy as np
    import torch

    from crdmodel_tpu_torch.config import config_from_ini
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import fused_kstep, fused_rkc
    from crdmodel_tpu_torch.ops.kernel_common import prepare_constants

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
    k2 = [e["dur"] for e in traced_kernels(lambda: cs.run_program(wide, {}))
          if "fused_rkc" in e["name"]]
    emit(label, "wide_run", steps=steps, wall_s=wall,
         k2_launches_traced=len(k2), k2_mean_device_us=float(np.mean(k2)),
         card=card)
    fields = cs.profile_run(dataclasses.replace(cfg, speculative_k=5), {},
                            5.0, "fused_kstep_kernel")
    emit(label, "kstep_run", **{k: fields[k] for k in RUN_FIELDS}, card=card)


def slot_info(symbol, *args):
    """The registers, blocks an SM and shared bytes of a bs32 kernel of
    the register-resident scheme (K1, K4, K8, K11), where the tree has its
    query (ops/erk_slots.py, ops/_build.py SIGNATURES), else {}."""
    import torch

    from crdmodel_tpu_torch.ops import _build
    try:
        from crdmodel_tpu_torch.ops import erk_slots
    except ImportError:
        return {}
    if symbol not in _build.SIGNATURES:
        return {}
    return erk_slots.kernel_info(symbol, torch.float32, *args)


def time_divform(cs, label, card, runs):
    import numpy as np
    import torch

    from crdmodel_tpu_torch.config import config_from_ini
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import fused_aniso, fused_divform
    from crdmodel_tpu_torch.ops import fused_shard_divform as f11
    from crdmodel_tpu_torch.ops import fused_shard_step as f8
    from crdmodel_tpu_torch.ops import fused_step
    from crdmodel_tpu_torch.ops.kernel_common import (
        prepare_aniso_constants, prepare_constants, prepare_divform_constants)

    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device="cuda")
    tab = TABLEAUS["bs32"]
    cfg_ap, ap_build = cs.bounded_tissue()
    problem = build_problem(dataclasses.replace(cfg_ap, t_boundary=0.0),
                            "cuda", **ap_build)
    dc = prepare_divform_constants(problem, f32, "cuda")
    y = problem.y0.contiguous()
    args = (y, torch.tensor(cs.K4_H, device="cuda"), zero, dc, tab,
            cfg_ap.rtol, cfg_ap.atol)

    def k4():
        return fused_divform.fused_divform_step(*args)

    emit(label, "k4", shape=list(y.shape), kernel_us=cs.median_ms(k4) * 1e3,
         device_us=cs.device_ms(k4, TAG) * 1e3,
         **slot_info("crd_fused_divform_info", dc.kinetics_id), card=card)
    del problem, dc, y, args

    cfg_aniso, aniso_build = cs.aniso_sheet()
    cfg_torus, torus_build = cs.torus_fibres(cfg_aniso)
    mesh = cs.shard_mesh(cs.SHARD_MESH)
    for case, cfg, build_kw, aniso, h in (
            ("bounded_ap", cfg_ap, ap_build, False, cs.K4_H),
            ("fibres_torus", cfg_torus, torus_build, True, cs.K5_H)):
        problem = build_problem(dataclasses.replace(cfg, t_boundary=0.0),
                                "cuda", **build_kw)
        bufs, consts = cs.shard_divform_inputs(
            problem, mesh, problem.y0.cpu().numpy(), f32, aniso)
        args = (bufs[0], torch.tensor(h, device="cuda"), zero, consts[0],
                tab, cfg.rtol, cfg.atol)

        def k11():
            return f11.fused_shard_divform_step(*args)

        emit(label, "k11", case=case, shape=list(bufs[0].shape),
             device_us=cs.device_ms(k11, TAG) * 1e3,
             burst_us=cs.median_ms(k11) * 1e3,
             **slot_info("crd_fused_shard_divform_info", int(aniso),
                         consts[0].kinetics_id), card=card)
        del problem, bufs, consts, args

    # K1, K5 and K8: the timings of chip_smoke's k1, k5 and k8_timing
    cfg = config_from_ini(cs.INI, model="fhn", surface="torus")
    problem = build_problem(cfg, "cuda")
    kc = prepare_constants(problem, f32, "cuda")
    y = torch.tensor(cs.random_state(cfg, tuple(problem.y0.shape),
                                     np.random.default_rng(cs.SEED)),
                     dtype=f32, device="cuda")
    args = (y, torch.tensor(cs.H, dtype=f32, device="cuda"), zero, kc, tab,
            cfg.rtol, cfg.atol)

    def k1():
        return fused_step.fused_step(*args)

    emit(label, "k1", shape=list(y.shape), kernel_us=cs.median_ms(k1) * 1e3,
         device_us=cs.device_ms(k1, PROFILE_TAG) * 1e3,
         card=card)
    problem = build_problem(dataclasses.replace(cfg_aniso, t_boundary=0.0),
                            "cuda", **aniso_build)
    ac = prepare_aniso_constants(problem, f32, "cuda")
    y = problem.y0.contiguous()
    args = (y, torch.tensor(cs.K5_H, device="cuda"), zero, ac, tab,
            cfg_aniso.rtol, cfg_aniso.atol)

    def k5():
        return fused_aniso.fused_aniso_step(*args)

    emit(label, "k5", shape=list(y.shape), kernel_us=cs.median_ms(k5) * 1e3,
         device_us=cs.device_ms(k5, "AnisoRhs") * 1e3, card=card)
    problem = build_problem(cfg, "cuda")
    bufs, consts = cs.shard_inputs(problem, mesh, problem.y0.cpu().numpy(),
                                   f32, f8.HALO)
    args = (bufs[0], torch.tensor(cs.H, device="cuda"), zero, consts[0], tab,
            cfg.rtol, cfg.atol)

    def k8():
        return f8.fused_shard_step(*args)

    emit(label, "k8", shape=list(bufs[0].shape),
         device_us=cs.device_ms(k8, PROFILE_TAG) * 1e3,
         burst_us=cs.median_ms(k8) * 1e3, card=card)
    del problem, bufs, consts, args, y

    if not runs:
        return
    for name, run_mesh in (("bounded_ap_run", None),
                           ("sharded_bounded_ap_run", mesh)):
        fields = cs.profile_run(cfg_ap, ap_build, 1.0, TAG, mesh=run_mesh)
        emit(label, name, **{k: fields[k] for k in RUN_FIELDS}, card=card)


def time_profile(cs, label, card, runs):
    import numpy as np
    import torch

    from crdmodel_tpu_torch.config import config_from_ini
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import fused_kstep, fused_rkc
    from crdmodel_tpu_torch.ops import fused_shard_rkc as f9
    from crdmodel_tpu_torch.ops import fused_shard_step as f8
    from crdmodel_tpu_torch.ops import fused_step
    from crdmodel_tpu_torch.ops.kernel_common import prepare_constants

    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device="cuda")
    tab = TABLEAUS["bs32"]
    cfg = config_from_ini(cs.INI, model="fhn", surface="torus")
    problem = build_problem(cfg, "cuda")
    kc = prepare_constants(problem, f32, "cuda")
    y = torch.tensor(cs.random_state(cfg, tuple(problem.y0.shape),
                                     np.random.default_rng(cs.SEED)),
                     dtype=f32, device="cuda")
    h = torch.tensor(cs.H, dtype=f32, device="cuda")

    def k1():
        return fused_step.fused_step(y, h, zero, kc, tab, cfg.rtol,
                                     cfg.atol)

    emit(label, "k1", shape=list(y.shape),
         device_us=cs.device_ms(k1, PROFILE_TAG) * 1e3,
         burst_us=cs.median_ms(k1) * 1e3,
         **slot_info("crd_fused_erk_step_info", kc.kinetics_id), card=card)
    cfg_gb = config_from_ini(cs.GB_INI, model="goldbeter", surface="torus",
                             use_pallas=True)
    gb = build_problem(cfg_gb, "cuda")
    gc = prepare_constants(gb, f32, "cuda")
    y_gb = gb.y0.contiguous()
    emit(label, "k1_goldbeter", shape=list(y_gb.shape),
         device_us=cs.device_ms(
             lambda: fused_step.fused_step(y_gb, h, zero, gc, tab,
                                           cfg_gb.rtol, cfg_gb.atol),
             PROFILE_TAG) * 1e3,
         **slot_info("crd_fused_erk_step_info", gc.kinetics_id), card=card)
    del gb, gc, y_gb
    n = torch.tensor(5, dtype=torch.int32, device="cuda")
    emit(label, "k14", shape=list(y.shape), k=5,
         device_us=cs.device_ms(
             lambda: fused_kstep.fused_kstep(y, h, zero, n, kc, tab, 5,
                                             cfg.rtol, cfg.atol),
             "fused_kstep_kernel") * 1e3, card=card)
    mu1, ctab = fused_rkc.static_stage_tables(fused_rkc.S_MAX_KERNEL, f32,
                                              "cuda")
    rho = cs.problem_rho(problem, problem.y0)
    for s in (5, 23):
        hs, st = cs.rkc_step_inputs(s, rho, f32)
        emit(label, "k2", shape=list(y.shape), s=s,
             device_us=cs.device_ms(
                 lambda: fused_rkc.fused_rkc_step(y, hs, zero, st, mu1, ctab,
                                                  kc, cfg.rtol, cfg.atol),
                 "fused_rkc") * 1e3, card=card)
    del problem, kc, y

    mesh = cs.shard_mesh(cs.SHARD_MESH)
    problem = build_problem(cfg, "cuda")
    bufs, consts = cs.shard_inputs(problem, mesh, problem.y0.cpu().numpy(),
                                   f32, f8.HALO)
    args = (bufs[0], h, zero, consts[0], tab, cfg.rtol, cfg.atol)

    def k8():
        return f8.fused_shard_step(*args)

    emit(label, "k8", shape=list(bufs[0].shape),
         device_us=cs.device_ms(k8, PROFILE_TAG) * 1e3,
         burst_us=cs.median_ms(k8) * 1e3,
         **slot_info("crd_fused_shard_step_info", consts[0].kinetics_id),
         card=card)
    del problem, bufs, consts, args

    large = cs.large_fhn_torus()
    problem = build_problem(large, "cuda")
    bufs, consts = cs.shard_inputs(problem, mesh, problem.y0.cpu().numpy(),
                                   f32, f9.P_RKC)
    mu1, ctab = fused_rkc.static_stage_tables(f9.S_MAX_KERNEL, f32, "cuda")
    rho = cs.problem_rho(problem, problem.y0)
    for s in (5, 23):
        hs, st = cs.rkc_step_inputs(s, rho, f32)
        emit(label, "k9", shape=list(bufs[0].shape), s=s,
             device_us=cs.device_ms(
                 lambda: f9.fused_shard_rkc_step(bufs[0], hs, zero, st, mu1,
                                                 ctab, consts[0], large.rtol,
                                                 large.atol),
                 "fused_rkc", cs.WIDE_TIMED[0]) * 1e3,
             card=card)
    del problem, bufs, consts

    if not runs:
        return
    for name, run_mesh in (("fhn_run", None), ("sharded_fhn_run", mesh)):
        fields = cs.profile_run(cfg, {}, 5.0, PROFILE_TAG, mesh=run_mesh)
        emit(label, name, **{k: fields[k] for k in RUN_FIELDS}, card=card)


def tree_info(module, name, *args):
    """module.<name>(*args) where the tree has the query (a kernel's
    registers, blocks an SM, shared bytes), else {}."""
    query = getattr(module, name, None)
    return {} if query is None else query(*args)


def steps_of(res):
    """A run's attempted, accepted and rejected steps."""
    return dict(steps=res.total_steps(),
                accepted=int(res.stats.accepted.sum()),
                rejected=int(res.stats.rejected.sum()))


def time_shard_rkc_imex(cs, label, card, runs):
    import collections

    import torch

    from crdmodel_tpu_torch.config import config_from_ini
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import fused_imex, fused_kstep, fused_rkc
    from crdmodel_tpu_torch.ops import fused_shard_imex as f10
    from crdmodel_tpu_torch.ops import fused_shard_rkc as f9
    from crdmodel_tpu_torch.ops.kernel_common import (
        prepare_constants, prepare_divform_constants)

    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device="cuda")
    mesh = cs.shard_mesh(cs.SHARD_MESH)
    mu1, ctab = fused_rkc.static_stage_tables(fused_rkc.S_MAX_KERNEL, f32,
                                              "cuda")
    emit(label, "ptxas", card=card,
         **{src: cs.ptxas_entries(src + ".cu", tag) for src, tag in (
             ("fused_shard_rkc", "fused_rkc"),
             ("fused_shard_imex", "fused_imex"),
             ("fused_rkc", "fused_rkc"))})

    # K9 at shard 0 of the 10.24M-point torus
    large = cs.large_fhn_torus()
    problem = build_problem(large, "cuda")
    bufs, consts = cs.shard_inputs(problem, mesh, problem.y0.cpu().numpy(),
                                   f32, f9.P_RKC)
    rho = cs.problem_rho(problem, problem.y0)
    for s in K9_STAGES:
        hs, st = cs.rkc_step_inputs(s, rho, f32)
        args = (bufs[0], hs, zero, st, mu1, ctab, consts[0], large.rtol,
                large.atol)

        def k9():
            return f9.fused_shard_rkc_step(*args)

        chunks = getattr(f9, "extent_rings", None)
        emit(label, "k9", shape=list(bufs[0].shape), s=s,
             device_us=cs.device_ms(k9, "fused_rkc", cs.WIDE_TIMED[0]) * 1e3,
             burst_us=cs.median_ms(k9, *cs.WIDE_TIMED) * 1e3,
             **({} if chunks is None else dict(
                 chunks=len(chunks(s)), grid_barriers=len(chunks(s)) - 1)),
             **tree_info(f9, "kernel_info", f32, consts[0].kinetics_id),
             card=card)
    del problem, bufs, consts

    # K10 from the ICs of the two Goldbeter tori's shards
    cfg_gb = config_from_ini(cs.GB_INI, model="goldbeter", surface="torus",
                             use_pallas=True, method="ark324")
    for cfg in (cs.large_goldbeter_torus(), cfg_gb):
        problem = build_problem(cfg, "cuda")
        bufs, consts = cs.shard_inputs(problem, mesh,
                                       problem.y0.cpu().numpy(), f32,
                                       f10.HALO)
        args = (bufs[0], torch.tensor(cs.K3_H[0], device="cuda"), zero,
                consts[0], cfg.rtol, cfg.atol)

        def k10():
            return f10.fused_shard_imex_step(*args)

        emit(label, "k10", shape=list(bufs[0].shape),
             device_us=cs.device_ms(k10, "fused_imex",
                                    cs.WIDE_TIMED[0]) * 1e3,
             burst_us=cs.median_ms(k10, *cs.WIDE_TIMED) * 1e3,
             **tree_info(f10, "kernel_info", f32, consts[0].kinetics_id),
             card=card)
        del problem, bufs, consts

    # K2 (both operators, both widths), K3 and K14 beside them
    cfg = config_from_ini(cs.INI, model="fhn", surface="torus")
    cfg_ap, ap_build = cs.bounded_tissue()
    for case, c, build_kw, prepare, stages in (
            ("canonical", cfg, {}, prepare_constants, (5, 23)),
            ("bounded_ap", dataclasses.replace(cfg_ap, t_boundary=0.0),
             ap_build, prepare_divform_constants, (5, 23)),
            ("wide", cs.wide_sheet(), {}, prepare_constants, (23,))):
        problem = build_problem(c, "cuda", **build_kw)
        kc = prepare(problem, f32, "cuda")
        y = problem.y0.contiguous()
        rho = cs.problem_rho(problem, y)
        for s in stages:
            hs, st = cs.rkc_step_inputs(s, rho, f32)
            emit(label, "k2", case=case, shape=list(y.shape), s=s,
                 device_us=cs.device_ms(
                     lambda: fused_rkc.fused_rkc_step(
                         y, hs, zero, st, mu1, ctab, kc, c.rtol, c.atol),
                     "fused_rkc", *(() if case != "wide"
                                    else (cs.WIDE_TIMED[0],))) * 1e3,
                 card=card)
        del problem, kc, y
    for c in (config_from_ini(cs.GB_INI, model="goldbeter", surface="torus"),
              config_from_ini(cs.GB_INI, model="goldbeter", surface="torus",
                              x_mesh=cs.K3_BIG_MESH)):
        problem = build_problem(c, "cuda")
        kc = prepare_constants(problem, f32, "cuda")
        y = problem.y0.contiguous()
        h = torch.tensor(cs.K3_H[0], device="cuda")
        emit(label, "k3", shape=list(y.shape),
             device_us=cs.device_ms(
                 lambda: fused_imex.fused_imex_step(y, h, zero, kc, c.rtol,
                                                    c.atol),
                 K3_TAG) * 1e3, card=card)
        del problem, kc, y
    problem = build_problem(cfg, "cuda")
    kc = prepare_constants(problem, f32, "cuda")
    y = problem.y0.contiguous()
    h = torch.tensor(cs.H, dtype=f32, device="cuda")
    n = torch.tensor(5, dtype=torch.int32, device="cuda")
    emit(label, "k14", shape=list(y.shape), k=5,
         device_us=cs.device_ms(
             lambda: fused_kstep.fused_kstep(y, h, zero, n, kc,
                                             TABLEAUS["bs32"], 5, cfg.rtol,
                                             cfg.atol),
             "fused_kstep_kernel") * 1e3, card=card)
    del problem, kc, y

    if not runs:
        return
    for name, c, tag in (("sharded_large_fhn_rkc2_run", large, "fused_rkc"),
                         ("sharded_large_goldbeter_ark324_run",
                          cs.large_goldbeter_torus(), "fused_imex")):
        fields = cs.profile_run(c, {}, c.t_final, tag, mesh=mesh)
        emit(label, name, **{k: fields[k] for k in RUN_FIELDS}, card=card)
    # K9's stage counts, a host read of s a launch (untraced, unreported
    # time), and the three sharded runs' steps
    seen = collections.Counter()
    step = f9.fused_shard_rkc_step

    def counted(buf, h, fz, s, *rest):
        seen[int(s)] += 1
        return step(buf, h, fz, s, *rest)

    counted.launches = 0   # the wrapper counts its launches on its own name
    f9.fused_shard_rkc_step = counted
    try:
        res = cs.run_program(large, {}, mesh)
    finally:
        f9.fused_shard_rkc_step = step
    emit(label, "k9_stage_counts", config=large.program_name,
         histogram={str(k): seen[k] for k in sorted(seen)},
         launches=sum(seen.values()), **steps_of(res), card=card)
    for name, c in (("sharded_large_goldbeter_ark324",
                     cs.large_goldbeter_torus()),
                    ("sharded_goldbeter_ark324", cfg_gb)):
        emit(label, name + "_steps", **steps_of(cs.run_program(c, {}, mesh)),
             card=card)


# the profiler tags of K3's and K5's kernels in either tree: K3's first
# port (fused_imex_tile_kernel) and its slots kernel
# (fused_imex_slots_kernel) both hold "fused_imex"; both of K5's schemes
# (fused_erk_tile_kernel, fused_erk_slots_kernel) take AnisoRhs
K3_TAG = "fused_imex"
K5_TAG = "AnisoRhs"
K3_KERNELS = ("fused_imex_tile_kernel", "fused_imex_slots_kernel")
K5_KERNELS = ("fused_erk_tile_kernel", "fused_erk_slots_kernel")


def launched(fn, names):
    """Which of `names` the calls of fn ran (pooled profiler traces)."""
    from crdmodel_tpu_torch.ops import trace
    ran = trace.kernel_names(fn)
    return sorted(n for n in names if any(n in k for k in ran))


def time_imex_aniso(cs, label, card, runs):
    import numpy as np
    import torch

    from crdmodel_tpu_torch.config import config_from_ini
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import _build, fused_aniso, fused_imex
    from crdmodel_tpu_torch.ops.kernel_common import (
        prepare_aniso_constants, prepare_constants)

    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device="cuda")
    emit(label, "ptxas", card=card,
         **{src: cs.ptxas_entries(src + ".cu", tag) for src, tag in (
             ("fused_imex", "fused_imex"), ("fused_aniso", "fused_erk"))})

    # K3 from the Goldbeter ICs at the canonical torus's shape and the
    # 2.56M-point one's, on the tree's plan; in a tree with the
    # small-grid plan, also on the 32x32 plan (SMS = 0)
    plan_of = getattr(fused_imex, "slots_plan", None)
    for mesh in (None, cs.K3_BIG_MESH):
        c = config_from_ini(cs.GB_INI, model="goldbeter", surface="torus",
                            **({} if mesh is None else {"x_mesh": mesh}))
        problem = build_problem(c, "cuda")
        kc = prepare_constants(problem, f32, "cuda")
        y = problem.y0.contiguous()
        h = torch.tensor(cs.K3_H[0], device="cuda")

        def k3():
            return fused_imex.fused_imex_step(y, h, zero, kc, c.rtol, c.atol)

        forced = ([None] if plan_of is None
                  or plan_of(c.ny, c.nx, 4).tile_y == fused_imex.TILE
                  else [None, 0])
        for sms in forced:
            saved = getattr(fused_imex, "SMS", None)
            if sms is not None:
                fused_imex.SMS = sms
            try:
                plan = None if plan_of is None else plan_of(c.ny, c.nx, 4)
                emit(label, "k3", shape=list(y.shape),
                     **({} if sms is None else {"case": "forced_32x32"}),
                     plan="first port" if plan is None
                     else f"{plan.tile_x}x{plan.tile_y}",
                     device_us=cs.device_ms(k3, K3_TAG) * 1e3,
                     burst_us=cs.median_ms(k3) * 1e3,
                     kernels=launched(k3, K3_KERNELS),
                     **({} if plan is None else dict(
                         blocks=plan.blocks,
                         **fused_imex.kernel_info(f32, kc.kinetics_id,
                                                  plan.tile_y))),
                     card=card)
            finally:
                if sms is not None:
                    fused_imex.SMS = saved
        del problem, kc, y

    # K5 bs32 at (2,1600,400) in k5_check's three cases, from their ICs
    cfg_aniso, aniso_build = cs.aniso_sheet()
    cfg_flat = dataclasses.replace(
        config_from_ini(cs.INI, model="fhn", surface="torus"),
        surface="flat", vary_beta=1)
    rng = np.random.default_rng(cs.SEED + 6)
    dxx = 0.05 + 0.1 * rng.random((cfg_flat.ny, cfg_flat.nx))
    dyy = 0.03 + 0.1 * rng.random((cfg_flat.ny, cfg_flat.nx))
    dxy = 0.9 * np.sqrt(dxx * dyy) * (2.0 * rng.random(dxx.shape) - 1.0)
    tab = TABLEAUS["bs32"]
    info = ("crd_fused_aniso_info" in _build.SIGNATURES)
    for case, c, build_kw in (
            ("fibres", cfg_aniso, aniso_build),
            ("const_noflux", dataclasses.replace(cfg_aniso,
                                                 boundary="noflux"),
             dict(diffusion_tensor=(1.0, 0.25, 0.15))),
            ("random_beta_ramp", cfg_flat,
             dict(diffusion_tensor=(dxx, dyy, dxy)))):
        problem = build_problem(dataclasses.replace(c, t_boundary=0.0),
                                "cuda", **build_kw)
        ac = prepare_aniso_constants(problem, f32, "cuda")
        y = problem.y0.contiguous()
        args = (y, torch.tensor(cs.K5_H, device="cuda"), zero, ac, tab,
                c.rtol, c.atol)

        def k5():
            return fused_aniso.fused_aniso_step(*args)

        emit(label, "k5", case=case, shape=list(y.shape),
             device_us=cs.device_ms(k5, K5_TAG) * 1e3,
             burst_us=cs.median_ms(k5) * 1e3,
             kernels=launched(k5, K5_KERNELS),
             **(slot_info("crd_fused_aniso_info", ac.kinetics_id)
                if info else {}), card=card)
        del problem, ac, y, args

    if not runs:
        return
    # the canonical Goldbeter ark324 run and the single-device 2.56M-point
    # Goldbeter ark324 run over Tf = 1 (K3), the fibered sheet's bs32 run
    # (K5): profile_run, then one more untraced run for its steps
    cfg_gb = config_from_ini(cs.GB_INI, model="goldbeter", surface="torus",
                             use_pallas=True, method="ark324")
    for name, c, build_kw, tag in (
            ("goldbeter_ark324_run", cfg_gb, {}, K3_TAG),
            ("large_goldbeter_ark324_run", cs.large_goldbeter_torus(), {},
             K3_TAG),
            ("aniso_sheet_run", cfg_aniso, aniso_build, K5_TAG)):
        fields = cs.profile_run(c, build_kw, c.t_final, tag)
        emit(label, name, **{**{k: fields[k] for k in RUN_FIELDS},
                             **steps_of(cs.run_program(c, build_kw))},
             card=card)


def box_tags():
    """The profiler tags of K6's and K12's bs32 kernels in the tree: the
    stream kernel where it has one, else the persistent kernels."""
    try:
        from crdmodel_tpu_torch.ops import box_stream
    except ImportError:
        return None, "fused_box3d_step_kernel", "fused_shard_box3d_kernel"
    return box_stream, box_stream.STREAM_KERNEL, box_stream.STREAM_KERNEL


def new_rkc(stream, mode):
    """The tree runs K7's and K13's chunk kernel in operator `mode`."""
    return (stream is not None and hasattr(stream, "rkc_uses_stream")
            and stream.rkc_uses_stream(mode))


def rkc_tag(stream, shard, mode):
    """The profiler tag of K7's (K13's with shard) kernel in `mode` in the
    tree: its dispatch's, else the persistent kernel."""
    if stream is not None and hasattr(stream, "rkc_kernel_name"):
        return stream.rkc_kernel_name(mode, shard)
    return ("fused_shard_box3d_rkc_kernel" if shard
            else "fused_box3d_rkc_kernel")


def rkc_launches(stream, s_cap, mode):
    """K7's (K13's) kernel launches a step in `mode` with tables of s_cap
    stages in the tree: one a chunk of the chunk kernel, else one."""
    return stream.rkc_launches(s_cap) if new_rkc(stream, mode) else 1


def traced_kernels(body):
    """The device kernels of one trace of body() by the tree's
    ops/trace.py: a trace checked to hold every launch's kernel (traced)
    where the tree has it, else an older tree's padded window."""
    from crdmodel_tpu_torch.ops import trace

    if hasattr(trace, "traced"):
        return trace.traced(body)[0]
    with trace.window() as prof:
        body()
    return trace.traced_kernels(prof)


def rkc_device_us(cs, fn, tag, group, n):
    """The device µs of a call of fn, its `group` kernels whose name holds
    `tag`: their summed time over a trace of n + n // 2 + 2 calls
    (traced_kernels) a call (a trace that lost a kernel of such steps, as
    older trees' could, would misread if kernels were paired in launch
    order)."""
    import torch

    fn()
    torch.cuda.synchronize()
    calls = n + n // 2 + 2
    tagged = [e["dur"] for e in traced_kernels(
        lambda: [fn() for _ in range(calls)]) if tag in e["name"]]
    if not tagged:
        raise AssertionError(f"traced no call of {tag} ({group} kernels)")
    return float(sum(tagged)) / calls


def stage_counts(cs, label, card, name, module, attr, cfg, build_kw,
                 mesh=None):
    """One untraced run of cfg through the entry point with the wrapper
    module.<attr> replaced by one that records the stage count s of each
    step it launches (a host read of s a step, so its time is not
    reported): the histogram and the run's steps."""
    import collections

    seen = collections.Counter()
    step = getattr(module, attr)

    def counted(y, h, fz, s, *rest):
        seen[int(s)] += 1
        return step(y, h, fz, s, *rest)

    counted.launches = 0   # the wrapper counts its launches on its own name
    setattr(module, attr, counted)
    try:
        res = cs.run_program(cfg, build_kw, mesh)
    finally:
        setattr(module, attr, step)
    emit(label, name, config=cfg.program_name,
         histogram={str(k): seen[k] for k in sorted(seen)},
         launches=sum(seen.values()), **steps_of(res), card=card)


# the stream kernel's plans timed beside the tree's own: MIN_TILES, which
# sets the z chunks (one; three at K12's shape, the default; four)
BOX_PLANS = (1, 264, 512)


def time_box(cs, label, card, runs):
    import torch

    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import fused_box3d as f6
    from crdmodel_tpu_torch.ops import fused_box3d_rkc as f7
    from crdmodel_tpu_torch.ops import fused_shard_box3d as f12
    from crdmodel_tpu_torch.ops import fused_shard_box3d_rkc as f13
    from crdmodel_tpu_torch.ops.fused_box3d import MODE_IDS
    from crdmodel_tpu_torch.ops.fused_rkc import static_stage_tables
    from crdmodel_tpu_torch.ops.kernel_common import (
        make_shard_box_constants, prepare_box_constants)

    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device="cuda")
    h = torch.tensor(cs.BOX_H, device="cuda")
    tab = TABLEAUS["bs32"]
    n, burst_n = cs.BOX_TIMED
    stream, tag6, tag12 = box_tags()
    mesh = cs.shard_mesh(cs.SHARD_MESH)
    mu1, ctab = static_stage_tables(f7.C_RKC, f32, "cuda")
    emit(label, "ptxas", card=card,
         **{src: cs.ptxas_entries(src + ".cu", stream.STREAM_KERNEL)
            for src in ("fused_box3d", "fused_shard_box3d")
            if stream is not None},
         **{src: cs.ptxas_entries(src + ".cu", stream.RKC_STREAM_KERNEL)
            if stream is not None and hasattr(stream, "RKC_STREAM_KERNEL")
            else cs.ptxas_summary(src + ".cu")
            for src in ("fused_box3d_rkc", "fused_shard_box3d_rkc")})
    cfg_box = cs.volumetric_box()
    for case, cfg, build_kw in cs.box_modes(cfg_box):
        problem = build_problem(cfg, "cuda", **build_kw)
        bc = prepare_box_constants(problem, f32, "cuda")
        y = problem.y0.contiguous()
        bufs, consts = cs.shard_inputs(problem, mesh, y.cpu().numpy(), f32,
                                       f12.HALO, make_shard_box_constants)
        args6 = (y, h, zero, bc, tab, cfg.rtol, cfg.atol)
        args12 = (bufs[0], h, zero, consts[0], tab, cfg.rtol, cfg.atol)

        def k6():
            return f6.fused_box3d_step(*args6)

        def k12():
            return f12.fused_shard_box3d_step(*args12)

        for name, fn, tag, x, symbol in (
                ("k6", k6, tag6, y, "crd_fused_box3d_info"),
                ("k12", k12, tag12, bufs[0], "crd_fused_shard_box3d_info")):
            info = {} if stream is None else dict(
                plan=stream.stream_plan(
                    4, tuple(x.shape[1:]),
                    f12.HALO if name == "k12" else None)[:3],
                **stream.kernel_info(symbol, f32, MODE_IDS[bc.kind],
                                     bc.kinetics_id))
            emit(label, name, case=case, shape=list(x.shape),
                 device_us=cs.device_ms(fn, tag, n) * 1e3,
                 burst_us=cs.median_ms(fn, n, burst_n) * 1e3, **info,
                 card=card)
        if stream is not None and case in ("noflux_slab", "scar_column"):
            time_box_plans(cs, label, card, stream, case, k6, k12, y,
                           bufs[0])
        rho = cs.problem_rho(problem, y)
        for s in cs.K7_TIMED_STAGES:
            hs, st = cs.rkc_step_inputs(s, rho, f32)
            a7 = (y, hs, zero, st, mu1, ctab, bc, cfg.rtol, cfg.atol)
            a13 = (bufs[0], hs, zero, st, mu1, ctab, consts[0], cfg.rtol,
                   cfg.atol)
            for name, fn, shard, symbol, x in (
                    ("k7", lambda: f7.fused_box3d_rkc_step(*a7), False,
                     "crd_fused_box3d_rkc_info", y),
                    ("k13", lambda: f13.fused_shard_box3d_rkc_step(*a13),
                     True, "crd_fused_shard_box3d_rkc_info", bufs[0])):
                group = rkc_launches(stream, f7.C_RKC, bc.kind)
                info = {} if not new_rkc(stream, bc.kind) else dict(
                    launches_a_step=group,
                    chunks=stream.rkc_chunks(s, shard),
                    plan=stream.stream_plan(
                        4, tuple(x.shape[1:]), f12.HALO if shard else None,
                        min_tiles=stream.RKC_MIN_TILES)[:3],
                    **stream.kernel_info(symbol, f32, MODE_IDS[bc.kind],
                                         bc.kinetics_id))
                emit(label, name, case=case, s=s,
                     kernel=rkc_tag(stream, shard, bc.kind),
                     device_us=rkc_device_us(cs, fn,
                                             rkc_tag(stream, shard, bc.kind),
                                             group, n),
                     burst_us=cs.median_ms(fn, n, burst_n) * 1e3, **info,
                     card=card)
        del problem, bc, y, bufs, consts

    if not runs:
        return
    scar = cs.box_scar(cfg_box)
    rkc2 = dataclasses.replace(cfg_box, method="rkc2")
    for name, cfg, build_kw, run_mesh, tag in (
            ("slab_bs32_run", cfg_box, {}, None, tag6),
            ("slab_scar_run", cfg_box, scar, None, tag6),
            ("sharded_slab_bs32_run", cfg_box, {}, mesh, tag12),
            ("slab_rkc2_run", rkc2, {}, None,
             rkc_tag(stream, False, "box_profile")),
            ("sharded_slab_rkc2_run", rkc2, {}, mesh,
             rkc_tag(stream, True, "box_profile"))):
        fields = cs.profile_run(cfg, build_kw, cfg.t_final, tag,
                                mesh=run_mesh)
        steps = steps_of(cs.run_program(cfg, build_kw, run_mesh))
        emit(label, name, **{k: fields[k] for k in RUN_FIELDS},
             accepted=steps["accepted"], rejected=steps["rejected"],
             card=card)
    # K7's and K13's stage counts, a host read of s a step (untraced,
    # unreported time)
    stage_counts(cs, label, card, "k7_stage_counts", f7,
                 "fused_box3d_rkc_step", rkc2, {})
    stage_counts(cs, label, card, "k13_stage_counts", f13,
                 "fused_shard_box3d_rkc_step", rkc2, {}, mesh)


def time_box_plans(cs, label, card, stream, case, k6, k12, y, buf):
    """The stream kernel of K6 and K12 on each plan of BOX_PLANS (the
    module's MIN_TILES set for the call, then restored): device time and
    the plan."""
    from crdmodel_tpu_torch.ops.fused_shard_box3d import HALO

    saved = stream.MIN_TILES
    try:
        for min_tiles in BOX_PLANS:
            stream.MIN_TILES = min_tiles
            for name, fn, x, halo in (("k6_plan", k6, y, None),
                                      ("k12_plan", k12, buf, HALO)):
                emit(label, name, case=case, min_tiles=min_tiles,
                     plan=stream.stream_plan(4, tuple(x.shape[1:]),
                                             halo)[:3],
                     device_us=cs.device_ms(fn, stream.STREAM_KERNEL,
                                            cs.BOX_TIMED[0]) * 1e3,
                     card=card)
    finally:
        stream.MIN_TILES = saved


def compare(other, runs, measure):
    order = [(other, "other"), (HERE, "this"), (HERE, "this"),
             (other, "other")]
    lines = []
    for tree, label in order:
        cmd = [sys.executable, os.path.abspath(__file__), "--tree", tree,
               "--label", label, "--measure", measure] + (
                   ["--runs"] if runs else [])
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
        key = "/".join(str(rec[f]) for f in ("measure", "case", "k", "s",
                                             "min_tiles", "shape")
                       if f in rec)
        for f in ("kernel_us", "kernel_us_per_substep", "device_us",
                  "burst_us", "wall_s", "untraced_wall_s",
                  "k2_mean_device_us", "device_busy_ms", "kernels_per_step",
                  "device_idle_share", "kernel_mean_us", "steps",
                  "accepted", "rejected"):
            if f in rec:
                summary.setdefault(f"{key}/{f}", {}).setdefault(
                    rec["tree"], []).append(rec[f])
    print(json.dumps({"summary": {
        k: {t: sum(v) / len(v) for t, v in trees.items()}
        for k, trees in summary.items()}}))
    digests = {}
    for rec in lines:
        if "digest" in rec:
            digests.setdefault(f"{rec['measure']}/{rec['case']}",
                               set()).add(rec["digest"])
    if digests:
        same = {k: len(v) == 1 for k, v in digests.items()}
        print(json.dumps({"bitwise_across_trees": same,
                          "all_bitwise": all(same.values())}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--label", default="this")
    ap.add_argument("--compare", metavar="OTHER_DIR")
    ap.add_argument("--runs", action="store_true")
    names = ("all", "kstep_rkc", "divform", "profile", "shard_rkc_imex",
             "box", "imex_aniso", "unforced", "families")
    ap.add_argument("--measure", default="all",
                    help="one of " + ", ".join(names)
                    + "; several joined by commas")
    args = ap.parse_args()
    unknown = set(args.measure.split(",")) - set(names)
    if unknown:
        ap.error(f"unknown --measure {sorted(unknown)}")
    if args.compare:
        compare(os.path.abspath(args.compare), args.runs, args.measure)
    else:
        time_one_tree(os.path.abspath(args.tree), args.label, args.runs,
                      args.measure)


if __name__ == "__main__":
    main()
