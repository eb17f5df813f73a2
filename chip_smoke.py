"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --profile     # a diagnostic, not the smoke test
    python3 chip_smoke.py --sharded     # the sharded main paths alone
    python3 chip_smoke.py --stream      # the run entry point's phases alone
    python3 chip_smoke.py --forced      # the forcing slice's phases alone
    python3 chip_smoke.py --box-forced  # forcing on the box alone
    python3 chip_smoke.py --kinetics    # the six other families alone
    python3 chip_smoke.py --timing      # the whole run, every timing case

Builds the CUDA kernels from crdmodel_tpu_torch/csrc, holds each against its
plain PyTorch version on the card (K1, the fused ERK step, y_new and every
partial sum bitwise with bs32 and dopri54 and the launched kernel traced,
and K3, the fused IMEX ark324 step, with the FitzHugh-Nagumo, Goldbeter
and Aliev-Panfilov kinetics, also on the Goldbeter torus cut to 4 columns
and an odd grid, every partial sum bitwise on the plan sized to the grid,
the launched kernel traced; K2, the fused RKC2 step, with the same
three, on the profile operator, on K4's five divergence-form cases, and
at the 41M-point shape of the JAX package's column-blocked K2b; K4, the fused divergence-form ERK
step, on no-flux walls with a scar, a torus obstacle, a 2-D diffusion
field, a torus narrower than a tile's rings and an odd grid, with bs32,
zonneveld43 and dopri54, every partial sum bitwise; K5, the fused
anisotropic-tensor ERK step, on rotating fibres, a constant tensor inside
no-flux walls, random fields with a beta ramp, a sheet cut to 4 columns
and an odd sheet, with bs32, zonneveld43 and dopri54, every partial sum
bitwise, each tableau's launched kernel traced;
K6 and K7, the fused ERK and RKC2 steps on the 3-D box, in their four
operator modes on the volumetric slab's 32x512x512 shape: no-flux walls,
a scar column, a 3-D diffusion field and a transmural tensor, and on
FitzHugh-Nagumo with a beta ramp (K6's bs32 through its z-streaming
kernel, every partial sum bitwise, the launched kernel traced, also on a
5x150x90 scarred box and a 2-plane FHN box); K8 and K9, the fused ERK and RKC2 steps
on one shard of a mesh, on the canonical torus's 2x2 shards, the flat
sheet's, an uneven 1x3 mesh whose last block carries mirror-pad cells, and
K9 on the 2x2 shards of the 10.24M-point torus (s = 2, 5, 23 and at its
chunk boundaries, and an s beyond its tables), every partial sum of both
bitwise, K8's launched kernel traced as K1's; K10, the fused IMEX ark324
step on one shard, on the canonical Goldbeter and FHN tori's 2x2 shards,
the uneven 1x3 mesh, the 2.56M-point Goldbeter torus's 2x2 shard and FHN
and Aliev-Panfilov on both Goldbeter tori's shards, every partial sum
bitwise; K11, the fused divergence-form and 2-D tensor ERK step on one shard,
on the bounded tissue's 2x2 shards, a flat 2-D diffusion field, the uneven
1x3 mesh, an uneven 2x2 mesh with mirror-pad cells on both axes, the
rotating fibres flat and on the torus and a constant tensor inside no-flux
walls, with bs32, zonneveld43 and dopri54, every partial sum bitwise; K12 and K13, the fused ERK and RKC2 steps on one
shard of the 3-D box, on the slab's 2x2 shards in the four operator modes,
FitzHugh-Nagumo's beta ramp on a 16x256x256 box's 2x2 shards and its
uneven 1x3 mesh (K12's bs32 as K6's); K14, the speculative K-step ERK kernel, on K1's five
cases with bs32 at K = 2, 5, 10 and dopri54 at K = 2, committing sub-step
0, 1, K-1 and K, against its plain version and against K1's launches,
state and every partial sum bitwise), times each, then runs the
port's main paths through simulate(): the
canonical FitzHugh-Nagumo torus program (data/FHNmodelArgs.ini: 400x1600,
f32, Tf=50) with its own method bs32 (through K1) and with method rkc2
(through K2), the canonical Goldbeter torus program
(data/GoldbeterModelArgs.ini: 100x400, f32, Tf=4) with its own method bs32
(through K1) and with method ark324 (through K3), the bounded
cardiac-tissue program (Aliev-Panfilov on a flat 1600x400 sheet with
no-flux walls and a circular scar, f32, Tf=8) with bs32 (through K4) and
with rkc2 (through K2's divergence branch), the JAX suite's wide FHN sheet
(flat 12800x3200, 41M points, rkc2, f32, Tf=0.5, through K2), and the
fibered cardiac sheet (Aliev-Panfilov on a flat periodic 1600x400 sheet
with rotating fibres, bs32, f32, Tf=1, through K5), the canonical FHN
torus with speculative_k=5 (K frozen-h sub-steps a launch through K14,
each interval's tail through K1) and with step_mode="normal" (ARK_NORMAL,
through K1), the canonical Goldbeter torus with speculative_k = 2, 5 and
10 (K14), and the JAX suite's
volumetric cardiac slab (Aliev-Panfilov on a 32x512x512 box, 8.4M points,
no-flux walls, f32, Tf=0.5) with bs32 (through K6), with rkc2 (through K7)
and with a scar column through every plane (through K6's tissue mode);
and through simulate_sharded() on a 2x2 mesh of shards, all on cuda:0
(with four cards or more, once more with a shard on each card): the
canonical FHN torus with bs32 (through K8), the JAX suite's large FHN
torus (6400x1600, 10.24M points, rkc2, f32, Tf=1, through K9), the
bounded tissue and the fibered sheet (through K11, its aniso mode for the
fibres), the same fibres on the torus (K11 with the inv4 profile), the
canonical Goldbeter torus with ark324 and the JAX suite's large Goldbeter
torus (3200x800, 2.56M points, ark324, f32, Tf=1; both through K10),
and the volumetric slab with bs32 (through K12), rkc2 (through K13) and
the scar column (through K12's tissue mode). Last, the run entry point
and the streaming drivers: `python -m crdmodel_tpu_torch run` of the
canonical FHN torus through cli.main in this process with --npz and
--map-torus over its first PREFIX_OUTPUTS outputs (cli_run_fhn: K1 on
every step, steps and trajectory bitwise the first ones of the simulate()
run's, the reference-format files read back exactly, the manifest's
counts), of the canonical Goldbeter torus with ark324 through K3 in a
subprocess with four ranks of files over its first PREFIX_OUTPUTS outputs
(cli_run_goldbeter_ark324, bitwise an in-process simulate_streaming of the
same cut), simulate_sharded_streaming of the
canonical FHN torus on the 2x2 mesh with the sharded writer over its first
PREFIX_OUTPUTS outputs (stream_sharded_fhn, K8, bitwise the first ones of
simulate_sharded's, the four ranks' files exactly), and the host-offload
copies' timing beside the solve's kernels (stream_host_offload).
The forcing and curvature slice (forced_phases, after the fibered sheet):
K1 and K4 with a structured forcing (the paced FHN torus's pulse train on
a row band and smooth drive, the bounded tissue's s1s2_protocol, each with
a sinusoid on variable 1; bs32 and dopri54), K2 in both branches with
gated and smooth waveforms at s = 5 and 23 (one chunk and four)
and K3 on the Goldbeter torus with its pulse train, f32 and f64, fz 0 and
1: y_new and every partial sum bitwise the plain version's, the forced
instantiation traced; each timed forced and unforced in one call
(k*_forced_timing: the kernels a step with and without the amplitudes),
K1 also at the JAX package's own forcing shape (scripts/bench_round4.py::
section_forcing, (2,6400,1600)); then five paths through simulate(),
each checked by launch counts and a trace of its kernel and against its
JAX CPU golden (tests/golden/torch_{curvature_fhn,s1s2_rkc2,
canonical_fhn_paced,canonical_goldbeter_ark324_paced,bounded_ap_paced}_
probes.npz, whose stimuli the paced runs rebuild): the JAX suite's
curvature-coupled FHN torus (Tf=5, K1), examples/s1s2_pacing.py's
configuration and protocol (K2's divergence branch, re-entrant at t=120),
and the paced canonical FHN torus (K1), Goldbeter torus with ark324 (K3)
and bounded tissue (K4).
Forcing on a mesh (mesh_forced_phases, after them): K8 (bs32, dopri54)
and K9 (gated and smooth at s = 2, 5, 7, 12, 23) on the paced canonical
FHN torus's shards, K10 on the paced Goldbeter torus's and K11 on the
paced bounded tissue's (divform mode) and the torus fibres' (aniso mode,
the bounded tissue's stimuli), each with the cross drive, on shard 0 and
the last shard of the 2x2 mesh (fz 0 and 1) and of the uneven 1x3 mesh
(mirror pads; fz 0), f32 and f64: y_new's block and every partial sum
bitwise the plain version's, the forced instantiation traced
(k8..k11_forced_check);
each timed forced and unforced in one call on shard 0 of the 2x2 mesh
with the bound of its shard (k8..k11_forced_timing: kernels a sharded
step, ptxas's forced and unforced registers and spills); then the paced
paths through simulate_sharded() on a 2x2 mesh of shards on cuda:0, each
traced through its forced kernel: the paced FHN torus
(paced_sharded_fhn_bs32, K8), Goldbeter torus with ark324
(paced_sharded_goldbeter_ark324, K10) and bounded tissue
(paced_sharded_bounded_ap_bs32, K11, the scar bitwise), each held to its
golden and to the single-device paced run of this call, and the paced
FHN torus with rkc2 over Tf=25 (paced_sharded_fhn_rkc2, K9), held to a
single-device forced K2 run of this call. The kernels line's K8-K11
entries carry their forced fields.
Forcing on the box (box_forced_phases, after the sharded slab): K6 (bs32,
dopri54) and K7 (smooth at s = 2, 5, 7, gated at s = 5) with the JAX
package's box pacing protocol (scripts/bench_round5.py:144-151: a pulse
train on a row band with a Gaussian depth profile, a cosine drive on a
column band) and the cross drive, at the slab's shape in the profile and
tensor modes and on the stream scheme's edge boxes, and K12 and K13 alike
on shards 0 and 3 of the slab's 2x2 mesh and the uneven 1x3 mesh, f32
and f64, fz 0 and 1: y_new (its block) and every partial sum bitwise the
plain version's, each scheme's forced instantiation traced
(k6/k7/k12/k13_forced_check); each timed forced and unforced in one call
(k6/k7/k12/k13_forced_timing, the bound counting the depth table); then
the paced slab through simulate() with bs32 (paced_box_bs32, K6) and rkc2
(paced_box_rkc2, K7), held to the port's torch path in f32 and f64 as the
unforced slab is, and through simulate_sharded() on a 2x2 mesh
(paced_sharded_slab_bs32, K12; paced_sharded_slab_rkc2, K13), held to the
single-device paced runs, each traced through its forced kernel; their
walls beside the unforced slab runs' (paced_box_walls). The kernels
line's K6, K7, K12 and K13 entries carry their forced fields.
The six other kinetics families (kinetics_phases, after the box's
forced phases): Barkley, the Oregonator, Gray-Scott, the Brusselator,
lambda-omega and SIR through K1 (bs32, dopri54), K2 (s = 2, 5, 7, 23) and
K3 at the JAX soak matrix's 800x3200 torus and on an odd 148x37 torus,
f32 and f64: y_new and every partial sum bitwise the plain version's,
each launch's kernel traced (kinetics_kernels); each timed at the soak
shape with its bound, registers and spills (kinetics_timing); the twelve
golden fixtures of those families in f64 through K1, K2 and K3, each
taking the port's torch path's recorded step sequence exactly
(kinetics_fixtures); and the soak matrix's 18 runs
(scripts/soak_matrix.py's physics, 800x3200 torus, Tf cut to SOAK_TF)
through simulate() with the kernels selected, held to the port's torch
path on the card (soak_matrix). Then the same families on a mesh: K8
(bs32, dopri54), K9 (s = 2, 5, 23) and K10 on a shard of the soak's 2x2
mesh, from a random state and the IC, and on an uneven 3x1 mesh of the
odd torus with a freeze, f32 and f64, bitwise (kinetics_shard_kernels);
each timed on the soak's shard (kinetics_shard_timing); and the soak
matrix's 18 runs through simulate_sharded() on a 2x2 mesh of shards on
cuda:0, every step through K8, K9 or K10, held to the one-device kernel
run of the same cell (ark324: to its plain version's sharded run in K10's
sum order, bitwise; soak_matrix_mesh). The kernels line carries a K1, K2,
K3, K8, K9 and K10 entry of each family.
Each run is checked against the JAX package's CPU runs recorded in
tests/golden/torch_canonical_{fhn,goldbeter}[_method]_probes.npz (the
speculative and ARK_NORMAL runs against
tests/golden/torch_canonical_fhn_{k5,normal}_probes.npz and
tests/golden/torch_canonical_goldbeter_k{2,5,10}_probes.npz, the K = 5
FHN run also against the per-step K1 run of the same call),
tests/golden/torch_bounded_ap[_rkc2]_probes.npz and
tests/golden/torch_aniso_sheet_probes.npz, the wide sheet and the slab
against the port's own torch path on the card, the sharded canonical runs,
bounded tissue and fibered sheet also against the single-device K1, K3,
K4 and K5 runs, the large FHN torus against the port's single-device K2
run, the fibres on the torus against the port's single-device torch path
and the large Goldbeter torus against the single-device K3 run and the
sharded slab against the single-device K6 and K7 runs, all in the same
call. Exits non-zero on any
failure, and prints as its last line {"ok": true, "device": {...}} only
when every phase passed. Imports nothing of JAX.

With --forced it builds the kernels and runs only the forcing slice's
phases, on one device, on a mesh and on the box (with --box-forced only
the box's); with --kinetics only the six other families' phases; no
kernels line and no last line.
With --profile it checks nothing: it builds the kernels and traces, with
torch.profiler, the bounded cardiac tissue with bs32 and rkc2, the fibered
sheet and the wide sheet over short horizons, the three slab runs over
their whole horizon, the sharded canonical FHN run over Tf=5, the sharded
large FHN torus over Tf=0.2, the sharded bounded tissue over Tf=1, the
sharded large Goldbeter torus over Tf=0.2, the three sharded slab runs
over their whole horizon and the canonical FHN torus over Tf=5 per step
(K1) and with speculative_k=5 (K14), and prints for each the
device's busy time and idle share, the kernels a step and the fused
kernel's share (phase "profile"). With --sharded it builds the kernels and
runs only the single-device runs the sharded paths are held to (K1, K3,
K4, K5, K6, K7) and the sharded main paths with their checks (on four cards or
more, again with a shard on each card); it prints no kernels line and no
last line. With --stream it builds the kernels and runs the canonical FHN
torus through simulate() and simulate_sharded() on the 2x2 mesh, then the
run entry point's and the streaming drivers' phases above; no kernels
line and no last line either.
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
GOLDEN = os.path.join(ROOT, "tests", "golden")
PROBES = {(model, method): os.path.join(
              GOLDEN, f"torch_canonical_{model}{tag}_probes.npz")
          for model, method, tag in (
              ("fhn", "bs32", ""), ("fhn", "rkc2", "_rkc2"),
              ("goldbeter", "bs32", ""), ("goldbeter", "ark324", "_ark324"))}
PROBES["aliev_panfilov", "bs32"] = os.path.join(GOLDEN,
                                                "torch_bounded_ap_probes.npz")
PROBES["aliev_panfilov", "rkc2"] = os.path.join(
    GOLDEN, "torch_bounded_ap_rkc2_probes.npz")
PROBES["aniso_sheet", "bs32"] = os.path.join(GOLDEN,
                                             "torch_aniso_sheet_probes.npz")
# the speculative and ARK_NORMAL runs' goldens (the JAX package's XLA-side
# speculation and free stepping on the CPU): keyed (model, "bs32_k<K>")
# and ("fhn", "bs32_normal")
K14_SPEC = 5            # main_path_kstep's speculative_k
GB_KS = (2, 5, 10)      # JAX's own sweep, scripts/bench_goldbeter_k.py:64-67
for _model, _tag in ([("fhn", f"k{K14_SPEC}"), ("fhn", "normal")]
                     + [("goldbeter", f"k{k}") for k in GB_KS]):
    PROBES[_model, f"bs32_{_tag}"] = os.path.join(
        GOLDEN, f"torch_canonical_{_model}_{_tag}_probes.npz")
SEED = 1234
H = 2e-3        # about 1/rho(L) on the canonical grid: stage errors resolved
# K2's stage counts checked, up to S_MAX_KERNEL, with those around its
# chunk boundaries (k2_stages: D - 1, D, D + 1 and 2D, D the chunk depth)
K2_STAGES = (2, 15, 23)
K2_TIMED_STAGES = (5, 23)    # an accuracy-limited and a stability-bound step
# K2's longest step checked: the Goldbeter and Aliev-Panfilov kinetics set
# rho on their grids, and the coverage of 22 stages there would leave the
# kinetics' time scale by far (s and h are independent kernel inputs)
K2_MAX_H = 0.01
# K3's steps: the canonical Goldbeter ark324 run's typical step (4/1561),
# and one where the implicit part carries the step
K3_H = (2.5e-3, 2e-2)
K3_BIG_MESH = 800   # (2,3200,800): the JAX suite's "Goldbeter torus
                    # 800x3200 Tf=1 ark324" row (scripts/bench_suite.py:124)
# K4's step: the bounded run's mean step, Tf/steps = 8/10189 (JAX f32)
K4_H = 8e-4
# the tableaus K4's and K11's gates take: bs32 through the register-resident
# scheme, zonneveld43 and dopri54 through K1's (ops/erk_slots.py)
ERK_METHODS = ("bs32", "zonneveld43", "dopri54")
# K2's divergence branch: the stage counts checked and timed
K2_DIVFORM_STAGES = (2, 5, 23)
# K2 at K2b's shape (the wide sheet): an accuracy-limited and a
# stability-bound stage count; timed with fewer samples (a plain step at
# s = 23 moves some 40 GB there)
K2B_STAGES = (5, 23)
# and timed, with s = 9 about the wide run's mean stage count
K2B_TIMED_STAGES = (5, 9, 23)
WIDE_TIMED = (10, 3)
# K5's step: the fibered sheet's mean step, Tf/steps = 1/775 (JAX f32)
K5_H = 1.3e-3
# K6's and K7's checks on the 3-D box: a step inside bs32's and dopri54's
# stability on the volumetric slab (rho ~ 3000 there); K7's stage counts up
# to its cap C_RKC = 7, and the two it is timed at
BOX_H = 5e-4
K7_STAGES = (2, 5, 7)
K7_TIMED_STAGES = (5, 7)
# the box's timings (samples, calls a sample): a plain step at 8.4M points
# moves some GB
BOX_TIMED = (20, 5)
BOX_PLAIN_TIMED = (5, 2)
BOX_PROBES = 64     # probe values of the box runs at every output
# the script's time limit: the runs that no golden holds, or that are
# held bitwise to another run of this call, are cut (PERF.md section 4,
# "Cut"): `run` of the canonical FHN torus and its sharded streaming run
# to their first PREFIX_OUTPUTS of 20 outputs (Tf 50 -> 5; bitwise the
# first rows of the golden-held main_path and main_path_sharded_fhn
# runs; the Goldbeter `run` to its first PREFIX_OUTPUTS of 5, Tf 4 ->
# 1.6, bitwise its in-process streaming run of the same cut), and the
# horizons of the wide sheet (0.5 -> WIDE_TF), the fibres on the torus on
# a mesh (1 -> TORUS_TENSOR_TF) and the host-offload measurement (5 ->
# OFFLOAD_TF)
PREFIX_OUTPUTS = 2
WIDE_TF = 0.25
TORUS_TENSOR_TF = 0.25
OFFLOAD_TF = 1.0
N_TIMED = 60    # timed samples (median reported)
BURST = 10      # back-to-back calls per sample
# kernel vs plain version: f64 parity tool, f32 production tolerance
LIMITS = {torch.float64: (1e-12, 1e-10), torch.float32: (2e-5, 1e-3)}
# the sharded paths: the 2x2 mesh of the main paths; the uneven mesh of
# the shard kernels' checks, whose 400 columns of the canonical torus go
# to blocks of 134, 134 and 132; K9's stage counts checked and timed
SHARD_MESH = (2, 2)
UNEVEN_MESH = (1, 3)
# K9's checked stage counts: K2_STAGES' ends and one to three chunk
# boundaries (ops/fused_rkc.py CHUNK = 6: s + 1 = 7, 13, 18 evaluations)
K9_STAGES = (2, 5, 6, 12, 17, 23)
# an accuracy-limited step, the sharded 10.24M-point run's most common
# stage count, a stability-bound step
K9_TIMED_STAGES = (5, 12, 23)
# the timing phases of the kernels and branches the six families' slice
# left alone (K2's divergence branch, K2b at s = 5 and 9, K3's base
# instantiation at (2,3200,800), K6, K7, K12, K13 in their three other
# modes, K14 at K = 2 and 10 and its traced comparison with K1) run with
# --timing, and every timing with its full samples (N_TIMED, BURST and
# each phase's own); the default run times each only where the kernels
# line reads it, with at most QUICK_TIMED's samples and calls a sample
# of CUDA events and QUICK_DEVICE traced calls (PERF.md section 5)
TIMING_ALL = False
QUICK_TIMED = (5, 2)
QUICK_DEVICE = 20
# K14's checks: (tableau, K) of the JAX gate's reach at P = 8..32, the
# n_commit values of each (0, 1, K-1, K), and the K it is timed at
K14_BATCHES = (("bs32", 2), ("bs32", 5), ("bs32", 10), ("dopri54", 2))
K14_TIMED = (2, 5, 10)
# the published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): HBM
# bytes/s and float32 operations/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12


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
    card would also time the host issuing it); without --timing at most
    QUICK_TIMED's samples and calls a sample."""
    if not TIMING_ALL:
        n, per_sample = min(n, QUICK_TIMED[0]), min(per_sample,
                                                     QUICK_TIMED[1])
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


# Operations a point, counted from the plain versions' expressions (each
# add, multiply, division and negation one operation): each kinetics family
# (du and dv), its closed-form Jacobian, and each operator on variable 0
KINETICS_OPS = {"fhn": 7, "goldbeter": 24, "aliev_panfilov": 18}
JACOBIAN_OPS = {"fhn": 3, "goldbeter": 30, "aliev_panfilov": 35}
OPERATOR_OPS = {"torus": 12, "flat": 7, "divform": 11, "aniso": 23,
                # K11: the face operator; and its mixed pair on the raw Dxy
                # with the weight outside (one more product than K5's)
                "shard_divform": 11, "shard_aniso": 24,
                # the box: six faces; the tissue mode's 12 openness
                # products; the tensor's three mixed pairs (33) and weights
                "box_profile": 17, "box_tissue": 29, "box_field": 17,
                "box_tensor": 56}
WEIGHT_OPS = 14     # 1/(rtol |y0| + atol), err * w, square, sum; two vars


def rhs_ops(kc):
    """Operations of one RHS evaluation at a point: kinetics, operator,
    their sum, and the freeze (live and two products) and tissue products."""
    ops = KINETICS_OPS[kc.model.name] + OPERATOR_OPS[kc.kind] + 1
    if kc.has_freeze:
        ops += 5
    if getattr(kc, "tissue", None) is not None:
        ops += 2
    return ops


def erk_ops(kc, tableau):
    """Operations a point of one ERK tile step (K1, K4): the stages, their
    inputs, the update, the error and its weights."""
    nnz = sum(int(np.count_nonzero(x)) for x in
              (tableau.a, tableau.b, tableau.b - tableau.bhat))
    return tableau.stages * rhs_ops(kc) + 4 * nnz + WEIGHT_OPS


def rkc_ops(kc, s):
    """Operations a point of one K2 step at stage count s: s + 1 RHS
    evaluations, Y1, the s - 1 recurrence updates, the error and weights."""
    return (s + 1) * rhs_ops(kc) + 4 + 18 * (s - 1) + 10 + WEIGHT_OPS


def imex_ops(kc):
    """Operations a point of one K3 step: 4 explicit stencils, the kinetics
    at y0, 3 stages of 3 Newton iterations (Jacobian, kinetics, freeze,
    2x2 solve: 35 more), the stage sums, slopes, update, error, weights and
    the Newton penalty."""
    from crdmodel_tpu_torch.integrate import imex
    op = OPERATOR_OPS[kc.kind] + (1 if kc.has_freeze else 0)
    kin = KINETICS_OPS[kc.model.name] + (2 if kc.has_freeze else 0)
    newton = JACOBIAN_OPS[kc.model.name] + kin + 4 + 35
    known = sum(2 * (imex.AE[s][j] != 0.0) + 4 * (imex.AI[s][j] != 0.0)
                for s in range(imex.STAGES) for j in range(s))
    nnz_bd = sum(int(x != 0.0) for x in (*imex.B, *imex.D))
    return (4 * op + kin + 3 * (4 + 3 * newton + 4 + WEIGHT_OPS) + known
            + 4 + 4 * nnz_bd + WEIGHT_OPS + 2)


def constant_bytes(kc):
    """Bytes of a kernel's constant inputs, each read once."""
    tensors = [*kc.coeffs, kc.b, kc.mask]
    for extra in ("tissue", "invs", "dxy", "inv4"):
        if getattr(kc, extra, None) is not None:
            tensors.append(getattr(kc, extra))
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(y, kc, ops_per_point, extra_bytes=0):
    """(bound ms, "bytes" or "operations"): the least time the card could
    take for one launch on y, the larger of the bytes it must move (y read
    once, y_new written once, the constants read once) over the HBM rate
    and its operations over the float32 rate."""
    state = y.numel() * y.element_size()
    n_bytes = 2 * state + constant_bytes(kc) + extra_bytes
    ops = ops_per_point * y[0].numel()
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def random_state(cfg, shape, rng):
    """A random state on the card's main-path shape: FHN's u and v in
    [-2, 2], Goldbeter's concentrations in [0.1, 2.5], Aliev-Panfilov's
    potential in [-0.1, 1.1] and recovery in [0, 2]."""
    if cfg.model == "goldbeter":
        return rng.uniform(0.1, 2.5, shape)
    if cfg.model == "aliev_panfilov":
        return np.stack([rng.uniform(-0.1, 1.1, shape[1:]),
                         rng.uniform(0.0, 2.0, shape[1:])])
    return rng.uniform(-2.0, 2.0, shape)


def same_bits(a, b):
    """a and b bitwise equal, NaN at the same points (a NaN's payload aside:
    a step whose Newton diverges or whose 2x2 solve meets a zero
    determinant gives NaN, in the kernel and its plain version alike)."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


def check_pair(name, fields, y_k, ss_k, y_k2, ss_k2, y_r, ss_r, dtype,
               y_in, bitwise=False, ss_tiles=None):
    """Hold a kernel's (y_new, partial sums) against its plain version's,
    and two launches against each other; print phase `name`; return the
    max |y_kernel - y_plain| over the points where neither is NaN. NaN
    must stand at the same points in both, and the sums must be NaN in
    both or finite in both. With ss_tiles, the plain version's partial
    sums in the kernel's order, every partial sum must equal its own
    bitwise."""
    torch.cuda.synchronize()
    if not (same_bits(y_k, y_k2) and same_bits(ss_k, ss_k2)):
        raise AssertionError(f"{name}: two launches differ")
    nan = torch.isnan(y_r)
    nan_match = torch.equal(torch.isnan(y_k), nan)
    err = float((y_k - y_r)[~nan].abs().max())
    y_scale = max(1.0, float(y_in.abs().max()),
                  float(y_r[~nan].abs().max()))
    tol_y, tol_ss = LIMITS[dtype]
    sk, sr = float(ss_k.sum()), float(ss_r.sum())
    rel = abs(sk - sr) / sr if np.isfinite(sr) else 0.0
    partials = {} if ss_tiles is None else dict(
        partials=int(ss_k.numel()),
        partials_bitwise=ss_k.shape == ss_tiles.shape
        and same_bits(ss_k, ss_tiles))
    phase(name, **fields, dtype=str(dtype), max_abs_err=err,
          bitwise=same_bits(y_k, y_r), nan_points=int(nan.sum()),
          limit=tol_y * y_scale, ss_rel_err=rel, ss_limit=tol_ss,
          **partials)
    if not (nan_match and np.isfinite(sk) == np.isfinite(sr)
            and err <= tol_y * y_scale and rel <= tol_ss):
        raise AssertionError(f"{name}: the kernel disagrees with its plain "
                             "version")
    if ss_tiles is not None and not partials["partials_bitwise"]:
        raise AssertionError(f"{name}: the partial sums are not bitwise "
                             "the plain version's")
    if bitwise and not same_bits(y_k, y_r):
        raise AssertionError(f"{name}: y_new not bitwise equal to the plain "
                             "version")
    return err


def check_dispatch(name, fn, tableau, shard=None):
    """The kernel that calls of fn run, from pooled torch.profiler traces
    (ops/trace.py::kernel_names): fn launches a wrapper whose launcher
    dispatches on the tableau, K1, K4, K8 or K11 (ops/erk_slots.py), or
    with shard K6 (False) or K12 (True) (ops/box_stream.py). Raises
    unless the kernel the dispatch names ran and the other scheme's did
    not. Returns the kernel's name."""
    from crdmodel_tpu_torch.ops import box_stream, erk_slots, trace
    if shard is None:
        want, pair = erk_slots.kernel_name(tableau), erk_slots.KERNELS
    else:
        want = box_stream.kernel_name(tableau, shard)
        pair = box_stream.kernels(shard)
    other = (set(pair) - {want}).pop()
    names = trace.kernel_names(fn)
    if not any(want in k for k in names) or any(other in k for k in names):
        raise AssertionError(f"{name}: {tableau.name} ran "
                             f"{sorted(set(names))}, not {want}")
    return want


def check_rkc_dispatch(name, fn, mode, shard):
    """The kernels calls of fn run, each a K7 (K13 with shard) step in
    operator `mode`, from pooled torch.profiler traces (ops/trace.py::
    kernel_names): raises unless the kernel the dispatch names
    (ops/box_stream.py::rkc_kernel_name: the chunk kernel or the
    persistent one) ran and the other did not. Returns the kernel's
    name."""
    from crdmodel_tpu_torch.ops import box_stream, trace
    names = trace.kernel_names(fn, n=1)
    want = box_stream.rkc_kernel_name(mode, shard)
    if not names or not all(want in k for k in names):
        raise AssertionError(f"{name}: {mode} ran {sorted(set(names))}, "
                             f"not {want}")
    return want


def check_kernel(cases):
    """K1 against its plain version at the main paths' shapes, for each
    config of `cases` (the FHN torus first), f32 and f64, bs32 and dopri54,
    fz 0 and 1: y_new bitwise equal, two launches bitwise equal, every
    partial sum bitwise the plain version's in the kernel's tile order
    (fused_step_tile_sums), the kernel the dispatch names (check_dispatch).
    Returns the max errors and (kernel ms, plain ms, bound ms, bound_by,
    burst ms) at the canonical FHN bs32 shape: the kernel's device time
    from profiler traces (device_ms; it is faster than the host issues a
    launch), the CUDA-event time of a burst beside it."""
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import erk_slots
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
            for method in ("bs32", "dopri54"):
                tab = TABLEAUS[method]
                for fz in (0.0, 1.0):
                    fzt = torch.tensor(fz, dtype=dtype, device="cuda")
                    args = (y, h, fzt, kc, tab, cfg.rtol, cfg.atol)
                    kernel = check_dispatch(
                        "k1_check", lambda: fs.fused_step(*args), tab)
                    err = check_pair(
                        "k1_check",
                        dict(model=cfg.model, surface=cfg.surface,
                             shape=list(y.shape),
                             beta="field" if kc.b_is_field else "scalar",
                             method=method, fz=fz, kernel=kernel),
                        *fs.fused_step(*args), *fs.fused_step(*args),
                        *fs.fused_step_reference(*args), dtype, y,
                        bitwise=True,
                        ss_tiles=fs.fused_step_tile_sums(*args))
                    worst[dtype] = max(worst[dtype], err)
            if cfg is cases[0] and dtype == torch.float32:
                tab = TABLEAUS[cfg.method]
                args = (y, h, torch.zeros((), dtype=dtype, device="cuda"),
                        kc, tab, cfg.rtol, cfg.atol)
                timing = (device_ms(lambda: fs.fused_step(*args),
                                    erk_slots.kernel_name(tab)),
                          median_ms(lambda: fs.fused_step_reference(*args)),
                          *bound(y, kc, erk_ops(kc, tab)),
                          median_ms(lambda: fs.fused_step(*args)))
    return worst, timing


def k2_stages():
    """K2's checked stage counts: K2_STAGES and those around its chunk
    boundaries, D - 1, D, D + 1 and 2D (ops/fused_rkc.py CHUNK)."""
    from crdmodel_tpu_torch.ops.fused_rkc import CHUNK
    return tuple(sorted({*K2_STAGES, CHUNK - 1, CHUNK, CHUNK + 1,
                         2 * CHUNK}))


def check_rkc_kernel(cases):
    """K2 against its plain version at the main paths' shapes, for each
    config of `cases` (the FHN torus first; a grid smaller than a chunk's
    halo among them), each of k2_stages() with h the stability coverage of
    s - 1 stages, at most K2_MAX_H, f32 and f64, fz 0 and 1: y_new bitwise
    equal, two launches bitwise equal; returns the max errors and
    {s: (kernel ms, plain ms, bound ms, bound_by)} at the canonical shape."""
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.ops import fused_rkc as fr
    from crdmodel_tpu_torch.ops.kernel_common import prepare_constants

    rng = np.random.default_rng(SEED + 1)
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    timing = {}
    for cfg in cases:
        problem = build_problem(cfg, device="cuda")
        y_np = random_state(cfg, tuple(problem.y0.shape), rng)
        for dtype in (torch.float32, torch.float64):
            kc = prepare_constants(problem, dtype, "cuda")
            mu1, ctab = fr.static_stage_tables(fr.S_MAX_KERNEL, dtype, "cuda")
            y = torch.tensor(y_np, dtype=dtype, device="cuda")
            rho = problem_rho(problem, y)
            for s in k2_stages():
                h, st = rkc_step_inputs(s, rho, dtype)
                for fz in (0.0, 1.0):
                    fzt = torch.tensor(fz, dtype=dtype, device="cuda")
                    args = (y, h, fzt, st, mu1, ctab, kc, cfg.rtol, cfg.atol)
                    err = check_pair(
                        "k2_check",
                        dict(model=cfg.model, surface=cfg.surface,
                             shape=list(y.shape),
                             beta="field" if kc.b_is_field else "scalar",
                             s=s, fz=fz, chunks=len(fr.chunk_schedule(s))),
                        *fr.fused_rkc_step(*args), *fr.fused_rkc_step(*args),
                        *fr.fused_rkc_step_reference(*args), dtype, y,
                        bitwise=True)
                    worst[dtype] = max(worst[dtype], err)
                if (cfg is cases[0] and dtype == torch.float32
                        and s in K2_TIMED_STAGES):
                    timing[s] = rkc_timing(y, h, st, mu1, ctab, kc, cfg)
    return worst, timing


def problem_rho(problem, y):
    """The RKC2 spectral-radius bound of `problem` at y (its operator's,
    as the driver computes it), a float."""
    from crdmodel_tpu_torch.core.problem import make_rho_bound
    return float(make_rho_bound(
        problem.cfg, problem.model, problem.geometry, y.dtype,
        diffusion_field=problem.diffusion_field,
        diffusion_tensor=problem.diffusion_tensor,
        face_mask=problem.face_mask)(0.0, y, problem.params))


def rkc_step_inputs(s, rho, dtype):
    """(h, s) of a K2 check at stage count s: h the stability coverage of
    s - 1 stages, at most K2_MAX_H, and s as a device int."""
    h = torch.tensor(min(0.65 * (s - 1) ** 2 / rho, K2_MAX_H), dtype=dtype,
                     device="cuda")
    return h, torch.tensor(s, dtype=torch.int32, device="cuda")


def rkc_timing(y, h, st, mu1, ctab, kc, cfg, timed=(N_TIMED, BURST)):
    """(kernel ms, plain ms, bound ms, bound_by, design) of one K2 step on
    y at the stage count st, unfrozen; `timed` = (samples, calls a
    sample); design: k2_design's fields."""
    from crdmodel_tpu_torch.ops import fused_rkc as fr
    args = (y, h, torch.zeros((), dtype=y.dtype, device="cuda"), st, mu1,
            ctab, kc, cfg.rtol, cfg.atol)
    tables = sum(t.numel() * t.element_size() for t in (mu1, ctab))
    timing = (median_ms(lambda: fr.fused_rkc_step(*args), *timed),
              median_ms(lambda: fr.fused_rkc_step_reference(*args), *timed),
              *bound(y, kc, rkc_ops(kc, int(st)), tables))
    return (*timing, k2_design(kc, y, int(st), timing))


def k2_design(kc, y, s, timing):
    """K2's design beside a timing (kernel ms, plain ms, bound ms, ...) at
    stage count s on y: the launched kernel's registers, resident blocks an
    SM and shared bytes (ops/fused_rkc.py::kernel_info), ptxas's most
    registers and spills over fused_rkc.cu, its chunks and grid barriers a
    launch, its time over its bound, and the device traffic its chunk
    boundaries add beyond the bound's bytes (each boundary writes the
    pair of 4 planes, the next chunk reads it, y0 and F0 back: 12 planes,
    and F0's 2 planes once), with that traffic's time at the HBM rate."""
    from crdmodel_tpu_torch.ops import fused_rkc as fr
    info = fr.kernel_info(y.dtype, kc.kind == "divform", kc.kinetics_id)
    barriers = fr.grid_barriers(s)
    extra = (12 * barriers + 2 * (barriers > 0)) * y[0].numel() \
        * y.element_size()
    return dict(**info, ptxas=ptxas_summary("fused_rkc.cu"),
                chunk_depth=fr.CHUNK, chunks=barriers + 1,
                grid_barriers=barriers, times_bound=timing[0] / timing[2],
                chunk_traffic_bytes=extra,
                chunk_traffic_ms=extra / PEAK_BYTES_PER_S * 1e3)


def check_rkc_divform_kernel(cases):
    """K2's divergence branch against its plain version at the bounded
    path's shape (2,1600,400), for each (label, config, build arguments) of
    `cases` (each with tBoundary > 0; the bounded tissue first), each s of
    K2_DIVFORM_STAGES (h as in check_rkc_kernel), f32 and f64, fz 0 and 1:
    y_new bitwise equal, two launches bitwise equal. Returns the max errors
    and {s: (kernel ms, plain ms, bound ms, bound_by)} from the first
    case's ICs, f32, for each s of K2_TIMED_STAGES."""
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.ops import fused_rkc as fr
    from crdmodel_tpu_torch.ops.kernel_common import prepare_divform_constants

    rng = np.random.default_rng(SEED + 4)
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    for label, cfg, build_kw in cases:
        problem = build_problem(cfg, device="cuda", **build_kw)
        y_np = random_state(cfg, tuple(problem.y0.shape), rng)
        for dtype in (torch.float32, torch.float64):
            dc = prepare_divform_constants(problem, dtype, "cuda")
            mu1, ctab = fr.static_stage_tables(fr.S_MAX_KERNEL, dtype, "cuda")
            y = torch.tensor(y_np, dtype=dtype, device="cuda")
            rho = problem_rho(problem, y)
            for s in K2_DIVFORM_STAGES:
                h, st = rkc_step_inputs(s, rho, dtype)
                for fz in (0.0, 1.0):
                    fzt = torch.tensor(fz, dtype=dtype, device="cuda")
                    args = (y, h, fzt, st, mu1, ctab, dc, cfg.rtol, cfg.atol)
                    err = check_pair(
                        "k2_divform_check",
                        dict(case=label, model=cfg.model, surface=cfg.surface,
                             shape=list(y.shape), s=s, fz=fz),
                        *fr.fused_rkc_step(*args), *fr.fused_rkc_step(*args),
                        *fr.fused_rkc_step_reference(*args), dtype, y,
                        bitwise=True)
                    worst[dtype] = max(worst[dtype], err)

    _, cfg, build_kw = cases[0]
    problem = build_problem(dataclasses.replace(cfg, t_boundary=0.0),
                            device="cuda", **build_kw)
    dc = prepare_divform_constants(problem, torch.float32, "cuda")
    mu1, ctab = fr.static_stage_tables(fr.S_MAX_KERNEL, torch.float32, "cuda")
    y = problem.y0.contiguous()
    rho = problem_rho(problem, y)
    timing = {s: rkc_timing(y, *rkc_step_inputs(s, rho, torch.float32), mu1,
                            ctab, dc, cfg)
              for s in (K2_TIMED_STAGES if TIMING_ALL else ())}
    return worst, timing


def check_wide_rkc_kernel(cfg):
    """K2 at the shape of the JAX package's column-blocked K2b, the wide
    sheet's (2,12800,3200), against its plain version from a random state,
    each s of K2B_STAGES (h as in check_rkc_kernel), f32 (the sheet has no
    freeze: fz 0): y_new bitwise equal, two launches bitwise equal. Returns
    the max errors and {s: rkc_timing} from the sheet's ICs for each s of
    K2B_TIMED_STAGES, with WIDE_TIMED samples."""
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.ops import fused_rkc as fr
    from crdmodel_tpu_torch.ops.kernel_common import prepare_constants

    dtype = torch.float32
    problem = build_problem(cfg, device="cuda")
    kc = prepare_constants(problem, dtype, "cuda")
    mu1, ctab = fr.static_stage_tables(fr.S_MAX_KERNEL, dtype, "cuda")
    y = torch.tensor(random_state(cfg, tuple(problem.y0.shape),
                                  np.random.default_rng(SEED + 5)),
                     dtype=dtype, device="cuda")
    rho = problem_rho(problem, y)
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    fz = torch.zeros((), dtype=dtype, device="cuda")
    for s in K2B_STAGES:
        h, st = rkc_step_inputs(s, rho, dtype)
        args = (y, h, fz, st, mu1, ctab, kc, cfg.rtol, cfg.atol)
        err = check_pair(
            "k2b_check", dict(model=cfg.model, surface=cfg.surface,
                              shape=list(y.shape), s=s, fz=0.0),
            *fr.fused_rkc_step(*args), *fr.fused_rkc_step(*args),
            *fr.fused_rkc_step_reference(*args), dtype, y, bitwise=True)
        worst[dtype] = max(worst[dtype], err)
    del y
    y = problem.y0.contiguous()
    rho = problem_rho(problem, y)
    timing = {s: rkc_timing(y, *rkc_step_inputs(s, rho, dtype), mu1, ctab,
                            kc, cfg, timed=WIDE_TIMED)
              for s in (K2B_TIMED_STAGES if TIMING_ALL
                        else (max(K2B_TIMED_STAGES),))}
    return worst, timing


def check_imex_kernel(cases, timed):
    """K3 against its plain version at the main paths' shapes and its
    edges, for each config of `cases` (each with tBoundary > 0, so that fz
    0 and 1 differ), both dtypes, fz 0 and 1 and each h of K3_H: y_new and
    every partial sum bitwise equal (fused_imex_tile_sums, on the tiles of
    the plan sized to the grid, ops/fused_imex.py::slots_plan), two
    launches bitwise equal, the slots kernel traced once a config; returns
    the max errors and {shape: (device ms, plain ms, bound ms, bound_by,
    burst ms, plan)} from the ICs of each config of `timed`, f32, at h =
    K3_H[0]: the kernel's device time from profiler traces, a burst's time
    a launch from CUDA events beside it."""
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.ops import fused_imex as fi
    from crdmodel_tpu_torch.ops import trace
    from crdmodel_tpu_torch.ops.kernel_common import prepare_constants

    rng = np.random.default_rng(SEED + 2)
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    for cfg in cases:
        problem = build_problem(cfg, device="cuda")
        y_np = random_state(cfg, tuple(problem.y0.shape), rng)
        plan = fi.slots_plan(cfg.ny, cfg.nx, 4)
        for dtype in (torch.float32, torch.float64):
            kc = prepare_constants(problem, dtype, "cuda")
            y = torch.tensor(y_np, dtype=dtype, device="cuda")
            for h_val in K3_H:
                h = torch.tensor(h_val, dtype=dtype, device="cuda")
                for fz in (0.0, 1.0):
                    fzt = torch.tensor(fz, dtype=dtype, device="cuda")
                    args = (y, h, fzt, kc, cfg.rtol, cfg.atol)
                    if dtype == torch.float32 and h_val == K3_H[0] and fz:
                        names = trace.kernel_names(
                            lambda: fi.fused_imex_step(*args))
                        if not all(fi.SLOTS_KERNEL in n for n in names):
                            raise AssertionError(
                                f"k3_check: ran {sorted(set(names))}, not "
                                f"{fi.SLOTS_KERNEL}")
                    err = check_pair(
                        "k3_check",
                        dict(model=cfg.model, surface=cfg.surface,
                             beta="field" if kc.b_is_field else "scalar",
                             shape=list(y.shape), h=h_val, fz=fz,
                             tile=[plan.tile_y, plan.tile_x]),
                        *fi.fused_imex_step(*args), *fi.fused_imex_step(*args),
                        *fi.fused_imex_step_reference(*args), dtype, y,
                        bitwise=True, ss_tiles=fi.fused_imex_tile_sums(*args))
                    worst[dtype] = max(worst[dtype], err)

    timing = {}
    for cfg in timed:
        problem = build_problem(cfg, device="cuda")
        kc = prepare_constants(problem, torch.float32, "cuda")
        y = problem.y0.contiguous()
        args = (y, torch.tensor(K3_H[0], device="cuda"),
                torch.zeros((), device="cuda"), kc, cfg.rtol, cfg.atol)

        def k3():
            return fi.fused_imex_step(*args)

        timing[tuple(y.shape)] = (
            device_ms(k3, fi.SLOTS_KERNEL),
            median_ms(lambda: fi.fused_imex_step_reference(*args)),
            *bound(y, kc, imex_ops(kc)), median_ms(k3),
            fi.slots_plan(cfg.ny, cfg.nx, y.element_size()))
    return worst, timing


def check_field_kernel(name, cases, prepare, step, reference, h_val, seed,
                       methods=("bs32", "dopri54"), tile_sums=None,
                       device_tag=None):
    """An ERK tile kernel on (ny, nx) coefficient fields (K4, K5) against
    its plain version, for each (label, config, build arguments) of
    `cases` (each with tBoundary > 0, so that fz 0 and 1 differ; the main
    path's program, at its shape (2,1600,400), first), f32 and f64, each
    tableau of `methods`, fz 0 and 1, at step h_val: y_new bitwise equal,
    two launches bitwise equal and, with tile_sums (the plain version of
    the partial sums, called as the wrapper), every partial sum bitwise;
    prints phase `name`. prepare(problem, dtype, device) makes the
    kernel's constants, step and reference are its wrapper and plain
    version. Returns the max errors and (kernel ms, plain ms, bound ms,
    bound_by, burst ms) of the first case's ICs, bs32, f32: the kernel's
    time from CUDA events around bursts, or with device_tag its device
    time in profiler traces (device_ms; a kernel faster than the host's
    issue of a call), the burst's beside it."""
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS

    rng = np.random.default_rng(seed)
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    for label, cfg, build_kw in cases:
        problem = build_problem(cfg, device="cuda", **build_kw)
        y_np = random_state(cfg, tuple(problem.y0.shape), rng)
        for dtype in (torch.float32, torch.float64):
            kc = prepare(problem, dtype, "cuda")
            y = torch.tensor(y_np, dtype=dtype, device="cuda")
            h = torch.tensor(h_val, dtype=dtype, device="cuda")
            for method in methods:
                for fz in (0.0, 1.0):
                    fzt = torch.tensor(fz, dtype=dtype, device="cuda")
                    args = (y, h, fzt, kc, TABLEAUS[method], cfg.rtol,
                            cfg.atol)
                    err = check_pair(
                        name,
                        dict(case=label, model=cfg.model, surface=cfg.surface,
                             shape=list(y.shape), method=method, fz=fz),
                        *step(*args), *step(*args), *reference(*args), dtype,
                        y, bitwise=True,
                        ss_tiles=tile_sums and tile_sums(*args))
                    worst[dtype] = max(worst[dtype], err)

    _, cfg, build_kw = cases[0]
    problem = build_problem(dataclasses.replace(cfg, t_boundary=0.0),
                            device="cuda", **build_kw)
    kc = prepare(problem, torch.float32, "cuda")
    y = problem.y0.contiguous()
    tab = TABLEAUS["bs32"]
    args = (y, torch.tensor(h_val, device="cuda"),
            torch.zeros((), device="cuda"), kc, tab, cfg.rtol, cfg.atol)
    burst = median_ms(lambda: step(*args))
    timing = (burst if device_tag is None
              else device_ms(lambda: step(*args), device_tag),
              median_ms(lambda: reference(*args)),
              *bound(y, kc, erk_ops(kc, tab)), burst)
    return worst, timing


def check_aniso_dispatch(cfg, build_kw):
    """The kernel each tableau's K5 launch runs at cfg's shape, from pooled
    profiler traces (check_dispatch): bs32 the slots kernel, zonneveld43
    and dopri54 erk_tile.cuh's; returns {method: kernel}."""
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import fused_aniso
    from crdmodel_tpu_torch.ops.kernel_common import prepare_aniso_constants

    problem = build_problem(cfg, device="cuda", **build_kw)
    ac = prepare_aniso_constants(problem, torch.float32, "cuda")
    y = problem.y0.contiguous()
    ran = {}
    for method in ERK_METHODS:
        args = (y, torch.tensor(K5_H, device="cuda"),
                torch.zeros((), device="cuda"), ac, TABLEAUS[method],
                cfg.rtol, cfg.atol)
        ran[method] = check_dispatch(
            "k5_dispatch", lambda: fused_aniso.fused_aniso_step(*args),
            TABLEAUS[method])
    return ran


def check_box_kernels(cases, seed):
    """K6 (bs32 and dopri54, at BOX_H) and K7 (each s of K7_STAGES, h as in
    check_rkc_kernel) against their plain versions, for each (label,
    config, build arguments, planes) of `cases` (planes: the box's first
    planes kept, box_stream.box_planes, or None), f32 and f64, fz 0 and 1:
    y_new bitwise equal, two launches bitwise equal, a bs32 step's and a
    K7 chunk-kernel step's every partial sum bitwise the plain version's in
    the stream kernels' order (fused_box3d_tile_sums,
    fused_box3d_rkc_tile_sums), K6's launched kernel the one its dispatch
    names (check_dispatch), K7's traced in f32 (check_rkc_dispatch);
    prints phases k6_check and k7_check. Returns the max errors of K6 and
    of K7."""
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import box_stream
    from crdmodel_tpu_torch.ops import fused_box3d as fb
    from crdmodel_tpu_torch.ops import fused_box3d_rkc as fk
    from crdmodel_tpu_torch.ops.fused_rkc import static_stage_tables
    from crdmodel_tpu_torch.ops.kernel_common import prepare_box_constants

    rng = np.random.default_rng(seed)
    worst6 = {torch.float32: 0.0, torch.float64: 0.0}
    worst7 = {torch.float32: 0.0, torch.float64: 0.0}
    for label, cfg, build_kw, planes in cases:
        problem = build_problem(cfg, device="cuda", **build_kw)
        shape = tuple(problem.y0.shape)
        if planes is not None:
            shape = (2, planes, *shape[2:])
        y_np = random_state(cfg, shape, rng)
        for dtype in (torch.float32, torch.float64):
            bc = prepare_box_constants(problem, dtype, "cuda")
            if planes is not None:
                bc = box_stream.box_planes(bc, planes)
            y = torch.tensor(y_np, dtype=dtype, device="cuda")
            h = torch.tensor(BOX_H, dtype=dtype, device="cuda")
            mu1, ctab = static_stage_tables(fk.C_RKC, dtype, "cuda")
            rho = problem_rho(problem, y) if planes is None else None
            fields = dict(case=label, model=cfg.model, mode=bc.kind,
                          shape=list(y.shape))
            for fz in (0.0, 1.0):
                fzt = torch.tensor(fz, dtype=dtype, device="cuda")
                for method in ("bs32", "dopri54"):
                    tab = TABLEAUS[method]
                    args = (y, h, fzt, bc, tab, cfg.rtol, cfg.atol)
                    kernel = check_dispatch(
                        "k6_check", lambda: fb.fused_box3d_step(*args), tab,
                        shard=False)
                    err = check_pair(
                        "k6_check",
                        dict(fields, method=method, fz=fz, kernel=kernel),
                        *fb.fused_box3d_step(*args),
                        *fb.fused_box3d_step(*args),
                        *fb.fused_box3d_step_reference(*args), dtype, y,
                        bitwise=True,
                        ss_tiles=(fb.fused_box3d_tile_sums(*args)
                                  if box_stream.uses_stream(tab) else None))
                    worst6[dtype] = max(worst6[dtype], err)
                for s in K7_STAGES if rho is not None else ():
                    hs, st = rkc_step_inputs(s, rho, dtype)
                    args = (y, hs, fzt, st, mu1, ctab, bc, cfg.rtol,
                            cfg.atol)
                    traced = dtype == torch.float32 and fz == 0.0
                    err = check_pair(
                        "k7_check", dict(fields, s=s, fz=fz, kernel=(
                            check_rkc_dispatch(
                                "k7_check",
                                lambda: fk.fused_box3d_rkc_step(*args),
                                bc.kind, shard=False)
                            if traced else None)),
                        *fk.fused_box3d_rkc_step(*args),
                        *fk.fused_box3d_rkc_step(*args),
                        *fk.fused_box3d_rkc_step_reference(*args), dtype, y,
                        bitwise=True,
                        ss_tiles=(fk.fused_box3d_rkc_tile_sums(*args)
                                  if box_stream.rkc_uses_stream(bc.kind)
                                  else None))
                    worst7[dtype] = max(worst7[dtype], err)
            del y, bc
        del problem
    return worst6, worst7


def box_timings(cases, card):
    """K6 (bs32) and K7 (each s of K7_TIMED_STAGES) in each operator mode,
    from the ICs of each (label, config, build arguments) of `cases` (the
    volumetric slab's shape), f32, unfrozen; prints phases k6_timing (the
    kernel's device time from profiler traces, device_ms, the CUDA-event
    time of a burst beside it, the stream plan and the kernel's registers,
    blocks an SM and shared bytes) and k7_timing (the device time of a
    step's launches, device_ms with their group, the burst, and for the
    chunk kernel the chunks, plan, registers, blocks an SM and shared
    bytes) with each bound.
    Returns {(kernel, label, s or None): (kernel ms, plain ms, bound ms,
    bound_by)}."""
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import box_stream
    from crdmodel_tpu_torch.ops import fused_box3d as fb
    from crdmodel_tpu_torch.ops import fused_box3d_rkc as fk
    from crdmodel_tpu_torch.ops.fused_box3d import MODE_IDS
    from crdmodel_tpu_torch.ops.fused_rkc import static_stage_tables
    from crdmodel_tpu_torch.ops.kernel_common import prepare_box_constants

    timings = {}
    dtype = torch.float32
    for label, cfg, build_kw in cases:
        problem = build_problem(cfg, device="cuda", **build_kw)
        bc = prepare_box_constants(problem, dtype, "cuda")
        y = problem.y0.contiguous()
        zero = torch.zeros((), dtype=dtype, device="cuda")
        tab = TABLEAUS["bs32"]
        args = (y, torch.tensor(BOX_H, device="cuda"), zero, bc, tab,
                cfg.rtol, cfg.atol)
        burst = median_ms(lambda: fb.fused_box3d_step(*args), *BOX_TIMED)
        t6 = (device_ms(lambda: fb.fused_box3d_step(*args),
                        box_stream.kernel_name(tab), BOX_TIMED[0]),
              median_ms(lambda: fb.fused_box3d_step_reference(*args),
                        *BOX_PLAIN_TIMED),
              *bound(y, bc, erk_ops(bc, tab)))
        timings["k6", label, None] = t6
        phase("k6_timing", case=label, mode=bc.kind, shape=list(y.shape),
              method="bs32", dtype="float32", kernel_us=t6[0] * 1e3,
              burst_us=burst * 1e3, plain_us=t6[1] * 1e3,
              bound_us=t6[2] * 1e3, bound_by=t6[3],
              plan=box_stream.stream_plan(4, tuple(y.shape[1:]))[:3],
              **box_stream.kernel_info("crd_fused_box3d_info", dtype,
                                       MODE_IDS[bc.kind], bc.kinetics_id),
              card=card)
        mu1, ctab = static_stage_tables(fk.C_RKC, dtype, "cuda")
        tables = sum(t.numel() * t.element_size() for t in (mu1, ctab))
        rho = problem_rho(problem, y)
        for s in K7_TIMED_STAGES:
            hs, st = rkc_step_inputs(s, rho, dtype)
            args = (y, hs, zero, st, mu1, ctab, bc, cfg.rtol, cfg.atol)
            stream = box_stream.rkc_uses_stream(bc.kind)
            burst = median_ms(lambda: fk.fused_box3d_rkc_step(*args),
                              *BOX_TIMED)
            t7 = (device_ms(lambda: fk.fused_box3d_rkc_step(*args),
                            box_stream.rkc_kernel_name(bc.kind),
                            BOX_TIMED[0],
                            group=(box_stream.rkc_launches(fk.C_RKC)
                                   if stream else 1)),
                  median_ms(lambda: fk.fused_box3d_rkc_step_reference(*args),
                            *BOX_PLAIN_TIMED),
                  *bound(y, bc, rkc_ops(bc, s), tables))
            timings["k7", label, s] = t7
            phase("k7_timing", case=label, mode=bc.kind,
                  shape=list(y.shape), s=s, dtype="float32",
                  kernel=box_stream.rkc_kernel_name(bc.kind),
                  kernel_us=t7[0] * 1e3, burst_us=burst * 1e3,
                  plain_us=t7[1] * 1e3, bound_us=t7[2] * 1e3,
                  bound_by=t7[3], **({} if not stream else dict(
                      chunks=box_stream.rkc_chunks(s),
                      plan=box_stream.stream_plan(
                          4, tuple(y.shape[1:]),
                          min_tiles=box_stream.RKC_MIN_TILES)[:3],
                      **box_stream.kernel_info(
                          "crd_fused_box3d_rkc_info", dtype,
                          MODE_IDS[bc.kind], bc.kinetics_id))),
                  card=card)
        del problem, bc, y
    return timings


def bounded_tissue():
    """The bounded cardiac-tissue program of scripts/bench_suite.py::
    bounded_tissue, copied (this script imports nothing of the JAX package
    or its scripts): Aliev-Panfilov on a flat 1600x400 sheet, no-flux
    walls, an inert circular scar of radius 36 cells around (800, 220),
    bs32, f32, Tf=8. Returns (cfg, build arguments)."""
    from crdmodel_tpu_torch.config import SimConfig
    cfg = SimConfig(model="aliev_panfilov", surface="flat", x_mesh=400,
                    surface_width=20, surface_length=80, diffusion=1.0,
                    beta=0.10, wave_length=0.25, wave_width=0.5,
                    t_final=8.0, output_timestep=2, dtype="float32",
                    rtol=1e-4, atol=1e-7, boundary="noflux")
    return cfg, dict(obstacle_mask=circular_scar(cfg))


def circular_scar(cfg):
    """The bounded tissue's obstacle mask on cfg's grid: False on a disc of
    radius 0.09 nx around (ny/2, 0.55 nx)."""
    ny, nx = cfg.ny, cfg.nx
    jj, ii = np.mgrid[0:ny, 0:nx]
    return (jj - ny * 0.5) ** 2 + (ii - nx * 0.55) ** 2 > (nx * 0.09) ** 2


def wide_sheet():
    """The JAX suite's wide FHN sheet (scripts/bench_suite.py:57-67, the
    row "FHN flat 12800x3200 Tf=0.5 rkc2 (halo ladder)"), copied: flat
    12800x3200 (41M points), rkc2, f32, Tf=0.5, auto selection."""
    from crdmodel_tpu_torch.config import SimConfig
    return SimConfig(model="fhn", surface="flat", x_mesh=3200,
                     surface_width=20, surface_length=80, t_final=0.5,
                     output_timestep=1, vary_beta=0, t_boundary=0.0,
                     dtype="float32", rtol=1e-5, atol=1e-8, method="rkc2")


def fiber_tensor(cfg, d_par, d_perp, angle0=0.0, angle1=np.pi / 3):
    """examples/anisotropic_fibers.py::fiber_tensor, copied: D = R
    diag(d_par, d_perp) R^T with the fibre angle rotating linearly in x
    from angle0 to angle1."""
    th = np.linspace(angle0, angle1, cfg.nx)[None, :]
    th = np.broadcast_to(th, (cfg.ny, cfg.nx))
    c, s = np.cos(th), np.sin(th)
    dxx = d_par * c * c + d_perp * s * s
    dyy = d_par * s * s + d_perp * c * c
    dxy = (d_par - d_perp) * c * s
    return dxx, dyy, dxy


def aniso_sheet():
    """The fibered cardiac sheet, copied: the configuration of the JAX
    package's on-chip K5 test (tests_tpu/test_aniso_tpu.py:16-20),
    Aliev-Panfilov on a flat periodic 1600x400 sheet, bs32, f32, Tf=1, with
    the rotating fibres of examples/anisotropic_fibers.py (d_par 1,
    d_perp 0.2, from 0 to pi/3 across x). Returns (cfg, build arguments)."""
    from crdmodel_tpu_torch.config import SimConfig
    cfg = SimConfig(model="aliev_panfilov", surface="flat", x_mesh=400,
                    surface_width=20, surface_length=80, diffusion=1.0,
                    beta=0.05, wave_length=0.1, wave_width=0.2, t_final=1.0,
                    output_timestep=2, dtype="float32", rtol=1e-4,
                    atol=1e-7)
    return cfg, dict(diffusion_tensor=fiber_tensor(cfg, 1.0, 0.2, 0.0,
                                                   np.pi / 3))


def volumetric_box():
    """The JAX suite's volumetric slab (scripts/bench_suite.py:95-105, the
    rows "AP box 32x512x512 (8.4M pts) Tf=0.5"), copied: Aliev-Panfilov on
    a 32x512x512 box (8.4M points, a 67 MB f32 state), no-flux walls,
    Tf=0.5, rtol 1e-4, bs32, auto selection."""
    from crdmodel_tpu_torch.config import SimConfig
    return SimConfig(model="aliev_panfilov", surface="box", x_mesh=512,
                     y_mesh=512, z_mesh=32, surface_width=32.0,
                     surface_length=32.0, surface_depth=2.0, diffusion=1.0,
                     beta=0.10, wave_length=0.25, wave_width=0.5,
                     t_final=0.5, output_timestep=1, dtype="float32",
                     rtol=1e-4, atol=1e-7, boundary="noflux")


def box_scar(cfg):
    """The scarred slab's build arguments (scripts/bench_box3d.py:47-52,
    box8M_scar), copied: an inert cylinder of radius 48 cells around
    (256, 256), through every plane."""
    yy, xx = np.meshgrid(np.arange(cfg.ny), np.arange(cfg.nx), indexing="ij")
    scar = (yy - 256) ** 2 + (xx - 256) ** 2 < 48 ** 2
    return dict(obstacle_mask=np.broadcast_to(~scar,
                                              (cfg.nz, cfg.ny, cfg.nx)))


def box_field(cfg):
    """The +-20% random 3-D diffusion field of scripts/bench_box3d.py:
    110-114 (box8M_field), copied."""
    rng = np.random.default_rng(0)
    return dict(diffusion_field=0.8 + 0.4 * rng.random((cfg.nz, cfg.ny,
                                                        cfg.nx)))


def transmural_tensor(cfg, d_par=1.0, d_perp=0.25, d_trans=0.02,
                      angle0=-np.pi / 3, angle1=np.pi / 3):
    """examples/fiber_rotation_3d.py:35-53, copied: the full 3x3 tensor
    with the fibre in the (x, y) plane rotating linearly in z from angle0
    to angle1. Returns the build arguments."""
    th = np.linspace(angle0, angle1, cfg.nz).reshape(-1, 1, 1)
    c, s = np.cos(th), np.sin(th)
    shape = (cfg.nz, cfg.ny, cfg.nx)
    return dict(diffusion_tensor=(
        np.broadcast_to(d_par * c * c + d_perp * s * s, shape),
        np.broadcast_to(d_par * s * s + d_perp * c * c, shape),
        np.full(shape, d_trans),
        np.broadcast_to((d_par - d_perp) * c * s, shape),
        np.zeros(shape), np.zeros(shape)))


# the torch-path reference runs started in a worker process while the
# kernels build (start_background_runs): {(cfg, dtype): the future of
# background_run's result}, which torch_path_run takes when it is there
BACKGROUND_RUNS = {}


def background_run(cfg, dtype):
    """torch_path_run(cfg, {}, dtype) in a worker process, the trajectory
    on the host, the card's cached memory released."""
    traj, steps, wall, ok = torch_path_run(cfg, {}, dtype)
    traj = traj.cpu()
    torch.cuda.empty_cache()
    return traj, steps, wall, ok


def start_background_runs():
    """Start the script's longest torch-path reference, the large Goldbeter
    torus's f64 run (~60 s, main_path_sharded_large_goldbeter_ark324's),
    in a spawned worker process, which runs it on the idle card while nvcc
    builds the kernels (one a CPU, _build.build_jobs) and exits after
    it."""
    import concurrent.futures
    import multiprocessing
    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    cfg = large_goldbeter_torus()
    BACKGROUND_RUNS[cfg, "float64"] = pool.submit(background_run, cfg,
                                                  "float64")
    pool.shutdown(wait=False)     # the worker ends with its run


def torch_path_run(cfg, build_kw, dtype, rkc_h_limit=None):
    """`cfg` (built with `build_kw`) through the port's torch path on the
    card (use_pallas=False) in `dtype`; rkc2 with K7's h cap
    (ops/fused_box3d_rkc.py::box_rkc_h_limit), or rkc_h_limit(rho_fn,
    dtype)'s (K2's: k2_h_limit), so that it takes the stage budget the
    kernel takes, and a forcing's pulse edges as breakpoints, as
    simulate() takes them; a run started in the background
    (BACKGROUND_RUNS) is taken from there. Returns (trajectory, steps, wall
    s, ok)."""
    import time

    pending = BACKGROUND_RUNS.get((cfg, dtype))
    if pending is not None and not build_kw and rkc_h_limit is None:
        traj, steps, wall, ok = pending.result()
        return traj.to("cuda"), steps, wall, ok

    from crdmodel_tpu_torch.core.problem import (build_problem,
                                                 make_rho_bound,
                                                 solver_breakpoints)
    from crdmodel_tpu_torch.integrate.erk import integrate_to_outputs
    from crdmodel_tpu_torch.ops.fused_box3d_rkc import box_rkc_h_limit
    from crdmodel_tpu_torch.sim import output_times, simulate

    c = dataclasses.replace(cfg, use_pallas=False, dtype=dtype)
    problem = build_problem(c, "cuda", **build_kw)
    if c.method != "rkc2":
        res = simulate(c, "cuda", problem=problem)
        return res.trajectory, res.total_steps(), res.wall_time, res.ok
    rho_fn = make_rho_bound(c, problem.model, problem.geometry,
                            problem.y0.dtype,
                            diffusion_field=problem.diffusion_field,
                            diffusion_tensor=problem.diffusion_tensor,
                            face_mask=problem.face_mask)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traj, stats = integrate_to_outputs(
        problem.rhs, problem.y0, problem.params, 0.0, output_times(c),
        rtol=c.rtol, atol=c.atol, method="rkc2", max_steps=c.max_steps,
        breakpoints=solver_breakpoints(c, problem.forcing),
        step_mode=c.step_mode,
        rho_fn=rho_fn, h_limit_fn=(rkc_h_limit or box_rkc_h_limit)(
            rho_fn, problem.y0.dtype))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (torch.cat([problem.y0[None], traj]), int(stats.steps.sum()),
            wall, bool(torch.all(stats.status == 0)))


def run_box_path(name, cfg, build_kw, kernel, label, min_step_tol,
                 scar=None, keep=None, report=None):
    """A box program through simulate() on the card (auto selection), held
    against the port's torch path on the card in f32 and f64 (a JAX CPU
    run of 8.4M points is out of this script's reach): steps within
    min_step_tol of the torch f32 run's, or within its own distance to the
    torch f64 run where that is larger; BOX_PROBES probe values at every
    output within 2x the torch f32-f64 gap plus 1e-4 of the torch f64
    run's. With `scar` (the tissue mask), its inert cells hold their IC
    bitwise at every output. Prints phase `name`; returns the launches of
    `kernel`. `keep`: a dict that receives the run's steps, wall, final
    field and that field's distance to the torch path's f64 run, which
    the sharded slab's runs are held to (run_sharded_slab). report(res,
    counts) -> dict adds fields to the phase line (traced_path)."""
    res, counts = drive_main_path(cfg, build_kw)
    launches = counts[kernel.__name__]
    checks = run_checks(cfg, res, kernel, launches)
    extra = {} if report is None else report(res, counts)
    forcing = res.problem.forcing
    traj = res.trajectory
    shape = tuple(traj.shape[1:])
    rng = np.random.default_rng(SEED + 20)
    idx = tuple(torch.as_tensor(rng.integers(0, n, BOX_PROBES),
                                device="cuda") for n in shape)
    got = traj[(slice(None), *idx)].double().cpu().numpy()
    if scar is not None:
        inert = torch.as_tensor(~scar, device="cuda")
        held = traj[:, :, inert]
        checks["scar cells hold their IC bitwise"] = bool(
            (held == held[:1]).all())
        phase("scar", cells=int(inert.sum()), outputs=int(traj.shape[0]),
              held_ic_bitwise=checks["scar cells hold their IC bitwise"])
    steps, wall, status = res.total_steps(), res.wall_time, res.describe()
    stats = res.stats
    final = traj[-1].clone()
    del res, traj
    refs = {}
    for dtype in ("float32", "float64"):
        ref_traj, ref_steps, ref_wall, ref_ok = torch_path_run(cfg, build_kw,
                                                               dtype)
        refs[dtype] = dict(steps=ref_steps, wall_s=ref_wall, ok=ref_ok,
                           probes=ref_traj[(slice(None), *idx)].double()
                           .cpu().numpy())
        if keep is not None and dtype == "float64":
            keep.update(steps=steps, wall_s=wall, final=final,
                        f64_gap=float((final.double() - ref_traj[-1])
                                      .abs().max()))
        del ref_traj
    r32, r64 = refs["float32"], refs["float64"]
    step_tol = max(min_step_tol,
                   abs(r32["steps"] - r64["steps"]) / r32["steps"])
    f32_gap = float(np.abs(r32["probes"] - r64["probes"]).max())
    gap = float(np.abs(got - r64["probes"]).max())
    limit = 2.0 * f32_gap + 1e-4
    points = int(np.prod(shape[1:]))
    phase(name, config=label, selection=selection_note(cfg), **extra,
          grid=list(shape[1:]), method=cfg.method, dtype=cfg.dtype,
          status=status, fused=True, steps=steps,
          accepted=int(stats.accepted.sum()),
          rejected=int(stats.rejected.sum()), kernel=kernel.__name__,
          launches=counts, launch_bound=launch_bound(cfg, steps, forcing),
          wall_s=wall, us_per_step=wall / steps * 1e6,
          points_steps_per_s=points * steps / wall,
          torch_path={k: dict(steps=v["steps"], wall_s=v["wall_s"],
                              ok=v["ok"]) for k, v in refs.items()},
          step_limit=step_tol, probe_max_abs_err_vs_torch_f64=gap,
          probe_limit=limit, torch_f32_probe_gap=f32_gap, card=card_line())
    checks.update({
        "torch path ok": r32["ok"] and r64["ok"],
        f"steps within {step_tol:.2%} of the torch path f32":
            abs(steps - r32["steps"]) <= step_tol * r32["steps"],
        "probes vs the torch path f64": gap <= limit,
    })
    fail_unless(name, checks)
    return launches


def ptxas_entries(source, tag=""):
    """ptxas's report (-Xptxas -v) of each kernel of csrc/<source> whose
    entry name holds `tag`, after the build: [{"kernel": the name (with a
    tag, the mangled name's template arguments after it: the RHS
    functor's, the grid's, the type's), "registers": n,
    "spill_store_bytes": the most of its spill lines}]; the lines before
    the first entry stand under the name ""."""
    import re

    from crdmodel_tpu_torch.ops import _build
    entries = [{"kernel": ""}]
    for line in _build.ptxas_report(source):
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entries.append({"kernel": m.group(1)})
            continue
        e = entries[-1]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            e["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            e["spill_store_bytes"] = max(e.get("spill_store_bytes", 0),
                                         int(m.group(1)))
    return [dict(e, kernel=e["kernel"].split(tag, 1)[1].split("EvPK")[0])
            if tag else e for e in entries if tag in e["kernel"]]


def ptxas_summary(source, tag=None):
    """The most registers and spill bytes over the kernels of csrc/
    <source> (ptxas_entries); with `tag`, over those whose entry name
    holds it."""
    entries = ptxas_entries(source, tag or "")
    regs = [e["registers"] for e in entries if "registers" in e]
    spills = [e["spill_store_bytes"] for e in entries
              if "spill_store_bytes" in e]
    return {"kernels": len(regs), "max_registers": max(regs),
            "max_spill_store_bytes": max(spills)}


def tensor_checks(probes, tensor):
    """extra_checks of the fibered run: this script's fibres are the
    stored ones, bitwise."""
    def checks(res):
        return {"fibres are the stored ones": all(
            np.array_equal(np.broadcast_to(c, probes[k].shape), probes[k])
            for c, k in zip(tensor, ("dxx", "dyy", "dxy")))}
    return checks


def run_main_path(cfg, probes, kernel, min_step_tol, name, label,
                  build_kw=None, extra_checks=None, mesh=None, keep=None,
                  versus=None, launch_checks=None, report=None):
    """The program `cfg` (built with `build_kw`) through simulate() on the
    card, with every kernel's launch count set to 0 just before and read
    just after; `kernel` is the wrapper whose kernel the path must take.
    Checks against the JAX CPU runs in `probes`, and extra_checks(res) ->
    {name: passed} when given; prints phase `name` with the config `label`;
    returns the launch count of `kernel`.

    The step count must lie within min_step_tol of the JAX f32 run's, or
    within that run's own distance to the JAX f64 run where that is larger:
    where the error estimate sits at the f32 rounding floor, the count
    follows the rounding (as the probe limit follows the f32-f64 gap).

    With `mesh`, the run goes through simulate_sharded on it. `keep`: a
    dict that receives the run's steps and probe values; `versus`: such a
    dict of an earlier run in this call, which this one is also held to:
    steps within the same tolerance (the probes' distance is printed; both
    runs are already held to the JAX f64 run's). launch_checks(res,
    counts) -> {name: passed} replaces the check that `kernel` took every
    step (a kernel-batched run's, kstep_launch_checks); report(res, counts)
    -> dict adds fields to the phase line."""
    res, counts = drive_main_path(cfg, build_kw or {}, mesh)
    launches = counts[kernel.__name__]

    traj = res.trajectory
    steps = res.total_steps()
    gate, gate_checks, got = golden_gate(traj, steps, probes, min_step_tol)
    step_tol = gate["step_limit"]
    wall = res.wall_time
    extra = {}
    if mesh is not None:
        extra.update(mesh=list(mesh.shape),
                     devices=[str(d) for d in mesh.device_list()])
    if versus is not None:
        extra.update(
            versus_steps=versus["steps"],
            probe_max_abs_err_vs_single_device=float(
                np.abs(got - versus["probes"]).max()))
    if keep is not None:
        keep.update(steps=steps, probes=got, wall_s=wall, trajectory=traj,
                    stats=res.stats)
    if report is not None:
        extra.update(report(res, counts))
    phase(name, config=label, selection=selection_note(cfg), **extra,
          grid=[cfg.ny, cfg.nx], method=cfg.method, dtype=cfg.dtype,
          status=res.describe(), fused=res.fused, steps=steps,
          accepted=int(res.stats.accepted.sum()),
          rejected=int(res.stats.rejected.sum()), **gate,
          kernel=kernel.__name__,
          launches=counts,
          launch_bound=launch_bound(cfg, steps, res.problem.forcing),
          wall_s=wall, us_per_step=wall / steps * 1e6,
          points_steps_per_s=cfg.nx * cfg.ny * steps / wall,
          card=card_line())
    checks = run_checks(cfg, res, kernel, launches,
                        1 if mesh is None else mesh.size)
    if launch_checks is not None:
        del checks[f"every step through {kernel.__name__}"]
        checks.update(launch_checks(res, counts))
    checks.update(gate_checks)
    if versus is not None:
        checks[f"steps within {step_tol:.2%} of the single-device run"] = (
            abs(steps - versus["steps"]) <= step_tol * versus["steps"])
    if extra_checks is not None:
        checks.update(extra_checks(res))
    fail_unless(name, checks)
    return launches


def kernel_wrappers():
    """Every kernel's wrapper, whose `launches` counts its launches."""
    from crdmodel_tpu_torch.ops import (fused_aniso, fused_box3d,
                                        fused_box3d_rkc, fused_divform,
                                        fused_imex, fused_kstep, fused_rkc,
                                        fused_shard_box3d,
                                        fused_shard_box3d_rkc,
                                        fused_shard_divform,
                                        fused_shard_imex, fused_shard_rkc,
                                        fused_shard_step, fused_step)
    return (fused_step.fused_step, fused_rkc.fused_rkc_step,
            fused_imex.fused_imex_step, fused_divform.fused_divform_step,
            fused_aniso.fused_aniso_step, fused_box3d.fused_box3d_step,
            fused_box3d_rkc.fused_box3d_rkc_step,
            fused_shard_step.fused_shard_step,
            fused_shard_rkc.fused_shard_rkc_step,
            fused_shard_imex.fused_shard_imex_step,
            fused_shard_divform.fused_shard_divform_step,
            fused_shard_box3d.fused_shard_box3d_step,
            fused_shard_box3d_rkc.fused_shard_box3d_rkc_step,
            fused_kstep.fused_kstep)


def run_program(cfg, build_kw, mesh=None):
    """`cfg` through simulate() on the card, or through simulate_sharded()
    on `mesh`, the problem built on cuda:0 (the mesh's control device)."""
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.parallel.sharded import simulate_sharded
    from crdmodel_tpu_torch.sim import simulate

    problem = build_problem(cfg, "cuda", **build_kw)
    if mesh is None:
        return simulate(cfg, device="cuda", problem=problem)
    return simulate_sharded(cfg, mesh=mesh, problem=problem)


def drive_main_path(cfg, build_kw, mesh=None):
    """Run `cfg` (built with `build_kw`) through simulate() on the card, or
    through simulate_sharded() on `mesh`, after a warm-up on a short
    horizon (the first launches of every torch op), with every kernel's
    launch count set to 0 just before and read just after. Returns (result,
    {wrapper name: launches}), with K14's batches and recoveries that did
    work (ops/fused_kstep.py::work_counts) under "fused_kstep_batches" and
    "fused_kstep_recoveries"."""
    from crdmodel_tpu_torch.ops import fused_kstep
    wrappers = kernel_wrappers()

    def run(c):
        return run_program(c, build_kw, mesh)

    run(dataclasses.replace(cfg, t_final=min(1.0, 0.1 * cfg.t_final),
                            output_timestep=1))
    work = fused_kstep.work_counts("cuda")
    for w in wrappers:
        w.launches = 0
    work.zero_()
    res = run(cfg)
    counts = {w.__name__: w.launches for w in wrappers}
    counts["fused_kstep_batches"], counts["fused_kstep_recoveries"] = (
        int(c) for c in work.tolist())
    return res, counts


def selection_note(cfg):
    """How the run's path was selected, for its phase line."""
    from crdmodel_tpu_torch.config import (PALLAS_AUTO_POINTS,
                                           PALLAS_BOX3D_AUTO_POINTS)
    points = cfg.nx * cfg.ny
    name, threshold = "PALLAS_AUTO_POINTS", PALLAS_AUTO_POINTS
    if cfg.surface == "box":
        points *= cfg.nz
        name, threshold = "PALLAS_BOX3D_AUTO_POINTS", PALLAS_BOX3D_AUTO_POINTS
    if cfg.use_pallas is None:
        return (f"auto (use_pallas=None): the fused path above "
                f"{name}={threshold} points")
    return (f"use_pallas={cfg.use_pallas}; {points} points, auto selection "
            f"would take the "
            f"{'fused' if points >= threshold else 'torch'} path")


def launch_bound(cfg, steps, forcing=None):
    """[least, most] kernel launches of a fused run of `steps` steps: every
    step, and the no-op iterations of the last block of each stop (the
    forcing's pulse edges among the stops)."""
    from crdmodel_tpu_torch.core.problem import solver_breakpoints
    from crdmodel_tpu_torch.integrate.erk import SYNC_EVERY, merge_stops
    from crdmodel_tpu_torch.sim import output_times
    n_stops = len(merge_stops(output_times(cfg),
                              solver_breakpoints(cfg, forcing))[0])
    return [steps, steps + SYNC_EVERY * n_stops]


def run_checks(cfg, res, kernel, launches, shards=1):
    """The checks every main path's run passes: status, the fused path,
    the trajectory's shape and finiteness, every step through `kernel`
    (once a shard a step on a mesh of `shards` shards)."""
    traj = res.trajectory
    least, most = (shards * n for n in launch_bound(
        cfg, res.total_steps(), res.problem.forcing))
    return {
        "status ok": res.ok,
        "fused path": res.fused,
        "shape": tuple(traj.shape) == (cfg.output_timestep + 1,
                                       *res.problem.y0.shape),
        "finite": bool(torch.isfinite(traj).all()),
        f"every step through {kernel.__name__}": least <= launches <= most,
    }


def fail_unless(name, checks):
    failed = [check for check, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"main path {name} failed: {failed}")


def scar_checks(probes, mask, drift=0.0):
    """extra_checks of the bounded runs: this script's scar is the stored
    one, and the stored scar cells hold the JAX IC (cast to the run's
    dtype) at every output: bitwise when drift is 0 (ERK: y0 + (h b) 0 is
    y0), else within drift. RKC2's recurrence (1 - mu - nu) y0 + mu Y_{j-1}
    + nu Y_{j-2} rounds at a stationary cell, in the JAX package too."""
    def checks(res):
        traj = res.trajectory
        j, i = (torch.as_tensor(probes[k], device=traj.device)
                for k in ("scar_j", "scar_i"))
        ic = torch.as_tensor(probes["scar_ic"], device=traj.device).to(
            traj.dtype)
        held = traj[:, :, j, i] - ic[None]
        worst = float(held.abs().max())
        phase("scar", cells=int(j.numel()),
              held_ic_bitwise=bool((held == 0).all()), max_drift=worst,
              drift_limit=drift, outputs=int(traj.shape[0]))
        return {"scar is the stored one": np.array_equal(
                    mask, probes["obstacle_mask"]),
                f"scar cells hold their IC to {drift}": worst <= drift}
    return checks


def run_wide_sheet(cfg, rkc2_probes):
    """The wide sheet through K2 (auto selection) and through the port's
    torch-path rkc2 (use_pallas=False), both on the card: steps within the
    rkc2 gate (2%), and the final fields within the JAX f32-f64 probe gap
    of the canonical rkc2 run plus 1e-4 (the sheet has no JAX golden: a
    JAX CPU run of 41M points at this horizon is out of reach); K2's mean
    device time a launch from a traced second run. Prints phase
    main_path_wide_fhn_rkc2; returns K2's launches."""
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.ops import fused_rkc
    from crdmodel_tpu_torch.sim import simulate

    name = "main_path_wide_fhn_rkc2"
    kernel = fused_rkc.fused_rkc_step
    res, counts = drive_main_path(cfg, {})
    launches = counts[kernel.__name__]
    checks = run_checks(cfg, res, kernel, launches)
    final = res.trajectory[-1].clone()
    steps, wall, status = res.total_steps(), res.wall_time, res.describe()
    stats = res.stats
    del res
    k2_us = traced_mean_us(lambda: run_program(cfg, {}),
                           "fused_rkc_chunk_kernel")
    torch_cfg = dataclasses.replace(cfg, use_pallas=False)
    ref = simulate(torch_cfg, device="cuda",
                   problem=build_problem(torch_cfg, "cuda"))
    ref_steps = ref.total_steps()
    gap = float((final - ref.trajectory[-1]).abs().max())
    f32_gap = float(np.abs(rkc2_probes["probes_f32"]
                           - rkc2_probes["probes_f64"]).max())
    limit = f32_gap + 1e-4
    phase(name, config="scripts/bench_suite.py:57-67 fhn flat 12800x3200 "
          f"rkc2, Tf cut 0.5 -> {cfg.t_final}", selection=selection_note(cfg),
          grid=[cfg.ny, cfg.nx], method=cfg.method, dtype=cfg.dtype,
          status=status, steps=steps, accepted=int(stats.accepted.sum()),
          rejected=int(stats.rejected.sum()), kernel=kernel.__name__,
          launches=counts, launch_bound=launch_bound(cfg, steps),
          wall_s=wall, us_per_step=wall / steps * 1e6,
          points_steps_per_s=cfg.nx * cfg.ny * steps / wall,
          k2_traced_run=k2_us,
          torch_path=dict(status=ref.describe(), fused=ref.fused,
                          steps=ref_steps, wall_s=ref.wall_time),
          step_limit=0.02, final_max_abs_vs_torch_path=gap,
          final_limit=limit, canonical_rkc2_jax_f32_probe_gap=f32_gap,
          card=card_line())
    checks.update({
        "torch path ok": ref.ok and not ref.fused,
        "steps within 2% of the torch path":
            abs(steps - ref_steps) <= 0.02 * ref_steps,
        "final field vs the torch path": gap <= limit,
    })
    fail_unless(name, checks)
    return launches


def traced_mean_us(run, tag):
    """One call of run() (a whole run through the entry point) traced
    with torch.profiler (ops/trace.py::traced, every launch's kernel
    held): the launches of the kernels whose name holds `tag` and their
    mean device µs a launch."""
    from crdmodel_tpu_torch.ops import trace

    kernels, _ = trace.traced(run)
    durations = [e["dur"] for e in kernels if tag in e["name"]]
    return dict(launches=len(durations),
                mean_device_us=float(np.mean(durations)) if durations
                else None)


def device_ms(fn, tag, n=N_TIMED, group=1):
    """The median device duration of the kernels whose name holds `tag`
    over at least n calls of fn (without --timing at most QUICK_DEVICE),
    from pooled torch.profiler traces (ops/trace.py::device_ms; with
    `group`, the sum of a call's `group` such kernels): a kernel's own
    time where the host's issue of each call takes longer than the
    kernel."""
    from crdmodel_tpu_torch.ops import trace
    return trace.device_ms(fn, tag, n if TIMING_ALL else min(n, QUICK_DEVICE),
                           group=group)


def profile_run(cfg, build_kw, t_final, kernel_tag, mesh=None):
    """Trace `cfg` (built with `build_kw`) over [0, t_final] through
    simulate() on the card (simulate_sharded() on `mesh`) with
    torch.profiler, after an untraced run of the same horizon, and print
    phase "profile": device kernels a step, the device's busy time (the sum
    of kernel durations in the trace) and idle share over the traced wall,
    and the share of the kernels whose name holds `kernel_tag`; returns
    the phase's fields."""
    from crdmodel_tpu_torch.ops import trace

    run_cfg = dataclasses.replace(cfg, t_final=t_final, output_timestep=1)

    def run():
        return run_program(run_cfg, build_kw, mesh)

    run()                               # warm-up
    plain = run()
    kernels, res = trace.traced(run, cpu=True)
    busy_us = float(sum(e["dur"] for e in kernels))
    tagged = [e["dur"] for e in kernels if kernel_tag in e["name"]]
    steps = res.total_steps()
    fields = dict(
        config=cfg.program_name, t_final=t_final, steps=steps,
        speculative_k=cfg.speculative_k, step_mode=cfg.step_mode,
        mesh=None if mesh is None else list(mesh.shape),
        wall_s=res.wall_time, untraced_wall_s=plain.wall_time,
        device_kernels=len(kernels), kernels_per_step=len(kernels) / steps,
        device_busy_ms=busy_us / 1e3,
        device_idle_share=1.0 - busy_us / (res.wall_time * 1e6),
        kernel=kernel_tag, kernel_launches=len(tagged),
        kernel_mean_us=float(np.mean(tagged)) if tagged else None,
        kernel_share_of_busy=float(sum(tagged)) / busy_us)
    phase("profile", **fields, card=card_line())
    return fields


def kernel_entry(name, source, replaces, launches, worst, timing,
                 forced=None):
    """One kernel's entry of the `kernels` line; timing (ms, plain ms,
    bound ms, bound_by, ...); forced: its forced fields (forced_fields),
    for K1-K4 (K8-K11 have theirs added from mesh_forced_phases), else
    "forced" is null."""
    ms, plain_ms, bound_ms, bound_by = timing[:4]
    return {"name": name, "route": "cuda",
            "source": f"crdmodel_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": worst[torch.float32], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            # no single PyTorch call computes a fused step
            "library_ms": None, "forced": None, **(forced or {})}


BOX_LABEL = ("scripts/bench_suite.py:95-105 aliev_panfilov box 32x512x512 "
             "Tf=0.5, noflux")
SCAR_LABEL = ", the scar column of scripts/bench_box3d.py:47-52, bs32"


def box_modes(cfg_box):
    """The box kernels' four operator modes on the volumetric slab: (label,
    config, build arguments) of the noflux slab, the scar column, the
    +-20% diffusion field and the transmural tensor with noflux_z walls."""
    return [("noflux_slab", cfg_box, {}),
            ("scar_column", cfg_box, box_scar(cfg_box)),
            ("field", cfg_box, box_field(cfg_box)),
            ("transmural_tensor",
             dataclasses.replace(cfg_box, boundary="noflux_z"),
             transmural_tensor(cfg_box))]


def fhn_box(cfg_box):
    """FitzHugh-Nagumo with the beta ramp and a freeze on a 16x256x256 box
    with noflux_z walls: the box kernels' case of a beta field."""
    return dataclasses.replace(
        cfg_box, t_boundary=0.1, model="fhn", boundary="noflux_z",
        vary_beta=1, beta=1.25, beta_min=0.7, beta_max=1.7, x_mesh=256,
        y_mesh=256, z_mesh=16, surface_width=16.0, surface_length=16.0,
        surface_depth=1.0)


def stream_edge_boxes(cfg_box):
    """K6's stream scheme at its edges, as (label, config, build
    arguments, planes) of check_box_kernels: a 5x150x90 box (no tile
    divides 150 x 90) with a scar (the tissue mode) and no-flux walls,
    and FitzHugh-Nagumo's beta ramp on a 70x40 box of 2 planes with x
    and y periodic (edge tiles wrap; both z walls in one ring of planes),
    cut from a 3-plane box (box_stream.box_planes)."""
    odd = dataclasses.replace(cfg_box, t_boundary=0.1, x_mesh=90,
                              y_mesh=150, z_mesh=5, surface_width=5.625,
                              surface_length=9.375, surface_depth=0.25)
    yy, xx = np.meshgrid(np.arange(150), np.arange(90), indexing="ij")
    scar = (yy - 75) ** 2 + (xx - 44) ** 2 < 20 ** 2
    two = dataclasses.replace(fhn_box(cfg_box), x_mesh=70, y_mesh=40,
                              z_mesh=3, surface_width=4.375,
                              surface_length=2.5, surface_depth=0.1875)
    return [("odd_grid_scar", odd,
             dict(obstacle_mask=np.broadcast_to(~scar, (5, 150, 90))),
             None),
            ("two_planes_fhn", two, {}, 2)]


def box_main_paths(cfg_box):
    """The volumetric slab through simulate() with bs32 (main_path_box,
    K6), rkc2 (main_path_box_rkc2, K7) and the scar column
    (main_path_box_scar, K6's tissue mode), each held to the port's torch
    path. Returns K6's and K7's launches and {"bs32" | "rkc2" | "scar":
    the run's keep (run_box_path)}."""
    from crdmodel_tpu_torch.ops import fused_box3d, fused_box3d_rkc

    singles = {key: {} for key in ("bs32", "rkc2", "scar")}
    launches6 = run_box_path("main_path_box", cfg_box, {},
                             fused_box3d.fused_box3d_step,
                             BOX_LABEL + ", bs32", 0.01,
                             keep=singles["bs32"])
    launches7 = run_box_path(
        "main_path_box_rkc2", dataclasses.replace(cfg_box, method="rkc2"), {},
        fused_box3d_rkc.fused_box3d_rkc_step, BOX_LABEL + ", rkc2", 0.02,
        keep=singles["rkc2"])
    scar = box_scar(cfg_box)
    run_box_path("main_path_box_scar", cfg_box, scar,
                 fused_box3d.fused_box3d_step, BOX_LABEL + SCAR_LABEL, 0.01,
                 scar=scar["obstacle_mask"], keep=singles["scar"])
    return launches6, launches7, singles


def box_phases(cfg_box, card):
    """The 3-D box's phases: K6 and K7 against their plain versions
    (k6_check, k7_check) on the volumetric slab's shape in the four
    operator modes of box_modes (each with a freeze), on fhn_box and (K6
    alone) on stream_edge_boxes; their
    timings in each mode (k6_timing, k7_timing); box_main_paths. Returns
    K6's and K7's entries of the kernels line and the single-device runs
    of box_main_paths."""
    modes = box_modes(cfg_box)
    worst6, worst7 = check_box_kernels(
        [(label, dataclasses.replace(c, t_boundary=0.1), kw, None)
         for label, c, kw in modes]
        + [("fhn_beta_ramp", fhn_box(cfg_box), {}, None)]
        + stream_edge_boxes(cfg_box), SEED + 8)
    timings = box_timings(modes if TIMING_ALL else modes[:1], card)
    launches6, launches7, singles = box_main_paths(cfg_box)
    return [
        kernel_entry("fused_box3d_step", "fused_box3d.cu",
                     "crdmodel_tpu/ops/pallas_box3d.py:307", launches6,
                     worst6, timings["k6", "noflux_slab", None]),
        kernel_entry("fused_box3d_rkc_step", "fused_box3d_rkc.cu",
                     "crdmodel_tpu/ops/pallas_box3d_rkc.py:119", launches7,
                     worst7, timings["k7", "noflux_slab",
                                     max(K7_TIMED_STAGES)])], singles


def check_shard_box_kernels(cases, seed):
    """K12 (bs32 and dopri54, at BOX_H) and K13 (each s of K7_STAGES, h as
    in check_rkc_kernel) against their plain versions on the shards of
    each (label, config, build arguments, mesh shape, shards checked) of
    `cases`, f32 and f64, fz 0 and 1: y_new's block bitwise equal, two
    launches bitwise equal, a bs32 step's and a K13 chunk-kernel step's
    every partial sum bitwise the plain version's in the stream kernels'
    order (fused_shard_box3d_tile_sums, fused_shard_box3d_rkc_tile_sums),
    K12's launched kernel the one its dispatch names (check_dispatch),
    K13's traced in f32 on the first shard (check_rkc_dispatch); prints
    phases k12_check and k13_check. Returns the max errors of K12 and of
    K13."""
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import box_stream
    from crdmodel_tpu_torch.ops import fused_shard_box3d as f12
    from crdmodel_tpu_torch.ops import fused_shard_box3d_rkc as f13
    from crdmodel_tpu_torch.ops.fused_rkc import static_stage_tables
    from crdmodel_tpu_torch.ops.kernel_common import make_shard_box_constants

    rng = np.random.default_rng(seed)
    worst12 = {torch.float32: 0.0, torch.float64: 0.0}
    worst13 = {torch.float32: 0.0, torch.float64: 0.0}
    for label, cfg, build_kw, shape, shards in cases:
        mesh = shard_mesh(shape)
        problem = build_problem(cfg, device="cuda", **build_kw)
        y_np = random_state(cfg, tuple(problem.y0.shape), rng)
        for dtype in (torch.float32, torch.float64):
            bufs, consts = shard_inputs(problem, mesh, y_np, dtype, f12.HALO,
                                        make_shard_box_constants)
            mu1, ctab = static_stage_tables(f13.C_RKC, dtype, "cuda")
            rho = problem_rho(problem, torch.tensor(y_np, dtype=dtype,
                                                    device="cuda"))
            h = torch.tensor(BOX_H, dtype=dtype, device="cuda")
            for fz in (0.0, 1.0):
                fzt = torch.tensor(fz, dtype=dtype, device="cuda")
                for k in shards:
                    fields = dict(case=label, model=cfg.model,
                                  mesh=list(shape), shard=k,
                                  mode=consts[k].kind,
                                  shape=list(bufs[k].shape),
                                  valid=[consts[k].valid_rows,
                                         consts[k].valid_cols], fz=fz)
                    for method in ("bs32", "dopri54"):
                        tab = TABLEAUS[method]
                        args = (bufs[k], h, fzt, consts[k], tab, cfg.rtol,
                                cfg.atol)
                        kernel = check_dispatch(
                            "k12_check",
                            lambda: f12.fused_shard_box3d_step(*args), tab,
                            shard=True)
                        err = check_shard_pair(
                            "k12_check",
                            dict(fields, method=method, kernel=kernel),
                            f12.fused_shard_box3d_step,
                            f12.fused_shard_box3d_step_reference, args,
                            dtype,
                            tile_sums=(f12.fused_shard_box3d_tile_sums
                                       if box_stream.uses_stream(tab)
                                       else None))
                        worst12[dtype] = max(worst12[dtype], err)
                    for s in K7_STAGES:
                        hs, st = rkc_step_inputs(s, rho, dtype)
                        args = (bufs[k], hs, fzt, st, mu1, ctab, consts[k],
                                cfg.rtol, cfg.atol)
                        traced = (dtype == torch.float32 and fz == 0.0
                                  and k == shards[0])
                        stream = box_stream.rkc_uses_stream(consts[k].kind)
                        err = check_shard_pair(
                            "k13_check", dict(fields, s=s, kernel=(
                                check_rkc_dispatch(
                                    "k13_check",
                                    lambda: f13.fused_shard_box3d_rkc_step(
                                        *args), consts[k].kind, shard=True)
                                if traced else None)),
                            f13.fused_shard_box3d_rkc_step,
                            f13.fused_shard_box3d_rkc_step_reference, args,
                            dtype,
                            tile_sums=(f13.fused_shard_box3d_rkc_tile_sums
                                       if stream else None))
                        worst13[dtype] = max(worst13[dtype], err)
            del bufs, consts
        del problem
    return worst12, worst13


def shard_box_timings(cases, card):
    """K12 (bs32) and K13 (each s of K7_TIMED_STAGES) on shard 0 of the
    slab's 2x2 mesh, (2, 32, 272, 272), in each operator mode of `cases`
    (box_modes), from the ICs, f32, unfrozen, with their plain versions
    and bounds: the kernel's device time in a profiler trace (device_ms)
    and the CUDA-event time of a burst beside it; and one step's exchange
    of the four halo-padded 4-D buffers (halo_exchange_timing). Prints
    phases k12_timing and k13_timing; returns {("k12", label, None) |
    ("k13", label, s): (kernel ms, plain ms, bound ms, bound_by)}."""
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import box_stream
    from crdmodel_tpu_torch.ops import fused_shard_box3d as f12
    from crdmodel_tpu_torch.ops import fused_shard_box3d_rkc as f13
    from crdmodel_tpu_torch.ops.fused_box3d import MODE_IDS
    from crdmodel_tpu_torch.ops.fused_rkc import static_stage_tables
    from crdmodel_tpu_torch.ops.kernel_common import make_shard_box_constants
    from crdmodel_tpu_torch.parallel.halo import refresh_halos

    timings = {}
    dtype = torch.float32
    zero = torch.zeros((), dtype=dtype, device="cuda")
    mesh = shard_mesh(SHARD_MESH)
    tab = TABLEAUS["bs32"]
    n, burst_n = BOX_TIMED
    for label, cfg, build_kw in cases:
        problem = build_problem(cfg, "cuda", **build_kw)
        bufs, consts = shard_inputs(problem, mesh, problem.y0.cpu().numpy(),
                                    dtype, f12.HALO, make_shard_box_constants)
        fields = dict(case=label, mode=consts[0].kind,
                      shape=list(bufs[0].shape), halo=f12.HALO,
                      dtype="float32", card=card)
        args = (bufs[0], torch.tensor(BOX_H, device="cuda"), zero, consts[0],
                tab, cfg.rtol, cfg.atol)
        burst = median_ms(lambda: f12.fused_shard_box3d_step(*args), n,
                          burst_n)
        t12 = (device_ms(lambda: f12.fused_shard_box3d_step(*args),
                         box_stream.kernel_name(tab, shard=True), n),
               median_ms(lambda: f12.fused_shard_box3d_step_reference(*args),
                         *BOX_PLAIN_TIMED),
               *shard_bound(bufs[0], consts[0], erk_ops(consts[0], tab)))
        timings["k12", label, None] = t12
        phase("k12_timing", **fields, method="bs32", kernel_us=t12[0] * 1e3,
              burst_us=burst * 1e3, plain_us=t12[1] * 1e3,
              bound_us=t12[2] * 1e3, bound_by=t12[3],
              plan=box_stream.stream_plan(4, tuple(bufs[0].shape[1:]),
                                          f12.HALO)[:3],
              **box_stream.kernel_info("crd_fused_shard_box3d_info", dtype,
                                       MODE_IDS[consts[0].kind],
                                       consts[0].kinetics_id))
        mu1, ctab = static_stage_tables(f13.C_RKC, dtype, "cuda")
        tables = sum(t.numel() * t.element_size() for t in (mu1, ctab))
        rho = problem_rho(problem, problem.y0)
        for s in K7_TIMED_STAGES:
            hs, st = rkc_step_inputs(s, rho, dtype)
            args = (bufs[0], hs, zero, st, mu1, ctab, consts[0], cfg.rtol,
                    cfg.atol)
            stream = box_stream.rkc_uses_stream(consts[0].kind)
            burst = median_ms(lambda: f13.fused_shard_box3d_rkc_step(*args),
                              n, burst_n)
            t13 = (device_ms(lambda: f13.fused_shard_box3d_rkc_step(*args),
                             box_stream.rkc_kernel_name(consts[0].kind,
                                                        shard=True), n,
                             group=(box_stream.rkc_launches(f13.C_RKC)
                                    if stream else 1)),
                   median_ms(lambda: f13.fused_shard_box3d_rkc_step_reference(
                       *args), *BOX_PLAIN_TIMED),
                   *shard_bound(bufs[0], consts[0], rkc_ops(consts[0], s),
                                tables))
            timings["k13", label, s] = t13
            phase("k13_timing", **fields, s=s,
                  kernel=box_stream.rkc_kernel_name(consts[0].kind,
                                                    shard=True),
                  kernel_us=t13[0] * 1e3, burst_us=burst * 1e3,
                  plain_us=t13[1] * 1e3, bound_us=t13[2] * 1e3,
                  bound_by=t13[3], **({} if not stream else dict(
                      chunks=box_stream.rkc_chunks(s, shard=True),
                      launch_blocks=box_stream.rkc_launch_blocks(
                          tuple(bufs[0].shape[1:]), f12.HALO, f13.C_RKC),
                      **box_stream.kernel_info(
                          "crd_fused_shard_box3d_rkc_info", dtype,
                          MODE_IDS[consts[0].kind], consts[0].kinetics_id))))
        if label == cases[0][0]:
            ex = median_ms(lambda: refresh_halos(bufs, mesh, f12.HALO), n,
                           burst_n)
            phase("halo_exchange_timing", mesh=list(SHARD_MESH),
                  shards_on="cuda:0", halo=f12.HALO,
                  buffer=list(bufs[0].shape), exchange_us=ex * 1e3,
                  copies=4 * len(bufs), card=card)
        del problem, bufs, consts
    return timings


def selected_shard_kernel(cfg, build_kw, mesh):
    """The name select_shard_kernel gives `cfg`'s run on `mesh` ("K12",
    "K13", ..., or None for the torch path)."""
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.parallel.sharded import (mesh_pad_spec,
                                                     select_shard_kernel,
                                                     sharded_rho_bound)
    problem = build_problem(cfg, "cuda", **build_kw)
    pad = mesh_pad_spec(cfg, mesh)
    rho_fn = (sharded_rho_bound(problem, mesh, pad)
              if cfg.method == "rkc2" else None)
    return select_shard_kernel(problem, mesh, pad, rho_fn)[0]


def run_sharded_slab(name, cfg, build_kw, kernel, want, label, mesh, single,
                     step_tol, scar=None, keep=None, report=None):
    """The slab `cfg` (built with `build_kw`) through simulate_sharded() on
    `mesh` with the default selection, every kernel's launch count set to
    0 just before and read just after: select_shard_kernel must name
    `want` ("K12" or "K13") and every step go through `kernel`. Held to the
    single-device K6 or K7 run of the same call, `single` (run_box_path's
    keep): steps within step_tol, the final field within that run's own
    distance to the torch path's f64 run plus 1e-4; with `scar` (the tissue
    mask), the inert cells hold their IC bitwise at every output. Prints
    phase `name`; returns the launches of `kernel`. `keep`: a dict that
    receives the run's steps and wall; report(res, counts) -> dict adds
    fields to the phase line (traced_path)."""
    selected = selected_shard_kernel(cfg, build_kw, mesh)
    res, counts = drive_main_path(cfg, build_kw, mesh)
    launches = counts[kernel.__name__]
    checks = run_checks(cfg, res, kernel, launches, mesh.size)
    extra = {} if report is None else report(res, counts)
    checks[f"select_shard_kernel names {want}"] = selected == want
    if scar is not None:
        inert = torch.as_tensor(~scar, device=res.trajectory.device)
        held = res.trajectory[:, :, inert]
        checks["scar cells hold their IC bitwise"] = bool(
            (held == held[:1]).all())
        del held
    final = res.trajectory[-1]
    gap = float((final - single["final"].to(final.device)).abs().max())
    limit = single["f64_gap"] + 1e-4
    steps, wall = res.total_steps(), res.wall_time
    if keep is not None:
        keep.update(steps=steps, wall_s=wall)
    points = cfg.nz * cfg.ny * cfg.nx
    phase(name, config=label, selection=selection_note(cfg), **extra,
          selected=selected, mesh=list(mesh.shape),
          devices=[str(d) for d in mesh.device_list()],
          grid=[cfg.nz, cfg.ny, cfg.nx], method=cfg.method, dtype=cfg.dtype,
          status=res.describe(), steps=steps,
          accepted=int(res.stats.accepted.sum()),
          rejected=int(res.stats.rejected.sum()), kernel=kernel.__name__,
          launches=counts,
          launch_bound=launch_bound(cfg, steps, res.problem.forcing),
          wall_s=wall, us_per_step=wall / steps * 1e6,
          points_steps_per_s=points * steps / wall,
          single_device=dict(steps=single["steps"], wall_s=single["wall_s"],
                             f64_gap=single["f64_gap"]),
          wall_vs_single_device=wall / single["wall_s"], step_limit=step_tol,
          final_max_abs_vs_single_device=gap, final_limit=limit,
          held_ic_bitwise=checks.get("scar cells hold their IC bitwise"),
          card=card_line())
    checks.update({
        f"steps within {step_tol:.2%} of the single-device run":
            abs(steps - single["steps"]) <= step_tol * single["steps"],
        "final field vs the single-device run": gap <= limit,
    })
    fail_unless(name, checks)
    return launches


def sharded_slab_main_paths(cfg_box, singles, walls=None):
    """The volumetric slab through simulate_sharded() on a 2x2 mesh of
    shards on cuda:0 and, with four cards or more, again (phases tagged
    _4cards) with shard i on cuda:i: bs32 (main_path_sharded_slab, K12),
    rkc2 (main_path_sharded_slab_rkc2, K13) and the scar column
    (main_path_sharded_slab_scar, K12's tissue mode), each held to the
    single-device run of `singles` (box_main_paths): steps within 1% (rkc2
    within 2.78%, the JAX f32-f64 distance of the canonical rkc2 run).
    Returns the 2x2 runs' launches of K12 and K13; `walls`, a dict,
    receives the 2x2 runs' walls by phase name."""
    from crdmodel_tpu_torch.ops import fused_shard_box3d, fused_shard_box3d_rkc
    f12 = fused_shard_box3d.fused_shard_box3d_step
    f13 = fused_shard_box3d_rkc.fused_shard_box3d_rkc_step
    scar = box_scar(cfg_box)
    meshes = [shard_mesh(SHARD_MESH)]
    if torch.cuda.device_count() >= 4:
        meshes.append(shard_mesh(SHARD_MESH, [f"cuda:{i}" for i in range(4)]))
    launches = []
    keeps = {name: {} for name in ("main_path_sharded_slab",
                                   "main_path_sharded_slab_rkc2",
                                   "main_path_sharded_slab_scar")}
    for i, mesh in enumerate(meshes):
        tag = "" if i == 0 else "_4cards"
        n12 = run_sharded_slab("main_path_sharded_slab" + tag, cfg_box, {},
                               f12, "K12", BOX_LABEL + ", bs32", mesh,
                               singles["bs32"], 0.01,
                               keep=keeps["main_path_sharded_slab"])
        n13 = run_sharded_slab(
            "main_path_sharded_slab_rkc2" + tag,
            dataclasses.replace(cfg_box, method="rkc2"), {}, f13, "K13",
            BOX_LABEL + ", rkc2", mesh, singles["rkc2"], 0.0278,
            keep=keeps["main_path_sharded_slab_rkc2"])
        run_sharded_slab("main_path_sharded_slab_scar" + tag, cfg_box, scar,
                         f12, "K12", BOX_LABEL + SCAR_LABEL, mesh,
                         singles["scar"], 0.01, scar=scar["obstacle_mask"],
                         keep=keeps["main_path_sharded_slab_scar"])
        launches.append((n12, n13))
        if i == 0 and walls is not None:
            walls.update({k: v["wall_s"] for k, v in keeps.items()})
    return launches[0]


def shard_box_phases(cfg_box, singles, card, walls=None):
    """The sharded box's phases: K12 and K13 against their plain versions
    (k12_check, k13_check) on the 2x2 shards of the slab in the four
    operator modes of box_modes (each with a freeze; shards 0 and 3), on
    fhn_box's 2x2 shards and on fhn_box's uneven 1x3 mesh (blocks of 86,
    86 and 84 columns, mirror-pad cells); their timings in each mode
    (k12_timing, k13_timing) and the exchange's; sharded_slab_main_paths
    (`walls` receives its 2x2 runs' walls). Returns K12's and K13's
    entries of the kernels line."""
    fhn = fhn_box(cfg_box)
    cases = [(label, dataclasses.replace(c, t_boundary=0.1), kw,
              SHARD_MESH, (0, 3))
             for label, c, kw in box_modes(cfg_box)]
    cases += [("fhn_beta_ramp_2x2", fhn, {}, SHARD_MESH, (0, 3)),
              ("fhn_beta_ramp_uneven_1x3", fhn, {}, UNEVEN_MESH, (0, 1, 2))]
    worst12, worst13 = check_shard_box_kernels(cases, SEED + 12)
    modes = box_modes(cfg_box)
    timings = shard_box_timings(modes if TIMING_ALL else modes[:1], card)
    launches12, launches13 = sharded_slab_main_paths(cfg_box, singles,
                                                     walls)
    return [
        kernel_entry("fused_shard_box3d_step", "fused_shard_box3d.cu",
                     "crdmodel_tpu/ops/pallas_shard_box3d.py:109",
                     launches12, worst12,
                     timings["k12", "noflux_slab", None]),
        kernel_entry("fused_shard_box3d_rkc_step", "fused_shard_box3d_rkc.cu",
                     "crdmodel_tpu/ops/pallas_shard_box3d_rkc.py:82",
                     launches13, worst13,
                     timings["k13", "noflux_slab", max(K7_TIMED_STAGES)])]


def large_fhn_torus():
    """The JAX suite's large FHN torus (scripts/bench_suite.py:48-54, the
    row "FHN torus 1600x6400 Tf=1 rkc2", 126-127), copied: torus 6400x1600
    (10.24M points, an 82 MB f32 state), beta ramp, no freeze, rkc2, f32,
    Tf=1, auto selection."""
    from crdmodel_tpu_torch.config import SimConfig
    return SimConfig(model="fhn", surface="torus", x_mesh=1600,
                     surface_width=20, surface_length=80, t_final=1.0,
                     output_timestep=2, vary_beta=1, beta_min=0.7,
                     beta_max=1.7, t_boundary=0.0, dtype="float32",
                     rtol=1e-5, atol=1e-8, method="rkc2")


def shard_mesh(shape, devices=None):
    """A mesh of `shape`: every shard on cuda:0 by default, or on the
    given devices."""
    from crdmodel_tpu_torch.parallel.mesh import make_mesh
    n = shape[0] * shape[1]
    return make_mesh(shape=shape, devices=devices or ["cuda:0"] * n)


def shard_inputs(problem, mesh, y_np, dtype, halo, constants=None):
    """A global state on the card split over `mesh` into halo-padded
    buffers, their halos exchanged (mirror-aware on a padded mesh), and
    every shard's constants from `constants` (kernel_common.
    make_shard_constants by default): (buffers, constants)."""
    from crdmodel_tpu_torch.ops.kernel_common import make_shard_constants
    from crdmodel_tpu_torch.parallel.halo import mirror_halo_pad
    from crdmodel_tpu_torch.parallel.sharded import mesh_pad_spec, split_state

    pad = mesh_pad_spec(problem.cfg, mesh)
    y = torch.tensor(y_np, dtype=dtype, device="cuda")
    blocks = split_state(y, mesh, pad, problem.cfg)
    return (mirror_halo_pad(list(blocks), mesh, halo, pad),
            (constants or make_shard_constants)(problem, mesh, pad, halo,
                                                dtype))


def check_shard_pair(name, fields, kernel, reference, args, dtype,
                     tile_sums=None):
    """check_pair on the blocks of a shard kernel's and its plain version's
    y_new (the halo of y_new is the next exchange's), y_new bitwise; with
    tile_sums (the plain version of the partial sums, called as the
    kernel), every partial sum bitwise."""
    from crdmodel_tpu_torch.ops.fused_shard_step import interior
    halo = next(a for a in args if hasattr(a, "halo")).halo
    y_k, ss_k = kernel(*args)
    y_k2, ss_k2 = kernel(*args)
    y_r, ss_r = reference(*args)
    return check_pair(name, fields, interior(y_k, halo), ss_k,
                      interior(y_k2, halo), ss_k2, interior(y_r, halo), ss_r,
                      dtype, interior(args[0], halo), bitwise=True,
                      ss_tiles=tile_sums and tile_sums(*args))


def check_shard_kernels(cases, seed):
    """K8 (bs32 and dopri54, at H) and K9 (each s of K9_STAGES, h as in
    check_rkc_kernel) against their plain versions on the shards of each
    (label, config, mesh shape, shards checked, K8 too, K9 too) of
    `cases`, f32 and f64, fz 0 and 1: y_new's block bitwise equal, two
    launches bitwise equal, every partial sum bitwise the plain version's
    over the physical cells (fused_shard_step_tile_sums,
    fused_shard_rkc_tile_sums); K8 also the kernel the dispatch names
    (check_dispatch); K9 also an s beyond its tables on the first shard
    of each case (y_new's block y's, every sum NaN); prints phases
    k8_check and k9_check. Returns the max errors of K8 and of K9."""
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import fused_shard_rkc as f9
    from crdmodel_tpu_torch.ops import fused_shard_step as f8
    from crdmodel_tpu_torch.ops.fused_rkc import static_stage_tables

    rng = np.random.default_rng(seed)
    worst8 = {torch.float32: 0.0, torch.float64: 0.0}
    worst9 = {torch.float32: 0.0, torch.float64: 0.0}
    for label, cfg, shape, shards, with_k8, with_k9 in cases:
        mesh = shard_mesh(shape)
        problem = build_problem(cfg, device="cuda")
        y_np = random_state(cfg, tuple(problem.y0.shape), rng)
        for dtype in (torch.float32, torch.float64):
            fields = dict(case=label, model=cfg.model, surface=cfg.surface,
                          mesh=list(shape))
            for fz in (0.0, 1.0):
                fzt = torch.tensor(fz, dtype=dtype, device="cuda")
                if with_k8:
                    bufs, consts = shard_inputs(problem, mesh, y_np, dtype,
                                                f8.HALO)
                    h = torch.tensor(H, dtype=dtype, device="cuda")
                    for method in ("bs32", "dopri54"):
                        for k in shards:
                            args = (bufs[k], h, fzt, consts[k],
                                    TABLEAUS[method], cfg.rtol, cfg.atol)
                            kernel = check_dispatch(
                                "k8_check",
                                lambda: f8.fused_shard_step(*args),
                                TABLEAUS[method])
                            err = check_shard_pair(
                                "k8_check", dict(
                                    fields, shard=k, shape=list(bufs[k].shape),
                                    valid=[consts[k].valid_rows,
                                           consts[k].valid_cols],
                                    method=method, fz=fz, kernel=kernel),
                                f8.fused_shard_step,
                                f8.fused_shard_step_reference, args, dtype,
                                f8.fused_shard_step_tile_sums)
                            worst8[dtype] = max(worst8[dtype], err)
                    del bufs, consts
                if with_k9:
                    bufs, consts = shard_inputs(problem, mesh, y_np, dtype,
                                                f9.P_RKC)
                    mu1, ctab = static_stage_tables(f9.S_MAX_KERNEL, dtype,
                                                    "cuda")
                    rho = problem_rho(problem, torch.tensor(
                        y_np, dtype=dtype, device="cuda"))
                    for s in K9_STAGES:
                        hs, st = rkc_step_inputs(s, rho, dtype)
                        for k in shards:
                            args = (bufs[k], hs, fzt, st, mu1, ctab,
                                    consts[k], cfg.rtol, cfg.atol)
                            err = check_shard_pair(
                                "k9_check", dict(
                                    fields, shard=k, shape=list(bufs[k].shape),
                                    valid=[consts[k].valid_rows,
                                           consts[k].valid_cols],
                                    s=s, fz=fz),
                                f9.fused_shard_rkc_step,
                                f9.fused_shard_rkc_step_reference, args,
                                dtype, f9.fused_shard_rkc_tile_sums)
                            worst9[dtype] = max(worst9[dtype], err)
                    check_rkc_refusal(
                        "k9_check", dict(fields, shard=shards[0], fz=fz),
                        f9.fused_shard_rkc_step, f9.fused_shard_rkc_tile_sums,
                        (bufs[shards[0]], hs, fzt, st, mu1, ctab,
                         consts[shards[0]], cfg.rtol, cfg.atol))
                    del bufs, consts
        del problem
    return worst8, worst9


def check_rkc_refusal(name, fields, kernel, tile_sums, args):
    """A shard RKC kernel at an s beyond its tables (args with s replaced
    by s_cap + 1): y_new's block must be y's, every partial sum NaN, as
    its plain sums; prints phase `name` with s = s_cap + 1."""
    from crdmodel_tpu_torch.ops.fused_shard_step import interior
    yp, h, fz, _, mu1 = args[:5]
    beyond = (yp, h, fz, torch.tensor(mu1.shape[0], dtype=torch.int32,
                                      device=yp.device), *args[4:])
    halo = args[6].halo
    y_k, ss_k = kernel(*beyond)
    torch.cuda.synchronize()
    ok = (torch.equal(interior(y_k, halo), interior(yp, halo))
          and bool(torch.isnan(ss_k).all())
          and ss_k.shape == tile_sums(*beyond).shape)
    phase(name, **fields, s=int(beyond[3]), refused=ok,
          partials=int(ss_k.numel()))
    if not ok:
        raise AssertionError(f"{name}: an s beyond the tables was not "
                             "refused with y kept and NaN sums")


def shard_bound(yp, sc, ops_per_point, extra_bytes=0):
    """bound() of one shard kernel launch: the halo-padded buffer read
    once, the block of y_new written once, the shard's constants read once;
    the operations of the block's points (every plane's on the box)."""
    halo = sc.halo
    block = (int(np.prod(yp.shape[:-2])) * (yp.shape[-2] - 2 * halo)
             * (yp.shape[-1] - 2 * halo))
    n_bytes = ((yp.numel() + block) * yp.element_size() + constant_bytes(sc)
               + extra_bytes)
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = ops_per_point * block / yp.shape[0] / PEAK_F32_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def shard_timings(cfg8, cfg9, card):
    """K8 (bs32, shard 0 of the canonical torus on a 2x2 mesh) and K9 (each
    s of K9_TIMED_STAGES, shard 0 of the large torus on a 2x2 mesh) from
    the ICs, f32, unfrozen, with their plain versions and bounds (the
    kernel's time its device time in a profiler trace, device_ms; the
    CUDA-event time of a burst beside it as burst_us; K8's time over its
    bound, the kernel the dispatch names, its registers, blocks an SM,
    shared bytes and ptxas's summary beside them), and the
    exchange of one step of each on the 2x2 mesh of shards on one card
    (parallel/halo.py::refresh_halos, four shards); prints phases
    k8_timing, k9_timing and halo_exchange_timing. Returns {("k8", None) |
    ("k9", s): (kernel ms, plain ms, bound ms, bound_by)}."""
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import erk_slots
    from crdmodel_tpu_torch.ops import fused_shard_rkc as f9
    from crdmodel_tpu_torch.ops import fused_shard_step as f8
    from crdmodel_tpu_torch.ops.fused_rkc import static_stage_tables
    from crdmodel_tpu_torch.parallel.halo import refresh_halos

    timings = {}
    dtype = torch.float32
    zero = torch.zeros((), dtype=dtype, device="cuda")
    mesh = shard_mesh(SHARD_MESH)
    problem = build_problem(dataclasses.replace(cfg8, t_boundary=0.0),
                            "cuda")
    y_np = problem.y0.cpu().numpy()
    bufs, consts = shard_inputs(problem, mesh, y_np, dtype, f8.HALO)
    tab = TABLEAUS["bs32"]
    args = (bufs[0], torch.tensor(H, device="cuda"), zero, consts[0], tab,
            cfg8.rtol, cfg8.atol)
    burst = median_ms(lambda: f8.fused_shard_step(*args))
    t8 = (device_ms(lambda: f8.fused_shard_step(*args),
                    erk_slots.kernel_name(tab)),
          median_ms(lambda: f8.fused_shard_step_reference(*args)),
          *shard_bound(bufs[0], consts[0], erk_ops(consts[0], tab)))
    timings["k8", None] = t8
    phase("k8_timing", shape=list(bufs[0].shape), halo=f8.HALO,
          method="bs32", dtype="float32", kernel_us=t8[0] * 1e3,
          burst_us=burst * 1e3, plain_us=t8[1] * 1e3,
          bound_us=t8[2] * 1e3, bound_by=t8[3],
          times_bound=t8[0] / t8[2], kernel=erk_slots.kernel_name(tab),
          **erk_slots.kernel_info("crd_fused_shard_step_info", dtype,
                                  consts[0].kinetics_id),
          ptxas=ptxas_summary("fused_shard_step.cu", erk_slots.SLOTS_KERNEL),
          card=card)
    ex8 = median_ms(lambda: refresh_halos(bufs, mesh, f8.HALO))
    phase("halo_exchange_timing", mesh=list(SHARD_MESH), shards_on="cuda:0",
          halo=f8.HALO, buffer=list(bufs[0].shape), exchange_us=ex8 * 1e3,
          copies=4 * len(bufs), card=card)
    del problem, bufs, consts

    problem = build_problem(cfg9, "cuda")
    y_np = problem.y0.cpu().numpy()
    bufs, consts = shard_inputs(problem, mesh, y_np, dtype, f9.P_RKC)
    mu1, ctab = static_stage_tables(f9.S_MAX_KERNEL, dtype, "cuda")
    tables = sum(t.numel() * t.element_size() for t in (mu1, ctab))
    rho = problem_rho(problem, problem.y0)
    for s in K9_TIMED_STAGES:
        hs, st = rkc_step_inputs(s, rho, dtype)
        args = (bufs[0], hs, zero, st, mu1, ctab, consts[0], cfg9.rtol,
                cfg9.atol)
        burst = median_ms(lambda: f9.fused_shard_rkc_step(*args),
                          *WIDE_TIMED)
        t9 = (device_ms(lambda: f9.fused_shard_rkc_step(*args),
                        "fused_rkc_chunk_kernel", WIDE_TIMED[0]),
              median_ms(lambda: f9.fused_shard_rkc_step_reference(*args),
                        *WIDE_TIMED),
              *shard_bound(bufs[0], consts[0], rkc_ops(consts[0], s),
                           tables))
        timings["k9", s] = t9
        phase("k9_timing", shape=list(bufs[0].shape), halo=f9.P_RKC, s=s,
              dtype="float32", kernel_us=t9[0] * 1e3, burst_us=burst * 1e3,
              plain_us=t9[1] * 1e3, bound_us=t9[2] * 1e3, bound_by=t9[3],
              times_bound=t9[0] / t9[2], samples=list(WIDE_TIMED),
              chunks=len(f9.extent_rings(s)),
              grid_barriers=len(f9.extent_rings(s)) - 1,
              extent_rings=[r for _, _, r in f9.extent_rings(s)],
              **f9.kernel_info(dtype, consts[0].kinetics_id),
              ptxas=ptxas_summary("fused_shard_rkc.cu"), card=card)
    ex9 = median_ms(lambda: refresh_halos(bufs, mesh, f9.P_RKC))
    phase("halo_exchange_timing", mesh=list(SHARD_MESH), shards_on="cuda:0",
          halo=f9.P_RKC, buffer=list(bufs[0].shape), exchange_us=ex9 * 1e3,
          copies=4 * len(bufs), card=card)
    return timings


def run_sharded_rkc2(cfg, rkc2_probes, mesh, name, build_kw=None,
                     label="scripts/bench_suite.py:48-54 fhn torus "
                           "6400x1600 Tf=1 rkc2", report=None):
    """An rkc2 program (the large FHN torus by default; built with
    `build_kw`) through simulate_sharded() on `mesh` (auto selection: K9),
    held against the port's single-device run through K2 on the card, in
    this call: steps within the JAX f32-f64 distance of the canonical rkc2
    run (2.78%), the final field within that run's JAX f32-f64 probe gap
    plus 1e-4 (as main_path_wide_fhn_rkc2). report(res, counts) -> more
    fields of the phase line. Prints phase `name`; returns K9's
    launches."""
    from crdmodel_tpu_torch.ops import fused_rkc, fused_shard_rkc

    build_kw = build_kw or {}
    forcing = build_kw.get("forcing")
    kernel = fused_shard_rkc.fused_shard_rkc_step
    res, counts = drive_main_path(cfg, build_kw, mesh)
    launches = counts[kernel.__name__]
    checks = run_checks(cfg, res, kernel, launches, mesh.size)
    extra = report(res, counts) if report is not None else {}
    final = res.trajectory[-1].clone()
    steps, wall, status = res.total_steps(), res.wall_time, res.describe()
    stats = res.stats
    del res
    fused_rkc.fused_rkc_step.launches = 0
    ref = run_program(cfg, build_kw)
    ref_launches = fused_rkc.fused_rkc_step.launches
    ref_steps = ref.total_steps()
    gap = float((final - ref.trajectory[-1]).abs().max())
    f32_gap = float(np.abs(rkc2_probes["probes_f32"]
                           - rkc2_probes["probes_f64"]).max())
    limit = f32_gap + 1e-4
    step_tol = abs(int(rkc2_probes["steps_f32"].sum())
                   - int(rkc2_probes["steps_f64"].sum())) / int(
                       rkc2_probes["steps_f32"].sum())
    points = cfg.nx * cfg.ny
    phase(name, config=label, selection=selection_note(cfg),
          mesh=list(mesh.shape),
          devices=[str(d) for d in mesh.device_list()],
          grid=[cfg.ny, cfg.nx], method=cfg.method, dtype=cfg.dtype,
          status=status, steps=steps, accepted=int(stats.accepted.sum()),
          rejected=int(stats.rejected.sum()), kernel=kernel.__name__,
          launches=counts, wall_s=wall, us_per_step=wall / steps * 1e6,
          points_steps_per_s=points * steps / wall, **extra,
          single_device=dict(status=ref.describe(), fused=ref.fused,
                             steps=ref_steps, wall_s=ref.wall_time,
                             fused_rkc_step_launches=ref_launches,
                             points_steps_per_s=points * ref_steps
                             / ref.wall_time),
          step_limit=step_tol, final_max_abs_vs_single_device=gap,
          final_limit=limit, card=card_line())
    least, _ = launch_bound(cfg, ref_steps, forcing)
    checks.update({
        "single-device run ok through K2": ref.ok and ref.fused
            and ref_launches >= least,
        f"steps within {step_tol:.2%} of the single-device run":
            abs(steps - ref_steps) <= step_tol * ref_steps,
        "final field vs the single-device run": gap <= limit,
    })
    fail_unless(name, checks)
    return launches


def sharded_main_paths(cfg, probes, single_fhn, keep=None):
    """main_path_sharded_fhn (the canonical FHN torus `cfg`, K8, held to the
    JAX goldens and to the single-device K1 run `single_fhn`) and
    main_path_sharded_fhn_rkc2 (the large FHN torus, K9) on a 2x2 mesh of
    shards on cuda:0 and, with four cards or more, again (phases tagged
    _4cards) with shard i on cuda:i. Returns the 2x2 runs' launches of K8
    and K9; `keep` receives the 2x2 cuda:0 FHN run (run_main_path)."""
    from crdmodel_tpu_torch.ops import fused_shard_step
    meshes = [shard_mesh(SHARD_MESH)]
    if torch.cuda.device_count() >= 4:
        meshes.append(shard_mesh(SHARD_MESH, [f"cuda:{i}" for i in range(4)]))
    launches = []
    for i, mesh in enumerate(meshes):
        tag = "" if i == 0 else "_4cards"
        n8 = run_main_path(
            cfg, probes["fhn", "bs32"], fused_shard_step.fused_shard_step,
            0.01, "main_path_sharded_fhn" + tag,
            "data/FHNmodelArgs.ini fhn torus", mesh=mesh, versus=single_fhn,
            keep=keep if i == 0 else None)
        n9 = run_sharded_rkc2(large_fhn_torus(), probes["fhn", "rkc2"], mesh,
                              "main_path_sharded_fhn_rkc2" + tag)
        launches.append((n8, n9))
    return launches[0]


def large_goldbeter_torus():
    """The JAX suite's large Goldbeter torus (scripts/bench_suite.py:39-45,
    the row "Goldbeter torus 800x3200 Tf=1 ark324", 124-125), copied: torus
    3200x800 (2.56M points), beta 0.4, rtol 1e-5, ark324, f32, Tf=1, auto
    selection."""
    from crdmodel_tpu_torch.config import SimConfig
    return SimConfig(model="goldbeter", surface="torus", x_mesh=800,
                     surface_width=20, surface_length=80, t_final=1.0,
                     output_timestep=2, beta=0.4, wave_length=0.2,
                     wave_width=0.5, wave_inside=1, dtype="float32",
                     rtol=1e-5, atol=1e-8, method="ark324")


def torus_fibres(cfg_aniso):
    """The fibered sheet's program on the torus (surface_width 20 and
    surface_length 80 as the torus's circumferences, 1600x400), with the
    same rotating fibres: the tensor's mixed-pair weight becomes the
    (nx,) profile 1/(4 dx dy r ring(theta)). Returns (cfg, build
    arguments)."""
    cfg = dataclasses.replace(cfg_aniso, surface="torus")
    return cfg, dict(diffusion_tensor=fiber_tensor(cfg, 1.0, 0.2, 0.0,
                                                   np.pi / 3))


def shard_divform_inputs(problem, mesh, y_np, dtype, aniso):
    """shard_inputs for K11: the halo-padded buffers and every shard's
    ShardDivformConstants (the coefficient stack exchanged once)."""
    from crdmodel_tpu_torch.ops import fused_shard_divform as f11
    from crdmodel_tpu_torch.ops.kernel_common import (
        make_shard_divform_constants)
    from crdmodel_tpu_torch.parallel.halo import mirror_halo_pad
    from crdmodel_tpu_torch.parallel.sharded import mesh_pad_spec, split_state

    pad = mesh_pad_spec(problem.cfg, mesh)
    y = torch.tensor(y_np, dtype=dtype, device="cuda")
    blocks = split_state(y, mesh, pad, problem.cfg)
    return (mirror_halo_pad(list(blocks), mesh, f11.HALO, pad),
            make_shard_divform_constants(problem, mesh, pad, f11.HALO,
                                         dtype, aniso=aniso))


def check_shard_imex_kernel(cases, seed):
    """K10 against its plain version on the shards of each (label, config,
    mesh shape, shards checked) of `cases`, f32 and f64, each h of K3_H, fz
    0 and 1: y_new's block bitwise equal (NaN at the same points), two
    launches bitwise equal, every partial sum bitwise the plain version's
    in the kernel's order (fused_shard_imex_tile_sums); prints phase
    k10_check. Returns the max errors."""
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.ops import fused_shard_imex as f10

    rng = np.random.default_rng(seed)
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    for label, cfg, shape, shards in cases:
        mesh = shard_mesh(shape)
        problem = build_problem(cfg, device="cuda")
        y_np = random_state(cfg, tuple(problem.y0.shape), rng)
        for dtype in (torch.float32, torch.float64):
            bufs, consts = shard_inputs(problem, mesh, y_np, dtype, f10.HALO)
            for h_val in K3_H:
                h = torch.tensor(h_val, dtype=dtype, device="cuda")
                for fz in (0.0, 1.0):
                    fzt = torch.tensor(fz, dtype=dtype, device="cuda")
                    for k in shards:
                        args = (bufs[k], h, fzt, consts[k], cfg.rtol,
                                cfg.atol)
                        err = check_shard_pair(
                            "k10_check", dict(
                                case=label, model=cfg.model, mesh=list(shape),
                                shard=k, shape=list(bufs[k].shape),
                                valid=[consts[k].valid_rows,
                                       consts[k].valid_cols],
                                h=h_val, fz=fz),
                            f10.fused_shard_imex_step,
                            f10.fused_shard_imex_step_reference, args, dtype,
                            f10.fused_shard_imex_tile_sums)
                        worst[dtype] = max(worst[dtype], err)
            del bufs, consts
        del problem
    return worst


def check_shard_divform_kernel(cases, seed):
    """K11 against its plain version on the shards of each (label, config,
    build arguments, mesh shape, shards checked, aniso mode, h) of `cases`,
    f32 and f64, each tableau of ERK_METHODS, fz 0 and 1: y_new's block
    bitwise equal, two launches bitwise equal, every partial sum bitwise
    the plain version's over the physical cells (fused_shard_divform_
    tile_sums); prints phase k11_check. Returns the max errors."""
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import fused_shard_divform as f11

    rng = np.random.default_rng(seed)
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    for label, cfg, build_kw, shape, shards, aniso, h_val in cases:
        mesh = shard_mesh(shape)
        problem = build_problem(cfg, device="cuda", **build_kw)
        y_np = random_state(cfg, tuple(problem.y0.shape), rng)
        for dtype in (torch.float32, torch.float64):
            bufs, consts = shard_divform_inputs(problem, mesh, y_np, dtype,
                                                aniso)
            h = torch.tensor(h_val, dtype=dtype, device="cuda")
            for method in ERK_METHODS:
                for fz in (0.0, 1.0):
                    fzt = torch.tensor(fz, dtype=dtype, device="cuda")
                    for k in shards:
                        args = (bufs[k], h, fzt, consts[k], TABLEAUS[method],
                                cfg.rtol, cfg.atol)
                        err = check_shard_pair(
                            "k11_check", dict(
                                case=label, mode=consts[k].kind,
                                model=cfg.model, surface=cfg.surface,
                                mesh=list(shape), shard=k,
                                shape=list(bufs[k].shape),
                                valid=[consts[k].valid_rows,
                                       consts[k].valid_cols],
                                method=method, fz=fz),
                            f11.fused_shard_divform_step,
                            f11.fused_shard_divform_step_reference, args,
                            dtype, f11.fused_shard_divform_tile_sums)
                        worst[dtype] = max(worst[dtype], err)
            del bufs, consts
        del problem
    return worst


def shard_field_timings(timed10, timed11, card):
    """K10 (shard 0 of each config of `timed10` on a 2x2 mesh, from the ICs,
    h = K3_H[0]) and K11 (shard 0 of each (label, config, build arguments,
    aniso mode, h) of `timed11` on a 2x2 mesh, bs32), f32, unfrozen, with
    their plain versions and bounds (the kernel's device time from a
    profiler trace, device_ms; the CUDA-event time of a burst beside it);
    prints phases k10_timing and k11_timing. Returns {("k10", shape) |
    ("k11", label): (kernel ms, plain ms, bound ms, bound_by)}."""
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import erk_slots
    from crdmodel_tpu_torch.ops import fused_shard_divform as f11
    from crdmodel_tpu_torch.ops import fused_shard_imex as f10

    timings = {}
    dtype = torch.float32
    zero = torch.zeros((), dtype=dtype, device="cuda")
    mesh = shard_mesh(SHARD_MESH)
    for cfg in timed10:
        problem = build_problem(dataclasses.replace(cfg, t_boundary=0.0),
                                "cuda")
        bufs, consts = shard_inputs(problem, mesh, problem.y0.cpu().numpy(),
                                    dtype, f10.HALO)
        args = (bufs[0], torch.tensor(K3_H[0], device="cuda"), zero,
                consts[0], cfg.rtol, cfg.atol)
        burst = median_ms(lambda: f10.fused_shard_imex_step(*args),
                          *WIDE_TIMED)
        t10 = (device_ms(lambda: f10.fused_shard_imex_step(*args),
                         "fused_imex_slots_kernel", WIDE_TIMED[0]),
               median_ms(lambda: f10.fused_shard_imex_step_reference(*args),
                         *WIDE_TIMED),
               *shard_bound(bufs[0], consts[0], imex_ops(consts[0])))
        timings["k10", tuple(bufs[0].shape)] = t10
        phase("k10_timing", config=cfg.program_name, shape=list(bufs[0].shape),
              halo=f10.HALO, h=K3_H[0], dtype="float32",
              kernel_us=t10[0] * 1e3, burst_us=burst * 1e3,
              plain_us=t10[1] * 1e3, bound_us=t10[2] * 1e3,
              bound_by=t10[3], times_bound=t10[0] / t10[2],
              samples=list(WIDE_TIMED),
              **f10.kernel_info(dtype, consts[0].kinetics_id),
              ptxas=ptxas_entries("fused_shard_imex.cu",
                                  "fused_imex_slots_kernel"), card=card)
        del problem, bufs, consts
    tab = TABLEAUS["bs32"]
    for label, cfg, build_kw, aniso, h_val in timed11:
        problem = build_problem(dataclasses.replace(cfg, t_boundary=0.0),
                                "cuda", **build_kw)
        bufs, consts = shard_divform_inputs(
            problem, mesh, problem.y0.cpu().numpy(), dtype, aniso)
        args = (bufs[0], torch.tensor(h_val, device="cuda"), zero,
                consts[0], tab, cfg.rtol, cfg.atol)
        burst = median_ms(lambda: f11.fused_shard_divform_step(*args))
        t11 = (device_ms(lambda: f11.fused_shard_divform_step(*args),
                         erk_slots.kernel_name(tab)),
               median_ms(lambda: f11.fused_shard_divform_step_reference(
                   *args)),
               *shard_bound(bufs[0], consts[0], erk_ops(consts[0], tab)))
        timings["k11", label] = t11
        phase("k11_timing", case=label, mode=consts[0].kind,
              shape=list(bufs[0].shape), halo=f11.HALO, method="bs32",
              dtype="float32", kernel_us=t11[0] * 1e3, burst_us=burst * 1e3,
              plain_us=t11[1] * 1e3, bound_us=t11[2] * 1e3, bound_by=t11[3],
              times_bound=t11[0] / t11[2], kernel=erk_slots.kernel_name(tab),
              **erk_slots.kernel_info("crd_fused_shard_divform_info", dtype,
                                      int(aniso), consts[0].kinetics_id),
              card=card)
        del problem, bufs, consts
    return timings


def run_sharded_against(name, cfg, build_kw, kernel, label, mesh,
                        single_kernel=None):
    """A program without a JAX golden (`cfg`, built with `build_kw`)
    through simulate_sharded() on `mesh`, with every kernel's launch count
    set to 0 just before and read just after; `kernel` the wrapper its
    steps must take. Held to a single-device f32 run of the same call: the
    kernel `single_kernel` takes (auto selection), or the port's torch path
    (use_pallas=False) when None; and to the torch path's f64 run on the
    card: steps within 1% of the f32 run's, the final field within that
    run's own distance to the f64 run plus 1e-4. Prints phase `name`;
    returns the launches of `kernel`."""
    res, counts = drive_main_path(cfg, build_kw, mesh)
    launches = counts[kernel.__name__]
    checks = run_checks(cfg, res, kernel, launches, mesh.size)
    final = res.trajectory[-1].clone()
    steps, wall, status = res.total_steps(), res.wall_time, res.describe()
    stats = res.stats
    del res
    if single_kernel is None:
        traj, ref_steps, ref_wall, ref_ok = torch_path_run(cfg, build_kw,
                                                           "float32")
        ref_final, ref_name = traj[-1].clone(), "torch path"
        del traj
    else:
        single_kernel.launches = 0
        ref = run_program(cfg, build_kw)
        ref_final, ref_name = ref.trajectory[-1].clone(), single_kernel.__name__
        ref_steps, ref_wall = ref.total_steps(), ref.wall_time
        ref_ok = (ref.ok and ref.fused and single_kernel.launches
                  >= launch_bound(cfg, ref_steps)[0])
        del ref
    traj64, steps64, wall64, ok64 = torch_path_run(cfg, build_kw, "float64")
    f32_gap = float((ref_final.double() - traj64[-1]).abs().max())
    del traj64
    limit = f32_gap + 1e-4
    gap = float((final - ref_final).abs().max())
    points = cfg.nx * cfg.ny
    phase(name, config=label, selection=selection_note(cfg),
          mesh=list(mesh.shape), devices=[str(d) for d in mesh.device_list()],
          grid=[cfg.ny, cfg.nx], method=cfg.method, dtype=cfg.dtype,
          status=status, steps=steps, accepted=int(stats.accepted.sum()),
          rejected=int(stats.rejected.sum()), kernel=kernel.__name__,
          launches=counts, launch_bound=launch_bound(cfg, steps),
          wall_s=wall, us_per_step=wall / steps * 1e6,
          points_steps_per_s=points * steps / wall,
          single_device=dict(path=ref_name, steps=ref_steps, wall_s=ref_wall,
                             ok=ref_ok,
                             points_steps_per_s=points * ref_steps / ref_wall),
          torch_f64=dict(steps=steps64, wall_s=wall64, ok=ok64),
          step_limit=0.01, final_max_abs_vs_single_device=gap,
          final_limit=limit, single_device_f32_f64_gap=f32_gap,
          card=card_line())
    checks.update({
        f"single-device run ok through {ref_name}": ref_ok,
        "torch path f64 ok": ok64,
        "steps within 1% of the single-device run":
            abs(steps - ref_steps) <= 0.01 * ref_steps,
        "final field vs the single-device run": gap <= limit,
    })
    fail_unless(name, checks)
    return launches


def sharded_field_main_paths(programs, probes, singles):
    """The main paths of kernels K10 and K11 through simulate_sharded() on
    a 2x2 mesh of shards on cuda:0 and, with four cards or more, again
    (phases tagged _4cards) with shard i on cuda:i: the bounded tissue
    (main_path_sharded_bounded_ap, K11) and the fibered sheet
    (main_path_sharded_aniso, K11's aniso mode), held to their JAX goldens
    and to the single-device K4 and K5 runs of `singles`; the fibres on the
    torus (main_path_sharded_torus_tensor, K11 with the inv4 profile),
    held to the port's single-device torch path; the canonical Goldbeter
    torus with ark324 (main_path_sharded_goldbeter_ark324, K10), held to
    its golden and the single-device K3 run; the large Goldbeter torus
    (main_path_sharded_large_goldbeter_ark324, K10), held to the
    single-device K3 run of the same call. Returns the 2x2 runs' launches
    {name: n}."""
    from crdmodel_tpu_torch.ops import (fused_imex, fused_shard_divform,
                                        fused_shard_imex)
    f10 = fused_shard_imex.fused_shard_imex_step
    f11 = fused_shard_divform.fused_shard_divform_step
    cfg_ap, ap_build = programs["bounded_ap"]
    cfg_aniso, aniso_build = programs["aniso"]
    cfg_torus, torus_build = programs["torus_tensor"]
    cfg_gb = programs["goldbeter_ark324"]
    ap_probes = probes["aliev_panfilov", "bs32"]
    aniso_probes = probes["aniso_sheet", "bs32"]
    meshes = [shard_mesh(SHARD_MESH)]
    if torch.cuda.device_count() >= 4:
        meshes.append(shard_mesh(SHARD_MESH, [f"cuda:{i}" for i in range(4)]))
    launches = []
    for i, mesh in enumerate(meshes):
        tag = "" if i == 0 else "_4cards"
        n = {}
        n["bounded_ap"] = run_main_path(
            cfg_ap, ap_probes, f11, 0.01, "main_path_sharded_bounded_ap" + tag,
            "scripts/bench_suite.py::bounded_tissue aliev_panfilov flat, "
            "noflux walls + circular scar", build_kw=ap_build,
            extra_checks=scar_checks(ap_probes, ap_build["obstacle_mask"]),
            mesh=mesh, versus=singles["bounded_ap"])
        n["aniso"] = run_main_path(
            cfg_aniso, aniso_probes, f11, 0.01,
            "main_path_sharded_aniso" + tag,
            "tests_tpu/test_aniso_tpu.py aliev_panfilov flat periodic, the "
            "rotating fibres of examples/anisotropic_fibers.py",
            build_kw=aniso_build,
            extra_checks=tensor_checks(aniso_probes,
                                       aniso_build["diffusion_tensor"]),
            mesh=mesh, versus=singles["aniso"])
        n["torus_tensor"] = run_sharded_against(
            "main_path_sharded_torus_tensor" + tag,
            dataclasses.replace(cfg_torus, t_final=TORUS_TENSOR_TF),
            torus_build, f11, "the fibered sheet's program and fibres on "
            f"the torus (1600x400), Tf cut {cfg_torus.t_final} -> "
            f"{TORUS_TENSOR_TF}", mesh)
        n["goldbeter_ark324"] = run_main_path(
            cfg_gb, probes["goldbeter", "ark324"], f10, 0.01,
            "main_path_sharded_goldbeter_ark324" + tag,
            "data/GoldbeterModelArgs.ini goldbeter torus, ark324", mesh=mesh,
            versus=singles["goldbeter_ark324"])
        n["large_goldbeter_ark324"] = run_sharded_against(
            "main_path_sharded_large_goldbeter_ark324" + tag,
            large_goldbeter_torus(), {}, f10,
            "scripts/bench_suite.py:39-45 goldbeter torus 3200x800 Tf=1 "
            "ark324", mesh, single_kernel=fused_imex.fused_imex_step)
        launches.append(n)
    return launches[0]


def single_field_runs(programs, probes):
    """The single-device runs the sharded K10 and K11 paths are held to
    (the bounded tissue through K4, the fibered sheet through K5, the
    canonical Goldbeter ark324 through K3), each with its checks: {name:
    its steps and probes}."""
    from crdmodel_tpu_torch.ops import fused_aniso, fused_divform, fused_imex
    singles = {}
    for key, kernel, probe_key, name in (
            ("bounded_ap", fused_divform.fused_divform_step,
             ("aliev_panfilov", "bs32"), "main_path_bounded_ap"),
            ("aniso", fused_aniso.fused_aniso_step, ("aniso_sheet", "bs32"),
             "main_path_aniso"),
            ("goldbeter_ark324", fused_imex.fused_imex_step,
             ("goldbeter", "ark324"), "main_path_goldbeter_ark324")):
        prog = programs[key]
        cfg, build_kw = prog if isinstance(prog, tuple) else (prog, {})
        singles[key] = {}
        run_main_path(cfg, probes[probe_key], kernel, 0.01, name,
                      cfg.program_name, build_kw=build_kw,
                      keep=singles[key])
    return singles


def shard_field_phases(cfg, programs, probes, singles, card):
    """The phases of kernels K10 and K11: their checks against their plain
    versions (k10_check: Goldbeter and FHN on the canonical tori's 2x2
    shards with the beta ramp and a freeze, the uneven 1x3 mesh, the large
    Goldbeter torus's 2x2 shard, FHN and Aliev-Panfilov on both Goldbeter
    tori's shards; every partial sum bitwise; k11_check: the bounded tissue's 2x2
    shards, a flat 2-D diffusion field, the uneven 1x3 mesh, an uneven
    2x2 mesh, the rotating fibres flat and on the torus, a constant tensor
    inside no-flux walls),
    their timings (k10_timing, k11_timing) and the main paths of
    sharded_field_main_paths. Returns K10's and K11's entries of the
    kernels line."""
    cfg_ap, ap_build = programs["bounded_ap"]
    cfg_aniso, aniso_build = programs["aniso"]
    cfg_torus, torus_build = programs["torus_tensor"]
    cfg_gb = programs["goldbeter_ark324"]
    cfg_large = large_goldbeter_torus()
    fhn_ark = dataclasses.replace(cfg, method="ark324")
    # the three kinetics on the Goldbeter tori's shards, (2,216,66) and
    # (2,1616,416), besides the canonical FHN torus's and its uneven mesh
    small = dataclasses.replace(cfg_gb, t_boundary=1.0)
    other = dict(fhn=dict(model="fhn", beta=1.25),
                 aliev_panfilov=dict(model="aliev_panfilov", beta=0.1))
    worst10 = check_shard_imex_kernel([
        ("goldbeter_2x2", small, SHARD_MESH, (0, 3)),
        ("fhn_2x2", fhn_ark, SHARD_MESH, (0, 3)),
        ("fhn_uneven_1x3", fhn_ark, UNEVEN_MESH, (0, 1, 2)),
        ("large_goldbeter_2x2", cfg_large, SHARD_MESH, (0,)),
        *((f"{m}_small_2x2", dataclasses.replace(small, **kw), SHARD_MESH,
           (0, 3)) for m, kw in other.items()),
        *((f"{m}_large_2x2", dataclasses.replace(cfg_large, t_boundary=0.5,
                                                 **kw), SHARD_MESH, (0,))
          for m, kw in other.items())], SEED + 10)
    frozen = dict(t_boundary=1.0)
    dfield = 0.05 + 0.1 * np.random.default_rng(SEED).random(
        (cfg_ap.ny, cfg_ap.nx))
    ap_periodic = dataclasses.replace(cfg_ap, boundary="periodic",
                                      diffusion=0.1, **frozen)
    # 1599x399 on the 2x2 mesh: blocks of 800x200 whose last row or column
    # (or both) are mirror-pad cells
    ap_uneven = dataclasses.replace(cfg_ap, x_mesh=399, y_mesh=1599,
                                    **frozen)
    worst11 = check_shard_divform_kernel([
        ("noflux_scar_2x2", dataclasses.replace(cfg_ap, **frozen), ap_build,
         SHARD_MESH, (0, 3), False, K4_H),
        ("flat_2d_field_2x2", ap_periodic, dict(diffusion_field=dfield),
         SHARD_MESH, (0, 3), False, K4_H),
        ("noflux_scar_uneven_1x3", dataclasses.replace(cfg_ap, **frozen),
         ap_build, UNEVEN_MESH, (0, 1, 2), False, K4_H),
        ("noflux_scar_uneven_2x2", ap_uneven,
         dict(obstacle_mask=circular_scar(ap_uneven)), SHARD_MESH,
         (0, 1, 2, 3), False, K4_H),
        ("fibres_flat_2x2", dataclasses.replace(cfg_aniso, **frozen),
         aniso_build, SHARD_MESH, (0, 3), True, K5_H),
        ("fibres_torus_2x2", dataclasses.replace(cfg_torus, **frozen),
         torus_build, SHARD_MESH, (0, 3), True, K5_H),
        ("const_tensor_noflux_2x2",
         dataclasses.replace(cfg_aniso, boundary="noflux", **frozen),
         dict(diffusion_tensor=(1.0, 0.25, 0.15)), SHARD_MESH, (0, 3), True,
         K5_H)], SEED + 11)
    timings = shard_field_timings(
        [cfg_gb, cfg_large],
        [("bounded_ap", cfg_ap, ap_build, False, K4_H),
         ("fibres_torus", cfg_torus, torus_build, True, K5_H)], card)
    n = sharded_field_main_paths(programs, probes, singles)
    large_shape = (2, cfg_large.ny // 2 + 16, cfg_large.nx // 2 + 16)
    return [
        kernel_entry("fused_shard_imex_step", "fused_shard_imex.cu",
                     "crdmodel_tpu/ops/pallas_shard_imex.py:57",
                     n["large_goldbeter_ark324"], worst10,
                     timings["k10", large_shape]),
        kernel_entry("fused_shard_divform_step", "fused_shard_divform.cu",
                     "crdmodel_tpu/ops/pallas_shard_divform.py:139",
                     n["bounded_ap"], worst11, timings["k11", "bounded_ap"]),
        kernel_entry("fused_shard_divform_step (aniso mode)",
                     "fused_shard_divform.cu",
                     "crdmodel_tpu/ops/pallas_shard_divform.py:139",
                     n["torus_tensor"], worst11,
                     timings["k11", "fibres_torus"])]


def kstep_ops(kc, tableau, k):
    """Operations a point of one K14 launch: K ERK steps less the K - 1
    RHS evaluations FSAL saves."""
    return k * erk_ops(kc, tableau) - (k - 1) * rhs_ops(kc)


def check_kstep_kernel(cases):
    """K14 against its plain version at the main paths' shape, for each
    config of `cases` (K1's five), f32 and f64, each (tableau, K) of
    K14_BATCHES, the freeze off and on, n_commit 0, 1, K-1 and K: the
    committed state and every partial sum (the plain version's in the
    kernel's tile order, fused_kstep.tile_error_sums) bitwise, and bitwise
    the state and partial sums of n_commit K1 launches; two launches
    bitwise equal. One phase k14_check a config, dtype and (tableau, K);
    returns the max |y_kernel - y_plain| a dtype."""
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import fused_kstep as fk
    from crdmodel_tpu_torch.ops import fused_step as fs
    from crdmodel_tpu_torch.ops.kernel_common import prepare_constants

    rng = np.random.default_rng(SEED + 14)
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    for cfg in cases:
        problem = build_problem(cfg, device="cuda")
        y_np = random_state(cfg, tuple(problem.y0.shape), rng)
        for dtype in (torch.float32, torch.float64):
            kc = prepare_constants(problem, dtype, "cuda")
            y = torch.tensor(y_np, dtype=dtype, device="cuda")
            h = torch.tensor(H, dtype=dtype, device="cuda")
            for method, k in K14_BATCHES:
                tab = TABLEAUS[method]
                _, tile_y, _ = fs.tile_plan(tab.stages, y.element_size())
                commits = sorted({0, 1, k - 1, k})
                result = dict(plain=True, k1=True, repeat=True, err=0.0,
                              nan_points=0)
                for fz in (0.0, 1.0):
                    fzt = torch.tensor(fz, dtype=dtype, device="cuda")
                    states, sums = [y], []
                    for _ in range(k):
                        y_j, ss_j = fs.fused_step(states[-1], h, fzt, kc, tab,
                                                  cfg.rtol, cfg.atol)
                        states.append(y_j)
                        sums.append(ss_j)
                    k1_sums = torch.stack(sums, dim=1)
                    for n_commit in commits:
                        args = (y, h, fzt, n_commit, kc, tab, k, cfg.rtol,
                                cfg.atol)
                        y_k, ss_k = fk.fused_kstep(*args)
                        y_k2, ss_k2 = fk.fused_kstep(*args)
                        y_r, ss_r = fk.fused_kstep_reference(*args,
                                                             tile_y=tile_y)
                        torch.cuda.synchronize()
                        nan = torch.isnan(y_r)
                        result["repeat"] &= (same_bits(y_k, y_k2)
                                             and same_bits(ss_k, ss_k2))
                        result["plain"] &= (same_bits(y_k, y_r)
                                            and same_bits(ss_k, ss_r))
                        result["k1"] &= (same_bits(y_k, states[n_commit])
                                         and same_bits(ss_k, k1_sums))
                        result["nan_points"] += int(nan.sum())
                        if not nan.all():
                            result["err"] = max(result["err"], float(
                                (y_k - y_r)[~nan].abs().max()))
                worst[dtype] = max(worst[dtype], result["err"])
                phase("k14_check", model=cfg.model, surface=cfg.surface,
                      beta="field" if kc.b_is_field else "scalar",
                      method=method, k=k, dtype=str(dtype), fz=[0.0, 1.0],
                      n_commit=commits, max_abs_err=result["err"],
                      nan_points=result["nan_points"],
                      bitwise_plain=result["plain"],
                      bitwise_k1_launches=result["k1"],
                      two_launches_equal=result["repeat"])
                if not (result["plain"] and result["k1"]
                        and result["repeat"]):
                    raise AssertionError(
                        f"k14_check {cfg.model} {cfg.surface} {method} k={k} "
                        f"{dtype}: {result}")
    return worst


def kstep_timing(cfg, card):
    """K14's timing at the canonical FHN shape, f32, bs32, for each K of
    K14_TIMED: the kernel's device time (profiler trace) and a burst's time
    a launch (CUDA events), a sub-step's share, the plain version's time,
    the bound and the time over it, the kernel's registers, resident
    blocks an SM and shared bytes (ops/fused_kstep.py::kernel_info),
    ptxas's most registers and spills over fused_kstep.cu, its grid
    barriers a launch, and K1's time in this call. Prints k14_timing
    phases; returns {K: (ms, plain_ms, bound_ms, bound_by)}."""
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import fused_kstep as fk
    from crdmodel_tpu_torch.ops import fused_step as fs
    from crdmodel_tpu_torch.ops.kernel_common import prepare_constants

    problem = build_problem(cfg, device="cuda")
    y = torch.tensor(random_state(cfg, tuple(problem.y0.shape),
                                  np.random.default_rng(SEED + 15)),
                     dtype=torch.float32, device="cuda")
    kc = prepare_constants(problem, torch.float32, "cuda")
    tab = TABLEAUS["bs32"]
    h = torch.tensor(H, dtype=torch.float32, device="cuda")
    fz = torch.zeros((), dtype=torch.float32, device="cuda")
    k1_ms = median_ms(lambda: fs.fused_step(y, h, fz, kc, tab, cfg.rtol,
                                            cfg.atol))
    timings = {}
    for k in K14_TIMED if TIMING_ALL else (K14_SPEC,):
        n = torch.tensor(k, dtype=torch.int32, device="cuda")

        def launch():
            return fk.fused_kstep(y, h, fz, n, kc, tab, k, cfg.rtol,
                                  cfg.atol)

        ms = device_ms(launch, "fused_kstep_kernel")
        burst_ms = median_ms(launch)
        plain_ms = median_ms(lambda: fk.fused_kstep_reference(
            y, h, fz, k, kc, tab, k, cfg.rtol, cfg.atol), *WIDE_TIMED)
        bound_ms, bound_by = bound(y, kc, kstep_ops(kc, tab, k))
        timings[k] = (ms, plain_ms, bound_ms, bound_by)
        phase("k14_timing", shape=list(y.shape), method="bs32", k=k,
              dtype="float32", kernel_us=ms * 1e3,
              kernel_us_per_substep=ms * 1e3 / k, burst_us=burst_ms * 1e3,
              plain_us=plain_ms * 1e3, bound_us=bound_ms * 1e3,
              bound_by=bound_by, times_bound=ms / bound_ms,
              **fk.kernel_info(torch.float32, kc.kinetics_id, tab.stages),
              ptxas=ptxas_summary("fused_kstep.cu"),
              grid_barriers=fk.grid_barriers(k), k1_us=k1_ms * 1e3,
              k1_us_times_k=k1_ms * 1e3 * k, card=card)
    return timings


def kstep_launch_checks(cfg, k):
    """launch_checks of a kernel-batched run (run_main_path): K14 took
    batches, each iteration two launches of which the masked ones are at
    most the last block's at each stop, every attempted step came from a
    batch or a K1 launch of a tail, and a rejected batch's recovery did
    work at most once a batch."""
    from crdmodel_tpu_torch.core.problem import solver_breakpoints
    from crdmodel_tpu_torch.integrate.erk import SYNC_EVERY, merge_stops
    from crdmodel_tpu_torch.sim import output_times
    n_stops = len(merge_stops(output_times(cfg), solver_breakpoints(cfg))[0])
    block = max(1, SYNC_EVERY // k)

    def checks(res, counts):
        launches = counts["fused_kstep"]
        batches = counts["fused_kstep_batches"]
        iterations = launches // 2
        return {
            "K14 took the batches": batches >= 1 and launches % 2 == 0,
            "masked iterations at most a block less one a stop":
                batches <= iterations <= batches + n_stops * (block - 1),
            "every step through K14 or the K1 tail":
                res.total_steps() <= k * batches + counts["fused_step"],
            "recoveries at most one a batch":
                counts["fused_kstep_recoveries"] <= batches,
            "no other kernel": all(
                v == 0 for name, v in counts.items()
                if not name.startswith("fused_kstep")
                and name != "fused_step"),
        }
    return checks


def kstep_report(k):
    """report of a kernel-batched run (run_main_path): the batches, K14's
    launches, the recoveries that did work, the K1 tail's launches, the
    masked iterations and launches, kernels of the port a step."""
    def report(res, counts):
        launches = counts["fused_kstep"]
        batches = counts["fused_kstep_batches"]
        masked = launches // 2 - batches
        return dict(
            speculative_k=k, batches=batches, k14_launches=launches,
            recoveries_with_work=counts["fused_kstep_recoveries"],
            k1_tail_launches=counts["fused_step"],
            masked_iterations=masked, masked_k14_launches=2 * masked,
            port_kernel_launches_per_step=(launches + counts["fused_step"])
            / res.total_steps())
    return report


def kstep_main_paths(cfg, cfg_gb, probes, single_fhn, card):
    """The K14 and ARK_NORMAL main paths, each held to its JAX golden:
    main_path_kstep (the canonical FHN torus, speculative_k = K14_SPEC,
    against the per-step K1 run `single_fhn` of this call, with both
    traced over Tf = 5 for the kernels a step and the device's idle share),
    main_path_goldbeter_kstep (the canonical Goldbeter torus,
    use_pallas=True, each K of GB_KS) and main_path_normal (the canonical
    FHN torus with step_mode="normal" through K1). Returns K14's launches
    on main_path_kstep."""
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import erk_slots, fused_kstep, fused_step

    fhn_label = "data/FHNmodelArgs.ini fhn torus"
    gb_label = "data/GoldbeterModelArgs.ini goldbeter torus"
    kernel = fused_kstep.fused_kstep
    cfg_k = dataclasses.replace(cfg, speculative_k=K14_SPEC)
    kept = {}
    launches = run_main_path(
        cfg_k, probes["fhn", f"bs32_k{K14_SPEC}"], kernel, 0.01,
        "main_path_kstep", f"{fhn_label}, speculative_k={K14_SPEC}",
        launch_checks=kstep_launch_checks(cfg_k, K14_SPEC),
        report=kstep_report(K14_SPEC), keep=kept)
    traced = {name: profile_run(c, {}, 5.0, tag) for name, c, tag in (
        ("per_step", cfg, erk_slots.kernel_name(TABLEAUS[cfg.method])),
        ("kstep", cfg_k, "fused_kstep_kernel"))} if TIMING_ALL else {}
    phase("kstep_vs_per_step", config=fhn_label, k=K14_SPEC,
          steps=kept["steps"], per_step_steps=single_fhn["steps"],
          wall_s=kept["wall_s"], per_step_wall_s=single_fhn["wall_s"],
          wall_ratio=kept["wall_s"] / single_fhn["wall_s"],
          steps_ratio=kept["steps"] / single_fhn["steps"],
          kernels_per_step_tf5={n: t["kernels_per_step"]
                                for n, t in traced.items()},
          idle_share_tf5={n: t["device_idle_share"]
                          for n, t in traced.items()}, card=card)
    for k in GB_KS:
        cfg_gk = dataclasses.replace(cfg_gb, speculative_k=k)
        run_main_path(cfg_gk, probes["goldbeter", f"bs32_k{k}"], kernel, 0.01,
                      "main_path_goldbeter_kstep",
                      f"{gb_label}, speculative_k={k}",
                      launch_checks=kstep_launch_checks(cfg_gk, k),
                      report=kstep_report(k))
    run_main_path(dataclasses.replace(cfg, step_mode="normal"),
                  probes["fhn", "bs32_normal"], fused_step.fused_step, 0.01,
                  "main_path_normal", f"{fhn_label}, step_mode=normal")
    return launches


def zero_launches():
    """Set every kernel wrapper's launch count to 0; returns a function that
    reads them ({wrapper name: launches})."""
    wrappers = kernel_wrappers()
    for w in wrappers:
        w.launches = 0
    return lambda: {w.__name__: w.launches for w in wrappers}


def golden_gate(traj, steps, probes, min_step_tol):
    """The gate of a trajectory (a tensor on any device, or a host array)
    of `steps` steps against the JAX CPU runs in `probes`: steps within
    min_step_tol of the JAX f32 run's (or its distance to the f64 run's),
    the probes within 2x the JAX f32-f64 gap plus 1e-4 of the f64 run's.
    Returns (fields, checks, the probe values as host float64)."""
    ref_steps = int(probes["steps_f32"].sum())
    f64_steps = int(probes["steps_f64"].sum())
    step_tol = max(min_step_tol, abs(ref_steps - f64_steps) / ref_steps)
    traj = torch.as_tensor(traj)
    var, j, i = (torch.as_tensor(probes[k], device=traj.device)
                 for k in ("probe_var", "probe_j", "probe_i"))
    got = traj[:, var, j, i].double().cpu().numpy()
    gap = float(np.abs(got - probes["probes_f64"]).max())
    f32_gap = float(np.abs(probes["probes_f32"] - probes["probes_f64"]).max())
    limit = 2.0 * f32_gap + 1e-4
    return (dict(jax_f32_cpu_steps=ref_steps, jax_f64_cpu_steps=f64_steps,
                 step_limit=step_tol, probe_max_abs_err_vs_jax_f64=gap,
                 probe_limit=limit, jax_f32_probe_gap=f32_gap),
            {f"steps within {step_tol:.2%} of JAX f32":
                 abs(steps - ref_steps) <= step_tol * ref_steps,
             "probes vs JAX f64": gap <= limit},
            got)


def same_stats(stats, other):
    """Per-interval steps, accepted, rejected and status all equal (host
    arrays or tensors, in SolveStats order)."""
    return all(np.array_equal(torch.as_tensor(a).cpu().numpy(),
                              torch.as_tensor(b).cpu().numpy())
               for a, b in zip(stats, other))


def read_back(outdir, cfg, model):
    """The reference-format files of `outdir` reassembled as (nt, nvars
    written, ny, nx) float64, and their rank count."""
    from crdmodel_tpu_torch.io.trajectory import (probe_nprocs,
                                                  read_reference_files)
    n = model.nvars if cfg.include_all_vars else 1
    fields = [read_reference_files(outdir, cfg.program_name,
                                   model.var_names[v])[0] for v in range(n)]
    return np.stack(fields, axis=1), probe_nprocs(outdir, cfg.program_name)


def prefix_cfg(cfg):
    """The first PREFIX_OUTPUTS output intervals of `cfg` as a run of its
    own: Tf cut to the last of them, the output interval kept, so that the
    run's steps and outputs are bitwise the first ones of cfg's run (the
    breakpoints past the cut Tf drop out, the steps before them never
    reach them)."""
    n = PREFIX_OUTPUTS
    return dataclasses.replace(cfg, t_final=cfg.t_final * n
                               / cfg.output_timestep, output_timestep=n)


def cli_run_fhn(cfg, single, card):
    """`run` of the canonical FHN torus through cli.main in this process,
    with --npz and --map-torus, cut to its first PREFIX_OUTPUTS outputs
    (prefix_cfg): K1 on every step, the steps and trajectory bitwise the
    first ones of the main_path phase's simulate() run `single` (held to
    the golden), the files read back equal to that trajectory exactly, the
    manifest's counts the run's; the integration's wall, the text's MB,
    seconds and writer, the .vtp files."""
    import contextlib
    import io
    import re
    import shutil
    import tempfile
    import time

    from crdmodel_tpu_torch import cli
    from crdmodel_tpu_torch.io import trajectory
    from crdmodel_tpu_torch.models import get_model
    out = tempfile.mkdtemp(prefix="cli_run_fhn_")
    pre = prefix_cfg(cfg)
    cut = [f"t_final={pre.t_final!r}", f"output_timestep={PREFIX_OUTPUTS}"]
    rows = PREFIX_OUTPUTS + 1
    try:
        read = zero_launches()
        trajectory.WRITES.clear()
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rc = cli.main(["run", INI, "--model", "fhn", "--surface",
                           "torus", "--outdir", out, "--npz", "--map-torus",
                           "--quiet", "--set", cut[0], "--set", cut[1]])
        total = time.perf_counter() - t0
        counts = read()
        prog = cfg.program_name
        with np.load(os.path.join(out, f"{prog}.npz")) as z:
            run = {k: z[k] for k in ("trajectory", "steps", "accepted",
                                     "rejected", "status")}
        with open(os.path.join(out, f"{prog}_manifest.json")) as fh:
            manifest = json.load(fh)
        traj = run["trajectory"]
        steps = int(run["steps"].sum())
        files, ranks = read_back(out, cfg, get_model("fhn"))
        m = re.search(r"\(([\d.]+) MB in ([\d.]+) s, writer (\S+)\)",
                      log.getvalue())
        vtps = [f for _, _, fs in os.walk(out) for f in fs
                if f.endswith(".vtp")]
        least, most = launch_bound(pre, steps)
        phase("cli_run_fhn", command="python -m crdmodel_tpu_torch run "
              "data/FHNmodelArgs.ini --model fhn --surface torus --npz "
              f"--map-torus --quiet --set {cut[0]} --set {cut[1]} "
              "(cli.main, in process)", exit_code=rc,
              cut=f"Tf {cfg.t_final} -> {pre.t_final}, outputs "
              f"{cfg.output_timestep} -> {PREFIX_OUTPUTS}",
              steps=steps, main_path_steps=single["steps"],
              main_path_prefix_steps=int(
                  single["stats"].steps[:PREFIX_OUTPUTS].sum()),
              launches=counts, integration_wall_s=manifest["wall_time"],
              main_path_wall_s=single["wall_s"],
              text_mb=float(m.group(1)) if m else None,
              text_write_s=float(m.group(2)) if m else None,
              writer=m.group(3) if m else None,
              files_by_writer=dict(trajectory.WRITES), vtp_files=len(vtps),
              cli_total_s=total, rows=int(traj.shape[0]), card=card)
        fail_unless("cli_run_fhn", {
            "exit code 0": rc == 0,
            "every step through fused_step":
                least <= counts["fused_step"] <= most,
            "trajectory bitwise main_path's first rows": np.array_equal(
                traj, single["trajectory"][:rows].cpu().numpy()),
            "per-interval stats main_path's first": same_stats(
                [run[k] for k in ("steps", "accepted", "rejected",
                                  "status")],
                [x[:PREFIX_OUTPUTS] for x in single["stats"]]),
            "files read back exactly": np.array_equal(
                files, traj[:, :files.shape[1]].astype(np.float64)),
            "one rank": ranks == 1,
            "manifest counts": (
                manifest["total_steps"] == steps
                and manifest["accepted"] == int(run["accepted"].sum())
                and manifest["rejected"] == int(run["rejected"].sum())
                and manifest["status"] == run["status"].tolist()
                and manifest["backend"] == "cuda"),
            "a vtp a row and the mesh's": len(vtps) == traj.shape[0] + 1,
        })
    finally:
        shutil.rmtree(out, ignore_errors=True)


def cli_run_goldbeter_ark324(cfg, card):
    """`python -m crdmodel_tpu_torch run` of the canonical Goldbeter torus
    with ark324 through K3 (use_pallas=true) in a subprocess, cut to its
    first PREFIX_OUTPUTS outputs (prefix_cfg), its files written as four
    ranks: exit code 0, the ranks reassembled bitwise equal to an
    in-process simulate_streaming of the same cut of `cfg`, whose K3
    launches are at least its steps."""
    import shutil
    import tempfile
    import time

    from crdmodel_tpu_torch.sim import simulate_streaming
    out = tempfile.mkdtemp(prefix="cli_run_goldbeter_")
    cfg = prefix_cfg(cfg)
    try:
        cmd = [sys.executable, "-m", "crdmodel_tpu_torch", "run", GB_INI,
               "--model", "goldbeter", "--surface", "torus", "--method",
               "ark324", "--set", "use_pallas=true", "--set",
               f"t_final={cfg.t_final!r}", "--set",
               f"output_timestep={PREFIX_OUTPUTS}", "--nprocs-files", "4",
               "--outdir", out]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=600)
        sub_s = time.perf_counter() - t0
        read = zero_launches()
        res = simulate_streaming(cfg, device="cuda")
        counts = read()
        files, ranks = read_back(out, cfg, res.problem.model)
        want = res.trajectory[:, :files.shape[1]].double().cpu().numpy()
        run_line = [x for x in proc.stdout.splitlines()
                    if x.startswith(cfg.program_name)]
        phase("cli_run_goldbeter_ark324",
              command=" ".join(["python -m crdmodel_tpu_torch"] + cmd[3:]),
              exit_code=proc.returncode, subprocess_s=sub_s,
              run_line=run_line[-1] if run_line else None,
              stderr_tail=proc.stderr[-2000:], ranks=ranks,
              in_process=res.describe(), launches=counts, card=card)
        fail_unless("cli_run_goldbeter_ark324", {
            "exit code 0": proc.returncode == 0,
            "four ranks": ranks == 4,
            "in-process run ok through K3": res.ok and res.fused,
            "K3 launches >= steps":
                counts["fused_imex_step"] >= res.total_steps(),
            "ranks reassemble bitwise": np.array_equal(files, want),
        })
    finally:
        shutil.rmtree(out, ignore_errors=True)


def stream_sharded_fhn(cfg, sharded, card):
    """simulate_sharded_streaming of the canonical FHN torus on the 2x2
    mesh on cuda:0 with the port's ShardedReferenceWriter, cut to its first
    PREFIX_OUTPUTS outputs (prefix_cfg): K8 on every step of every shard,
    the steps and trajectory bitwise the first ones of simulate_sharded's
    run `sharded` on the same mesh (held to the golden), the four ranks'
    files reassembled to that trajectory exactly."""
    import shutil
    import tempfile
    import time

    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.io.trajectory import ShardedReferenceWriter
    from crdmodel_tpu_torch.parallel.sharded import \
        simulate_sharded_streaming
    mesh = shard_mesh(SHARD_MESH)
    out = tempfile.mkdtemp(prefix="stream_sharded_fhn_")
    pre = prefix_cfg(cfg)
    try:
        problem = build_problem(pre, "cuda")
        writer = ShardedReferenceWriter(out, pre, problem.model, mesh)
        write_s = [0.0]

        def timed_writer(k, blocks):
            t0 = time.perf_counter()
            writer(k, blocks)
            write_s[0] += time.perf_counter() - t0

        read = zero_launches()
        res = simulate_sharded_streaming(pre, mesh=mesh, problem=problem,
                                         on_snapshot=timed_writer)
        counts = read()
        files, ranks = read_back(out, pre, problem.model)
        traj = res.trajectory.cpu().numpy()
        steps = res.total_steps()
        least, most = (mesh.size * n for n in launch_bound(pre, steps))
        phase("stream_sharded_fhn", mesh=list(mesh.shape),
              devices=[str(d) for d in mesh.device_list()],
              cut=f"Tf {cfg.t_final} -> {pre.t_final}, outputs "
              f"{cfg.output_timestep} -> {PREFIX_OUTPUTS}",
              status=res.describe(), steps=steps,
              simulate_sharded_steps=sharded["steps"],
              simulate_sharded_prefix_steps=int(
                  sharded["stats"].steps[:PREFIX_OUTPUTS].sum()),
              launches=counts, wall_s=res.wall_time, writer_s=write_s[0],
              simulate_sharded_wall_s=sharded["wall_s"], ranks=ranks,
              card=card)
        fail_unless("stream_sharded_fhn", {
            "status ok, fused": res.ok and res.fused,
            "every step of every shard through fused_shard_step":
                least <= counts["fused_shard_step"] <= most,
            "trajectory bitwise simulate_sharded's first rows": torch.equal(
                res.trajectory,
                sharded["trajectory"][:PREFIX_OUTPUTS + 1]),
            "per-interval stats simulate_sharded's first": same_stats(
                res.stats, [x[:PREFIX_OUTPUTS] for x in sharded["stats"]]),
            "four ranks": ranks == 4,
            "files read back exactly": np.array_equal(
                files, traj[:, :files.shape[1]].astype(np.float64)),
        })
    finally:
        shutil.rmtree(out, ignore_errors=True)


def copy_overlap(events, min_bytes):
    """From a trace's device events: for each device-to-host copy of at
    least `min_bytes` (a snapshot's copy into pinned memory), (its µs, the
    µs of it during which a kernel of another stream ran, the µs from its
    end to the start of the first kernel of another stream that starts
    after it started: positive when the copy was done before the solve's
    next kernel began). A snapshot's copy waits for an event recorded at
    the end of its interval, so a kernel beside or after it belongs to a
    later interval."""
    kernels = [(e["ts"], e["ts"] + e["dur"], e["args"].get("stream"))
               for e in events if e.get("cat") == "kernel"]
    rows = []
    for c in events:
        if (c.get("cat") != "gpu_memcpy" or "DtoH" not in c.get("name", "")
                or c.get("args", {}).get("bytes", 0) < min_bytes):
            continue
        lo, hi = c["ts"], c["ts"] + c["dur"]
        others = [(a, b) for a, b, st in kernels
                  if st != c["args"].get("stream")]
        spans = sorted((max(a, lo), min(b, hi)) for a, b in others
                       if b > lo and a < hi)
        covered, end = 0.0, lo
        for a, b in spans:
            if b > end:
                covered += b - max(a, end)
                end = b
        nxt = min((a for a, _ in others if a >= lo), default=None)
        rows.append((c["dur"], covered,
                     None if nxt is None else nxt - hi))
    return rows


def stream_host_offload(cfg, card):
    """The snapshot copies of snapshot_mode "host" (sim.py::HostOffload)
    on the canonical FHN torus over Tf = OFFLOAD_TF with 20 outputs: the
    walls of the device, host and none modes (two untraced runs each,
    alternating),
    the host mode's rows bitwise the device mode's, and from one traced
    host run each copy's duration and the share of it during which a
    kernel of the solve's stream ran (a measurement, not a check)."""
    import time

    from crdmodel_tpu_torch.ops import trace
    from crdmodel_tpu_torch.sim import simulate_streaming
    c5 = dataclasses.replace(cfg, t_final=OFFLOAD_TF, output_timestep=20)
    walls = {"device": [], "host": [], "none": []}
    runs = {}
    simulate_streaming(c5, device="cuda")        # warm-up
    for mode in ("device", "host", "none") * 2:
        t0 = time.perf_counter()
        runs[mode] = simulate_streaming(c5, device="cuda", snapshot_mode=mode)
        walls[mode].append(time.perf_counter() - t0)
    snap = runs["device"].trajectory[0]
    snap_bytes = snap.numel() * snap.element_size()
    events, res = trace.device_events(
        lambda: simulate_streaming(c5, device="cuda", snapshot_mode="host"))
    rows = copy_overlap(events, snap_bytes)
    dur = [r[0] for r in rows]
    leads = [r[2] for r in rows if r[2] is not None]
    phase("stream_host_offload", config="data/FHNmodelArgs.ini fhn torus, "
          f"Tf={OFFLOAD_TF} (cut from 5), 20 outputs",
          steps=res.total_steps(), walls_s=walls,
          snapshot_mb=snap_bytes / 1e6, copies=len(rows),
          copy_us_mean=float(np.mean(dur)) if dur else None,
          copy_us_max=float(np.max(dur)) if dur else None,
          copies_beside_a_kernel=sum(r[1] > 0 for r in rows),
          copy_time_beside_kernels_share=(
              sum(r[1] for r in rows) / sum(dur) if dur else None),
          copies_done_before_next_kernel=sum(x >= 0 for x in leads),
          next_kernel_after_copy_us_median=(
              float(np.median(leads)) if leads else None),
          kernels_in_trace=sum(e.get("cat") == "kernel" for e in events),
          card=card)
    fail_unless("stream_host_offload", {
        "host rows bitwise the device mode's": torch.equal(
            runs["host"].trajectory, runs["device"].trajectory.cpu()),
        "host rows pinned": runs["host"].trajectory.is_pinned(),
        "none: the final state": torch.equal(
            runs["none"].trajectory[0], runs["device"].trajectory[-1]),
    })


def stream_phases(cfg, cfg_gb_ark, single_fhn, sharded_fhn, card):
    """The `run` entry point and the streaming drivers on the card:
    cli_run_fhn, cli_run_goldbeter_ark324, stream_sharded_fhn and the
    host-offload measurement stream_host_offload; their seconds in phase
    "stream_phases"."""
    import time
    t0 = time.perf_counter()
    cli_run_fhn(cfg, single_fhn, card)
    t1 = time.perf_counter()
    cli_run_goldbeter_ark324(cfg_gb_ark, card)
    t2 = time.perf_counter()
    stream_sharded_fhn(cfg, sharded_fhn, card)
    t3 = time.perf_counter()
    stream_host_offload(cfg, card)
    t4 = time.perf_counter()
    phase("stream_phases", seconds={
        "cli_run_fhn": t1 - t0, "cli_run_goldbeter_ark324": t2 - t1,
        "stream_sharded_fhn": t3 - t2, "stream_host_offload": t4 - t3},
        card=card)


# --- the forcing and curvature slice: K1-K4 with a structured forcing ---

# the paced programs' goldens (scripts/torch_canonical_probes.py
# --forcing, --config curvature_fhn, --config s1s2); a forced file's
# stimuli come with it as plain data (stim_*)
FORCED_PROBES = {name: os.path.join(GOLDEN, f"torch_{name}_probes.npz")
                 for name in ("curvature_fhn", "s1s2_rkc2",
                              "canonical_fhn_paced",
                              "canonical_goldbeter_ark324_paced",
                              "bounded_ap_paced")}
# K2's forced stage counts: an accuracy-limited step (one chunk) and the
# paths' largest (four chunks)
K2_FORCED_STAGES = (5, 23)
# the cross drive the kernel checks add on variable 1: amp sin(2 pi t /
# period) on a Gaussian column band, so that every kernel forces both
# variables
CROSS_DRIVE = (0.3, 5.0)
# the JAX package's own forcing measurement (scripts/bench_round4.py::
# section_forcing): a flat FHN sheet, x_mesh 1600 (10.24M points),
# s1s2_protocol with S1 at 0.01 and S2 at 0.03, amplitude 1, duration 0.005
ROUND4_FORCING = dict(model="fhn", surface="flat", x_mesh=1600,
                      surface_width=20.0, surface_length=80.0, t_final=0.05,
                      output_timestep=1, beta=1.25, dtype="float32",
                      rtol=1e-5, atol=1e-8)


def sine_wave(amplitude, period):
    """amp sin(2 pi t / period) on the device, elementwise: the torch twin
    of scripts/torch_canonical_probes.py::sine_wave (the same operations)."""
    def waveform(t, seg_end=None):
        return amplitude * torch.sin((2.0 * np.pi / period) * t)
    return waveform


def golden_forcing(probes, extra=()):
    """The port's SeparableForcing of a forced golden's stimuli (stim_*),
    through convert.forcing_from_numpy: its pulse trains as data, its
    sinusoid drives as their torch twins; `extra` stimuli's data after
    them."""
    from crdmodel_tpu_torch.convert import forcing_from_numpy
    stimuli = []
    for j, var in enumerate(probes["stim_var"]):
        st = dict(var=int(var), row=probes["stim_row"][j],
                  col=probes["stim_col"][j])
        starts = probes["stim_pulse_starts"][j]
        if np.all(np.isnan(starts)):
            st["waveform"] = sine_wave(*(float(x)
                                         for x in probes["stim_sine"][j]))
        else:
            st["pulses"] = (starts[~np.isnan(starts)].tolist(),
                            float(probes["stim_pulse_duration"][j]),
                            float(probes["stim_pulse_amplitude"][j]))
        stimuli.append(st)
    return forcing_from_numpy([*stimuli, *extra])


def cross_drive(cfg):
    """CROSS_DRIVE's stimulus data on cfg's grid: variable 1, a Gaussian
    column band around nx/2."""
    from crdmodel_tpu_torch.core.forcing import gaussian_profile
    return dict(var=1, col=gaussian_profile(cfg.nx, cfg.nx / 2, cfg.nx / 8),
                waveform=sine_wave(*CROSS_DRIVE))


def load_forced_probes():
    probes = {}
    for key, path in FORCED_PROBES.items():
        with np.load(path) as z:
            probes[key] = {k: z[k] for k in z.files}
    return probes


def stim_ops(stim, n_evals):
    """Operations a point the forcing needs in a launch of n_evals RHS
    evaluations: a stimulus is rank-1, so amp * row is one product a row,
    which leaves one product and one sum a point, a stimulus and an
    evaluation. The sums the kernel's order adds beyond these (from +0,
    then into the RHS) are its cost, not the bound's."""
    return n_evals * 2 * stim.n_stim


def stim_bytes(stim, amps):
    """Bytes the forcing adds to a launch, each read once: the profiles,
    the box's depth table and the amplitude table."""
    tables = (stim.rows, stim.cols, amps) + (
        () if stim.z is None else (stim.z,))
    return sum(t.numel() * t.element_size() for t in tables)


def ptxas_split(source, tag):
    """ptxas_summary of the f32 kernels of csrc/<source> (a name, or a
    tuple of names: a kernel whose forced instantiations are compiled
    apart) whose entry name holds `tag` (a double among the mangled
    template arguments, a "d" after "E", "I" or "_" and before "E", "L",
    "N" or "S", marks an f64 one), apart for the forced (StimTable) and
    unforced (NoStim) instantiations."""
    import re
    sources = (source,) if isinstance(source, str) else source
    entries = [e for src in sources for e in ptxas_entries(src)
               if tag in e["kernel"] and not re.search(
                   r"(?<=[EI_])d(?=[ELNS])", e["kernel"].split("EvPK")[0])]
    out = {}
    for label, key in (("forced", "StimTable"), ("unforced", "NoStim")):
        sel = [e for e in entries if key in e["kernel"]]
        out[label] = {
            "kernels": len(sel),
            "max_registers": max(e.get("registers", 0) for e in sel),
            "max_spill_store_bytes": max(e.get("spill_store_bytes", 0)
                                         for e in sel)}
    return out


def check_forced_trace(name, fn, tag):
    """Raise unless the kernels one call of fn runs include `tag`'s forced
    instantiation (its name holds StimTable) and none of its unforced one;
    returns the kernel's name."""
    from crdmodel_tpu_torch.ops import trace
    names = trace.kernel_names(fn, n=1)
    mine = [n for n in names if tag in n]
    if not mine or not all("StimTable" in n for n in mine):
        raise AssertionError(f"{name}: ran {sorted(set(names))}, not the "
                             f"forced {tag}")
    return mine[0].split("(")[0]


def kernels_a_step(problem, build, t, y, h, seg):
    """The device kernels of one call of the step_err that build(problem)
    makes, its amplitudes included, with the problem's forcing and without
    it: {"forced": n, "unforced": n}."""
    from crdmodel_tpu_torch.ops import trace
    out = {}
    for label, prob in (("forced", problem),
                        ("unforced", dataclasses.replace(problem,
                                                         forcing=None))):
        step_err = build(prob)
        params = {**prob.params, "_seg_end": seg}
        out[label] = len(trace.kernel_names(
            lambda: step_err(t, y, h, params), n=1))
    return out


def forced_timing(name, y, kc, stim, amps, forced_call, plain_call,
                  reference, tag, ops, n_evals, extra_bytes, per_step,
                  source, card, bound_of=bound, timed=WIDE_TIMED, group=1,
                  **fields):
    """Print phase `name`: the forced and the unforced launch's device
    times in one call (device_ms; `group`: the kernels a call launches, K7's
    and K13's chunk launches), the forced plain version's (`timed`'s
    samples: the plain versions take milliseconds a call), the bounds of
    both (bound_of(y, constants, operations a point, extra bytes): bound,
    or shard_bound for a shard's buffer; the forcing's profile, depth-table
    and amplitude bytes and its operations added), the kernels a step and
    ptxas's forced and unforced registers and spills. Returns the forced
    (ms, plain ms, bound ms, bound_by) and the unforced device ms."""
    ms_f = device_ms(forced_call, tag, group=group)
    ms_u = device_ms(plain_call, tag, group=group)
    timing = (ms_f, median_ms(reference, *timed),
              *bound_of(y, kc, ops + stim_ops(stim, n_evals),
                        extra_bytes + stim_bytes(stim, amps)))
    unforced_bound = bound_of(y, kc, ops, extra_bytes)
    phase(name, shape=list(y.shape), dtype=str(y.dtype), n_stim=stim.n_stim,
          **fields, forced_us=ms_f * 1e3, unforced_us=ms_u * 1e3,
          forced_over_unforced=ms_f / ms_u, forced_plain_us=timing[1] * 1e3,
          bound_us=timing[2] * 1e3, bound_by=timing[3],
          unforced_bound_us=unforced_bound[0] * 1e3,
          times_bound=ms_f / timing[2], kernels_a_step=per_step,
          kernel=tag, ptxas=ptxas_split(source, tag), card=card)
    return timing, ms_u


def forced_erk_cases(cfg, cfg_ap, ap_build, fprobes):
    """K1's and K4's forced cases: (name, the ops module, its constants'
    prepare, config, build arguments, forcing, (t, seg_end) windows inside
    a pulse, h)."""
    from crdmodel_tpu_torch.ops import fused_divform, fused_step
    from crdmodel_tpu_torch.ops.kernel_common import (
        prepare_constants, prepare_divform_constants)
    fhn = dataclasses.replace(cfg, t_boundary=1.0)
    ap = dataclasses.replace(cfg_ap, t_boundary=1.0)
    return [
        # the paced FHN torus's two S1 pulses on a row band and smooth
        # drive, and the cross drive; inside the first pulse
        ("k1", fused_step, prepare_constants, fhn, {},
         golden_forcing(fprobes["canonical_fhn_paced"], [cross_drive(fhn)]),
         ((2.3, 2.5),), H),
        # the bounded tissue's s1s2_protocol and the cross drive; in S1 and
        # in S2
        ("k4", fused_divform, prepare_divform_constants, ap, ap_build,
         golden_forcing(fprobes["bounded_ap_paced"], [cross_drive(ap)]),
         ((0.6, 0.8), (4.1, 4.3)), K4_H)]


def check_forced_erk_kernels(cases, card):
    """K1 and K4 with a forcing against their plain versions at the main
    paths' shapes, f32 and f64, bs32 and dopri54, fz 0 and 1, in each
    window: y_new and every partial sum bitwise, two launches bitwise, the
    forced instantiation traced; then each timed forced and unforced
    (forced_timing, bs32, f32). Returns {name: (worst errors, forced
    timing, unforced ms)}; each check's line names the kernel traced in
    its case's f32 launch."""
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import erk_slots
    from crdmodel_tpu_torch.ops.kernel_common import (prepare_stim_constants,
                                                      stage_amplitudes)
    rng = np.random.default_rng(SEED + 11)
    out = {}
    for name, mod, prepare, cfg, build, frc, windows, h_val in cases:
        divform = name == "k4"
        step = mod.fused_divform_step if divform else mod.fused_step
        reference = (mod.fused_divform_step_reference if divform
                     else mod.fused_step_reference)
        tile_sums = (mod.fused_divform_tile_sums if divform
                     else mod.fused_step_tile_sums)
        problem = build_problem(cfg, "cuda", forcing=frc, **build)
        y_np = random_state(cfg, tuple(problem.y0.shape), rng)
        worst = {torch.float32: 0.0, torch.float64: 0.0}
        traced = {}
        for dtype in (torch.float32, torch.float64):
            kc = prepare(problem, dtype, "cuda")
            stim = prepare_stim_constants(problem, dtype, "cuda")
            y = torch.tensor(y_np, dtype=dtype, device="cuda")
            h = torch.tensor(h_val, dtype=dtype, device="cuda")
            for method in ("bs32", "dopri54"):
                tab = TABLEAUS[method]
                for t, seg in windows:
                    amps = stage_amplitudes(
                        frc, torch.tensor(t, dtype=dtype, device="cuda"), h,
                        torch.tensor(tab.c, dtype=dtype, device="cuda"),
                        {"_seg_end": torch.tensor(seg, dtype=dtype,
                                                  device="cuda")}, dtype)
                    for fz in (0.0, 1.0):
                        fzt = torch.tensor(fz, dtype=dtype, device="cuda")
                        args = (y, h, fzt, kc, tab, cfg.rtol, cfg.atol, stim,
                                amps)
                        if dtype == torch.float32 and not fz and (
                                (t, seg) == windows[0]):
                            traced[method] = check_forced_trace(
                                f"{name}_forced_check", lambda: step(*args),
                                erk_slots.kernel_name(tab))
                        err = check_pair(
                            f"{name}_forced_check",
                            dict(model=cfg.model, surface=cfg.surface,
                                 shape=list(y.shape), method=method, t=t,
                                 seg_end=seg, fz=fz, n_stim=stim.n_stim,
                                 amps_stage0=amps[:, 0].tolist(),
                                 traced_f32_kernel=traced[method]),
                            *step(*args), *step(*args), *reference(*args),
                            dtype, y, bitwise=True, ss_tiles=tile_sums(*args))
                        worst[dtype] = max(worst[dtype], err)
        # timed at the case's shape on its ICs, bs32, f32, in the first
        # window
        tab = TABLEAUS["bs32"]
        kc = prepare(problem, torch.float32, "cuda")
        stim = prepare_stim_constants(problem, torch.float32, "cuda")
        y = problem.y0.contiguous()
        h = torch.tensor(h_val, device="cuda")
        zero = torch.zeros((), device="cuda")
        t, seg = (torch.tensor(x, device="cuda") for x in windows[0])
        c_nodes = torch.tensor(tab.c, dtype=torch.float32, device="cuda")
        amps = stage_amplitudes(frc, t, h, c_nodes, {"_seg_end": seg},
                                torch.float32)
        base = (y, h, zero, kc, tab, cfg.rtol, cfg.atol)
        build_step = (mod.build_fused_divform_step if divform
                      else mod.build_fused_step)
        timing, ms_u = forced_timing(
            f"{name}_forced_timing", y, kc, stim, amps,
            lambda: step(*base, stim, amps), lambda: step(*base),
            lambda: reference(*base, stim, amps), erk_slots.SLOTS_KERNEL,
            erk_ops(kc, tab), tab.stages, 0,
            kernels_a_step(problem, lambda p: build_step(p, tab), t, y, h,
                           seg),
            "fused_divform.cu" if divform else "fused_step.cu", card,
            method="bs32", h=h_val, window=list(windows[0]))
        out[name] = (worst, timing, ms_u)
    return out


def forced_round4_timing(card):
    """K1 forced and unforced at the JAX package's own forcing measurement
    shape (ROUND4_FORCING: (2,6400,1600), s1s2_protocol), bs32, f32, in
    S1: phase k1_forced_round4_timing."""
    from crdmodel_tpu_torch.config import SimConfig
    from crdmodel_tpu_torch.core.forcing import s1s2_protocol
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import erk_slots
    from crdmodel_tpu_torch.ops import fused_step as fs
    from crdmodel_tpu_torch.ops.kernel_common import (prepare_constants,
                                                      prepare_stim_constants,
                                                      stage_amplitudes)
    cfg = SimConfig(**ROUND4_FORCING)
    frc = s1s2_protocol(cfg, amplitude=1.0, s1_times=[0.01], s2_time=0.03,
                        duration=0.005)
    problem = build_problem(cfg, "cuda", forcing=frc)
    tab = TABLEAUS["bs32"]
    kc = prepare_constants(problem, torch.float32, "cuda")
    stim = prepare_stim_constants(problem, torch.float32, "cuda")
    y = problem.y0.contiguous()
    h = torch.tensor(1e-4, device="cuda")
    zero = torch.zeros((), device="cuda")
    t, seg = (torch.tensor(x, device="cuda") for x in (0.011, 0.012))
    c_nodes = torch.tensor(tab.c, dtype=torch.float32, device="cuda")
    amps = stage_amplitudes(frc, t, h, c_nodes, {"_seg_end": seg},
                            torch.float32)
    base = (y, h, zero, kc, tab, cfg.rtol, cfg.atol)
    forced_timing(
        "k1_forced_round4_timing", y, kc, stim, amps,
        lambda: fs.fused_step(*base, stim, amps), lambda: fs.fused_step(*base),
        lambda: fs.fused_step_reference(*base, stim, amps),
        erk_slots.SLOTS_KERNEL, erk_ops(kc, tab), tab.stages, 0,
        kernels_a_step(problem, lambda p: fs.build_fused_step(p, tab), t, y,
                       h, seg),
        "fused_step.cu", card, method="bs32",
        config="scripts/bench_round4.py::section_forcing fhn flat "
               "x_mesh=1600, s1s2_protocol S1 0.01 S2 0.03")


def forced_rkc_cases(cfg, cfg_ap, ap_build, fprobes):
    """K2's forced cases: (name, config, build arguments, forcing, (t,
    seg_end) window): both branches, gated (pulse trains alone: one
    amplitude column) and smooth (a sinusoid beside them: a column a stage
    time)."""
    fhn = dataclasses.replace(cfg, t_boundary=1.0, method="rkc2")
    ap = dataclasses.replace(cfg_ap, t_boundary=1.0, method="rkc2")
    fhn_probes = fprobes["canonical_fhn_paced"]
    pulses = {k: v[:1] for k, v in fhn_probes.items()
              if k.startswith("stim_")}
    ap_probes = fprobes["bounded_ap_paced"]
    return [
        ("profile_gated", fhn, {}, golden_forcing(pulses), (2.3, 2.5)),
        ("profile_smooth", fhn, {},
         golden_forcing(fhn_probes, [cross_drive(fhn)]), (2.3, 2.5)),
        ("divform_gated", ap, ap_build, golden_forcing(ap_probes),
         (0.6, 0.8)),
        ("divform_smooth", ap, ap_build,
         golden_forcing(ap_probes, [cross_drive(ap)]), (0.6, 0.8))]


def check_forced_rkc_kernel(cases, card):
    """K2 with a forcing against its plain version in both branches, gated
    and smooth, at each of K2_FORCED_STAGES (one chunk and four),
    f32 and f64, fz 0 and 1: y_new and every partial sum bitwise
    (fused_rkc_tile_sums), two launches bitwise, the forced instantiation
    traced; then each branch timed forced (smooth) and unforced at s = 5
    and 23 (forced_timing). Returns (worst errors, {(branch, s): (forced
    timing, unforced ms)})."""
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.ops import fused_rkc as fr
    from crdmodel_tpu_torch.ops.kernel_common import (
        needs_divform, prepare_constants, prepare_divform_constants,
        prepare_stim_constants)
    rng = np.random.default_rng(SEED + 12)
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    timing = {}
    for label, cfg, build, frc, (t_val, seg_val) in cases:
        problem = build_problem(cfg, "cuda", forcing=frc, **build)
        prepare = (prepare_divform_constants if needs_divform(problem)
                   else prepare_constants)
        y_np = random_state(cfg, tuple(problem.y0.shape), rng)
        for dtype in (torch.float32, torch.float64):
            kc = prepare(problem, dtype, "cuda")
            stim = prepare_stim_constants(problem, dtype, "cuda")
            mu1, ctab, ctimes = fr.static_stage_tables(
                fr.S_MAX_KERNEL, dtype, "cuda", with_times=True)
            y = torch.tensor(y_np, dtype=dtype, device="cuda")
            rho = problem_rho(problem, y)
            t = torch.tensor(t_val, dtype=dtype, device="cuda")
            seg = {"_seg_end": torch.tensor(seg_val, dtype=dtype,
                                            device="cuda")}
            for s in K2_FORCED_STAGES:
                h, st = rkc_step_inputs(s, rho, dtype)
                amps = fr.stage_times_amplitudes(frc, t, h, st, ctimes, seg,
                                                 dtype)
                for fz in (0.0, 1.0):
                    fzt = torch.tensor(fz, dtype=dtype, device="cuda")
                    args = (y, h, fzt, st, mu1, ctab, kc, cfg.rtol, cfg.atol,
                            stim, amps)
                    if dtype == torch.float32 and not fz and (
                            s == K2_FORCED_STAGES[0]):
                        kernel = check_forced_trace(
                            "k2_forced_check",
                            lambda: fr.fused_rkc_step(*args),
                            "fused_rkc_chunk_kernel")
                    err = check_pair(
                        "k2_forced_check",
                        dict(case=label, model=cfg.model,
                             shape=list(y.shape), s=s, fz=fz,
                             chunks=len(fr.chunk_schedule(s)),
                             n_stim=stim.n_stim, amp_columns=amps.shape[1],
                             traced_f32_kernel=kernel),
                        *fr.fused_rkc_step(*args), *fr.fused_rkc_step(*args),
                        *fr.fused_rkc_step_reference(*args), dtype, y,
                        bitwise=True,
                        ss_tiles=fr.fused_rkc_tile_sums(*args))
                    worst[dtype] = max(worst[dtype], err)
        if not label.endswith("smooth"):
            continue
        # timed on the ICs, f32, at an accuracy-limited and a
        # stability-bound stage count
        kc = prepare(problem, torch.float32, "cuda")
        stim = prepare_stim_constants(problem, torch.float32, "cuda")
        mu1, ctab, ctimes = fr.static_stage_tables(
            fr.S_MAX_KERNEL, torch.float32, "cuda", with_times=True)
        y = problem.y0.contiguous()
        rho = problem_rho(problem, y)
        t = torch.tensor(t_val, device="cuda")
        seg = torch.tensor(seg_val, device="cuda")
        zero = torch.zeros((), device="cuda")
        for s in K2_TIMED_STAGES:
            h, st = rkc_step_inputs(s, rho, torch.float32)
            amps = fr.stage_times_amplitudes(frc, t, h, st, ctimes,
                                             {"_seg_end": seg},
                                             torch.float32)
            base = (y, h, zero, st, mu1, ctab, kc, cfg.rtol, cfg.atol)
            tables = sum(x.numel() * x.element_size() for x in (mu1, ctab))
            per_step = kernels_a_step(
                problem, lambda p: fr.build_fused_rkc_step(
                    p, torch.float32).step_err, t, y, h, seg)
            timing[label.split("_")[0], s] = forced_timing(
                "k2_forced_timing", y, kc, stim, amps,
                lambda: fr.fused_rkc_step(*base, stim, amps),
                lambda: fr.fused_rkc_step(*base),
                lambda: fr.fused_rkc_step_reference(*base, stim, amps),
                "fused_rkc_chunk_kernel", rkc_ops(kc, s), s + 1, tables,
                per_step, "fused_rkc.cu", card, case=label, s=s,
                chunks=len(fr.chunk_schedule(s)))
    return worst, timing


def check_forced_imex_kernel(cfg_gb, fprobes, card):
    """K3 with a forcing (the paced Goldbeter torus's pulse train and the
    cross drive) against its plain version on the canonical Goldbeter
    torus with a freeze, f32 and f64, each h of K3_H, fz 0 and 1: y_new
    and every partial sum bitwise (fused_imex_tile_sums), two launches
    bitwise, the forced instantiation traced; then timed forced and
    unforced (forced_timing). Returns (worst errors, forced timing,
    unforced ms)."""
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.integrate import imex
    from crdmodel_tpu_torch.ops import fused_imex as fi
    from crdmodel_tpu_torch.ops.kernel_common import (prepare_constants,
                                                      prepare_stim_constants,
                                                      stage_amplitudes)
    cfg = dataclasses.replace(cfg_gb, t_boundary=1.0, method="ark324")
    frc = golden_forcing(fprobes["canonical_goldbeter_ark324_paced"],
                         [cross_drive(cfg)])
    problem = build_problem(cfg, "cuda", forcing=frc)
    y_np = random_state(cfg, tuple(problem.y0.shape),
                        np.random.default_rng(SEED + 13))
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    window = (0.55, 0.7)        # inside the first pulse
    for dtype in (torch.float32, torch.float64):
        kc = prepare_constants(problem, dtype, "cuda")
        stim = prepare_stim_constants(problem, dtype, "cuda")
        y = torch.tensor(y_np, dtype=dtype, device="cuda")
        t, seg = (torch.tensor(x, dtype=dtype, device="cuda")
                  for x in window)
        for h_val in K3_H:
            h = torch.tensor(h_val, dtype=dtype, device="cuda")
            amps = stage_amplitudes(
                frc, t, h, torch.tensor(imex.C, dtype=dtype, device="cuda"),
                {"_seg_end": seg}, dtype)
            for fz in (0.0, 1.0):
                fzt = torch.tensor(fz, dtype=dtype, device="cuda")
                args = (y, h, fzt, kc, cfg.rtol, cfg.atol, stim, amps)
                if dtype == torch.float32 and not fz and h_val == K3_H[0]:
                    kernel = check_forced_trace(
                        "k3_forced_check", lambda: fi.fused_imex_step(*args),
                        fi.SLOTS_KERNEL)
                err = check_pair(
                    "k3_forced_check",
                    dict(model=cfg.model, surface=cfg.surface,
                         shape=list(y.shape), h=h_val, fz=fz,
                         n_stim=stim.n_stim, traced_f32_kernel=kernel),
                    *fi.fused_imex_step(*args), *fi.fused_imex_step(*args),
                    *fi.fused_imex_step_reference(*args), dtype, y,
                    bitwise=True, ss_tiles=fi.fused_imex_tile_sums(*args))
                worst[dtype] = max(worst[dtype], err)
    kc = prepare_constants(problem, torch.float32, "cuda")
    stim = prepare_stim_constants(problem, torch.float32, "cuda")
    y = problem.y0.contiguous()
    h = torch.tensor(K3_H[0], device="cuda")
    zero = torch.zeros((), device="cuda")
    t, seg = (torch.tensor(x, device="cuda") for x in window)
    c_nodes = torch.tensor(imex.C, dtype=torch.float32, device="cuda")
    amps = stage_amplitudes(frc, t, h, c_nodes, {"_seg_end": seg},
                            torch.float32)
    base = (y, h, zero, kc, cfg.rtol, cfg.atol)
    timing, ms_u = forced_timing(
        "k3_forced_timing", y, kc, stim, amps,
        lambda: fi.fused_imex_step(*base, stim, amps),
        lambda: fi.fused_imex_step(*base),
        lambda: fi.fused_imex_step_reference(*base, stim, amps),
        fi.SLOTS_KERNEL, imex_ops(kc), imex.STAGES, 0,
        kernels_a_step(problem, fi.build_fused_imex_step, t, y, h, seg),
        "fused_imex.cu", card, h=K3_H[0], window=list(window))
    return worst, timing, ms_u


def traced_path(tag, forced, fields=None, mesh=None):
    """report(res, counts) of a forced or coupled main path: a short run of
    the same problem traced (ops/trace.py::traced), through
    simulate_sharded on `mesh` when given, raising unless it ran `tag`'s
    kernel, in its forced instantiation (StimTable) when `forced`, else its
    unforced one (NoStim); fields(res) -> more fields of the phase line."""
    from crdmodel_tpu_torch.ops import trace
    from crdmodel_tpu_torch.parallel.sharded import simulate_sharded
    from crdmodel_tpu_torch.sim import simulate

    def report(res, counts):
        cfg = dataclasses.replace(res.cfg, t_final=res.cfg.t_final / 50,
                                  output_timestep=1)
        problem = dataclasses.replace(res.problem, cfg=cfg)
        if mesh is None:
            def run():
                return simulate(cfg, device="cuda", problem=problem)
        else:
            def run():
                return simulate_sharded(cfg, mesh=mesh, problem=problem)
        kernels, _ = trace.traced(run)
        names = [e["name"] for e in kernels]
        mine = [n for n in names if tag in n]
        want = "StimTable" if forced else "NoStim"
        if not mine or not all(want in n for n in mine):
            raise AssertionError(f"traced path: ran {sorted(set(names))}, "
                                 f"not {tag} with {want}")
        return dict(traced_kernel=mine[0].split("(")[0],
                    traced_launches=len(mine),
                    **(fields(res) if fields is not None else {}))
    return report


def forced_main_paths(cfg, cfg_gb, cfg_ap, ap_build, fprobes, keep=None):
    """The slice's paths through simulate() on the card, each through the
    kernel the slice names, checked by launch counts and by a trace, and
    against its JAX CPU golden: the JAX suite's curvature-coupled FHN torus
    (K1), examples/s1s2_pacing.py (K2's divergence branch), the paced
    canonical FHN torus (K1), Goldbeter torus with ark324 (K3) and bounded
    tissue (K4). Returns {name: launches}; `keep`, a dict, receives each
    paced run (run_main_path's keep) under its phase's name."""
    keep = {} if keep is None else keep
    for name in ("paced_fhn_bs32", "paced_goldbeter_ark324",
                 "paced_bounded_ap_bs32"):
        keep[name] = {}
    from crdmodel_tpu_torch.config import SimConfig
    from crdmodel_tpu_torch.ops import (fused_divform, fused_imex,
                                        fused_rkc, fused_step)
    launches = {}
    curv = dataclasses.replace(cfg, coupling="curvature", t_final=5.0,
                               output_timestep=2)
    launches["curvature_fhn"] = run_main_path(
        curv, fprobes["curvature_fhn"], fused_step.fused_step, 0.01,
        "curvature_fhn",
        "scripts/bench_suite.py:70-75 fhn torus 400x1600 Tf=5 bs32 "
        "coupling=curvature",
        report=traced_path("fused_erk_slots_kernel", False))
    s1s2 = fprobes["s1s2_rkc2"]
    cfg_s1s2 = SimConfig(
        model="aliev_panfilov", surface="flat", x_mesh=256,
        surface_width=25.0, surface_length=25.0, diffusion=1.0, beta=0.075,
        wave_length=0.0, wave_width=0.0, t_final=120.0, output_timestep=24,
        boundary="noflux", method="rkc2", dtype="float32", rtol=1e-4,
        atol=1e-6, use_pallas=True)

    def reentrant(res):
        u_end = float(res.trajectory[-1, 0].max())
        return {f"re-entrant at t=120 (max u {u_end:.3f} > 0.4)":
                u_end > 0.4}

    launches["s1s2_pacing_rkc2"] = run_main_path(
        cfg_s1s2, s1s2, fused_rkc.fused_rkc_step, 0.02, "s1s2_pacing_rkc2",
        "examples/s1s2_pacing.py aliev_panfilov flat 256x256 noflux rkc2, "
        "S1 t=1 S2 t=60 amplitude 3 duration 1; use_pallas=True (auto "
        "selection keeps 65536 points on the torch path)",
        build_kw=dict(forcing=golden_forcing(s1s2)),
        extra_checks=reentrant,
        report=traced_path("fused_rkc_chunk_kernel", True, lambda res: dict(
            final_max_u=float(res.trajectory[-1, 0].max()),
            jax_f32_final_max_u=float(s1s2["final_max_u"]))))
    paced = fprobes["canonical_fhn_paced"]
    launches["paced_fhn_bs32"] = run_main_path(
        cfg, paced, fused_step.fused_step, 0.01, "paced_fhn_bs32",
        "data/FHNmodelArgs.ini fhn torus, two S1 pulses (t=2, 20, "
        "duration 1, amplitude 1) on rows ny/8..ny/4 and 0.1 sin(2 pi t / "
        "12.5) on a Gaussian column band",
        build_kw=dict(forcing=golden_forcing(paced)),
        report=traced_path("fused_erk_slots_kernel", True),
        keep=keep["paced_fhn_bs32"])
    gb = fprobes["canonical_goldbeter_ark324_paced"]
    launches["paced_goldbeter_ark324"] = run_main_path(
        dataclasses.replace(cfg_gb, method="ark324"), gb,
        fused_imex.fused_imex_step, 0.01, "paced_goldbeter_ark324",
        "data/GoldbeterModelArgs.ini goldbeter torus ark324, pulses at "
        "t=0.5, 2 (duration 0.25, amplitude 0.5) on columns 0..nx/4",
        build_kw=dict(forcing=golden_forcing(gb)),
        report=traced_path("fused_imex_slots_kernel", True),
        keep=keep["paced_goldbeter_ark324"])
    ap = fprobes["bounded_ap_paced"]
    launches["paced_bounded_ap_bs32"] = run_main_path(
        cfg_ap, ap, fused_divform.fused_divform_step, 0.01,
        "paced_bounded_ap_bs32",
        "scripts/bench_suite.py::bounded_tissue aliev_panfilov flat, noflux "
        "walls + circular scar, s1s2_protocol S1 t=0.5 S2 t=4 amplitude 3 "
        "duration 0.5",
        build_kw=dict(ap_build, forcing=golden_forcing(ap)),
        extra_checks=scar_checks(ap, ap_build["obstacle_mask"]),
        report=traced_path("fused_erk_slots_kernel", True),
        keep=keep["paced_bounded_ap_bs32"])
    return launches


def forced_phases(cfg, cfg_gb, cfg_ap, ap_build, card, keep=None):
    """The forcing slice: its kernel checks and timings, then its paths.
    Returns (erk results, (K2 worst, K2 timings), K3 results, launches);
    `keep` receives the paced runs (forced_main_paths)."""
    fprobes = load_forced_probes()
    erk = check_forced_erk_kernels(
        forced_erk_cases(cfg, cfg_ap, ap_build, fprobes), card)
    forced_round4_timing(card)
    rkc = check_forced_rkc_kernel(
        forced_rkc_cases(cfg, cfg_ap, ap_build, fprobes), card)
    imx = check_forced_imex_kernel(cfg_gb, fprobes, card)
    launches = forced_main_paths(cfg, cfg_gb, cfg_ap, ap_build, fprobes,
                                 keep)
    return erk, rkc, imx, launches


def forced_fields(worst, timing, ms_u, launches):
    """A kernel entry's forced fields: the forced cases' worst difference,
    the forced launch's time, plain time and bound beside the unforced
    time of the same call, and the forced paths' launches."""
    ms, plain_ms, bound_ms, bound_by = timing[:4]
    return {"forced": {"max_abs_err": worst[torch.float32], "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "unforced_ms": ms_u,
                       "launches": launches}}


# ---------------------------------------------------------------------------
# Forcing on a mesh: K8-K11 forced, and the paced paths on a 2x2 mesh


# the forced shard kernels' meshes, the shards checked on each and the
# freeze scalars: shard 0 and the last shard of the 2x2 mesh, frozen and
# not, and of the uneven 1x3 mesh (its last shard holds mirror-pad
# columns), not frozen
FORCED_MESHES = ((SHARD_MESH, (0, 3), (0.0, 1.0)),
                 (UNEVEN_MESH, (0, 2), (0.0,)))
# K9's forced stage counts: s + 1 = 3, 6, 8, 13, 24 evaluations, one to
# four chunks of at most 6; and the two it is timed at
K9_FORCED_STAGES = (2, 5, 7, 12, 23)
K9_FORCED_TIMED = (5, 23)
# paced_sharded_fhn_rkc2 runs the paced FHN torus's first 10 of its 20
# output intervals (Tf = 25, past both S1 pulses at t = 2 and 20), so
# that the script stays inside its time limit; no golden holds the run,
# which is held to a single-device run of the same horizon
PACED_RKC2_INTERVALS = 10


def mesh_forced_cases(cfg, cfg_gb, cfg_ap, ap_build, cfg_torus,
                      torus_build, fprobes):
    """The forced shard kernels' cases: (kernel, label, config, build
    arguments, forcing, (t, seg_end) inside a pulse). K8 and K9 on the
    paced canonical FHN torus (its golden's stimuli and the cross drive;
    K9 gated, its pulse train alone, and smooth), K10 on the paced
    Goldbeter torus with the cross drive, K11 on the paced bounded tissue
    (divform mode) and on the torus fibres (aniso mode) with the bounded
    tissue's s1s2 stimuli and the cross drive (the same 1600x400 grid);
    each with a freeze."""
    fhn = dataclasses.replace(cfg, t_boundary=1.0)
    paced = fprobes["canonical_fhn_paced"]
    pulses = {k: v[:1] for k, v in paced.items() if k.startswith("stim_")}
    gb = dataclasses.replace(cfg_gb, t_boundary=1.0, method="ark324")
    ap = dataclasses.replace(cfg_ap, t_boundary=1.0)
    torus = dataclasses.replace(cfg_torus, t_boundary=1.0)
    ap_paced = fprobes["bounded_ap_paced"]
    return [
        ("k8", "paced_fhn", fhn, {},
         golden_forcing(paced, [cross_drive(fhn)]), (2.3, 2.5)),
        ("k9", "paced_fhn_gated", dataclasses.replace(fhn, method="rkc2"),
         {}, golden_forcing(pulses), (2.3, 2.5)),
        ("k9", "paced_fhn_smooth", dataclasses.replace(fhn, method="rkc2"),
         {}, golden_forcing(paced, [cross_drive(fhn)]), (2.3, 2.5)),
        ("k10", "paced_goldbeter", gb, {},
         golden_forcing(fprobes["canonical_goldbeter_ark324_paced"],
                        [cross_drive(gb)]), (0.55, 0.7)),
        ("k11", "paced_bounded_ap", ap, ap_build,
         golden_forcing(ap_paced, [cross_drive(ap)]), (0.6, 0.8)),
        ("k11", "torus_fibres_s1s2", torus, torus_build,
         golden_forcing(ap_paced, [cross_drive(torus)]), (0.6, 0.8))]


def shard_stim_inputs(problem, mesh, y_np, dtype, halo, constants=None):
    """shard_inputs with every shard's StimConstants (kernel_common.
    prepare_shard_stim_constants): (buffers, constants, stims)."""
    from crdmodel_tpu_torch.ops.kernel_common import (
        prepare_shard_stim_constants)
    from crdmodel_tpu_torch.parallel.sharded import mesh_pad_spec
    bufs, consts = shard_inputs(problem, mesh, y_np, dtype, halo, constants)
    return bufs, consts, prepare_shard_stim_constants(
        problem, mesh, mesh_pad_spec(problem.cfg, mesh), halo, dtype)


def forced_shard_kernel(key, problem):
    """(step, plain version, plain partial sums, halo, constants(problem,
    mesh, pad, halo, dtype), device tag, source) of shard kernel `key`."""
    from crdmodel_tpu_torch.ops import erk_slots
    from crdmodel_tpu_torch.ops import fused_shard_divform as f11
    from crdmodel_tpu_torch.ops import fused_shard_imex as f10
    from crdmodel_tpu_torch.ops import fused_shard_rkc as f9
    from crdmodel_tpu_torch.ops import fused_shard_step as f8
    from crdmodel_tpu_torch.ops.kernel_common import (
        make_shard_constants, make_shard_divform_constants)
    if key == "k8":
        return (f8.fused_shard_step, f8.fused_shard_step_reference,
                f8.fused_shard_step_tile_sums, f8.HALO, make_shard_constants,
                erk_slots.SLOTS_KERNEL, "fused_shard_step.cu")
    if key == "k9":
        return (f9.fused_shard_rkc_step, f9.fused_shard_rkc_step_reference,
                f9.fused_shard_rkc_tile_sums, f9.P_RKC, make_shard_constants,
                "fused_rkc_chunk_kernel", "fused_shard_rkc.cu")
    if key == "k10":
        return (f10.fused_shard_imex_step,
                f10.fused_shard_imex_step_reference,
                f10.fused_shard_imex_tile_sums, f10.HALO,
                make_shard_constants, "fused_imex_slots_kernel",
                "fused_shard_imex.cu")
    aniso = problem.diffusion_tensor is not None
    return (f11.fused_shard_divform_step,
            f11.fused_shard_divform_step_reference,
            f11.fused_shard_divform_tile_sums, f11.HALO,
            lambda p, m, pad, halo, d: make_shard_divform_constants(
                p, m, pad, halo, d, aniso=aniso),
            erk_slots.SLOTS_KERNEL, "fused_shard_divform.cu")


def forced_shard_variants(key, problem, frc, y, t, seg, dtype):
    """[(fields, h, args(buf, fz, sc, stim))] of shard kernel `key`'s
    forced launches: K8 and K11 bs32 and dopri54, K10 each h of K3_H, K9
    each s of K9_FORCED_STAGES (h as in check_rkc_kernel), each with the
    step's amplitudes (kernel_common.stage_amplitudes, fused_rkc.
    stage_times_amplitudes) on the card."""
    from crdmodel_tpu_torch.integrate import imex
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import fused_rkc as fr
    from crdmodel_tpu_torch.ops.kernel_common import stage_amplitudes
    cfg = problem.cfg
    params = {"_seg_end": seg}
    out = []
    if key == "k9":
        mu1, ctab, ctimes = fr.static_stage_tables(
            fr.S_MAX_KERNEL, dtype, "cuda", with_times=True)
        rho = problem_rho(problem, y)
        for s in K9_FORCED_STAGES:
            h, st = rkc_step_inputs(s, rho, dtype)
            amps = fr.stage_times_amplitudes(frc, t, h, st, ctimes, params,
                                             dtype)
            out.append((dict(s=s, chunks=len(fr.chunk_schedule(s)),
                             amp_columns=amps.shape[1]),
                        lambda buf, fz, sc, stim, h=h, st=st, a=amps: (
                            buf, h, fz, st, mu1, ctab, sc, cfg.rtol,
                            cfg.atol, stim, a)))
        return out
    if key == "k10":
        for h_val in K3_H:
            h = torch.tensor(h_val, dtype=dtype, device="cuda")
            amps = stage_amplitudes(frc, t, h, torch.tensor(
                imex.C, dtype=dtype, device="cuda"), params, dtype)
            out.append((dict(h=h_val),
                        lambda buf, fz, sc, stim, h=h, a=amps: (
                            buf, h, fz, sc, cfg.rtol, cfg.atol, stim, a)))
        return out
    h = torch.tensor(H if key == "k8" else K4_H, dtype=dtype, device="cuda")
    for method in ("bs32", "dopri54"):
        tab = TABLEAUS[method]
        amps = stage_amplitudes(frc, t, h, torch.tensor(
            tab.c, dtype=dtype, device="cuda"), params, dtype)
        out.append((dict(method=method),
                    lambda buf, fz, sc, stim, tab=tab, a=amps: (
                        buf, h, fz, sc, tab, cfg.rtol, cfg.atol, stim, a)))
    return out


def check_forced_shard_kernels(cases, seed):
    """K8-K11 with a structured forcing against their plain versions on
    FORCED_MESHES' shards of each case (mesh_forced_cases), f32 and f64,
    with its freeze scalars, inside a pulse: y_new's block and every partial sum bitwise
    (check_shard_pair with the plain partial sums), two launches bitwise;
    each case's first f32 launch of each scheme (K8's and K11's bs32 and
    dopri54 kernels, K9's and K10's one) traced to the forced
    instantiation. Prints phases k8_forced_check .. k11_forced_check;
    returns {kernel: its max errors}."""
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import erk_slots
    rng = np.random.default_rng(seed)
    worst = {}
    for key, label, cfg, build_kw, frc, (t_val, seg_val) in cases:
        problem = build_problem(cfg, "cuda", forcing=frc, **build_kw)
        step, reference, tile_sums, halo, constants, tag, _ = (
            forced_shard_kernel(key, problem))
        y_np = random_state(cfg, tuple(problem.y0.shape), rng)
        w = worst.setdefault(key, {torch.float32: 0.0, torch.float64: 0.0})
        name = f"{key}_forced_check"
        traced = {}     # the traced kernel of each of the case's schemes
        for shape, shards, fzs in FORCED_MESHES:
            mesh = shard_mesh(shape)
            for dtype in (torch.float32, torch.float64):
                bufs, consts, stims = shard_stim_inputs(
                    problem, mesh, y_np, dtype, halo, constants)
                y = torch.tensor(y_np, dtype=dtype, device="cuda")
                t, seg = (torch.tensor(v, dtype=dtype, device="cuda")
                          for v in (t_val, seg_val))
                for fields, make in forced_shard_variants(
                        key, problem, frc, y, t, seg, dtype):
                    method = fields.get("method")
                    want = (erk_slots.kernel_name(TABLEAUS[method])
                            if method else tag)
                    if dtype == torch.float32 and want not in traced:
                        zero = torch.zeros((), dtype=dtype, device="cuda")
                        args = make(bufs[shards[0]], zero, consts[shards[0]],
                                    stims[shards[0]])
                        traced[want] = check_forced_trace(
                            name, lambda: step(*args), want)
                    for fz in fzs:
                        fzt = torch.tensor(fz, dtype=dtype, device="cuda")
                        for k in shards:
                            args = make(bufs[k], fzt, consts[k], stims[k])
                            err = check_shard_pair(
                                name, dict(
                                    case=label, model=cfg.model,
                                    surface=cfg.surface, mesh=list(shape),
                                    shard=k, shape=list(bufs[k].shape),
                                    valid=[consts[k].valid_rows,
                                           consts[k].valid_cols],
                                    **fields, fz=fz, t=t_val, seg_end=seg_val,
                                    n_stim=stims[k].n_stim,
                                    traced_f32_kernel=traced.get(want)),
                                step, reference, args, dtype, tile_sums)
                            w[dtype] = max(w[dtype], err)
                del bufs, consts, stims
        del problem
    return worst


def shard_kernels_a_step(problem, mesh, build, t, h, seg):
    """The device kernels of one call of the sharded step_err that
    build(problem, pad_spec) makes on `mesh` (the exchange, the
    amplitudes and a launch a shard), with the problem's forcing and
    without it: {"forced": n, "unforced": n}."""
    from crdmodel_tpu_torch.ops import trace
    from crdmodel_tpu_torch.parallel.sharded import (mesh_pad_spec,
                                                     shard_params,
                                                     sharded_params,
                                                     split_state)
    cfg = problem.cfg
    pad = mesh_pad_spec(cfg, mesh)
    out = {}
    for label, prob in (("forced", problem),
                        ("unforced", dataclasses.replace(problem,
                                                         forcing=None))):
        fused = build(prob, pad)
        params = {**shard_params(sharded_params(prob, pad), mesh, pad, cfg),
                  "_seg_end": seg}
        yp = fused.pad(split_state(prob.y0, mesh, pad, cfg))
        out[label] = len(trace.kernel_names(
            lambda: fused.step_err(t, yp, h, params), n=1))
    return out


def mesh_forced_timings(cases, card):
    """Each forced shard kernel timed forced and unforced in one call on
    shard 0 of its case's 2x2 mesh (forced_timing with shard_bound: the
    forcing's bytes and operations added), from the ICs, f32, unfrozen,
    inside the case's pulse: K8 and K11 bs32, K10 at K3_H[0], K9 smooth at
    K9_FORCED_TIMED; with the kernels a step of a sharded step_err and
    ptxas's forced and unforced registers and spills. Prints phases
    k8_forced_timing .. k11_forced_timing; returns {(kernel, label, s):
    (forced timing, unforced ms)}."""
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.integrate import imex
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import fused_rkc as fr
    from crdmodel_tpu_torch.ops import fused_shard_divform as f11
    from crdmodel_tpu_torch.ops import fused_shard_imex as f10
    from crdmodel_tpu_torch.ops import fused_shard_rkc as f9
    from crdmodel_tpu_torch.ops import fused_shard_step as f8
    from crdmodel_tpu_torch.ops.kernel_common import stage_amplitudes
    from crdmodel_tpu_torch.parallel.sharded import sharded_rho_bound
    dtype = torch.float32
    zero = torch.zeros((), device="cuda")
    mesh = shard_mesh(SHARD_MESH)
    tab = TABLEAUS["bs32"]
    out = {}
    for key, label, cfg, build_kw, frc, window in cases:
        if label == "paced_fhn_gated":
            continue
        cfg = dataclasses.replace(cfg, t_boundary=0.0)
        problem = build_problem(cfg, "cuda", forcing=frc, **build_kw)
        step, reference, _, halo, constants, tag, source = (
            forced_shard_kernel(key, problem))
        bufs, consts, stims = shard_stim_inputs(
            problem, mesh, problem.y0.cpu().numpy(), dtype, halo, constants)
        buf, sc, stim = bufs[0], consts[0], stims[0]
        t, seg = (torch.tensor(v, device="cuda") for v in window)
        rtol, atol = cfg.rtol, cfg.atol
        if key == "k9":
            mu1, ctab, ctimes = fr.static_stage_tables(
                fr.S_MAX_KERNEL, dtype, "cuda", with_times=True)
            tables = sum(x.numel() * x.element_size() for x in (mu1, ctab))
            rho = problem_rho(problem, problem.y0)
            per_step = shard_kernels_a_step(
                problem, mesh, lambda p, pad: f9.build_fused_shard_rkc(
                    p, mesh, sharded_rho_bound(p, mesh, pad), pad),
                t, rkc_step_inputs(max(K9_FORCED_TIMED), rho, dtype)[0], seg)
            for s in K9_FORCED_TIMED:
                h, st = rkc_step_inputs(s, rho, dtype)
                amps = fr.stage_times_amplitudes(frc, t, h, st, ctimes,
                                                 {"_seg_end": seg}, dtype)
                base = (buf, h, zero, st, mu1, ctab, sc, rtol, atol)
                out[key, label, s] = forced_timing(
                    f"{key}_forced_timing", buf, sc, stim, amps,
                    lambda: step(*base, stim, amps), lambda: step(*base),
                    lambda: reference(*base, stim, amps), tag,
                    rkc_ops(sc, s), s + 1, tables, per_step, source, card,
                    bound_of=shard_bound, case=label, s=s,
                    chunks=len(f9.extent_rings(s)))
            continue
        if key == "k10":
            h = torch.tensor(K3_H[0], device="cuda")
            c_nodes, ops, n_evals = imex.C, imex_ops(sc), imex.STAGES
            base = (buf, h, zero, sc, rtol, atol)

            def build(p, pad):
                return f10.build_fused_shard_imex(p, mesh, pad)
        else:
            h = torch.tensor(H if key == "k8" else K4_H, device="cuda")
            c_nodes, ops, n_evals = tab.c, erk_ops(sc, tab), tab.stages
            base = (buf, h, zero, sc, tab, rtol, atol)

            if key == "k8":
                def build(p, pad):
                    return f8.build_fused_shard_step(p, tab, mesh, pad)
            else:
                def build(p, pad, aniso=problem.diffusion_tensor is not None):
                    return f11.build_fused_shard_divform(p, tab, mesh, pad,
                                                         aniso=aniso)
        amps = stage_amplitudes(frc, t, h, torch.tensor(
            c_nodes, dtype=dtype, device="cuda"), {"_seg_end": seg}, dtype)
        out[key, label, None] = forced_timing(
            f"{key}_forced_timing", buf, sc, stim, amps,
            lambda: step(*base, stim, amps), lambda: step(*base),
            lambda: reference(*base, stim, amps), tag, ops, n_evals, 0,
            shard_kernels_a_step(problem, mesh, build, t, h, seg), source,
            card, bound_of=shard_bound, case=label, mode=sc.kind,
            h=float(h), window=list(window))
        del problem, bufs, consts, stims
    return out


def paced_sharded_fhn_rkc2(cfg, rkc2_probes, fprobes, mesh):
    """paced_sharded_fhn_rkc2: the paced canonical FHN torus with rkc2
    over its first PACED_RKC2_INTERVALS output intervals, through
    simulate_sharded() on `mesh` (K9, forced), held as
    main_path_sharded_fhn_rkc2 to this call's single-device forced run
    through K2 (run_sharded_rkc2: no golden holds the paced rkc2 run), and
    traced through K9's forced instantiation. Returns K9's launches."""
    n = PACED_RKC2_INTERVALS
    cfg = dataclasses.replace(cfg, method="rkc2",
                              t_final=cfg.t_final * n / cfg.output_timestep,
                              output_timestep=n)
    return run_sharded_rkc2(
        cfg, rkc2_probes, mesh, "paced_sharded_fhn_rkc2",
        build_kw=dict(forcing=golden_forcing(fprobes["canonical_fhn_paced"])),
        label="data/FHNmodelArgs.ini fhn torus rkc2, the paced golden's "
              f"stimuli (two S1 pulses, a sinusoid), Tf={cfg.t_final}",
        report=traced_path("fused_rkc_chunk_kernel", True, mesh=mesh))


def mesh_forced_paths(cfg, cfg_gb, cfg_ap, ap_build, fprobes, probes,
                      singles):
    """The paced paths on one card's 2x2 mesh of shards at full grid size,
    each through the kernel named (launch counts, and a traced short run
    of the same problem through its forced instantiation) and held to its
    JAX CPU golden and to this call's single-device forced run (`singles`,
    forced_main_paths' keep): the paced FHN torus
    (paced_sharded_fhn_bs32, K8), Goldbeter torus with ark324
    (paced_sharded_goldbeter_ark324, K10), bounded tissue with its scar
    checks (paced_sharded_bounded_ap_bs32, K11) and the paced FHN torus
    with rkc2 over its first PACED_RKC2_INTERVALS output intervals
    (paced_sharded_fhn_rkc2, K9; held to a single-device K2 run instead).
    Returns {name: launches}."""
    from crdmodel_tpu_torch.ops import (fused_shard_divform,
                                        fused_shard_imex, fused_shard_step)
    mesh = shard_mesh(SHARD_MESH)
    tag = "fused_erk_slots_kernel"
    launches = {}
    paced = fprobes["canonical_fhn_paced"]
    launches["paced_sharded_fhn_bs32"] = run_main_path(
        cfg, paced, fused_shard_step.fused_shard_step, 0.01,
        "paced_sharded_fhn_bs32",
        "data/FHNmodelArgs.ini fhn torus, two S1 pulses (t=2, 20, "
        "duration 1, amplitude 1) on rows ny/8..ny/4 and 0.1 sin(2 pi t / "
        "12.5) on a Gaussian column band",
        build_kw=dict(forcing=golden_forcing(paced)), mesh=mesh,
        versus=singles["paced_fhn_bs32"],
        report=traced_path(tag, True, mesh=mesh))
    gb = fprobes["canonical_goldbeter_ark324_paced"]
    launches["paced_sharded_goldbeter_ark324"] = run_main_path(
        dataclasses.replace(cfg_gb, method="ark324"), gb,
        fused_shard_imex.fused_shard_imex_step, 0.01,
        "paced_sharded_goldbeter_ark324",
        "data/GoldbeterModelArgs.ini goldbeter torus ark324, pulses at "
        "t=0.5, 2 (duration 0.25, amplitude 0.5) on columns 0..nx/4",
        build_kw=dict(forcing=golden_forcing(gb)), mesh=mesh,
        versus=singles["paced_goldbeter_ark324"],
        report=traced_path("fused_imex_slots_kernel", True, mesh=mesh))
    ap = fprobes["bounded_ap_paced"]
    launches["paced_sharded_bounded_ap_bs32"] = run_main_path(
        cfg_ap, ap, fused_shard_divform.fused_shard_divform_step, 0.01,
        "paced_sharded_bounded_ap_bs32",
        "scripts/bench_suite.py::bounded_tissue aliev_panfilov flat, noflux "
        "walls + circular scar, s1s2_protocol S1 t=0.5 S2 t=4 amplitude 3 "
        "duration 0.5",
        build_kw=dict(ap_build, forcing=golden_forcing(ap)),
        extra_checks=scar_checks(ap, ap_build["obstacle_mask"]), mesh=mesh,
        versus=singles["paced_bounded_ap_bs32"],
        report=traced_path(tag, True, mesh=mesh))
    launches["paced_sharded_fhn_rkc2"] = paced_sharded_fhn_rkc2(
        cfg, probes["fhn", "rkc2"], fprobes, mesh)
    return launches


def mesh_forced_phases(cfg, cfg_gb, cfg_ap, ap_build, cfg_torus,
                       torus_build, probes, singles, card):
    """Forcing on a mesh: the forced shard kernels' checks
    (check_forced_shard_kernels) and timings (mesh_forced_timings), then
    the paced paths on a 2x2 mesh (mesh_forced_paths). Returns each shard
    kernel entry's forced fields (forced_fields), by the entry's name; no
    forced path drives K11's aniso mode, so its forced launches are
    None."""
    fprobes = load_forced_probes()
    cases = mesh_forced_cases(cfg, cfg_gb, cfg_ap, ap_build, cfg_torus,
                              torus_build, fprobes)
    worst = check_forced_shard_kernels(cases, SEED + 14)
    timings = mesh_forced_timings(cases, card)
    n = mesh_forced_paths(cfg, cfg_gb, cfg_ap, ap_build, fprobes, probes,
                          singles)
    return {
        "fused_shard_step": forced_fields(
            worst["k8"], *timings["k8", "paced_fhn", None],
            n["paced_sharded_fhn_bs32"]),
        "fused_shard_rkc_step": forced_fields(
            worst["k9"], *timings["k9", "paced_fhn_smooth",
                                  max(K9_FORCED_TIMED)],
            n["paced_sharded_fhn_rkc2"]),
        "fused_shard_imex_step": forced_fields(
            worst["k10"], *timings["k10", "paced_goldbeter", None],
            n["paced_sharded_goldbeter_ark324"]),
        "fused_shard_divform_step": forced_fields(
            worst["k11"], *timings["k11", "paced_bounded_ap", None],
            n["paced_sharded_bounded_ap_bs32"]),
        "fused_shard_divform_step (aniso mode)": forced_fields(
            worst["k11"], *timings["k11", "torus_fibres_s1s2", None], None)}


# ---------------------------------------------------------------------------
# Forcing on the box: K6, K7, K12 and K13 forced, and the paced slab


PACED_BOX_LABEL = (BOX_LABEL + ", paced as scripts/bench_round5.py:144-151 "
                   "(S1 at t=0.05, 0.3, duration 0.08, on rows 0..ny/8 with "
                   "a Gaussian depth profile; 0.3 cos(4t) on columns "
                   "0..nx/2)")
# (t, seg_end) of the forced box checks' and timings' steps: in the first
# S1 pulse of box_forcing, beside its smooth drive
BOX_WINDOW = (0.06, 0.09)
# K7's and K13's forced variants: (smooth, s) - the smooth table's columns
# at K7_STAGES' stage counts, the gated table's one column at s = 5
BOX_RKC_VARIANTS = ((True, 2), (True, 5), (True, 7), (False, 5))


def cosine_wave(amplitude, omega):
    """amp cos(omega t) on the device, elementwise: the torch twin of the
    box protocol's smooth drive (scripts/bench_round5.py:150)."""
    def waveform(t, seg_end=None):
        return amplitude * torch.cos(omega * t)
    return waveform


def box_forcing(cfg, cross=False):
    """The JAX package's own box pacing protocol (scripts/bench_round5.py:
    144-151) on cfg's box, copied: S1, pulse_train([0.05, 0.3], 0.08, 1.0)
    on rows [0, ny/8) with the depth profile gaussian_profile(nz, 0, 2),
    and a drive 0.3 cos(4t) on columns [0, nx/2), both on variable 0; with
    `cross` also CROSS_DRIVE on variable 1 (cross_drive), so that a kernel
    check forces both variables."""
    from crdmodel_tpu_torch.convert import forcing_from_numpy
    from crdmodel_tpu_torch.core.forcing import gaussian_profile, rect_profile
    stimuli = [dict(var=0, row=rect_profile(cfg.ny, 0, cfg.ny // 8),
                    zprof=gaussian_profile(cfg.nz, 0.0, 2.0),
                    pulses=([0.05, 0.3], 0.08, 1.0)),
               dict(var=0, col=rect_profile(cfg.nx, 0, cfg.nx // 2),
                    waveform=cosine_wave(0.3, 4.0))]
    if cross:
        stimuli.append(cross_drive(cfg))
    return forcing_from_numpy(stimuli)


def box_rkc_forcing(cfg, smooth):
    """box_forcing with the cross drive, or without `smooth` its pulse train
    alone (every stimulus segment-gated: one amplitude column)."""
    frc = box_forcing(cfg, cross=True)
    if smooth:
        return frc
    from crdmodel_tpu_torch.core.forcing import SeparableForcing
    return SeparableForcing(frc.stimuli[0])


def box_forced_cases(cfg_box):
    """The forced box checks' cases, (label, config, build arguments,
    planes) of check_box_kernels: the slab's shape in the profile mode
    (the noflux slab) and the tensor mode (the transmural tensor), each
    with a freeze, and stream_edge_boxes."""
    modes = {label: (c, kw) for label, c, kw in box_modes(cfg_box)}
    return [(label, dataclasses.replace(modes[label][0], t_boundary=0.1),
             modes[label][1], None)
            for label in ("noflux_slab", "transmural_tensor")] + (
        stream_edge_boxes(cfg_box))


def box_stim(problem, dtype, planes=None):
    """The problem's StimConstants on the card, its depth table cut to the
    first `planes` planes with the constants (box_stream.box_planes)."""
    from crdmodel_tpu_torch.ops.kernel_common import prepare_stim_constants
    stim = prepare_stim_constants(problem, dtype, "cuda")
    if planes is None:
        return stim
    return dataclasses.replace(stim, z=stim.z[:, :planes].contiguous())


def box_amps(frc, dtype, h, tab=None, s=None, ctimes=None):
    """The amplitude table of a forced box step at BOX_WINDOW on the card:
    an ERK tableau's stages (stage_amplitudes), or an RKC2 step of s stages
    on the stage-time table ctimes (fused_rkc.stage_times_amplitudes)."""
    from crdmodel_tpu_torch.ops.fused_rkc import stage_times_amplitudes
    from crdmodel_tpu_torch.ops.kernel_common import stage_amplitudes
    t, seg = (torch.tensor(v, dtype=dtype, device="cuda")
              for v in BOX_WINDOW)
    if tab is not None:
        return stage_amplitudes(frc, t, h, torch.tensor(
            tab.c, dtype=dtype, device="cuda"), {"_seg_end": seg}, dtype)
    return stage_times_amplitudes(frc, t, h, s, ctimes, {"_seg_end": seg},
                                  dtype)


def check_forced_box_kernels(cases, seed):
    """K6 (bs32 and dopri54) and K7 (BOX_RKC_VARIANTS) with box_forcing and
    the cross drive against their plain versions on each case of
    box_forced_cases, f32 and f64, in BOX_WINDOW, fz 0 and 1 (K7: the
    variants alternate): y_new bitwise, two launches bitwise, every
    partial sum of the stream schemes bitwise (fused_box3d_tile_sums,
    fused_box3d_rkc_tile_sums); each scheme's forced instantiation traced
    once in f32 (check_forced_trace). Prints phases k6_forced_check and
    k7_forced_check; returns the max errors of K6 and of K7."""
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import box_stream
    from crdmodel_tpu_torch.ops import fused_box3d as fb
    from crdmodel_tpu_torch.ops import fused_box3d_rkc as fk
    from crdmodel_tpu_torch.ops.fused_rkc import (stage_times_table,
                                                  static_stage_tables)
    from crdmodel_tpu_torch.ops.kernel_common import prepare_box_constants

    rng = np.random.default_rng(seed)
    worst6 = {torch.float32: 0.0, torch.float64: 0.0}
    worst7 = {torch.float32: 0.0, torch.float64: 0.0}
    traced = {}         # a scheme's tag: the forced kernel traced
    for label, cfg, build_kw, planes in cases:
        problems = {smooth: build_problem(
            cfg, device="cuda", forcing=box_rkc_forcing(cfg, smooth),
            **build_kw) for smooth in (True, False)}
        shape = tuple(problems[True].y0.shape)
        if planes is not None:
            shape = (2, planes, *shape[2:])
        y_np = random_state(cfg, shape, rng)
        for dtype in (torch.float32, torch.float64):
            problem = problems[True]
            bc = prepare_box_constants(problem, dtype, "cuda")
            if planes is not None:
                bc = box_stream.box_planes(bc, planes)
            y = torch.tensor(y_np, dtype=dtype, device="cuda")
            h = torch.tensor(BOX_H, dtype=dtype, device="cuda")
            fields = dict(case=label, model=cfg.model, mode=bc.kind,
                          shape=list(y.shape), window=list(BOX_WINDOW))
            stim = box_stim(problem, dtype, planes)
            for method in ("bs32", "dopri54"):
                tab = TABLEAUS[method]
                amps = box_amps(problem.forcing, dtype, h, tab=tab)
                tag = box_stream.kernel_name(tab)
                for fz in (0.0, 1.0):
                    fzt = torch.tensor(fz, dtype=dtype, device="cuda")
                    args = (y, h, fzt, bc, tab, cfg.rtol, cfg.atol, stim,
                            amps)
                    if dtype == torch.float32 and tag not in traced:
                        traced[tag] = check_forced_trace(
                            "k6_forced_check",
                            lambda: fb.fused_box3d_step(*args), tag)
                    err = check_pair(
                        "k6_forced_check",
                        dict(fields, method=method, fz=fz,
                             n_stim=stim.n_stim),
                        *fb.fused_box3d_step(*args),
                        *fb.fused_box3d_step(*args),
                        *fb.fused_box3d_step_reference(*args), dtype, y,
                        bitwise=True,
                        ss_tiles=(fb.fused_box3d_tile_sums(*args)
                                  if box_stream.uses_stream(tab) else None))
                    worst6[dtype] = max(worst6[dtype], err)
            if planes is not None:
                continue        # K7 takes a configuration's box: nz >= 3
            mu1, ctab = static_stage_tables(fk.C_RKC, dtype, "cuda")
            ctimes = stage_times_table(fk.C_RKC, dtype, "cuda")
            rho = problem_rho(problem, y)
            tag = box_stream.rkc_kernel_name(bc.kind)
            for i, (smooth, s) in enumerate(BOX_RKC_VARIANTS):
                hs, st = rkc_step_inputs(s, rho, dtype)
                frc = problems[smooth].forcing
                stim = box_stim(problems[smooth], dtype)
                amps = box_amps(frc, dtype, hs, s=st, ctimes=ctimes)
                fz = float(i % 2)
                fzt = torch.tensor(fz, dtype=dtype, device="cuda")
                args = (y, hs, fzt, st, mu1, ctab, bc, cfg.rtol, cfg.atol,
                        stim, amps)
                if dtype == torch.float32 and tag not in traced:
                    traced[tag] = check_forced_trace(
                        "k7_forced_check",
                        lambda: fk.fused_box3d_rkc_step(*args), tag)
                err = check_pair(
                    "k7_forced_check",
                    dict(fields, s=s, smooth=smooth, fz=fz,
                         n_stim=stim.n_stim, amp_columns=amps.shape[1]),
                    *fk.fused_box3d_rkc_step(*args),
                    *fk.fused_box3d_rkc_step(*args),
                    *fk.fused_box3d_rkc_step_reference(*args), dtype, y,
                    bitwise=True,
                    ss_tiles=(fk.fused_box3d_rkc_tile_sums(*args)
                              if box_stream.rkc_uses_stream(bc.kind)
                              else None))
                worst7[dtype] = max(worst7[dtype], err)
            del y, bc
        del problems
    phase("box_forced_traces", kernels=traced)
    return worst6, worst7


def check_forced_shard_box_kernels(cases, seed):
    """K12 (bs32 and dopri54) and K13 (BOX_RKC_VARIANTS) with box_forcing
    and the cross drive against their plain versions on the shards of each
    (label, config, build arguments, mesh shape, shards checked) of
    `cases`, f32 and f64, in BOX_WINDOW, fz 0 and 1 (K13: the variants
    alternate): y_new's block and every partial sum of the stream schemes
    bitwise, two launches bitwise; each scheme's forced instantiation
    traced once in f32. Prints phases k12_forced_check and
    k13_forced_check; returns the max errors of K12 and of K13."""
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import box_stream
    from crdmodel_tpu_torch.ops import fused_shard_box3d as f12
    from crdmodel_tpu_torch.ops import fused_shard_box3d_rkc as f13
    from crdmodel_tpu_torch.ops.fused_rkc import (stage_times_table,
                                                  static_stage_tables)
    from crdmodel_tpu_torch.ops.kernel_common import make_shard_box_constants

    from crdmodel_tpu_torch.ops.kernel_common import (
        prepare_shard_stim_constants)
    from crdmodel_tpu_torch.parallel.sharded import mesh_pad_spec

    rng = np.random.default_rng(seed)
    worst12 = {torch.float32: 0.0, torch.float64: 0.0}
    worst13 = {torch.float32: 0.0, torch.float64: 0.0}
    traced = {}         # a scheme's tag: the forced kernel traced
    for label, cfg, build_kw, shape, shards in cases:
        mesh = shard_mesh(shape)
        problems = {smooth: build_problem(
            cfg, device="cuda", forcing=box_rkc_forcing(cfg, smooth),
            **build_kw) for smooth in (True, False)}
        y_np = random_state(cfg, tuple(problems[True].y0.shape), rng)
        for dtype in (torch.float32, torch.float64):
            bufs, consts = shard_inputs(problems[True], mesh, y_np, dtype,
                                        f12.HALO, make_shard_box_constants)
            stims = {smooth: prepare_shard_stim_constants(
                p, mesh, mesh_pad_spec(cfg, mesh), f12.HALO, dtype)
                for smooth, p in problems.items()}
            h = torch.tensor(BOX_H, dtype=dtype, device="cuda")
            fields = dict(case=label, model=cfg.model, mesh=list(shape),
                          mode=consts[0].kind, window=list(BOX_WINDOW))
            for method in ("bs32", "dopri54"):
                tab = TABLEAUS[method]
                amps = box_amps(problems[True].forcing, dtype, h, tab=tab)
                tag = box_stream.kernel_name(tab, shard=True)
                for fz in (0.0, 1.0):
                    fzt = torch.tensor(fz, dtype=dtype, device="cuda")
                    for k in shards:
                        args = (bufs[k], h, fzt, consts[k], tab, cfg.rtol,
                                cfg.atol, stims[True][k], amps)
                        if dtype == torch.float32 and tag not in traced:
                            traced[tag] = check_forced_trace(
                                "k12_forced_check",
                                lambda: f12.fused_shard_box3d_step(*args),
                                tag)
                        err = check_shard_pair(
                            "k12_forced_check",
                            dict(fields, shard=k, shape=list(bufs[k].shape),
                                 valid=[consts[k].valid_rows,
                                        consts[k].valid_cols],
                                 method=method, fz=fz,
                                 n_stim=stims[True][k].n_stim),
                            f12.fused_shard_box3d_step,
                            f12.fused_shard_box3d_step_reference, args,
                            dtype,
                            tile_sums=(f12.fused_shard_box3d_tile_sums
                                       if box_stream.uses_stream(tab)
                                       else None))
                        worst12[dtype] = max(worst12[dtype], err)
            mu1, ctab = static_stage_tables(f13.C_RKC, dtype, "cuda")
            ctimes = stage_times_table(f13.C_RKC, dtype, "cuda")
            rho = problem_rho(problems[True], torch.tensor(
                y_np, dtype=dtype, device="cuda"))
            tag = box_stream.rkc_kernel_name(consts[0].kind, shard=True)
            stream = box_stream.rkc_uses_stream(consts[0].kind)
            for i, (smooth, s) in enumerate(BOX_RKC_VARIANTS):
                hs, st = rkc_step_inputs(s, rho, dtype)
                stims_v = stims[smooth]
                amps = box_amps(problems[smooth].forcing, dtype, hs, s=st,
                                ctimes=ctimes)
                fz = float(i % 2)
                fzt = torch.tensor(fz, dtype=dtype, device="cuda")
                for k in shards:
                    args = (bufs[k], hs, fzt, st, mu1, ctab, consts[k],
                            cfg.rtol, cfg.atol, stims_v[k], amps)
                    if dtype == torch.float32 and tag not in traced:
                        traced[tag] = check_forced_trace(
                            "k13_forced_check",
                            lambda: f13.fused_shard_box3d_rkc_step(*args),
                            tag)
                    err = check_shard_pair(
                        "k13_forced_check",
                        dict(fields, shard=k, shape=list(bufs[k].shape),
                             valid=[consts[k].valid_rows,
                                    consts[k].valid_cols],
                             s=s, smooth=smooth, fz=fz,
                             n_stim=stims_v[k].n_stim,
                             amp_columns=amps.shape[1]),
                        f13.fused_shard_box3d_rkc_step,
                        f13.fused_shard_box3d_rkc_step_reference, args,
                        dtype,
                        tile_sums=(f13.fused_shard_box3d_rkc_tile_sums
                                   if stream else None))
                    worst13[dtype] = max(worst13[dtype], err)
            del bufs, consts, stims
        del problems
    phase("shard_box_forced_traces", kernels=traced)
    return worst12, worst13


def box_forced_timings(cfg_box, card):
    """K6 (bs32), K7 (smooth, each s of K7_TIMED_STAGES), K12 (bs32) and
    K13 (smooth, s of K7_TIMED_STAGES) forced and unforced in one call
    (forced_timing: the forced bound adds the profiles', the depth table's
    and the amplitudes' bytes and the stimuli's operations) on the paced
    slab's ICs in the profile mode, f32, unfrozen, in BOX_WINDOW: K6 and
    K7 at (2, 32, 512, 512), K12 and K13 on shard 0 of its 2x2 mesh, with
    the kernels of one step_err call forced and unforced. Prints phases
    k6_forced_timing .. k13_forced_timing; returns {(kernel, s):
    (forced timing, unforced ms)}."""
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import box_stream
    from crdmodel_tpu_torch.ops import fused_box3d as fb
    from crdmodel_tpu_torch.ops import fused_box3d_rkc as fk
    from crdmodel_tpu_torch.ops import fused_shard_box3d as f12
    from crdmodel_tpu_torch.ops import fused_shard_box3d_rkc as f13
    from crdmodel_tpu_torch.ops.fused_rkc import (stage_times_table,
                                                  static_stage_tables)
    from crdmodel_tpu_torch.ops.kernel_common import (
        make_shard_box_constants, prepare_box_constants)
    from crdmodel_tpu_torch.parallel.sharded import sharded_rho_bound
    dtype = torch.float32
    zero = torch.zeros((), device="cuda")
    t, seg = (torch.tensor(v, device="cuda") for v in BOX_WINDOW)
    tab = TABLEAUS["bs32"]
    mesh = shard_mesh(SHARD_MESH)
    out = {}
    for method in ("bs32", "rkc2"):
        cfg = dataclasses.replace(cfg_box, method=method)
        frc = box_forcing(cfg)
        problem = build_problem(cfg, "cuda", forcing=frc)
        y = problem.y0.contiguous()
        bc = prepare_box_constants(problem, dtype, "cuda")
        stim = box_stim(problem, dtype)
        bufs, consts, stims = shard_stim_inputs(
            problem, mesh, y.cpu().numpy(), dtype, f12.HALO,
            make_shard_box_constants)
        buf, sc, sstim = bufs[0], consts[0], stims[0]
        h = torch.tensor(BOX_H, device="cuda")
        if method == "bs32":
            amps = box_amps(frc, dtype, h, tab=tab)
            base = (y, h, zero, bc, tab, cfg.rtol, cfg.atol)
            out["k6", None] = forced_timing(
                "k6_forced_timing", y, bc, stim, amps,
                lambda: fb.fused_box3d_step(*base, stim, amps),
                lambda: fb.fused_box3d_step(*base),
                lambda: fb.fused_box3d_step_reference(*base, stim, amps),
                box_stream.STREAM_KERNEL, erk_ops(bc, tab), tab.stages, 0,
                kernels_a_step(problem, lambda p: fb.build_fused_box3d_step(
                    p, tab), t, y, h, seg),
                ("fused_box3d.cu", "fused_box3d_forced.cu"), card,
                timed=BOX_PLAIN_TIMED, mode=bc.kind, method="bs32",
                window=list(BOX_WINDOW))
            sbase = (buf, h, zero, sc, tab, cfg.rtol, cfg.atol)
            out["k12", None] = forced_timing(
                "k12_forced_timing", buf, sc, sstim, amps,
                lambda: f12.fused_shard_box3d_step(*sbase, sstim, amps),
                lambda: f12.fused_shard_box3d_step(*sbase),
                lambda: f12.fused_shard_box3d_step_reference(*sbase, sstim,
                                                            amps),
                box_stream.STREAM_KERNEL, erk_ops(sc, tab), tab.stages, 0,
                shard_kernels_a_step(
                    problem, mesh, lambda p, pad: f12.build_fused_shard_box3d(
                        p, tab, mesh, pad), t, h, seg),
                ("fused_shard_box3d.cu", "fused_shard_box3d_forced.cu"),
                card, bound_of=shard_bound, timed=BOX_PLAIN_TIMED,
                mode=sc.kind, method="bs32", mesh=list(SHARD_MESH),
                window=list(BOX_WINDOW))
            continue
        mu1, ctab = static_stage_tables(fk.C_RKC, dtype, "cuda")
        ctimes = stage_times_table(fk.C_RKC, dtype, "cuda")
        tables = sum(x.numel() * x.element_size() for x in (mu1, ctab))
        rho = problem_rho(problem, y)
        tag = box_stream.rkc_kernel_name(bc.kind)
        stag = box_stream.rkc_kernel_name(sc.kind, shard=True)
        group = 1 if not box_stream.rkc_uses_stream(bc.kind) else (
            box_stream.rkc_launches(fk.C_RKC))
        h_max = rkc_step_inputs(max(K7_TIMED_STAGES), rho, dtype)[0]
        per_step = kernels_a_step(
            problem, lambda p: fk.build_fused_box3d_rkc_step(
                p, dtype).step_err, t, y, h_max, seg)
        per_shard_step = shard_kernels_a_step(
            problem, mesh, lambda p, pad: f13.build_fused_shard_box3d_rkc(
                p, mesh, sharded_rho_bound(p, mesh, pad), pad), t, h_max,
            seg)
        for s in K7_TIMED_STAGES:
            hs, st = rkc_step_inputs(s, rho, dtype)
            amps = box_amps(frc, dtype, hs, s=st, ctimes=ctimes)
            base = (y, hs, zero, st, mu1, ctab, bc, cfg.rtol, cfg.atol)
            out["k7", s] = forced_timing(
                "k7_forced_timing", y, bc, stim, amps,
                lambda: fk.fused_box3d_rkc_step(*base, stim, amps),
                lambda: fk.fused_box3d_rkc_step(*base),
                lambda: fk.fused_box3d_rkc_step_reference(*base, stim,
                                                          amps),
                tag, rkc_ops(bc, s), s + 1, tables, per_step,
                ("fused_box3d_rkc.cu", "fused_box3d_rkc_forced.cu"), card,
                timed=BOX_PLAIN_TIMED, group=group, mode=bc.kind, s=s,
                amp_columns=amps.shape[1], window=list(BOX_WINDOW))
            sbase = (buf, hs, zero, st, mu1, ctab, sc, cfg.rtol, cfg.atol)
            out["k13", s] = forced_timing(
                "k13_forced_timing", buf, sc, sstim, amps,
                lambda: f13.fused_shard_box3d_rkc_step(*sbase, sstim, amps),
                lambda: f13.fused_shard_box3d_rkc_step(*sbase),
                lambda: f13.fused_shard_box3d_rkc_step_reference(
                    *sbase, sstim, amps),
                stag, rkc_ops(sc, s), s + 1, tables, per_shard_step,
                ("fused_shard_box3d_rkc.cu",
                 "fused_shard_box3d_rkc_forced.cu"), card,
                bound_of=shard_bound, timed=BOX_PLAIN_TIMED, group=group,
                mode=sc.kind, s=s, mesh=list(SHARD_MESH),
                amp_columns=amps.shape[1], window=list(BOX_WINDOW))
        del problem, y, bc, bufs, consts, stims
    return out


def paced_box_paths(cfg_box, unforced=None):
    """The paced slab (volumetric_box with box_forcing, nothing else
    changed) through simulate() on the card with bs32 (paced_box_bs32, K6)
    and rkc2 (paced_box_rkc2, K7), each held as run_box_path holds the
    unforced slab, to the port's torch path on the card in f32 and f64,
    and traced through the kernel's forced instantiation; then through
    simulate_sharded() on a 2x2 mesh of shards on cuda:0
    (paced_sharded_slab_bs32, K12; paced_sharded_slab_rkc2, K13), held as
    run_sharded_slab holds the unforced ones to the single-device paced
    run of this call (steps within 1%, rkc2 2.78%). `unforced`: the walls
    of this call's unforced slab runs, {phase name: wall s}, printed
    beside the paced ones (phase paced_box_walls). Returns the launches
    of K6, K7, K12 and K13."""
    from crdmodel_tpu_torch.ops import (box_stream, fused_box3d,
                                        fused_box3d_rkc, fused_shard_box3d,
                                        fused_shard_box3d_rkc)
    cfg_rkc = dataclasses.replace(cfg_box, method="rkc2")
    singles = {"bs32": {}, "rkc2": {}}
    walls = {}
    launches = {}
    launches["k6"] = run_box_path(
        "paced_box_bs32", cfg_box, dict(forcing=box_forcing(cfg_box)),
        fused_box3d.fused_box3d_step, PACED_BOX_LABEL + ", bs32", 0.01,
        keep=singles["bs32"],
        report=traced_path(box_stream.STREAM_KERNEL, True))
    launches["k7"] = run_box_path(
        "paced_box_rkc2", cfg_rkc, dict(forcing=box_forcing(cfg_rkc)),
        fused_box3d_rkc.fused_box3d_rkc_step, PACED_BOX_LABEL + ", rkc2",
        0.02, keep=singles["rkc2"],
        report=traced_path(box_stream.rkc_kernel_name("box_profile"), True))
    mesh = shard_mesh(SHARD_MESH)
    for key, cfg, kernel, want, tol, tag in (
            ("bs32", cfg_box, fused_shard_box3d.fused_shard_box3d_step,
             "K12", 0.01, box_stream.STREAM_KERNEL),
            ("rkc2", cfg_rkc, fused_shard_box3d_rkc.fused_shard_box3d_rkc_step,
             "K13", 0.0278,
             box_stream.rkc_kernel_name("box_profile", shard=True))):
        keep = {}
        launches["k12" if want == "K12" else "k13"] = run_sharded_slab(
            f"paced_sharded_slab_{key}", cfg, dict(forcing=box_forcing(cfg)),
            kernel, want, PACED_BOX_LABEL + f", {key}", mesh, singles[key],
            tol, keep=keep, report=traced_path(tag, True, mesh=mesh))
        walls[f"paced_sharded_slab_{key}"] = keep["wall_s"]
    walls.update({f"paced_box_{k}": v["wall_s"] for k, v in singles.items()})
    phase("paced_box_walls", paced=walls, unforced=unforced,
          card=card_line())
    return launches


def box_forced_phases(cfg_box, card, unforced=None):
    """Forcing on the box: the forced box kernels' checks
    (check_forced_box_kernels, check_forced_shard_box_kernels: the slab's
    2x2 shards 0 and 3 in the profile and tensor modes and fhn_box's
    uneven 1x3 mesh), their timings (box_forced_timings) and the paced
    slab's paths (paced_box_paths; `unforced`: this call's unforced slab
    walls). Returns each box kernel entry's forced fields
    (forced_fields), by the entry's name."""
    worst6, worst7 = check_forced_box_kernels(box_forced_cases(cfg_box),
                                              SEED + 16)
    shard_cases = [(label, c, kw, SHARD_MESH, (0, 3))
                   for label, c, kw, _ in box_forced_cases(cfg_box)[:2]]
    shard_cases.append(("fhn_beta_ramp_uneven_1x3", fhn_box(cfg_box), {},
                        UNEVEN_MESH, (0, 1, 2)))
    worst12, worst13 = check_forced_shard_box_kernels(shard_cases, SEED + 17)
    timings = box_forced_timings(cfg_box, card)
    n = paced_box_paths(cfg_box, unforced)
    s = max(K7_TIMED_STAGES)
    return {
        "fused_box3d_step": forced_fields(worst6, *timings["k6", None],
                                          n["k6"]),
        "fused_box3d_rkc_step": forced_fields(worst7, *timings["k7", s],
                                              n["k7"]),
        "fused_shard_box3d_step": forced_fields(
            worst12, *timings["k12", None], n["k12"]),
        "fused_shard_box3d_rkc_step": forced_fields(
            worst13, *timings["k13", s], n["k13"])}


# --- the six other kinetics families (K1, K2 and K3) --------------------

# the families beyond the base three (ops/kernel_common.py::NEW_FAMILIES),
# and their physics in the JAX package's soak matrix, which puts each in
# its interesting regime at 800x3200 (scripts/soak_matrix.py:27-32)
KIN_FAMILIES = ("barkley", "grayscott", "oregonator", "brusselator", "sir",
                "lambdaomega")
SOAK_PHYSICS = {
    "barkley": dict(beta=0.05, diffusion=1.0),
    "grayscott": dict(beta=0.03, diffusion=2e-5),
    "oregonator": dict(beta=1.5, diffusion=1.0),
    "brusselator": dict(beta=1.9, diffusion=0.2),
    "sir": dict(beta=1.5, diffusion=1.0),
    "lambdaomega": dict(beta=0.5, diffusion=0.5),
}
SOAK_METHODS = ("bs32", "rkc2", "ark324")
SOAK_LABEL = ("scripts/soak_matrix.py:27-32,51-56 {} torus 800x3200 {}, "
              "Tf cut 0.5 -> {}")
# the matrix's horizon, cut from its 0.5 (scripts/soak_matrix.py:38) to
# fit the script's time limit: the torch-path references take ~3 ms a
# bs32 step and ~40 ms an ark324 step at 2.56M points (PERF.md section 4)
SOAK_TF = 0.005
# the soak runs' step gates against the port's torch path in f32: bs32
# 1%, rkc2 the JAX f32-f64 rkc2 gap (2.78%, run_main_path), at least one
# step (14-50% of Gray-Scott's runs of 2-7 steps). ark324's run follows
# the order of its error's partial sums there (a third of its steps
# rejected at the explicit stages' stability edge; PERF.md section 6): the
# plain K3 with the torch path's one-sum order takes the torch path's
# steps and field, with the kernel's tile order the kernel's (2-7% fewer
# steps, fields 3e-4 to 0.017 apart), so ark324's steps and field are
# held to that plain run, exactly, and their distance to the torch path
# is printed
SOAK_STEP_TOL = {"bs32": 0.01, "rkc2": 0.0278}
# the kinetics kernels' checks: K2's stage counts (one chunk, two, four),
# and the explicit steps' h rho (inside bs32's, dopri54's and the ARK
# explicit part's stability; rho the RKC2 bound, problem_rho)
KIN_K2_STAGES = (2, 5, 7, 23)
KIN_H_RHO = 1.0
# operations a point, counted as KINETICS_OPS and JACOBIAN_OPS are, and
# the Cramer solve of 2 or 3 variables with the Newton's residual and
# update (imex_ops' 35 for two)
KINETICS_OPS.update(barkley=8, oregonator=10, grayscott=9, brusselator=8,
                    lambdaomega=14, sir=5)
JACOBIAN_OPS.update(barkley=15, oregonator=15, grayscott=8, brusselator=7,
                    lambdaomega=29, sir=5)
SOLVE_OPS = {2: 35, 3: 80}


def soak_cfg(model, method, **kw):
    """The soak matrix's run of `model` with `method`: an 800x3200 torus
    (2.56M points), Tf = SOAK_TF, f32 (scripts/soak_matrix.py:51-56)."""
    from crdmodel_tpu_torch.config import SimConfig
    return SimConfig(**{**dict(
        model=model, surface="torus", x_mesh=800, surface_width=20,
        surface_length=80, t_final=SOAK_TF, output_timestep=1,
        wave_length=0.2, wave_width=0.5, dtype="float32", rtol=1e-5,
        atol=1e-8, method=method), **SOAK_PHYSICS[model], **kw})


def family_state(model, shape, rng):
    """A random state of a family inside the range its runs visit."""
    lo, hi = {"barkley": ((0.0, 0.0), (1.0, 0.6)),
              "oregonator": ((0.002, 0.0), (0.9, 0.6)),
              "grayscott": ((0.2, 0.0), (1.0, 0.5)),
              "brusselator": ((0.5, 1.0), (1.5, 2.5)),
              "lambdaomega": ((-1.0, -1.0), (1.0, 1.0)),
              "sir": ((0.5, 0.0, 0.0), (1.0, 0.5, 0.5))}[model]
    return np.stack([rng.uniform(a, b, shape[1:]) for a, b in zip(lo, hi)])


def family_rhs_ops(kc):
    """Operations of one RHS evaluation of a family at a point: kinetics,
    the operator, its ratio and its sum on each diffusing variable, the
    freeze (live and a product a variable)."""
    model = kc.model
    ops = KINETICS_OPS[model.name] + sum(
        OPERATOR_OPS[kc.kind] + 1 + (r != 1.0)
        for r in model.diffusion_ratios)
    return ops + (3 + model.nvars if kc.has_freeze else 0)


def family_step_ops(kc, method, s=None):
    """Operations a point of one step of K1 (bs32), K2 (stage count s) or
    K3 on a family, as erk_ops, rkc_ops and imex_ops count them, a
    variable's share of each per-variable term taken nvars times."""
    from crdmodel_tpu_torch.integrate import imex
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    nv, nd = kc.model.nvars, len(kc.model.diffusive_vars)
    weights = 7 * nv
    rhs = family_rhs_ops(kc)
    if method == "rkc2":
        return (s + 1) * rhs + nv * (2 + 9 * (s - 1) + 5) + weights
    if method == "bs32":
        tab = TABLEAUS["bs32"]
        nnz = sum(int(np.count_nonzero(x))
                  for x in (tab.a, tab.b, tab.b - tab.bhat))
        return tab.stages * rhs + 2 * nv * nnz + weights
    freeze = 1 if kc.has_freeze else 0
    op = nd * (OPERATOR_OPS[kc.kind] + 1 + freeze)
    kin = KINETICS_OPS[kc.model.name] + nv * freeze
    newton = (JACOBIAN_OPS[kc.model.name] + nv * nv * freeze + kin
              + SOLVE_OPS[nv])
    known = sum((nd * 2) * (imex.AE[s_][j] != 0.0)
                + (nv * 2) * (imex.AI[s_][j] != 0.0)
                for s_ in range(imex.STAGES) for j in range(s_))
    nnz_bd = sum(int(x != 0.0) for x in (*imex.B, *imex.D))
    return (4 * op + kin + 3 * (2 * nv + 3 * newton + 2 * nv + weights)
            + known + 2 * nv + 2 * nv * nnz_bd + weights + 2)


def kin_steps(kc, y, rho, method, s=None):
    """(call, plain call, tile sums, args, kernel tag) of one K1 (bs32, or
    dopri54), K2 (stage count s, h its stability coverage) or K3 step of a
    family on y, unfrozen, h = KIN_H_RHO / rho for K1 and K3: the
    wrapper, its plain version, its partial sums' plain version, their
    arguments and the kernel's name."""
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import fused_imex as fi
    from crdmodel_tpu_torch.ops import fused_rkc as fr
    from crdmodel_tpu_torch.ops import fused_step as fs
    dev = dict(dtype=y.dtype, device="cuda")
    fz = torch.zeros((), **dev)
    h = torch.tensor(KIN_H_RHO / rho, **dev)
    if method == "rkc2":
        mu1, ctab = fr.static_stage_tables(fr.S_MAX_KERNEL, y.dtype, "cuda")
        h, st = rkc_step_inputs(s, rho, y.dtype)
        args = (y, h, fz, st, mu1, ctab, kc, 1e-5, 1e-8)
        return (fr.fused_rkc_step, fr.fused_rkc_step_reference,
                fr.fused_rkc_tile_sums, args, "fused_rkc_chunk_n_kernel")
    if method == "ark324":
        args = (y, h, fz, kc, 1e-5, 1e-8)
        return (fi.fused_imex_step, fi.fused_imex_step_reference,
                fi.fused_imex_tile_sums, args, "fused_imex_slots_n_kernel")
    args = (y, h, fz, kc, TABLEAUS[method], 1e-5, 1e-8)
    tag = ("fused_erk_slots_n_kernel" if method == "bs32"
           else "fused_erk_tile_n_kernel")
    return (fs.fused_step, fs.fused_step_reference, fs.fused_step_tile_sums,
            args, tag)


def check_kinetics_kernels():
    """Phase kinetics_kernels: each new family's K1 (bs32 and dopri54), K2
    (KIN_K2_STAGES) and K3 against their plain versions on the card, at
    the soak shape and on an odd 148x37 torus (partial tiles on both axes,
    a grid narrower than a K2 region, with a freeze), f32 and f64: y_new
    and every partial sum bitwise, two launches bitwise, each launch's
    kernel traced once at the soak shape (the families' kernel of the
    dispatch, ops/trace.py::kernel_names). Returns {kernel:
    {dtype: max |y_kernel - y_plain|}}."""
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.ops import trace
    from crdmodel_tpu_torch.ops.kernel_common import prepare_constants

    rng = np.random.default_rng(SEED + 22)
    worst = {k: {torch.float32: 0.0, torch.float64: 0.0}
             for k in ("k1", "k2", "k3")}
    runs = ([("k1", "bs32", None), ("k1", "dopri54", None)]
            + [("k2", "rkc2", s) for s in KIN_K2_STAGES]
            + [("k3", "ark324", None)])
    for model in KIN_FAMILIES:
        soak = soak_cfg(model, "bs32")
        for cfg in (soak, soak_cfg(model, "bs32", x_mesh=37,
                                   t_boundary=0.1)):
            problem = build_problem(cfg, device="cuda")
            y_np = family_state(model, tuple(problem.y0.shape), rng)
            for dtype in (torch.float32, torch.float64):
                kc = prepare_constants(problem, dtype, "cuda")
                y = torch.tensor(y_np, dtype=dtype, device="cuda")
                rho = problem_rho(problem, y)
                for kernel, method, s in runs:
                    call, plain, sums, args, tag = kin_steps(kc, y, rho,
                                                             method, s)
                    if dtype == torch.float32 and cfg is soak:
                        names = trace.kernel_names(lambda: call(*args), n=1)
                        if not all(tag in n for n in names):
                            raise AssertionError(
                                f"kinetics_kernels: {model} {method} ran "
                                f"{sorted(set(names))}, not {tag}")
                    err = check_pair(
                        "kinetics_kernels",
                        dict(model=model, kernel=kernel, method=method, s=s,
                             shape=list(y.shape), kernel_name=tag,
                             freeze=kc.has_freeze),
                        *call(*args), *call(*args), *plain(*args), dtype, y,
                        bitwise=True, ss_tiles=sums(*args))
                    worst[kernel][dtype] = max(worst[kernel][dtype], err)
    return worst


def kinetics_timing(card):
    """Phase kinetics_timing: each new family's K1 (bs32), K2 (s = 5 and
    23) and K3 launch at the soak shape from its IC, f32: device µs from
    profiler traces (device_ms), the plain version's (CUDA events), the
    bound from the family's bytes (nvars planes in and out) and
    operations (family_step_ops), the launched kernel's registers,
    blocks an SM and shared bytes, and ptxas's registers and spills of
    its instantiation. Returns {(model, kernel): (ms, plain ms, bound ms,
    bound_by)}."""
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.ops import erk_slots
    from crdmodel_tpu_torch.ops import fused_imex as fi
    from crdmodel_tpu_torch.ops import fused_rkc as fr
    from crdmodel_tpu_torch.ops.kernel_common import prepare_constants

    out = {}
    for model in KIN_FAMILIES:
        problem = build_problem(soak_cfg(model, "bs32"), device="cuda")
        kc = prepare_constants(problem, torch.float32, "cuda")
        y = problem.y0.contiguous()
        rho = problem_rho(problem, y)
        kid = kc.kinetics_id
        plan = fi.slots_plan(*y.shape[1:], 4, y.shape[0],
                             len(kc.model.diffusive_vars))
        for kernel, method, s, source, info in (
                ("k1", "bs32", None, "fused_step_families.cu",
                 lambda: erk_slots.kernel_info(
                     "crd_fused_erk_step_families_info", torch.float32,
                     kid)),
                ("k2", "rkc2", 5, "fused_rkc_families.cu",
                 lambda: fr.kernel_info(torch.float32, False, kid)),
                ("k2", "rkc2", 23, "fused_rkc_families.cu",
                 lambda: fr.kernel_info(torch.float32, False, kid)),
                ("k3", "ark324", None, "fused_imex_families.cu",
                 lambda: fi.kernel_info(torch.float32, kid, plan.tile_y))):
            call, plain, _, args, tag = kin_steps(kc, y, rho, method, s)
            extra = 0
            if method == "rkc2":
                extra = sum(t.numel() * t.element_size() for t in args[4:6])
            t = (device_ms(lambda: call(*args), tag),
                 median_ms(lambda: plain(*args), 10, 2),
                 *bound(y, kc, family_step_ops(kc, method, s), extra))
            out[model, kernel, s] = t
            phase("kinetics_timing", model=model, kernel=kernel,
                  method=method, s=s, shape=list(y.shape), dtype="float32",
                  kernel_us=t[0] * 1e3, plain_us=t[1] * 1e3,
                  bound_us=t[2] * 1e3, bound_by=t[3],
                  times_bound=t[0] / t[2], kernel_name=tag, **info(),
                  ptxas=[e for e in ptxas_entries(source, tag)
                         if e["kernel"].startswith(f"ILi{kid}E")],
                  card=card)
    return out


def k2_h_limit(rho_fn, dtype):
    """The h cap of K2's stage budget, STAB_FACTOR (S_MAX_KERNEL - 1)^2 /
    rho (ops/fused_rkc.py::build_fused_rkc_step's h_limit): the cap a
    torch-path rkc2 run takes to follow the kernel's step sequence."""
    from crdmodel_tpu_torch.integrate import rkc
    from crdmodel_tpu_torch.ops.fused_rkc import S_MAX_KERNEL

    def h_limit(t, y, params):
        rho = rho_fn(t, y, params).to(dtype)
        return (rkc.STAB_FACTOR * (S_MAX_KERNEL - 1) ** 2
                / torch.clamp_min(rho, 1e-30)).to(dtype)

    return h_limit


def plain_in_kernel_order(method):
    """(module, name, stand-in) of K1's (bs32), K2's or K3's wrapper: the
    kernel's plain version, returning its partial sums in the kernel's
    order (fused_step_tile_sums', fused_rkc_tile_sums' and
    fused_imex_tile_sums' arithmetic, the stages computed once), so that
    a run through it takes the kernel's run exactly when each launch is
    bitwise its plain version (unforced)."""
    from crdmodel_tpu_torch.ops import fused_imex as fi
    from crdmodel_tpu_torch.ops import fused_rkc as fr
    from crdmodel_tpu_torch.ops import fused_step as fs
    from crdmodel_tpu_torch.ops.fused_kstep import tile_error_sums
    from crdmodel_tpu_torch.ops.kernel_common import make_rhs_block

    if method == "rkc2":
        def step(y, h, fz, s, mu1, ctab, kc, rtol, atol, stim=None,
                 amps=None):
            y_new, est = fr.rkc_stages_reference(y, h, s, mu1, ctab,
                                                 make_rhs_block(kc, fz))
            return y_new, tile_error_sums(est, y, rtol, atol, fr.CHUNK_TILE,
                                          fr.CHUNK_TILE, fr.CHUNK_THREADS)
        return fr, "fused_rkc_step", step
    if method == "ark324":
        def step(y, h, fz, kc, rtol, atol, stim=None, amps=None):
            y_new, err, dys = fi.imex_stages_reference(y, h, fz, kc)
            tile_y = fi.slots_plan(y.shape[1], y.shape[2],
                                   y.element_size()).tile_y
            return y_new, fi.imex_tile_sums(err, dys, y, rtol, atol, tile_y)
        return fi, "fused_imex_step", step

    def step(y, h, fz, kc, tableau, rtol, atol, stim=None, amps=None):
        y_new, err = fs.erk_stages_reference(y, h, make_rhs_block(kc, fz),
                                             tableau)
        tile_y = fs.tile_plan(tableau.stages, y.element_size(),
                              y.shape[0])[1]
        return y_new, tile_error_sums(err, y, rtol, atol, tile_y)
    return fs, "fused_step", step


def plain_ordered_run(cfg):
    """`cfg` through simulate() on the card with its kernel's wrapper
    replaced by plain_in_kernel_order's stand-in."""
    from crdmodel_tpu_torch.sim import simulate
    module, name, step = plain_in_kernel_order(cfg.method)
    wrapper = getattr(module, name)
    setattr(module, name, step)
    try:
        return simulate(cfg, "cuda")
    finally:
        setattr(module, name, wrapper)


def soak_matrix(card):
    """Phase soak_matrix: the 18 runs of the new families x {bs32, rkc2,
    ark324} at the soak shape through simulate() on the card with the
    default selection (2.56M points > PALLAS_AUTO_POINTS), each with the
    kernel selected (res.fused, every step through K1, K2 or K3, the
    launch counts zeroed just before the run), held to the port's torch
    path on the card in f32 (use_pallas=False; rkc2 with K2's h cap):
    status ok, finite, and for bs32 and rkc2 steps within SOAK_STEP_TOL
    (one step at least) and the final field within the family's
    torch-path f32-f64 gap (bs32, one f64 run a family) plus 1e-4 (for
    ark324 both printed; SOAK_STEP_TOL's comment); and to its plain
    version's run in the kernel's sum order (plain_ordered_run): the same
    steps and the trajectory bitwise. Returns ({(model, method):
    launches}, {(model, method): the one-device kernel run's steps, final
    field and the family's f32-f64 gap}, which soak_matrix_mesh holds its
    mesh runs to)."""
    from crdmodel_tpu_torch.ops import fused_imex, fused_rkc, fused_step

    kernels = {"bs32": fused_step.fused_step,
               "rkc2": fused_rkc.fused_rkc_step,
               "ark324": fused_imex.fused_imex_step}
    launches, singles = {}, {}
    for model in KIN_FAMILIES:
        ref64 = torch_path_run(soak_cfg(model, "bs32"), {}, "float64",
                               k2_h_limit)
        gap = None
        for method in SOAK_METHODS:
            cfg = soak_cfg(model, method)
            kernel = kernels[method]
            res, counts = drive_main_path(cfg, {})
            launches[model, method] = counts[kernel.__name__]
            checks = run_checks(cfg, res, kernel, launches[model, method])
            ref = torch_path_run(cfg, {}, "float32", k2_h_limit)
            if gap is None:
                gap = float((ref[0][-1].double() - ref64[0][-1]).abs().max())
            final = float((res.trajectory[-1] - ref[0][-1]).abs().max())
            plain = plain_ordered_run(cfg)
            plain_same = (same_bits(res.trajectory, plain.trajectory)
                          and all(torch.equal(getattr(res.stats, n),
                                              getattr(plain.stats, n))
                                  for n in ("steps", "accepted",
                                            "rejected", "status")))
            steps, tol = res.total_steps(), SOAK_STEP_TOL.get(method)
            step_limit = None if tol is None else max(tol * ref[1], 1)
            phase("soak_matrix",
                  config=SOAK_LABEL.format(model, method, cfg.t_final),
                  selection=selection_note(cfg), grid=[cfg.ny, cfg.nx],
                  nvars=res.problem.model.nvars, method=method,
                  t_final=cfg.t_final, status=res.describe(),
                  fused=res.fused, steps=steps,
                  accepted=int(res.stats.accepted.sum()),
                  rejected=int(res.stats.rejected.sum()),
                  kernel=kernel.__name__, launches=counts,
                  wall_s=res.wall_time,
                  us_per_step=res.wall_time / steps * 1e6,
                  torch_path=dict(steps=ref[1], wall_s=ref[2], ok=ref[3]),
                  torch_path_f64_bs32=dict(steps=ref64[1], wall_s=ref64[2],
                                           ok=ref64[3]),
                  step_limit=step_limit, final_max_abs_vs_torch_path=final,
                  f32_f64_gap=gap, final_limit=gap + 1e-4,
                  plain_in_kernel_order=dict(steps=plain.total_steps(),
                                             wall_s=plain.wall_time,
                                             bitwise=plain_same),
                  card=card)
            if tol is not None:
                checks[f"steps within {tol:.2%} (one step at least) of the "
                       "torch path"] = abs(steps - ref[1]) <= step_limit
                checks["final field within the f32-f64 gap + 1e-4"] = (
                    final <= gap + 1e-4)
            checks.update({
                "torch path ok": ref[3] and ref64[3],
                "the plain version's run in the kernel's order, bitwise":
                    plain_same})
            fail_unless("soak_matrix", checks)
            singles[model, method] = dict(
                steps=steps, final=res.trajectory[-1].clone(), gap=gap,
                wall_s=res.wall_time)
            del res
    return launches, singles


# the families' shard kernels' checks: K9's stage counts (one chunk, two,
# four), and an uneven mesh of each family's odd torus (148 rows to blocks
# of 50, 50 and 48, with mirror-pad rows, a freeze, partial tiles)
KIN_K9_STAGES = (2, 5, 23)
KIN_UNEVEN_MESH = (3, 1)
# the shard kernels a family's mesh soak run takes, by method, and their
# entries of the kernels line: (key, source, the TPU kernel it replaces)
KIN_SHARD_KERNELS = {
    "bs32": ("k8", "fused_shard_step_families.cu",
             "crdmodel_tpu/ops/pallas_shard_step.py:105"),
    "rkc2": ("k9", "fused_shard_rkc_families.cu",
             "crdmodel_tpu/ops/pallas_shard_rkc.py:86"),
    "ark324": ("k10", "fused_shard_imex_families.cu",
               "crdmodel_tpu/ops/pallas_shard_imex.py:57")}


def kin_shard_steps(sc, yp, rho, method, s=None):
    """(call, plain call, tile sums, args, kernel tag) of one K8 (bs32 or
    dopri54), K9 (stage count s, h its stability coverage) or K10 step of
    a family on the shard buffer yp with constants sc, unfrozen, h =
    KIN_H_RHO / rho for K8 and K10 (rho the global state's): the wrapper,
    its plain version, its partial sums' plain version, their arguments
    and the kernel's name."""
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import fused_shard_imex as f10
    from crdmodel_tpu_torch.ops import fused_shard_rkc as f9
    from crdmodel_tpu_torch.ops import fused_shard_step as f8
    from crdmodel_tpu_torch.ops.fused_rkc import static_stage_tables
    dev = dict(dtype=yp.dtype, device="cuda")
    fz = torch.zeros((), **dev)
    h = torch.tensor(KIN_H_RHO / rho, **dev)
    if method == "rkc2":
        mu1, ctab = static_stage_tables(f9.S_MAX_KERNEL, yp.dtype, "cuda")
        h, st = rkc_step_inputs(s, rho, yp.dtype)
        args = (yp, h, fz, st, mu1, ctab, sc, 1e-5, 1e-8)
        return (f9.fused_shard_rkc_step, f9.fused_shard_rkc_step_reference,
                f9.fused_shard_rkc_tile_sums, args,
                "fused_rkc_chunk_n_kernel")
    if method == "ark324":
        args = (yp, h, fz, sc, 1e-5, 1e-8)
        return (f10.fused_shard_imex_step,
                f10.fused_shard_imex_step_reference,
                f10.fused_shard_imex_tile_sums, args,
                "fused_imex_slots_n_kernel")
    args = (yp, h, fz, sc, TABLEAUS[method], 1e-5, 1e-8)
    tag = ("fused_erk_slots_n_kernel" if method == "bs32"
           else "fused_erk_tile_n_kernel")
    return (f8.fused_shard_step, f8.fused_shard_step_reference,
            f8.fused_shard_step_tile_sums, args, tag)


def check_kinetics_shard_kernels():
    """Phase kinetics_shard_kernels: each new family's K8 (bs32 and
    dopri54), K9 (KIN_K9_STAGES) and K10 against their plain versions on
    the card, on shard 0 of the mesh soak's 2x2 mesh ((nvars, 1600 + 2P,
    400 + 2P)) from a random state and from the IC, and on shards 0 and 2
    of each family's odd torus on KIN_UNEVEN_MESH, f32 and f64: y_new's
    block and every partial sum bitwise, two launches bitwise, each
    launch's kernel traced once (the families' HaloGrid kernel of the
    dispatch, ops/trace.py::kernel_names). Returns {kernel: {dtype: max
    |y_kernel - y_plain|}}."""
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.ops import fused_shard_rkc as f9
    from crdmodel_tpu_torch.ops import fused_shard_step as f8
    from crdmodel_tpu_torch.ops import trace

    rng = np.random.default_rng(SEED + 23)
    worst = {k: {torch.float32: 0.0, torch.float64: 0.0}
             for k in ("k8", "k9", "k10")}
    runs = ([("k8", "bs32", None), ("k8", "dopri54", None)]
            + [("k9", "rkc2", s) for s in KIN_K9_STAGES]
            + [("k10", "ark324", None)])
    for model in KIN_FAMILIES:
        soak = soak_cfg(model, "bs32")
        cases = (("soak_2x2", soak, SHARD_MESH, (0,)),
                 ("uneven_3x1", soak_cfg(model, "bs32", x_mesh=37,
                                         t_boundary=0.1),
                  KIN_UNEVEN_MESH, (0, 2)))
        for label, cfg, shape, shards in cases:
            mesh = shard_mesh(shape)
            problem = build_problem(cfg, device="cuda")
            states = {"random": family_state(model,
                                             tuple(problem.y0.shape), rng)}
            if cfg is soak:
                states["ic"] = problem.y0.double().cpu().numpy()
            for state, y_np in states.items():
                for dtype in (torch.float32, torch.float64):
                    rho = problem_rho(problem, torch.tensor(
                        y_np, dtype=dtype, device="cuda"))
                    inputs = {p: shard_inputs(problem, mesh, y_np, dtype, p)
                              for p in (f8.HALO, f9.P_RKC)}
                    for kernel, method, s in runs:
                        bufs, consts = inputs[f9.P_RKC if kernel == "k9"
                                              else f8.HALO]
                        for k in shards:
                            call, plain, sums, args, tag = kin_shard_steps(
                                consts[k], bufs[k], rho, method, s)
                            if (dtype == torch.float32 and state == "random"
                                    and cfg is soak):
                                names = trace.kernel_names(
                                    lambda: call(*args), n=1)
                                if not all(tag in n and "HaloGrid" in n
                                           for n in names):
                                    raise AssertionError(
                                        f"kinetics_shard_kernels: {model} "
                                        f"{method} ran {sorted(set(names))}"
                                        f", not {tag} on HaloGrid")
                            err = check_shard_pair(
                                "kinetics_shard_kernels",
                                dict(model=model, case=label, state=state,
                                     kernel=kernel, method=method, s=s,
                                     mesh=list(shape), shard=k,
                                     shape=list(bufs[k].shape),
                                     valid=[consts[k].valid_rows,
                                            consts[k].valid_cols],
                                     kernel_name=tag,
                                     freeze=consts[k].has_freeze),
                                call, plain, args, dtype, sums)
                            worst[kernel][dtype] = max(
                                worst[kernel][dtype], err)
                    del inputs
            del problem
    return worst


def kinetics_shard_timing(card):
    """Phase kinetics_shard_timing: each new family's K8 (bs32), K9 (s = 5
    and 23) and K10 launch on shard 0 of the mesh soak's 2x2 mesh from the
    IC, f32: device µs from profiler traces (device_ms), the plain
    version's (CUDA events), the bound from the shard's bytes (the buffer
    in, the block out, the constants; shard_bound) and operations
    (family_step_ops), the launched kernel's registers, blocks an SM and
    shared bytes, and ptxas's registers and spills of its instantiation.
    Returns {(model, kernel, s): (ms, plain ms, bound ms, bound_by)}."""
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.ops import erk_slots
    from crdmodel_tpu_torch.ops import fused_shard_imex as f10
    from crdmodel_tpu_torch.ops import fused_shard_rkc as f9
    from crdmodel_tpu_torch.ops import fused_shard_step as f8
    from crdmodel_tpu_torch.ops.kernel_common import KINETICS_IDS

    mesh = shard_mesh(SHARD_MESH)
    out = {}
    for model in KIN_FAMILIES:
        problem = build_problem(soak_cfg(model, "bs32"), device="cuda")
        y = problem.y0.contiguous()
        y_np = y.double().cpu().numpy()
        rho = problem_rho(problem, y)
        kid = KINETICS_IDS[model]
        inputs = {p: shard_inputs(problem, mesh, y_np, torch.float32, p)
                  for p in (f8.HALO, f9.P_RKC)}
        for kernel, method, s, source, info in (
                ("k8", "bs32", None, "fused_shard_step_families.cu",
                 lambda: erk_slots.kernel_info(
                     "crd_fused_shard_step_families_info", torch.float32,
                     kid)),
                ("k9", "rkc2", 5, "fused_shard_rkc_families.cu",
                 lambda: f9.kernel_info(torch.float32, kid)),
                ("k9", "rkc2", 23, "fused_shard_rkc_families.cu",
                 lambda: f9.kernel_info(torch.float32, kid)),
                ("k10", "ark324", None, "fused_shard_imex_families.cu",
                 lambda: f10.kernel_info(torch.float32, kid))):
            bufs, consts = inputs[f9.P_RKC if kernel == "k9" else f8.HALO]
            yp, sc = bufs[0], consts[0]
            call, plain, _, args, tag = kin_shard_steps(sc, yp, rho, method,
                                                        s)
            extra = 0
            if method == "rkc2":
                extra = sum(t.numel() * t.element_size() for t in args[4:6])
            t = (device_ms(lambda: call(*args), tag),
                 median_ms(lambda: plain(*args), 10, 2),
                 *shard_bound(yp, sc, family_step_ops(sc, method, s),
                              extra))
            out[model, kernel, s] = t
            phase("kinetics_shard_timing", model=model, kernel=kernel,
                  method=method, s=s, shape=list(yp.shape),
                  dtype="float32", kernel_us=t[0] * 1e3,
                  plain_us=t[1] * 1e3, bound_us=t[2] * 1e3, bound_by=t[3],
                  times_bound=t[0] / t[2], kernel_name=tag, **info(),
                  ptxas=[e for e in ptxas_entries(source, tag)
                         if e["kernel"].startswith(f"ILi{kid}E")],
                  card=card)
        del inputs, problem
    return out


def plain_ordered_mesh_run(cfg, mesh):
    """`cfg` through simulate_sharded() on `mesh` with K10's wrapper
    replaced by its plain version returning its partial sums in the
    kernel's order (fused_shard_imex_tile_sums' arithmetic, the stages
    computed once), so that the run takes the kernel's run exactly when
    each launch is bitwise its plain version (unforced)."""
    from crdmodel_tpu_torch.ops import fused_imex as fi
    from crdmodel_tpu_torch.ops import fused_shard_imex as f10
    from crdmodel_tpu_torch.ops.fused_shard_step import interior

    def step(yp, h, fz, sc, rtol, atol, stim=None, amps=None):
        p = sc.halo
        y_all, err, dys = fi.imex_stages_reference(yp, h, fz, sc)
        y_new = yp.clone()
        interior(y_new, p).copy_(interior(y_all, p))
        return y_new, fi.imex_tile_sums(
            interior(err, p), [interior(dy, p) for dy in dys],
            interior(yp, p), rtol, atol, f10.TILE,
            (sc.valid_rows, sc.valid_cols))

    wrapper = f10.fused_shard_imex_step
    f10.fused_shard_imex_step = step
    try:
        return run_program(cfg, {}, mesh)
    finally:
        f10.fused_shard_imex_step = wrapper


def soak_matrix_mesh(card, singles):
    """Phase soak_matrix_mesh: the 18 runs of soak_matrix through
    simulate_sharded() on a 2x2 mesh of shards on cuda:0 with the default
    selection, each with its shard kernel selected (K8, K9 or K10: every
    step of every shard through it, the launch counts zeroed just before
    the run): status ok, finite, and for bs32 and rkc2
    held to the one-device kernel run of the same cell that soak_matrix
    made in this call (`singles`): steps within SOAK_STEP_TOL (one step at
    least), the final field within the family's f32-f64 gap + 1e-4; for
    ark324, whose steps follow the order of its error's sum, held to its
    plain version's sharded run in K10's sum order (plain_ordered_mesh_run):
    the same steps and the trajectory bitwise, its distance to the
    one-device run printed. Returns {(model, method): launches}."""
    from crdmodel_tpu_torch.ops import (fused_shard_imex, fused_shard_rkc,
                                        fused_shard_step)

    kernels = {"bs32": fused_shard_step.fused_shard_step,
               "rkc2": fused_shard_rkc.fused_shard_rkc_step,
               "ark324": fused_shard_imex.fused_shard_imex_step}
    mesh = shard_mesh(SHARD_MESH)
    launches = {}
    for model in KIN_FAMILIES:
        for method in SOAK_METHODS:
            cfg = soak_cfg(model, method)
            kernel = kernels[method]
            res, counts = drive_main_path(cfg, {}, mesh)
            launches[model, method] = counts[kernel.__name__]
            checks = run_checks(cfg, res, kernel, launches[model, method],
                                mesh.size)
            single = singles[model, method]
            steps = res.total_steps()
            final = float((res.trajectory[-1] - single["final"]).abs().max())
            fields = dict(
                config=SOAK_LABEL.format(model, method, cfg.t_final)
                + ", 2x2 mesh of shards on cuda:0",
                selection=selection_note(cfg), mesh=list(mesh.shape),
                grid=[cfg.ny, cfg.nx],
                nvars=res.problem.model.nvars, method=method,
                t_final=cfg.t_final, status=res.describe(), fused=res.fused,
                steps=steps, accepted=int(res.stats.accepted.sum()),
                rejected=int(res.stats.rejected.sum()),
                kernel=kernel.__name__, launches=counts,
                wall_s=res.wall_time, us_per_step=res.wall_time / steps * 1e6,
                one_device=dict(steps=single["steps"],
                                wall_s=single["wall_s"]),
                final_max_abs_vs_one_device=final,
                f32_f64_gap=single["gap"], final_limit=single["gap"] + 1e-4,
                card=card)
            tol = SOAK_STEP_TOL.get(method)
            if tol is not None:
                step_limit = max(tol * single["steps"], 1)
                fields["step_limit"] = step_limit
                checks[f"steps within {tol:.2%} (one step at least) of the "
                       "one-device run"] = (
                    abs(steps - single["steps"]) <= step_limit)
                checks["final field within the f32-f64 gap + 1e-4 of the "
                       "one-device run"] = final <= single["gap"] + 1e-4
            else:
                plain = plain_ordered_mesh_run(cfg, mesh)
                same = (same_bits(res.trajectory, plain.trajectory)
                        and all(torch.equal(getattr(res.stats, n),
                                            getattr(plain.stats, n))
                                for n in ("steps", "accepted", "rejected",
                                          "status")))
                fields["plain_in_kernel_order"] = dict(
                    steps=plain.total_steps(), wall_s=plain.wall_time,
                    bitwise=same)
                checks["the plain version's sharded run in K10's order, "
                       "bitwise"] = same
                del plain
            phase("soak_matrix_mesh", **fields)
            fail_unless("soak_matrix_mesh", checks)
            del res
    return launches


def kernel_run(problem):
    """(trajectory, stats) of `problem` on the card with every step through
    K1 (bs32), K2 (rkc2) or K3 (ark324), in the problem's dtype: the
    steppers select_stepper builds on the fused path (sim.py), here built
    whatever the gates' f32 rule says, f64 being the kernels' parity
    tool."""
    from crdmodel_tpu_torch.core.problem import (make_rhs, make_rho_bound,
                                                 solver_breakpoints)
    from crdmodel_tpu_torch.integrate import imex, rkc
    from crdmodel_tpu_torch.integrate.erk import (TABLEAUS,
                                                  integrate_to_outputs)
    from crdmodel_tpu_torch.ops import fused_imex, fused_rkc, fused_step
    from crdmodel_tpu_torch.sim import output_times

    cfg, dtype = problem.cfg, problem.y0.dtype
    if cfg.method == "rkc2":
        rho_fn = make_rho_bound(cfg, problem.model, problem.geometry, dtype)
        frkc = fused_rkc.build_fused_rkc_step(problem, dtype, rho_fn=rho_fn)
        kw = dict(rho_fn=rho_fn, step_err=frkc.step_err,
                  err_order=rkc.ERR_ORDER, h_limit_fn=frkc.h_limit)
    else:
        if cfg.method == "ark324":
            step = fused_imex.build_fused_imex_step(problem)
            kw = dict(rhs_split=make_rhs(cfg, problem.model,
                                         problem.geometry, dtype,
                                         problem.device, split=True),
                      err_order=imex.ERR_ORDER)
        else:
            tableau = TABLEAUS[cfg.method]
            step = fused_step.build_fused_step(problem, tableau)
            kw = dict(err_order=tableau.err_order)
        kw["step_err"] = lambda t, y, h, p, carry: (*step(t, y, h, p), ())
    return integrate_to_outputs(
        problem.rhs, problem.y0, problem.params, 0.0, output_times(cfg),
        rtol=cfg.rtol, atol=cfg.atol, method=cfg.method,
        max_steps=cfg.max_steps, breakpoints=solver_breakpoints(cfg),
        step_mode=cfg.step_mode, spec_k=0, **kw)


def fixture_run(model, surface, method):
    """One golden fixture of the new families in f64 on the card through
    K1, K2 or K3 (bs32, rkc2 or ark324; kernel_run): (phase fields,
    checks) (fixture_runs)."""
    from crdmodel_tpu_torch.config import SimConfig
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.ops import fused_imex, fused_rkc, fused_step

    kernel = {"bs32": fused_step.fused_step,
              "rkc2": fused_rkc.fused_rkc_step,
              "ark324": fused_imex.fused_imex_step}[method]
    base = dict(x_mesh=16, surface_width=20, surface_length=40,
                t_final=1.0, output_timestep=2, wave_length=0.1,
                wave_width=0.5, dtype="float64", rtol=1e-7, atol=1e-11)
    with np.load(FIXTURE_STATS) as z:
        recorded = dict(z)
    case = f"{model}_{surface}"
    cfg = SimConfig(**{**base, **FIXTURE_PHYSICS[model], "model": model,
                       "surface": surface, "method": method})
    problem = build_problem(cfg, "cuda")
    count = zero_launches()
    traj, stats = kernel_run(problem)
    launches = count()[kernel.__name__]
    key = f"{case}/{method}"
    same = all(np.array_equal(getattr(stats, n).cpu().numpy(),
                              recorded[f"{key}/{n}"])
               for n in ("steps", "accepted", "rejected", "status"))
    steps = int(stats.steps.sum())
    checks = {
        "status ok": bool(torch.all(stats.status == 0)),
        "finite": bool(torch.isfinite(traj).all()),
        f"every step through {kernel.__name__}":
            steps <= launches <= launch_bound(cfg, steps)[1],
        "the torch path's step sequence": same}
    golden = None
    if method == "bs32":
        with np.load(os.path.join(GOLDEN, f"{case}.npz")) as z:
            want = z["trajectory"]
        got = torch.cat([problem.y0[None], traj]).cpu().numpy()
        golden = float(np.max(np.abs(got - want) - 1e-5 * np.abs(want)))
        checks["golden fixture"] = golden <= 1e-6
    return (dict(case=case, method=method, steps=stats.steps.tolist(),
                 torch_path_steps=recorded[f"{key}/steps"].tolist(),
                 launches=launches, same_steps=same, golden_excess=golden),
            checks)


def fixture_runs():
    """Phase kinetics_fixtures: the twelve golden fixtures of the new
    families (tests/test_golden.py:30-57, flat and torus) in f64 on the
    card through K1, K2 and K3, each taking the port's torch path's f64
    step sequence exactly (steps, accepted, rejected and status of every
    output interval, recorded on the CPU in FIXTURE_STATS by
    scripts/kinetics_fixture_stats.py; the CPU suite holds the torch path
    to the JAX package's), every step through its kernel, and bs32's
    trajectory within the fixture's tolerance (rtol 1e-5, atol 1e-6) of
    tests/golden/<case>.npz. The runs take ~2 ms a step of the host's
    launches, the Oregonator's ~34,600 steps most of them, so the 36 runs
    go to FIXTURE_WORKERS processes on the card (fixture_run), the
    Oregonator's rkc2 runs first; every process ends with the phase."""
    import concurrent.futures
    import multiprocessing

    runs = sorted(((m, s, k) for m in KIN_FAMILIES
                   for s in ("flat", "torus") for k in SOAK_METHODS),
                  key=lambda r: (r[0] != "oregonator", r[2] != "rkc2"))
    with concurrent.futures.ProcessPoolExecutor(
            FIXTURE_WORKERS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        for fields, checks in pool.map(fixture_run, *zip(*runs)):
            phase("kinetics_fixtures", **fields)
            fail_unless("kinetics_fixtures", checks)


# the processes the fixture runs share the card in (fixture_runs)
FIXTURE_WORKERS = 6
# the port's torch-path step statistics of those fixtures (f64, CPU)
FIXTURE_STATS = os.path.join(GOLDEN, "torch_kinetics_fixture_stats.npz")
# tests/test_golden.py:30-57's physics of the new families' fixtures
FIXTURE_PHYSICS = {
    "barkley": dict(beta=0.05, diffusion=1.0),
    "grayscott": dict(beta=0.03, diffusion=2e-5, t_final=20.0),
    "oregonator": dict(beta=1.5, diffusion=1.0),
    "brusselator": dict(beta=1.9, diffusion=0.2),
    "sir": dict(beta=1.5, diffusion=1.0),
    "lambdaomega": dict(beta=0.5, diffusion=0.5),
}


def kinetics_phases(card):
    """The six other families' phases: kinetics_kernels, kinetics_timing,
    kinetics_fixtures and soak_matrix (K1, K2 and K3 on one device), then
    kinetics_shard_kernels, kinetics_shard_timing and soak_matrix_mesh
    (K8, K9 and K10 on a 2x2 mesh), each phase's seconds printed (phase
    kinetics_seconds). Returns the kernels line's entries of the families'
    K1, K2, K3, K8, K9 and K10, one a family and kernel."""
    import time
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    worst = timed("kinetics_kernels", check_kinetics_kernels)
    timing = timed("kinetics_timing", kinetics_timing, card)
    timed("kinetics_fixtures", fixture_runs)
    launches, singles = timed("soak_matrix", soak_matrix, card)
    worst.update(timed("kinetics_shard_kernels",
                       check_kinetics_shard_kernels))
    timing.update(timed("kinetics_shard_timing", kinetics_shard_timing,
                        card))
    mesh_launches = timed("soak_matrix_mesh", soak_matrix_mesh, card,
                          singles)
    del singles
    phase("kinetics_seconds", **seconds, card=card)
    entries = []
    for model in KIN_FAMILIES:
        for kernel, method, s, source, replaces in (
                ("k1", "bs32", None, "fused_step_families.cu",
                 "crdmodel_tpu/ops/pallas_step.py:117"),
                ("k2", "rkc2", 23, "fused_rkc_families.cu",
                 "crdmodel_tpu/ops/pallas_rkc.py:365"),
                ("k3", "ark324", None, "fused_imex_families.cu",
                 "crdmodel_tpu/ops/pallas_imex.py:155")):
            entries.append(kernel_entry(
                f"{source[:-3]}[{model}]", source, replaces,
                launches[model, method], worst[kernel],
                timing[model, kernel, s]))
        for method, (kernel, source, replaces) in KIN_SHARD_KERNELS.items():
            s = 23 if method == "rkc2" else None
            entries.append(kernel_entry(
                f"{source[:-3]}[{model}]", source, replaces,
                mesh_launches[model, method], worst[kernel],
                timing[model, kernel, s]))
    return entries


def load_probes():
    """Every golden of PROBES: {(model, method): {name: array}}."""
    probes = {}
    for key, path in PROBES.items():
        with np.load(path) as z:
            probes[key] = {k: z[k] for k in z.files}
    return probes


def shard_phases(cfg, probes, single_fhn, card, keep=None):
    """The sharded paths' phases: K8 and K9 against their plain versions
    (k8_check, k9_check) on the canonical torus's 2x2 shards (800x200; the
    beta ramp, a freeze), the flat FHN's (scalar beta), the uneven 1x3 mesh
    (blocks of 134, 134 and 132 columns, padded and mirrored) and K9 on the
    large torus's 2x2 shards (3200x800); their timings and the halo
    exchange's; the canonical FHN torus through simulate_sharded() on a 2x2
    mesh (main_path_sharded_fhn, K8; held to the JAX goldens and to the
    single-device K1 run `single_fhn` of this call) and the large FHN torus
    with rkc2 (main_path_sharded_fhn_rkc2, K9; held to the single-device K2
    run). Every shard lives on cuda:0; with four cards or more each path
    runs again with one shard on each card. Returns K8's and K9's entries
    of the kernels line; `keep` receives the 2x2 FHN run."""
    cfg_flat = dataclasses.replace(cfg, surface="flat", vary_beta=0)
    cfg_large = large_fhn_torus()
    worst8, worst9 = check_shard_kernels([
        ("canonical_2x2", cfg, SHARD_MESH, (0, 3), True, True),
        ("flat_2x2", cfg_flat, SHARD_MESH, (0, 3), True, True),
        ("canonical_uneven_1x3", cfg, UNEVEN_MESH, (0, 1, 2), True, True),
        ("large_rkc2_2x2", cfg_large, SHARD_MESH, (0,), False, True)],
        SEED + 9)
    timings = shard_timings(cfg, cfg_large, card)
    launches8, launches9 = sharded_main_paths(cfg, probes, single_fhn,
                                              keep)
    return [
        kernel_entry("fused_shard_step", "fused_shard_step.cu",
                     "crdmodel_tpu/ops/pallas_shard_step.py:105", launches8,
                     worst8, timings["k8", None]),
        kernel_entry("fused_shard_rkc_step", "fused_shard_rkc.cu",
                     "crdmodel_tpu/ops/pallas_shard_rkc.py:86", launches9,
                     worst9, timings["k9", max(K9_TIMED_STAGES)])]


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
    from crdmodel_tpu_torch.ops import (_build, box_stream, erk_slots,
                                        fused_aniso, fused_divform,
                                        fused_imex, fused_rkc, fused_step)
    from crdmodel_tpu_torch.ops.kernel_common import (
        KINETICS_IDS, prepare_aniso_constants, prepare_divform_constants)

    # the large Goldbeter torus's f64 reference runs while nvcc builds
    if sys.argv[1:] in ([], ["--timing"], ["--sharded"]):
        start_background_runs()
    phase("build", seconds=_build.build(), library=_build.library_path(),
          ptxas_slots_kernels={
              src: ptxas_entries(src, erk_slots.SLOTS_KERNEL)
              for src in ("fused_step.cu", "fused_shard_step.cu",
                          "fused_divform.cu", "fused_shard_divform.cu",
                          "fused_aniso.cu")},
          ptxas_fused_step=ptxas_summary("fused_step.cu"),
          ptxas_fused_divform=ptxas_summary("fused_divform.cu"),
          ptxas_fused_rkc=_build.ptxas_report("fused_rkc.cu"),
          ptxas_fused_aniso=ptxas_summary("fused_aniso.cu"),
          ptxas_stream_kernels={
              src: ptxas_entries(src, box_stream.STREAM_KERNEL)
              for src in ("fused_box3d.cu", "fused_shard_box3d.cu")},
          ptxas_rkc_stream_kernels={
              src: ptxas_entries(src, box_stream.RKC_STREAM_KERNEL)
              for src in ("fused_box3d_rkc.cu",
                          "fused_shard_box3d_rkc.cu")},
          ptxas_fused_box3d=ptxas_summary("fused_box3d.cu"),
          ptxas_fused_box3d_rkc=ptxas_summary("fused_box3d_rkc.cu"),
          ptxas_forced_box={
              src: ptxas_summary(src)
              for src in ("fused_box3d_forced.cu",
                          "fused_box3d_rkc_forced.cu",
                          "fused_shard_box3d_forced.cu",
                          "fused_shard_box3d_rkc_forced.cu")},
          ptxas_fused_shard_step=ptxas_summary("fused_shard_step.cu"),
          ptxas_fused_shard_rkc=ptxas_entries("fused_shard_rkc.cu",
                                              "fused_rkc_chunk_kernel"),
          ptxas_fused_imex=ptxas_entries("fused_imex.cu",
                                         "fused_imex_slots_kernel"),
          ptxas_fused_shard_imex=ptxas_entries("fused_shard_imex.cu",
                                               "fused_imex_slots_kernel"),
          ptxas_fused_shard_divform=ptxas_summary("fused_shard_divform.cu"),
          ptxas_fused_shard_box3d=ptxas_summary("fused_shard_box3d.cu"),
          ptxas_fused_shard_box3d_rkc=ptxas_summary(
              "fused_shard_box3d_rkc.cu"),
          ptxas_fused_kstep=ptxas_summary("fused_kstep.cu"),
          ptxas_families={src: ptxas_summary(src)
                          for src in ("fused_step_families.cu",
                                      "fused_rkc_families.cu",
                                      "fused_imex_families.cu",
                                      "fused_shard_step_families.cu",
                                      "fused_shard_rkc_families.cu",
                                      "fused_shard_imex_families.cu")})
    cfg_ap, ap_build = bounded_tissue()
    cfg_ap_rkc = dataclasses.replace(cfg_ap, method="rkc2")
    cfg_wide = wide_sheet()
    cfg_aniso, aniso_build = aniso_sheet()
    cfg_box = volumetric_box()
    cfg_gb = config_from_ini(GB_INI, model="goldbeter", surface="torus",
                             use_pallas=True)
    # the programs of K10's and K11's sharded main paths
    programs = {"bounded_ap": (cfg_ap, ap_build),
                "aniso": (cfg_aniso, aniso_build),
                "torus_tensor": torus_fibres(cfg_aniso),
                "goldbeter_ark324": dataclasses.replace(cfg_gb,
                                                        method="ark324")}
    if sys.argv[1:] == ["--profile"]:
        profile_run(cfg_ap, ap_build, 1.0, "DivformRhs")
        profile_run(cfg_ap_rkc, ap_build, 1.0, "fused_rkc_chunk_kernel")
        profile_run(cfg_aniso, aniso_build, 0.25, "AnisoRhs")
        profile_run(cfg_wide, {}, 0.05, "fused_rkc_chunk_kernel")
        # the slab's runs whole: the ~54 steps of Tf/10 are too few for a
        # steady idle share (it read 12% and 39% in two runs)
        tf = cfg_box.t_final
        profile_run(cfg_box, {}, tf, box_stream.STREAM_KERNEL)
        profile_run(dataclasses.replace(cfg_box, method="rkc2"), {}, tf,
                    box_stream.rkc_kernel_name("box_profile"))
        profile_run(cfg_box, box_scar(cfg_box), tf,
                    box_stream.STREAM_KERNEL)
        profile_run(config_from_ini(INI, model="fhn", surface="torus"), {},
                    5.0, "HaloGrid", mesh=shard_mesh(SHARD_MESH))
        profile_run(large_fhn_torus(), {}, 0.2, "HaloGrid",
                    mesh=shard_mesh(SHARD_MESH))
        profile_run(cfg_ap, ap_build, 1.0, "DivformRhs",
                    mesh=shard_mesh(SHARD_MESH))
        profile_run(large_goldbeter_torus(), {}, 0.2,
                    "fused_imex_slots_kernel", mesh=shard_mesh(SHARD_MESH))
        profile_run(cfg_box, {}, tf, box_stream.STREAM_KERNEL,
                    mesh=shard_mesh(SHARD_MESH))
        profile_run(dataclasses.replace(cfg_box, method="rkc2"), {}, tf,
                    box_stream.rkc_kernel_name("box_profile", shard=True),
                    mesh=shard_mesh(SHARD_MESH))
        profile_run(cfg_box, box_scar(cfg_box), tf,
                    box_stream.STREAM_KERNEL, mesh=shard_mesh(SHARD_MESH))
        # the canonical FHN torus over Tf=5, per step through K1 and in
        # batches of K14_SPEC through K14
        cfg_fhn = config_from_ini(INI, model="fhn", surface="torus")
        profile_run(cfg_fhn, {}, 5.0, erk_slots.SLOTS_KERNEL)
        profile_run(dataclasses.replace(cfg_fhn, speculative_k=K14_SPEC),
                    {}, 5.0, "fused_kstep_kernel")
        return
    cfg = config_from_ini(INI, model="fhn", surface="torus")
    fhn_label = "data/FHNmodelArgs.ini fhn torus"
    if sys.argv[1:] == ["--sharded"]:
        probes, single_fhn = load_probes(), {}
        run_main_path(cfg, probes["fhn", "bs32"], fused_step.fused_step, 0.01,
                      "main_path", fhn_label, keep=single_fhn)
        sharded_main_paths(cfg, probes, single_fhn)
        sharded_field_main_paths(programs, probes,
                                 single_field_runs(programs, probes))
        sharded_slab_main_paths(cfg_box, box_main_paths(cfg_box)[2])
        return
    if sys.argv[1:] == ["--stream"]:
        from crdmodel_tpu_torch.ops import fused_shard_step
        probes, single_fhn, sharded_fhn = load_probes(), {}, {}
        run_main_path(cfg, probes["fhn", "bs32"], fused_step.fused_step, 0.01,
                      "main_path", fhn_label, keep=single_fhn)
        run_main_path(cfg, probes["fhn", "bs32"],
                      fused_shard_step.fused_shard_step, 0.01,
                      "main_path_sharded_fhn", fhn_label,
                      mesh=shard_mesh(SHARD_MESH), versus=single_fhn,
                      keep=sharded_fhn)
        stream_phases(cfg, programs["goldbeter_ark324"], single_fhn,
                      sharded_fhn, card)
        return
    if sys.argv[1:] == ["--forced"]:
        paced = {}
        forced_phases(cfg, cfg_gb, cfg_ap, ap_build, card, paced)
        mesh_forced_phases(cfg, cfg_gb, cfg_ap, ap_build,
                           *programs["torus_tensor"], load_probes(), paced,
                           card)
        box_forced_phases(cfg_box, card)
        return
    if sys.argv[1:] == ["--box-forced"]:
        box_forced_phases(cfg_box, card)
        return
    if sys.argv[1:] == ["--kinetics"]:
        kinetics_phases(card)
        return
    if sys.argv[1:] == ["--timing"]:
        global TIMING_ALL
        TIMING_ALL = True
    elif sys.argv[1:]:
        sys.exit(f"unknown arguments {sys.argv[1:]}; see the docstring")

    cfg_flat = dataclasses.replace(cfg, surface="flat", vary_beta=0)
    # Goldbeter with a freeze (the ini has tBoundary=0), torus with a
    # scalar beta and flat with the beta ramp
    gb_torus = dataclasses.replace(cfg_gb, t_boundary=1.0)
    gb_flat = dataclasses.replace(cfg_gb, surface="flat", vary_beta=1,
                                  t_boundary=1.0)
    mask = ap_build["obstacle_mask"]
    # Aliev-Panfilov on the bounded sheet's grid with periodic edges and a
    # freeze: the profile kernels' case of its kinetics. D = 0.1 keeps the
    # checked steps (H, K3_H) inside the explicit stages' stability region
    # on this fine grid, as they are on the canonical grids.
    ap_periodic = dataclasses.replace(cfg_ap, boundary="periodic",
                                      t_boundary=1.0, diffusion=0.1)
    worst, k1_timing = check_kernel([cfg, cfg_flat, gb_torus, gb_flat,
                                     ap_periodic])
    phase("k1_timing", shape=[2, cfg.ny, cfg.nx], method=cfg.method,
          dtype="float32", kernel_us=k1_timing[0] * 1e3,
          burst_us=k1_timing[4] * 1e3,
          plain_us=k1_timing[1] * 1e3, bound_us=k1_timing[2] * 1e3,
          bound_by=k1_timing[3],
          times_bound=k1_timing[0] / k1_timing[2],
          kernel=erk_slots.SLOTS_KERNEL,
          **erk_slots.kernel_info("crd_fused_erk_step_info", torch.float32,
                                  KINETICS_IDS["fhn"]),
          ptxas=ptxas_summary("fused_step.cu", erk_slots.SLOTS_KERNEL),
          card=card)
    # K2's cases: K1's four, and the canonical torus cut to 4 columns, a
    # grid smaller than a chunk's halo, which the wrap covers many times
    worst2, timing2 = check_rkc_kernel([cfg, cfg_flat, gb_torus,
                                        ap_periodic,
                                        dataclasses.replace(cfg, x_mesh=4)])
    for s, t2 in timing2.items():
        phase("k2_timing", shape=[2, cfg.ny, cfg.nx], s=s, dtype="float32",
              kernel_us=t2[0] * 1e3, plain_us=t2[1] * 1e3,
              bound_us=t2[2] * 1e3, bound_by=t2[3], **t2[4], card=card)
    cfg_big = config_from_ini(GB_INI, model="goldbeter", surface="torus",
                              x_mesh=K3_BIG_MESH)
    # K3's cases: Goldbeter on the canonical torus and flat with the beta
    # ramp (the plan's 32x16 tiles), FHN's and Aliev-Panfilov's at
    # (2,1600,400) (32x32), and the edges of the slots scheme: the
    # Goldbeter torus cut to 4 columns, which the wrap covers many times,
    # and an odd 301x75 grid, partial tiles on both axes
    worst3, timing3 = check_imex_kernel(
        [gb_torus, gb_flat, cfg, cfg_flat, ap_periodic,
         dataclasses.replace(gb_torus, x_mesh=4),
         dataclasses.replace(gb_flat, x_mesh=75, y_mesh=301)],
        [cfg_gb, cfg_big] if TIMING_ALL else [cfg_gb])
    for shape, t3 in timing3.items():
        plan = t3[5]
        phase("k3_timing", shape=list(shape), h=K3_H[0], dtype="float32",
              kernel_us=t3[0] * 1e3, burst_us=t3[4] * 1e3,
              plain_us=t3[1] * 1e3, bound_us=t3[2] * 1e3, bound_by=t3[3],
              times_bound=t3[0] / t3[2], kernel=fused_imex.SLOTS_KERNEL,
              plan=plan._asdict(),
              **fused_imex.kernel_info(torch.float32,
                                       KINETICS_IDS["goldbeter"],
                                       plan.tile_y),
              ptxas=ptxas_summary("fused_imex.cu", fused_imex.SLOTS_KERNEL),
              card=card)
    # K4's cases at (2,1600,400), each with a freeze: the bounded tissue; a
    # torus obstacle (FHN, the canonical torus with a scar of its own); a
    # flat 2-D diffusion field around D = 0.1; and the edges of bs32's
    # register-resident scheme: the canonical torus cut to 4 columns, a
    # grid narrower than a tile's rings, which the wrap covers many times,
    # and the bounded tissue on an odd 301x75 grid, partial tiles on both
    # axes
    torus_scar = np.ones((cfg.ny, cfg.nx), bool)
    torus_scar[700:780, 150:230] = False
    dfield = 0.05 + 0.1 * np.random.default_rng(SEED).random(
        (cfg_ap.ny, cfg_ap.nx))
    torus4 = dataclasses.replace(cfg, x_mesh=4)
    torus4_scar = np.ones((torus4.ny, torus4.nx), bool)
    torus4_scar[6:9, 1:3] = False
    ap_odd = dataclasses.replace(cfg_ap, x_mesh=75, y_mesh=301,
                                 t_boundary=1.0)
    divform_cases = [
        ("noflux_scar", dataclasses.replace(cfg_ap, t_boundary=1.0),
         ap_build),
        ("torus_obstacle", cfg, dict(obstacle_mask=torus_scar)),
        ("flat_2d_field", ap_periodic, dict(diffusion_field=dfield)),
        ("torus_4_columns", torus4, dict(obstacle_mask=torus4_scar)),
        ("noflux_scar_odd", ap_odd,
         dict(obstacle_mask=circular_scar(ap_odd)))]
    worst4, k4_timing = check_field_kernel(
        "k4_check", divform_cases, prepare_divform_constants,
        fused_divform.fused_divform_step,
        fused_divform.fused_divform_step_reference, K4_H, SEED + 3,
        methods=ERK_METHODS,
        tile_sums=fused_divform.fused_divform_tile_sums,
        device_tag=erk_slots.SLOTS_KERNEL)
    phase("k4_timing", shape=[2, cfg_ap.ny, cfg_ap.nx], method="bs32",
          dtype="float32", kernel_us=k4_timing[0] * 1e3,
          burst_us=k4_timing[4] * 1e3,
          plain_us=k4_timing[1] * 1e3, bound_us=k4_timing[2] * 1e3,
          bound_by=k4_timing[3],
          times_bound=k4_timing[0] / k4_timing[2],
          kernel=erk_slots.SLOTS_KERNEL,
          **erk_slots.kernel_info("crd_fused_divform_info", torch.float32,
                                  KINETICS_IDS["aliev_panfilov"]),
          ptxas=ptxas_summary("fused_divform.cu", erk_slots.SLOTS_KERNEL),
          card=card)
    # K2's divergence branch on K4's five cases, with rkc2
    worst2d, timing2d = check_rkc_divform_kernel(
        [(label, dataclasses.replace(c, method="rkc2"), kw)
         for label, c, kw in divform_cases])
    for s, t2 in timing2d.items():
        phase("k2_divform_timing", shape=[2, cfg_ap.ny, cfg_ap.nx], s=s,
              dtype="float32", kernel_us=t2[0] * 1e3, plain_us=t2[1] * 1e3,
              bound_us=t2[2] * 1e3, bound_by=t2[3], **t2[4], card=card)
    # K2 at K2b's shape, the wide sheet's
    worst2b, timing2b = check_wide_rkc_kernel(cfg_wide)
    for s, t2 in timing2b.items():
        phase("k2b_timing", shape=[2, cfg_wide.ny, cfg_wide.nx], s=s,
              dtype="float32", kernel_us=t2[0] * 1e3, plain_us=t2[1] * 1e3,
              bound_us=t2[2] * 1e3, bound_by=t2[3], **t2[4],
              samples=list(WIDE_TIMED), card=card)
    # K5's cases at (2,1600,400), each with a freeze: the fibered sheet; a
    # constant tensor inside no-flux walls; FHN on the flat sheet with the
    # beta ramp and random SPD fields around D = 0.1
    rng = np.random.default_rng(SEED + 6)
    dxx = 0.05 + 0.1 * rng.random((cfg_flat.ny, cfg_flat.nx))
    dyy = 0.03 + 0.1 * rng.random((cfg_flat.ny, cfg_flat.nx))
    dxy = 0.9 * np.sqrt(dxx * dyy) * (2.0 * rng.random(dxx.shape) - 1.0)
    worst5, k5_timing = check_field_kernel(
        "k5_check",
        [("fibres", dataclasses.replace(cfg_aniso, t_boundary=0.5),
          aniso_build),
         ("const_noflux", dataclasses.replace(cfg_aniso, t_boundary=0.5,
                                              boundary="noflux"),
          dict(diffusion_tensor=(1.0, 0.25, 0.15))),
         ("random_beta_ramp", dataclasses.replace(cfg_flat, vary_beta=1),
          dict(diffusion_tensor=(dxx, dyy, dxy))),
         # the edges of bs32's slots scheme: a sheet cut to 4 columns and
         # an odd 301x75 sheet, a constant tensor on each
         ("const_4_columns", dataclasses.replace(cfg_aniso, x_mesh=4,
                                                 t_boundary=0.5),
          dict(diffusion_tensor=(1.0, 0.25, 0.15))),
         ("const_odd", dataclasses.replace(cfg_aniso, x_mesh=75, y_mesh=301,
                                           t_boundary=0.5),
          dict(diffusion_tensor=(1.0, 0.25, 0.15)))],
        prepare_aniso_constants, fused_aniso.fused_aniso_step,
        fused_aniso.fused_aniso_step_reference, K5_H, SEED + 7,
        methods=ERK_METHODS, tile_sums=fused_aniso.fused_aniso_tile_sums,
        device_tag=erk_slots.SLOTS_KERNEL)
    # the dispatch at the fibered sheet's shape: bs32 the slots kernel,
    # the other tableaus erk_tile.cuh's
    k5_kernels = check_aniso_dispatch(cfg_aniso, aniso_build)
    phase("k5_timing", shape=[2, cfg_aniso.ny, cfg_aniso.nx], method="bs32",
          dtype="float32", kernel_us=k5_timing[0] * 1e3,
          burst_us=k5_timing[4] * 1e3,
          plain_us=k5_timing[1] * 1e3, bound_us=k5_timing[2] * 1e3,
          bound_by=k5_timing[3],
          times_bound=k5_timing[0] / k5_timing[2],
          kernel=erk_slots.SLOTS_KERNEL, dispatch=k5_kernels,
          **erk_slots.kernel_info("crd_fused_aniso_info", torch.float32,
                                  KINETICS_IDS["aliev_panfilov"]),
          ptxas=ptxas_summary("fused_aniso.cu", erk_slots.SLOTS_KERNEL),
          card=card)

    probes = load_probes()
    gb_label = "data/GoldbeterModelArgs.ini goldbeter torus"
    single_fhn = {}
    launches = run_main_path(cfg, probes["fhn", "bs32"],
                             fused_step.fused_step, 0.01, "main_path",
                             fhn_label, keep=single_fhn)
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
    singles = {key: {} for key in ("bounded_ap", "aniso",
                                   "goldbeter_ark324")}
    launches3 = run_main_path(
        programs["goldbeter_ark324"], probes["goldbeter", "ark324"],
        fused_imex.fused_imex_step, 0.01, "main_path_goldbeter_ark324",
        gb_label, keep=singles["goldbeter_ark324"])
    ap_probes = probes["aliev_panfilov", "bs32"]
    launches4 = run_main_path(
        cfg_ap, ap_probes, fused_divform.fused_divform_step, 0.01,
        "main_path_bounded_ap",
        "scripts/bench_suite.py::bounded_tissue aliev_panfilov flat, "
        "noflux walls + circular scar",
        build_kw=ap_build, extra_checks=scar_checks(ap_probes, mask),
        keep=singles["bounded_ap"])
    # the bounded tissue with rkc2, through K2's divergence branch; its
    # scar drifts by the recurrence's rounding (scar_checks), held to the
    # probes' floor of 1e-4
    ap_rkc_probes = probes["aliev_panfilov", "rkc2"]
    run_main_path(
        cfg_ap_rkc, ap_rkc_probes, fused_rkc.fused_rkc_step, 0.02,
        "main_path_bounded_ap_rkc2",
        "scripts/bench_suite.py::bounded_tissue aliev_panfilov flat, "
        "noflux walls + circular scar, rkc2",
        build_kw=ap_build,
        extra_checks=scar_checks(ap_rkc_probes, mask, drift=1e-4))
    launches2b = run_wide_sheet(dataclasses.replace(cfg_wide,
                                                    t_final=WIDE_TF),
                                probes["fhn", "rkc2"])
    aniso_probes = probes["aniso_sheet", "bs32"]
    launches5 = run_main_path(
        cfg_aniso, aniso_probes, fused_aniso.fused_aniso_step, 0.01,
        "main_path_aniso",
        "tests_tpu/test_aniso_tpu.py aliev_panfilov flat periodic, the "
        "rotating fibres of examples/anisotropic_fibers.py",
        build_kw=aniso_build,
        extra_checks=tensor_checks(aniso_probes,
                                   aniso_build["diffusion_tensor"]),
        keep=singles["aniso"])
    # the forcing and curvature slice: K1-K4 forced, and its five paths;
    # then forcing on a mesh: K8-K11 forced, and the paced paths on 2x2
    # shards, held to the single-device paced runs
    paced = {}
    forced_erk, (worst2f, timing2f), forced_k3, forced_launches = \
        forced_phases(cfg, cfg_gb, cfg_ap, ap_build, card, paced)
    mesh_forced = mesh_forced_phases(cfg, cfg_gb, cfg_ap, ap_build,
                                     *programs["torus_tensor"], probes,
                                     paced, card)

    worst14 = check_kstep_kernel([cfg, cfg_flat, gb_torus, gb_flat,
                                  ap_periodic])
    timing14 = kstep_timing(cfg, card)
    launches14 = kstep_main_paths(cfg, cfg_gb, probes, single_fhn, card)

    box_entries, box_singles = box_phases(cfg_box, card)
    sharded_fhn = {}
    shard_entries = shard_phases(cfg, probes, single_fhn, card, sharded_fhn)
    field_entries = shard_field_phases(cfg, programs, probes, singles, card)
    for entry in (*shard_entries, *field_entries):
        entry.update(mesh_forced[entry["name"]])
    slab_walls = {f"main_path_box{suffix}": box_singles[key]["wall_s"]
                  for key, suffix in (("bs32", ""), ("rkc2", "_rkc2"),
                                      ("scar", "_scar"))}
    shard_box_entries = shard_box_phases(cfg_box, box_singles, card,
                                         slab_walls)
    # forcing on the box: K6, K7, K12, K13 forced, and the paced slab
    box_forced = box_forced_phases(cfg_box, card, slab_walls)
    for entry in (*box_entries, *shard_box_entries):
        entry.update(box_forced[entry["name"]])
    # the six other kinetics families through K1, K2 and K3
    family_entries = kinetics_phases(card)
    stream_phases(cfg, programs["goldbeter_ark324"], single_fhn,
                  sharded_fhn, card)

    # the profiler traces of the run, and those taken again with more
    # primers after one lost kernels (ops/trace.py::traced)
    from crdmodel_tpu_torch.ops import trace
    phase("traces", taken=trace.traced.taken, retaken=trace.traced.retaken)
    k2_s = max(timing2)     # the stability-bound step: the larger time
    k3_shape = (2, cfg_gb.ny, cfg_gb.nx)    # the ark324 main path's shape
    print(json.dumps({"kernels": [
        kernel_entry("fused_erk_step", "fused_step.cu",
                     "crdmodel_tpu/ops/pallas_step.py:117", launches, worst,
                     k1_timing, forced_fields(
                         *forced_erk["k1"],
                         forced_launches["paced_fhn_bs32"])),
        kernel_entry("fused_rkc_step", "fused_rkc.cu",
                     "crdmodel_tpu/ops/pallas_rkc.py:365", launches2, worst2,
                     timing2[k2_s], forced_fields(
                         worst2f, *timing2f["divform", k2_s],
                         forced_launches["s1s2_pacing_rkc2"])),
        kernel_entry("fused_imex_step", "fused_imex.cu",
                     "crdmodel_tpu/ops/pallas_imex.py:155", launches3,
                     worst3, timing3[k3_shape], forced_fields(
                         *forced_k3,
                         forced_launches["paced_goldbeter_ark324"])),
        kernel_entry("fused_divform_step", "fused_divform.cu",
                     "crdmodel_tpu/ops/pallas_divform.py:130", launches4,
                     worst4, k4_timing, forced_fields(
                         *forced_erk["k4"],
                         forced_launches["paced_bounded_ap_bs32"])),
        kernel_entry("fused_rkc_step", "fused_rkc.cu",
                     "crdmodel_tpu/ops/pallas_rkc.py:764", launches2b,
                     worst2b, timing2b[max(timing2b)]),
        kernel_entry("fused_aniso_step", "fused_aniso.cu",
                     "crdmodel_tpu/ops/pallas_aniso.py:82", launches5,
                     worst5, k5_timing),
        *box_entries, *shard_entries, *field_entries,
        *shard_box_entries,
        kernel_entry("fused_kstep", "fused_kstep.cu",
                     "crdmodel_tpu/ops/pallas_kstep.py:112", launches14,
                     worst14, timing14[K14_SPEC]),
        *family_entries]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
