"""The device time of each launch of K7's and K13's step on the card, chunk
by chunk, in one tree of the port.

For the volumetric slab's four operator modes (chip_smoke.py::box_modes,
from the ICs, f32, unfrozen) and s = 5 and 7, it traces 24 steps of K7 at
(2,32,512,512) and of K13 on shard 0 of the slab's 2x2 mesh
(2,32,272,272) with torch.profiler (ops/trace.py::traced, or an older
tree's padded window) and prints one
JSON line a measurement: where the tree runs the chunk kernel
(ops/box_stream.py::rkc_uses_stream), the median device µs of the first
and of the second launch of a step and of their sum; elsewhere of the one
launch. With --min-tiles, K13's chunk-kernel steps are taken again at
each of those plans (ops/box_stream.py::RKC_MIN_TILES set for the call).

    python3 scripts/rkc_chunk_probe.py [--tree DIR] [--label NAME]
        [--min-tiles 256,264,512]

Only the wrappers' public signatures are used, so an older tree times the
same way; compare trees only within one call. Needs a CUDA card; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = (5, 7)
STEPS = 24


def traced_kernels(trace, body):
    """The device kernels of one trace of body() by the tree's
    ops/trace.py: a trace checked to hold every launch's kernel (traced)
    where the tree has it, else an older tree's padded window."""
    if hasattr(trace, "traced"):
        return trace.traced(body)[0]
    with trace.window() as prof:
        body()
    return trace.traced_kernels(prof)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--label", default="this")
    ap.add_argument("--min-tiles", default="",
                    help="comma-separated plans for K13's chunk kernel")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.ops import _build, box_stream, trace
    from crdmodel_tpu_torch.ops import fused_box3d_rkc as f7
    from crdmodel_tpu_torch.ops import fused_shard_box3d_rkc as f13
    from crdmodel_tpu_torch.ops.fused_rkc import static_stage_tables
    from crdmodel_tpu_torch.ops.fused_shard_step import HALO
    from crdmodel_tpu_torch.ops.kernel_common import (
        make_shard_box_constants, prepare_box_constants)

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: rkc_chunk_probe.py needs an NVIDIA GPU")
    card = cs.card_line()
    print(json.dumps({"tree": args.label, "build_s": _build.build(),
                      "card": card}), flush=True)
    plans = [int(m) for m in args.min_tiles.split(",") if m]
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device="cuda")
    mu1, ctab = static_stage_tables(f7.C_RKC, f32, "cuda")
    mesh = cs.shard_mesh(cs.SHARD_MESH)
    for case, cfg, build_kw in cs.box_modes(cs.volumetric_box()):
        problem = build_problem(cfg, "cuda", **build_kw)
        bc = prepare_box_constants(problem, f32, "cuda")
        y = problem.y0.contiguous()
        bufs, consts = cs.shard_inputs(problem, mesh, y.cpu().numpy(), f32,
                                       HALO, make_shard_box_constants)
        chunked = (hasattr(box_stream, "rkc_uses_stream")
                   and box_stream.rkc_uses_stream(bc.kind))
        rho = cs.problem_rho(problem, y)
        for s in STAGES:
            hs, st = cs.rkc_step_inputs(s, rho, f32)
            steps = (
                ("k7", None, lambda: f7.fused_box3d_rkc_step(
                    y, hs, zero, st, mu1, ctab, bc, cfg.rtol, cfg.atol)),
                *(("k13", m, lambda: f13.fused_shard_box3d_rkc_step(
                    bufs[0], hs, zero, st, mu1, ctab, consts[0], cfg.rtol,
                    cfg.atol)) for m in [None] + (plans if chunked else [])))
            for name, min_tiles, fn in steps:
                saved = getattr(box_stream, "RKC_MIN_TILES", None)
                if min_tiles is not None:
                    box_stream.RKC_MIN_TILES = min_tiles
                try:
                    fn()
                    torch.cuda.synchronize()
                    kernels = traced_kernels(
                        trace, lambda: [fn() for _ in range(STEPS)])
                finally:
                    if min_tiles is not None:
                        box_stream.RKC_MIN_TILES = saved
                d = [e["dur"] for e in sorted(
                    (e for e in kernels if "rkc" in e["name"]),
                    key=lambda e: e["ts"])]
                rec = dict(tree=args.label, kernel=name, case=case,
                           mode=bc.kind, s=s, launches=len(d),
                           min_tiles=min_tiles, card=card)
                if chunked and len(d) % 2 == 0:
                    first, second = np.array(d[0::2]), np.array(d[1::2])
                    rec.update(chunk0_us=float(np.median(first)),
                               chunk1_us=float(np.median(second)),
                               step_us=float(np.median(first + second)))
                else:
                    rec.update(step_us=float(np.median(d)))
                print(json.dumps(rec), flush=True)
        del problem, bc, y, bufs, consts


if __name__ == "__main__":
    main()
