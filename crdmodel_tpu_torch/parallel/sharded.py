"""Sharded simulation: the adaptive integration over a mesh of shards
(counterpart of crdmodel_tpu/parallel/sharded.py).

The JAX package runs the whole solver loop under `shard_map`: each device
steps its own block, and every control decision (accept/reject, the next
h, failure flags) derives from `lax.psum`-reduced WRMS norms, so it is the
same on every device — the equivalent of the reference's SUNDIALS parallel
NVector, whose allreduce per step synchronised ARKode's error control
across MPI ranks (src/FHNmodel_torus.cpp:281). Here one controlling
process does the same with the shards as tensors (parallel/mesh.py): the
state is a Shards, one block a shard on its device (parallel/shards.py);
the integrator of integrate/erk.py runs once over it, its control state on
the mesh's first device; the per-shard sums are added there in a fixed
order (make_reduce), so all shards take the same steps.

The 3-D box shards its (y, x) axes over the mesh and keeps z on every
shard: a block is (nvars, nz, nyl, nxl), and every exchange moves (y, x)
halos of all nz planes.

Kernel selection, in the JAX package's order (crdmodel_tpu/parallel/
sharded.py:838-852): ERK tableaus through K8 (ops/fused_shard_step.py,
the profile operator, theta-only torus fields through its profile remap),
K11 (ops/fused_shard_divform.py: no-flux walls, obstacles, 2-D and flat
diffusion fields), K11's aniso mode (the 2-D tensor, flat and torus) or,
on the box, K12 (ops/fused_shard_box3d.py); ark324 through K10
(ops/fused_shard_imex.py); rkc2 through K9 (ops/fused_shard_rkc.py) or,
on the box, K13 (ops/fused_shard_box3d_rkc.py); each with the gates of
the JAX package's maybe_fused_shard_*; else the torch path
(make_local_rhs: a width-1 exchange before every RHS evaluation).

A forcing (core/forcing.py) runs on a mesh as under JAX's shard_map:
sharded_params registers each stimulus's profiles, which every shard sees
as its local slices, and the torch path calls forcing(t, block, local
params) on each shard. K8-K11 take a structured forcing in the kernel;
K12 and K13 decline one, so the box takes it on the torch path. Not
ported yet, each raising NotImplementedError with its ROADMAP item:
step_mode="normal" (item 15), checkpoints (item 14) and member lockstep
(item 14). speculative_k is ignored, as in the JAX package's sharded
driver: every shard steps one step at a time.

simulate_sharded runs the whole solve in one call; simulate_sharded_
streaming one stop at a time, handing each output's per-shard blocks to
a writer (io/trajectory.py::ShardedReferenceWriter). Both build their
steps from local_stepping, so they take the same steps bitwise.
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from crdmodel_tpu_torch.config import (PALLAS_AUTO_POINTS,
                                       PALLAS_BOX3D_AUTO_POINTS, SimConfig)
from crdmodel_tpu_torch.core.forcing import SeparableForcing
from crdmodel_tpu_torch.core.problem import (Problem, beta_field,
                                             build_problem, interior_rows,
                                             make_rho_bound,
                                             solver_breakpoints)
from crdmodel_tpu_torch.integrate import imex, rkc
from crdmodel_tpu_torch.integrate.erk import (TABLEAUS, StopLoop,
                                              integrate_to_outputs)
from crdmodel_tpu_torch.ops.kernel_common import coeff_kind
from crdmodel_tpu_torch.ops.stencil import (anisotropic3_from_padded,
                                            anisotropic_from_padded,
                                            divergence3_from_padded,
                                            divergence_from_padded,
                                            laplacian_from_padded)
from crdmodel_tpu_torch.parallel.halo import halo_pad
from crdmodel_tpu_torch.parallel.mesh import make_mesh
from crdmodel_tpu_torch.parallel.padding import pad_spec_for
from crdmodel_tpu_torch.parallel.shards import Shards
from crdmodel_tpu_torch.sim import (SimResult, output_times,
                                   refuse_checkpoints, run_stream,
                                   snapshot_policy)


def _unported(problem: Problem):
    """Raise for what the sharded run does not take yet."""
    if problem.cfg.step_mode != "tstop":
        raise NotImplementedError(f"step_mode={problem.cfg.step_mode!r} on "
                                  "a mesh is not ported yet (ROADMAP queue "
                                  "1, item 15)")


def tensor_weight(problem: Problem):
    """make_local_rhs's tensor_inv4 of a problem with a diffusion tensor
    (crdmodel_tpu/parallel/sharded.py:788-802): the flat surface's scalar
    mixed-pair weight 1/(4 dx dy) as a Python float, "param" for the
    torus's (nx,) profile, which rides params["inv4"], or the box's three
    weights (xy, xz, yz) as a tuple of floats; None without a tensor."""
    if problem.diffusion_tensor is None:
        return None
    inv4 = problem.geometry.tensor_coeffs64(
        *problem.diffusion_tensor, boundary=problem.cfg.boundary)[2]
    if problem.geometry.kind == "box":
        return tuple(float(v) for v in inv4)
    return "param" if np.ndim(inv4) > 0 else float(inv4)


def make_local_rhs(cfg: SimConfig, model, kind: str, mesh, pad_spec=None,
                   split: bool = False, divergence: bool = False,
                   tensor_inv4=None, tissue: bool = False, forcing=None):
    """rhs(t, state, params) over a Shards of local (nvars, nyl, nxl) blocks
    with width-1 exchanged halos (crdmodel_tpu/parallel/sharded.py:43-187,
    without pole bands). params["local"]: each shard's dict of
    "coeffs" (the profile operator's (nxl,) torus profiles or flat scalars;
    with divergence=True the four face arrays (aE, aW, aN, aS), (nxl,) or
    (nyl, nxl)), "b" (scalar or its (nyl, 1) rows), "interior" ((nyl, 1)
    bool, False on global rows 0 and ny-1), with tissue=True "tissue"
    ((nyl, nxl) bool, False on obstacle cells, whose RHS is zeroed so they
    hold their IC), with a tensor "_dxy_pad" (Dxy with a width-1 halo,
    exchanged once a run: build_local_run) and, when tensor_inv4 is
    "param", "inv4" (the (1, nxl) torus weights; else tensor_inv4 is the
    flat scalar) and, on a padded grid, "valid" ((nyl, nxl) bool, False on
    pad cells: every derivative is zeroed there, so pad values never move
    and the error sums exclude them).

    On the box (kind "box") the blocks are (nvars, nz, nyl, nxl), z local:
    the six faces in their broadcast-minimal shapes (aE (nxl,), aN (nyl,
    1), aU (nz, 1, 1), or (nz, nyl, nxl) fields) through
    divergence3_from_padded, a tensor through anisotropic3_from_padded with
    "_dxy_pad" the stacked (3, nz, nyl+2, nxl+2) (Dxy, Dxz, Dyz) and
    tensor_inv4 their three weights; "tissue" is (nz, nyl, nxl).

    forcing(t, state, params) -> dstate (core/forcing.py, or any such
    callable) is called on each shard, as under JAX's shard_map
    (:155-176), with the shard's block, its local dict (a
    SeparableForcing reads its "_stim_*" profiles there) and the step's
    params["_seg_end"], t and the segment end on the shard's device; it
    joins the diffusion term before the kinetics, kinetics + (diffusion +
    forcing), then come the freeze, the tissue and the pad masks.

    split=True returns (rhs_ex, rhs_im) for ark324: rhs_ex the diffusion
    (and the forcing) with the freeze applied, rhs_im the pointwise
    kinetics with the freeze, with no exchange, so the Newton stage solves
    are shard-local; both masked like rhs, so that rhs_ex + rhs_im is
    rhs."""
    just_diffusion = bool(cfg.just_diffusion)
    t_boundary = float(cfg.t_boundary)
    has_freeze = (t_boundary > 0.0) and not just_diffusion
    dvars = tuple(model.diffusive_vars)
    ratios = tuple(model.diffusion_ratios)
    padded = pad_spec is not None and pad_spec.active
    seam_y = pad_spec.seam_y() if padded else None
    seam_x = pad_spec.seam_x() if padded else None

    def operator(up, loc):
        if kind == "box":
            if tensor_inv4 is None:
                return divergence3_from_padded(up, loc["coeffs"])
            dp = loc["_dxy_pad"]
            return anisotropic3_from_padded(up, loc["coeffs"],
                                            (dp[0], dp[1], dp[2]),
                                            tensor_inv4)
        if tensor_inv4 is not None:
            inv4 = loc["inv4"] if tensor_inv4 == "param" else tensor_inv4
            return anisotropic_from_padded(up, loc["coeffs"], loc["_dxy_pad"],
                                           inv4)
        if divergence:
            return divergence_from_padded(up, loc["coeffs"])
        return laplacian_from_padded(up, loc["coeffs"], kind)

    def diffusion_terms(state, local):
        out = [[] for _ in local]
        for v in range(model.nvars):
            if v in dvars:
                r = ratios[dvars.index(v)]
                ups = halo_pad([blk[v] for blk in state], mesh, 1, seam_y,
                               seam_x)
                for i, up in enumerate(ups):
                    term = operator(up, local[i])
                    out[i].append(term if r == 1.0 else r * term)
            else:
                for i, blk in enumerate(state):
                    out[i].append(torch.zeros_like(blk[v]))
        return [torch.stack(o) for o in out]

    def forced(t, state, diffs, params):
        """Each shard's diffusion term plus its forcing."""
        if forcing is None:
            return diffs
        seg = params.get("_seg_end")
        out = []
        for blk, diff, loc in zip(state, diffs, params["local"]):
            dev = blk.device
            p = loc if seg is None else {**loc, "_seg_end": seg.to(dev)}
            t_dev = t.to(dev) if isinstance(t, torch.Tensor) else t
            out.append(diff + forcing(t_dev, blk, p))
        return out

    def freeze_flag(t, params):
        seg_end = params.get("_seg_end")
        freeze_now = torch.as_tensor(t < t_boundary)
        if seg_end is not None:
            freeze_now = freeze_now | (seg_end <= t_boundary)
        return freeze_now

    def finish(ydot, loc, freeze_now):
        """The freeze (when freeze_now is not None), the tissue and the pad
        masks on one shard's ydot."""
        if freeze_now is not None:
            frozen = torch.where(loc["interior"], ydot, 0.0)
            ydot = torch.where(freeze_now.to(ydot.device), frozen, ydot)
        if tissue:
            ydot = torch.where(loc["tissue"], ydot, 0.0)
        if padded:
            ydot = torch.where(loc["valid"], ydot, 0.0)
        return ydot

    def rhs(t, state, params):
        local = params["local"]
        diffs = forced(t, state, diffusion_terms(state, local), params)
        freeze_now = freeze_flag(t, params) if has_freeze else None
        out = []
        for blk, diff, loc in zip(state, diffs, local):
            ydot = (diff if just_diffusion
                    else model.kinetics(blk, loc["b"]) + diff)
            out.append(finish(ydot, loc, freeze_now))
        return Shards(out)

    if not split:
        return rhs

    def rhs_ex(t, state, params):
        local = params["local"]
        freeze_now = freeze_flag(t, params) if has_freeze else None
        diffs = forced(t, state, diffusion_terms(state, local), params)
        return Shards(finish(diff, loc, freeze_now)
                      for diff, loc in zip(diffs, local))

    def rhs_im(t, state, params):
        if just_diffusion:
            return torch.zeros_like(state)
        freeze_now = freeze_flag(t, params) if has_freeze else None
        return Shards(finish(model.kinetics(blk, loc["b"]), loc, freeze_now)
                      for blk, loc in zip(state, params["local"]))

    return rhs_ex, rhs_im


def mesh_pad_spec(cfg, mesh):
    """PadSpec for running cfg's grid on this mesh (parallel/padding.py);
    None when the grid divides the mesh evenly."""
    spec = pad_spec_for(cfg, *mesh.shape)
    return spec if spec.active else None


def sharded_params(problem: Problem, pad_spec=None) -> dict:
    """The global parameter tensors, wrap-padded to the mesh-divisible
    shape on a padded grid (crdmodel_tpu/parallel/sharded.py:258-420,
    without pole bands): "coeffs" (the profile operator's three
    (nx,) torus profiles or flat scalars; the divergence form's four face
    arrays, (nx,) or (ny, nx), with the closed faces of no-flux walls and
    obstacles zeroed; a tensor's four axis faces (ny, nx)), with a tensor
    "dxy" ((ny, nx)) and on the torus "inv4" (the (1, nx) mixed-pair
    weights), with an obstacle "tissue" ((ny, nx) bool, True = tissue),
    "b" (scalar or (ny, 1) ramp), "interior" ((ny, 1) bool), padded,
    "valid" ((nyp, nxp) bool) and, with a SeparableForcing, each stimulus
    i's profiles (:391-419): "_stim_row_{i}" (ny, 1) and "_stim_col_{i}"
    (1, nx), ones where it has none, or a full field's "_stim_{i}"
    (ny, nx), so that each shard's forcing reads its local slices. Wrap
    fill keeps pad values inside the physical range, and gives the fused
    kernels' mirror-pad cells their sources' values.

    On the box: the six faces in their broadcast-minimal shapes (aN
    (ny, 1), aU (nz, 1, 1): sharded_params pads and split_field splits an
    axis only where it spans the grid, so the z profiles stay replicated),
    a tensor's "dxy" the stacked (3, nz, ny, nx) (Dxy, Dxz, Dyz) and no
    "inv4" (its three weights are scalars: tensor_weight), "tissue"
    (nz, ny, nx); a stimulus's profiles as on the surface (its depth
    profile zprof stays on the stimulus, replicated)."""
    cfg = problem.cfg
    dtype, device = problem.y0.dtype, problem.device
    geometry = problem.geometry
    padded = pad_spec is not None and pad_spec.active
    params = {}
    if problem.diffusion_tensor is not None:
        faces, dxy, inv4 = geometry.tensor_coeffs64(
            *problem.diffusion_tensor, boundary=cfg.boundary)
        coeffs = tuple(torch.tensor(a, dtype=dtype, device=device)
                       for a in faces)
        if geometry.kind == "box":
            # one stack, so one exchange a run covers the three fields
            dxy = np.stack(dxy)
        params["dxy"] = torch.tensor(dxy, dtype=dtype, device=device)
        if geometry.kind != "box" and np.ndim(inv4) > 0:
            params["inv4"] = torch.tensor(np.reshape(inv4, (1, -1)),
                                          dtype=dtype, device=device)
    elif problem.diffusion_field is not None:
        coeffs = geometry.divergence_coeffs(problem.diffusion_field, dtype,
                                            device,
                                            face_mask=problem.face_mask)
    else:
        coeffs = geometry.stencil_coeffs(dtype, device)
    if problem.obstacle_mask is not None:
        params["tissue"] = torch.tensor(np.broadcast_to(
            np.asarray(problem.obstacle_mask, bool), geometry.grid.shape),
            device=device)
    b = beta_field(cfg, dtype, device)
    interior = interior_rows(cfg.ny, torch.bool, device)
    if padded:
        def pad(c):
            # only the axes that span the grid (size-1 axes broadcast)
            if c.dim() >= 1 and c.shape[-1] == cfg.nx:
                c = pad_spec.pad_cols(c)
            if c.dim() >= 2 and c.shape[-2] == cfg.ny:
                c = pad_spec.pad_rows(c)
            return c

        coeffs = tuple(pad(c) for c in coeffs)
        params = {k: pad(v) for k, v in params.items()}
        b, interior = pad(b), pad(interior)
    params.update(coeffs=tuple(coeffs), b=b, interior=interior)
    if padded:
        params["valid"] = torch.as_tensor(pad_spec.valid_mask(),
                                          device=device)
    params.update(stim_params(problem, pad_spec))
    return params


def stim_params(problem: Problem, pad_spec=None) -> dict:
    """The "_stim_*" entries of sharded_params: each stimulus's profiles of
    a SeparableForcing, wrap-padded like every other spatial parameter
    (crdmodel_tpu/parallel/sharded.py:391-419); {} without one."""
    frc = problem.forcing
    if not isinstance(frc, SeparableForcing):
        return {}
    cfg = problem.cfg
    dtype, device = problem.y0.dtype, problem.device
    padded = pad_spec is not None and pad_spec.active

    def tensor(a):
        return torch.tensor(np.asarray(a, np.float64), dtype=dtype,
                            device=device)

    out = {}
    for i, st in enumerate(frc.stimuli):
        if st.spatial is not None:
            a = tensor(np.broadcast_to(np.asarray(st.spatial, np.float64),
                                       (cfg.ny, cfg.nx)))
            if padded:
                a = pad_spec.pad_rows(pad_spec.pad_cols(a))
            out[f"_stim_{i}"] = a
            continue
        r = tensor(np.ones((cfg.ny, 1)) if st.row is None
                   else np.reshape(st.row, (-1, 1)))
        c = tensor(np.ones((1, cfg.nx)) if st.col is None
                   else np.reshape(st.col, (1, -1)))
        if padded:
            r, c = pad_spec.pad_rows(r), pad_spec.pad_cols(c)
        out[f"_stim_row_{i}"], out[f"_stim_col_{i}"] = r, c
    return out


def _local_block_shape(cfg, mesh, pad_spec=None) -> tuple:
    """(nyl, nxl) of one shard on the mesh."""
    if pad_spec is not None and pad_spec.active:
        return pad_spec.y.blk, pad_spec.x.blk
    py, px = mesh.shape
    return cfg.ny // py, cfg.nx // px


def split_field(a, mesh, nyl: int, nxl: int, ny_arr: int, nx_arr: int):
    """Each shard's local slice of a global tensor, on its device, in mesh
    order: the trailing axis is split where it spans nx_arr, the one before
    where it spans ny_arr (JAX's PartitionSpecs, sharded.py:329-340);
    broadcast axes and scalars are replicated."""
    out = []
    px = mesh.shape[1]
    for k, dev in enumerate(mesh.device_list()):
        iy, ix = divmod(k, px)
        blk = a
        if a.dim() >= 1 and a.shape[-1] == nx_arr:
            blk = blk[..., ix * nxl:(ix + 1) * nxl]
        if a.dim() >= 2 and a.shape[-2] == ny_arr:
            blk = blk[..., iy * nyl:(iy + 1) * nyl, :]
        out.append(blk.contiguous().to(dev))
    return out


def shard_params(params: dict, mesh, pad_spec, cfg) -> dict:
    """The run's params from the global sharded_params: "local", each
    shard's dict on its device, and "b" (and, padded, "valid") as Shards
    for the rho bound."""
    nyl, nxl = _local_block_shape(cfg, mesh, pad_spec)
    ny_arr, nx_arr = (pad_spec.padded_shape if pad_spec is not None
                      else (cfg.ny, cfg.nx))

    def split(a):
        return split_field(a, mesh, nyl, nxl, ny_arr, nx_arr)

    coeffs = list(zip(*(split(c) for c in params["coeffs"])))
    local = [{"coeffs": c} for c in coeffs]
    keys = ("b", "interior", "valid", "tissue", "dxy", "inv4",
            *(k for k in params if k.startswith("_stim")))
    for key in keys:
        if key in params:
            for loc, blk in zip(local, split(params[key])):
                loc[key] = blk
    out = {"local": tuple(local), "b": Shards(loc["b"] for loc in local)}
    if "valid" in params:
        out["valid"] = Shards(loc["valid"] for loc in local)
    return out


def with_dxy_halo(params: dict, mesh, pad_spec=None) -> dict:
    """params with each shard's "_dxy_pad": its Dxy block with a width-1
    halo, the seam legs of a padded axis included. Dxy is static, so one
    exchange a run serves every RHS evaluation (crdmodel_tpu/parallel/
    sharded.py:876-884)."""
    local = params["local"]
    if "dxy" not in local[0]:
        return params
    padded = pad_spec is not None and pad_spec.active
    ups = halo_pad([loc["dxy"] for loc in local], mesh, 1,
                   pad_spec.seam_y() if padded else None,
                   pad_spec.seam_x() if padded else None)
    return {**params, "local": tuple({**loc, "_dxy_pad": up}
                                     for loc, up in zip(local, ups))}


def split_state(y, mesh, pad_spec, cfg) -> Shards:
    """The global (nvars, ny, nx) state as a Shards of local blocks,
    wrap-padded first on a padded grid."""
    if pad_spec is not None:
        y = pad_spec.pad_field(y)
    nyl, nxl = _local_block_shape(cfg, mesh, pad_spec)
    return Shards(split_field(y, mesh, nyl, nxl, *y.shape[-2:]))


def gather(blocks, mesh, pad_spec=None):
    """The global state from a Shards of blocks, on the control device,
    without the pad cells."""
    py, px = mesh.shape
    ctl = mesh.control
    blocks = list(blocks)
    rows = [torch.cat([b.to(ctl) for b in blocks[iy * px:(iy + 1) * px]],
                      dim=-1) for iy in range(py)]
    full = torch.cat(rows, dim=-2)
    return pad_spec.unpad_field(full) if pad_spec is not None else full


def _shard_kernel_eligible(cfg, mesh) -> bool:
    """Shard-kernel selection policy (crdmodel_tpu/parallel/sharded.py:
    431-451, 515-522): explicit use_pallas wins; auto takes the kernels
    only with every shard on a CUDA device and a LOCAL block of at least
    PALLAS_AUTO_POINTS points (the per-device work is nyl*nxl), on the box
    a local VOLUME nz*nyl*nxl of at least PALLAS_BOX3D_AUTO_POINTS. On the
    CPU the kernels' plain versions run, with use_pallas=True only (the JAX
    package's interpret=True)."""
    if cfg.use_pallas is not None:
        return bool(cfg.use_pallas)
    if any(d.type != "cuda" for d in mesh.device_list()):
        return False
    nyl, nxl = _local_block_shape(cfg, mesh)
    if cfg.surface == "box":
        return cfg.nz * nyl * nxl >= PALLAS_BOX3D_AUTO_POINTS
    return nyl * nxl >= PALLAS_AUTO_POINTS


def maybe_fused_shard_step(problem: Problem, mesh, pad_spec=None):
    """K8 (ops/fused_shard_step.py) when the configuration supports it,
    else None (crdmodel_tpu/parallel/sharded.py:454-492)."""
    from crdmodel_tpu_torch.ops import fused_shard_step
    cfg = problem.cfg
    if cfg.method not in TABLEAUS or not _shard_kernel_eligible(cfg, mesh):
        return None
    tableau = TABLEAUS[cfg.method]
    nyl, nxl = _local_block_shape(cfg, mesh, pad_spec)
    if not fused_shard_step.is_shard_supported(problem, tableau,
                                               problem.y0.dtype, nyl, nxl):
        return None
    return fused_shard_step.build_fused_shard_step(problem, tableau, mesh,
                                                   pad_spec)


def maybe_fused_shard_box3d(problem: Problem, mesh, pad_spec=None):
    """K12 (ops/fused_shard_box3d.py) when the configuration supports it,
    else None: ERK tableaus on the 3-D box (crdmodel_tpu/parallel/
    sharded.py:495-536)."""
    from crdmodel_tpu_torch.ops import fused_shard_box3d
    cfg = problem.cfg
    if problem.geometry.kind != "box" or cfg.method not in TABLEAUS:
        return None
    if not _shard_kernel_eligible(cfg, mesh):
        return None
    tableau = TABLEAUS[cfg.method]
    nyl, nxl = _local_block_shape(cfg, mesh, pad_spec)
    if not fused_shard_box3d.is_shard_box3d_supported(
            problem, tableau, problem.y0.dtype, nyl, nxl):
        return None
    return fused_shard_box3d.build_fused_shard_box3d(problem, tableau, mesh,
                                                     pad_spec)


def maybe_fused_shard_rkc(problem: Problem, mesh, rho_fn, pad_spec=None):
    """K9 (ops/fused_shard_rkc.py) or, on the box, K13
    (ops/fused_shard_box3d_rkc.py) when supported, else None
    (crdmodel_tpu/parallel/sharded.py:604-677)."""
    from crdmodel_tpu_torch.ops import fused_shard_box3d_rkc, fused_shard_rkc
    from crdmodel_tpu_torch.sim import _quiescent_autonomous
    cfg = problem.cfg
    if cfg.method != "rkc2":
        return None
    if cfg.use_pallas is None and _quiescent_autonomous(problem):
        return None   # the stage-budget cost model (sim.py)
    if not _shard_kernel_eligible(cfg, mesh):
        return None
    nyl, nxl = _local_block_shape(cfg, mesh, pad_spec)
    dtype = problem.y0.dtype
    if problem.geometry.kind == "box":
        if not fused_shard_box3d_rkc.is_shard_box3d_rkc_supported(
                problem, dtype, nyl, nxl):
            return None
        return fused_shard_box3d_rkc.build_fused_shard_box3d_rkc(
            problem, mesh, rho_fn, pad_spec)
    if not fused_shard_rkc.is_shard_rkc_supported(problem, dtype, nyl, nxl):
        return None
    return fused_shard_rkc.build_fused_shard_rkc(problem, mesh, rho_fn,
                                                 pad_spec)


def maybe_fused_shard_divform(problem: Problem, mesh, pad_spec=None,
                              aniso: bool = False):
    """K11 (ops/fused_shard_divform.py) when the configuration supports it,
    else None: the divergence form that K8 declines (no-flux walls,
    obstacles, 2-D and flat diffusion fields) or, with aniso=True, the 2-D
    diffusion tensor (crdmodel_tpu/parallel/sharded.py:539-601)."""
    from crdmodel_tpu_torch.ops import fused_shard_divform
    cfg = problem.cfg
    if cfg.method not in TABLEAUS or not _shard_kernel_eligible(cfg, mesh):
        return None
    tableau = TABLEAUS[cfg.method]
    nyl, nxl = _local_block_shape(cfg, mesh, pad_spec)
    if not fused_shard_divform.is_shard_divform_supported(
            problem, tableau, problem.y0.dtype, nyl, nxl, aniso=aniso):
        return None
    return fused_shard_divform.build_fused_shard_divform(
        problem, tableau, mesh, pad_spec, aniso=aniso)


def maybe_fused_shard_aniso(problem: Problem, mesh, pad_spec=None):
    """K11's aniso mode when supported, else None (crdmodel_tpu/parallel/
    sharded.py:571-601): the only fused route of a tensor on the torus."""
    return maybe_fused_shard_divform(problem, mesh, pad_spec, aniso=True)


def maybe_fused_shard_imex(problem: Problem, mesh, pad_spec=None):
    """K10 (ops/fused_shard_imex.py) when supported, else None
    (crdmodel_tpu/parallel/sharded.py:680-714)."""
    from crdmodel_tpu_torch.ops import fused_shard_imex
    cfg = problem.cfg
    if cfg.method != "ark324" or not _shard_kernel_eligible(cfg, mesh):
        return None
    nyl, nxl = _local_block_shape(cfg, mesh, pad_spec)
    if not fused_shard_imex.is_shard_imex_supported(
            problem, problem.y0.dtype, nyl, nxl):
        return None
    return fused_shard_imex.build_fused_shard_imex(problem, mesh, pad_spec)


def select_shard_kernel(problem: Problem, mesh, pad_spec=None,
                        rho_fn=None):
    """(name, kernel) of the fused shard kernel that takes `problem`'s
    steps on `mesh`, in the JAX package's order of selection
    (crdmodel_tpu/parallel/sharded.py:838-852 and run_local): "K8", "K11",
    "K11 aniso", "K12" (the box), then "K10" (ark324), then "K9" or, on
    the box, "K13" (rkc2, with the run's rho_fn); (None, None) for the
    torch path."""
    rkc_name = "K13" if problem.geometry.kind == "box" else "K9"
    chain = (("K8", lambda: maybe_fused_shard_step(problem, mesh, pad_spec)),
             ("K11", lambda: maybe_fused_shard_divform(problem, mesh,
                                                       pad_spec)),
             ("K11 aniso", lambda: maybe_fused_shard_aniso(problem, mesh,
                                                           pad_spec)),
             ("K12", lambda: maybe_fused_shard_box3d(problem, mesh,
                                                     pad_spec)),
             ("K10", lambda: maybe_fused_shard_imex(problem, mesh,
                                                    pad_spec)),
             (rkc_name, lambda: maybe_fused_shard_rkc(problem, mesh, rho_fn,
                                                      pad_spec)))
    for name, build in chain:
        kernel = build()
        if kernel is not None:
            return name, kernel
    return None, None


def make_reduce(mesh, valid=None):
    """The cross-shard sum for the WRMS norms (crdmodel_tpu/parallel/
    sharded.py:717-734, JAX's psum): x a Shards of per-shard partial sums
    or, for h0's norms, of cell-shaped fields, which `valid` (a Shards of
    the physical-cell masks on a padded grid) masks first. Each shard's sum
    goes to the control device and they are added in mesh order."""
    ctl = mesh.control

    def reduce_fn(x):
        parts = []
        for i, xi in enumerate(x):
            if valid is not None and xi.dim() >= 2:
                xi = torch.where(valid.blocks[i], xi, 0.0)
            parts.append(torch.sum(xi).to(ctl))
        return functools.reduce(torch.add, parts)

    return reduce_fn


def make_max_reduce(mesh):
    """make_rho_bound's max_reduce(fn, y, b): fn(block, beta) -> 0-d on
    each shard of the Shards y and b, their max on the control device in
    mesh order (JAX's pmax)."""
    ctl = mesh.control

    def max_reduce(fn, y, b):
        return functools.reduce(torch.maximum,
                                [fn(yi, bi).to(ctl) for yi, bi in zip(y, b)])

    return max_reduce


def _mask_rho(rho0):
    """Spectral-radius bound over the PHYSICAL cells only
    (crdmodel_tpu/parallel/sharded.py:737-748): pad cells take their
    shard's (0, 0) cell, so the max sees physical values (on pad-only
    shards a wrap-copied cell: finite and conservative)."""
    def rho(t, y, params):
        y = y.map(lambda yl, v: torch.where(v, yl, yl[..., :1, :1]),
                  params["valid"])
        return rho0(t, y, params)

    return rho


def sharded_rho_bound(problem: Problem, mesh, pad_spec=None):
    """rkc2's spectral-radius bound of a sharded state: the kinetics term
    max-reduced across the shards, over the physical cells on a padded
    grid (crdmodel_tpu/parallel/sharded.py:818-829)."""
    rho_fn = make_rho_bound(problem.cfg, problem.model, problem.geometry,
                            problem.y0.dtype,
                            max_reduce=make_max_reduce(mesh),
                            diffusion_field=problem.diffusion_field,
                            diffusion_tensor=problem.diffusion_tensor,
                            face_mask=problem.face_mask)
    return _mask_rho(rho_fn) if pad_spec is not None else rho_fn


class LocalStepping(NamedTuple):
    """The pieces of a sharded run (crdmodel_tpu/parallel/sharded.py:
    751-918, without member_sync), which the batch and the streaming
    drivers share, so that both take the same steps: the local RHS, the pad
    plan, the output times and the fused shard kernel (select_shard_kernel;
    None on the torch path) with its name."""
    rhs: object
    pad_spec: object
    touts: np.ndarray
    name: Optional[str]
    kernel: object
    loop_kw: dict       # StopLoop's keywords, but reduce_fn and y_loop0
    mesh: object

    def unpad(self, y):
        """The loop state's blocks without the kernel's halo (a Shards of
        the padded grid's equal blocks)."""
        return self.kernel.unpad(y) if self.kernel is not None else y

    def loop_args(self, y0, params) -> tuple:
        """(params, keywords) of the StopLoop that starts from the Shards
        y0 with shard_params' params: Dxy's halo exchanged once, the
        cross-shard reduce_fn, the kernel's padded y_loop0."""
        params = with_dxy_halo(params, self.mesh, self.pad_spec)
        kw = dict(self.loop_kw,
                  reduce_fn=make_reduce(self.mesh, params.get("valid")))
        if self.kernel is not None:
            kw["y_loop0"] = self.kernel.pad(y0)
        return params, kw


def local_stepping(problem: Problem, mesh) -> LocalStepping:
    """The LocalStepping of `problem` on `mesh`, the kernel from
    select_shard_kernel."""
    _unported(problem)
    cfg = problem.cfg
    model = problem.model
    kind = coeff_kind(problem.geometry.kind)
    pad_spec = mesh_pad_spec(cfg, mesh)
    operator = dict(divergence=problem.diffusion_field is not None,
                    tensor_inv4=tensor_weight(problem),
                    tissue=problem.obstacle_mask is not None)
    local_rhs = make_local_rhs(cfg, model, kind, mesh, pad_spec=pad_spec,
                               forcing=problem.forcing, **operator)
    rhs_split = (make_local_rhs(cfg, model, kind, mesh, pad_spec=pad_spec,
                                split=True, forcing=problem.forcing,
                                **operator)
                 if cfg.method == "ark324" else None)
    rho_fn = (sharded_rho_bound(problem, mesh, pad_spec)
              if cfg.method == "rkc2" else None)
    name, kernel = select_shard_kernel(problem, mesh, pad_spec, rho_fn)
    kw = dict(rtol=cfg.rtol, atol=cfg.atol, method=cfg.method,
              max_steps=cfg.max_steps,
              breakpoints=solver_breakpoints(cfg, problem.forcing),
              step_mode=cfg.step_mode,
              global_size=problem.y0.numel(),    # the PHYSICAL cell count
              rho_fn=rho_fn, rhs_split=rhs_split)
    if name in ("K9", "K13"):
        kw.update(step_err=kernel.step_err, err_order=rkc.ERR_ORDER,
                  h_limit_fn=kernel.h_limit)
    elif kernel is not None:
        # K8, K10, K11 and K12 carry no state (init_carry's default ())
        kw.update(step_err=lambda t, y, h, p, carry:
                  (*kernel.step_err(t, y, h, p), ()),
                  err_order=(imex.ERR_ORDER if name == "K10"
                             else TABLEAUS[cfg.method].err_order))
    return LocalStepping(local_rhs, pad_spec, output_times(cfg), name,
                         kernel, kw, mesh)


def build_local_run(problem: Problem, mesh):
    """run(y0, params) -> (traj, stats) of `problem` on `mesh`, with y0 a
    Shards of local blocks and params from shard_params, plus the pad_spec,
    the output times and whether a fused shard kernel takes the steps
    (local_stepping). traj is gathered on the control device, without the
    pad cells."""
    st = local_stepping(problem, mesh)

    def capture(y):
        return gather(st.unpad(y), mesh, st.pad_spec)

    def run(y0, params):
        params, kw = st.loop_args(y0, params)
        return integrate_to_outputs(st.rhs, y0, params, 0.0, st.touts,
                                    capture=capture, **kw)

    return run, st.pad_spec, st.touts, st.kernel is not None


def _sync(mesh):
    for d in dict.fromkeys(mesh.device_list()):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def default_mesh(cfg: SimConfig, n_devices: Optional[int], device):
    """One shard on each of n_devices CUDA cards (all visible by default)
    or, with a CPU `device`, n_devices shards on it."""
    dev = torch.device(device)
    devices = None if dev.type == "cuda" else [dev] * (n_devices or 1)
    return make_mesh(n_devices=n_devices, grid_shape=(cfg.ny, cfg.nx),
                     devices=devices)


def simulate_sharded(cfg: SimConfig, mesh=None,
                     n_devices: Optional[int] = None,
                     problem: Optional[Problem] = None,
                     device="cuda") -> SimResult:
    """Sharded variant of sim.simulate() (crdmodel_tpu/parallel/sharded.py:
    1394-1418). Without a mesh, one shard on each of n_devices CUDA cards
    (all visible by default) or, with device="cpu", n_devices shards on the
    CPU. The problem is built on the mesh's control device. Returns the
    trajectory unpadded and gathered there, the IC first; wall_time covers
    the integration, device work included."""
    if mesh is None:
        mesh = default_mesh(cfg, n_devices, device)
    problem = (problem if problem is not None
               else build_problem(cfg, mesh.control))
    run, pad_spec, touts, fused = build_local_run(problem, mesh)
    params = shard_params(sharded_params(problem, pad_spec), mesh, pad_spec,
                          problem.cfg)
    y0 = split_state(problem.y0, mesh, pad_spec, problem.cfg)
    _sync(mesh)
    t_start = time.perf_counter()
    traj, stats = run(y0, params)
    _sync(mesh)
    wall = time.perf_counter() - t_start
    ic = problem.y0.to(mesh.control)
    return SimResult(cfg=problem.cfg, problem=problem,
                     trajectory=torch.cat([ic[None], traj], dim=0),
                     touts=np.concatenate([[0.0], touts]),
                     stats=stats, wall_time=wall, fused=fused)


def physical_blocks(blocks: Shards, mesh, pad_spec=None) -> Shards:
    """Each shard's block without its pad cells (parallel/padding.py: pads
    sit past the last physical row and column, so a shard keeps its leading
    rows and columns)."""
    if pad_spec is None:
        return blocks
    px = mesh.shape[1]
    out = []
    for k, blk in enumerate(blocks):
        iy, ix = divmod(k, px)
        nyl, nxl = blk.shape[-2:]
        rows = max(0, min(nyl, pad_spec.y.n - iy * nyl))
        cols = max(0, min(nxl, pad_spec.x.n - ix * nxl))
        out.append(blk[..., :rows, :cols])
    return Shards(out)


def simulate_sharded_streaming(cfg: SimConfig, mesh=None,
                               n_devices: Optional[int] = None,
                               problem: Optional[Problem] = None,
                               on_snapshot=None, progress: bool = False,
                               checkpoint_every: Optional[int] = None,
                               checkpoint_dir: Optional[str] = None,
                               resume_dir: Optional[str] = None,
                               host_offload: bool = False,
                               snapshot_mode: Optional[str] = None,
                               device="cuda") -> SimResult:
    """Streaming sharded run (crdmodel_tpu/parallel/sharded.py:1180-1391):
    simulate_sharded's steps (local_stepping, the same StopLoop calls), one
    stop at a time, with sim.py::simulate_streaming's snapshot modes,
    progress line and sticky failure. The mesh and problem default as in
    simulate_sharded. After each output, `on_snapshot(k, blocks)` receives
    a Shards of each shard's physical block, pad cells removed, on its
    device (io/trajectory.py::ShardedReferenceWriter writes them as the
    reference's per-rank files); the trajectory's rows are gathered on the
    control device. checkpoint_every, checkpoint_dir and resume_dir raise
    NotImplementedError (ROADMAP queue 1, item 14)."""
    snapshot_mode = snapshot_policy(snapshot_mode, host_offload, on_snapshot,
                                    None)
    refuse_checkpoints(checkpoint_every=checkpoint_every,
                       checkpoint_dir=checkpoint_dir, resume_dir=resume_dir)
    if mesh is None:
        mesh = default_mesh(cfg, n_devices, device)
    problem = (problem if problem is not None
               else build_problem(cfg, mesh.control))
    cfg = problem.cfg
    st = local_stepping(problem, mesh)
    params = shard_params(sharded_params(problem, st.pad_spec), mesh,
                          st.pad_spec, cfg)
    y0 = split_state(problem.y0, mesh, st.pad_spec, cfg)
    _sync(mesh)
    t_start = time.perf_counter()
    params, kw = st.loop_args(y0, params)
    loop = StopLoop(st.rhs, y0, params, 0.0, st.touts, capture=st.unpad,
                    **kw)
    emit = None
    if on_snapshot is not None:
        def emit(k, snap):
            on_snapshot(k, physical_blocks(snap, mesh, st.pad_spec))
    traj, tout_axis, stats = run_stream(
        loop, st.touts, snapshot_mode, emit, progress, t_start,
        row=lambda snap: gather(snap, mesh, st.pad_spec))
    _sync(mesh)
    return SimResult(cfg=cfg, problem=problem, trajectory=traj,
                     touts=tout_axis, stats=stats,
                     wall_time=time.perf_counter() - t_start,
                     fused=st.kernel is not None)
