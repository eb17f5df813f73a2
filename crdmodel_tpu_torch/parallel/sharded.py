"""Sharded simulation: the adaptive integration over a mesh of shards
(counterpart of crdmodel_tpu/parallel/sharded.py, its ERK and rkc2 slice).

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

Kernel selection: ERK tableaus through K8 (ops/fused_shard_step.py), rkc2
through K9 (ops/fused_shard_rkc.py), with the gates of the JAX package's
maybe_fused_shard_step / maybe_fused_shard_rkc; else the torch path
(make_local_rhs: a width-1 exchange before every RHS evaluation). Not
ported yet, each raising NotImplementedError with its ROADMAP item:
ark324 (kernel K10), the divergence form and diffusion tensors (K11), the
3-D box (K12, K13), streaming (item 5) and member lockstep (item 14).
"""

from __future__ import annotations

import functools
import time
from typing import Optional

import numpy as np
import torch

from crdmodel_tpu_torch.config import PALLAS_AUTO_POINTS, SimConfig
from crdmodel_tpu_torch.core.problem import (Problem, beta_field,
                                             build_problem, interior_rows,
                                             make_rho_bound,
                                             solver_breakpoints)
from crdmodel_tpu_torch.integrate import rkc
from crdmodel_tpu_torch.integrate.erk import TABLEAUS, integrate_to_outputs
from crdmodel_tpu_torch.ops.kernel_common import coeff_kind
from crdmodel_tpu_torch.ops.stencil import laplacian_from_padded
from crdmodel_tpu_torch.parallel.halo import halo_pad
from crdmodel_tpu_torch.parallel.mesh import make_mesh
from crdmodel_tpu_torch.parallel.padding import pad_spec_for
from crdmodel_tpu_torch.parallel.shards import Shards
from crdmodel_tpu_torch.sim import SimResult, output_times


def _unported(problem: Problem):
    """Raise for what this slice of the sharded run does not take."""
    cfg = problem.cfg
    if problem.geometry.kind == "box":
        raise NotImplementedError("sharded 3-D boxes are not ported yet "
                                  "(ROADMAP queue 1, item 15: kernels K12 "
                                  "and K13)")
    if problem.diffusion_tensor is not None:
        raise NotImplementedError("sharded diffusion tensors are not ported "
                                  "yet (ROADMAP queue 1, item 15: kernel "
                                  "K11's aniso mode)")
    if (problem.diffusion_field is not None or problem.face_mask is not None
            or problem.obstacle_mask is not None):
        raise NotImplementedError("the sharded divergence form is not ported "
                                  "yet (ROADMAP queue 1, item 15: kernel "
                                  "K11)")
    if cfg.method == "ark324":
        raise NotImplementedError("sharded ark324 is not ported yet (ROADMAP "
                                  "queue 1, item 15: kernel K10)")


def make_local_rhs(cfg: SimConfig, model, kind: str, mesh, pad_spec=None,
                   split: bool = False):
    """rhs(t, state, params) over a Shards of local (nvars, nyl, nxl) blocks
    with width-1 exchanged halos (crdmodel_tpu/parallel/sharded.py:43-187,
    the profile operator). params["local"]: each shard's dict of "coeffs"
    (its (nxl,) torus profiles or the flat scalars), "b" (scalar or its
    (nyl, 1) rows), "interior" ((nyl, 1) bool, False on global rows 0 and
    ny-1) and, on a padded grid, "valid" ((nyl, nxl) bool, False on pad
    cells: every derivative is zeroed there, so pad values never move and
    the error sums exclude them). split=True (ark324's pair) waits for
    kernel K10's slice."""
    if split:
        raise NotImplementedError("the sharded IMEX split is not ported yet "
                                  "(ROADMAP queue 1, item 15: kernel K10)")
    just_diffusion = bool(cfg.just_diffusion)
    t_boundary = float(cfg.t_boundary)
    has_freeze = (t_boundary > 0.0) and not just_diffusion
    dvars = tuple(model.diffusive_vars)
    ratios = tuple(model.diffusion_ratios)
    padded = pad_spec is not None and pad_spec.active
    seam_y = pad_spec.seam_y() if padded else None
    seam_x = pad_spec.seam_x() if padded else None

    def diffusion_terms(state, local):
        out = [[] for _ in local]
        for v in range(model.nvars):
            if v in dvars:
                r = ratios[dvars.index(v)]
                ups = halo_pad([blk[v] for blk in state], mesh, 1, seam_y,
                               seam_x)
                for i, up in enumerate(ups):
                    term = laplacian_from_padded(up, local[i]["coeffs"], kind)
                    out[i].append(term if r == 1.0 else r * term)
            else:
                for i, blk in enumerate(state):
                    out[i].append(torch.zeros_like(blk[v]))
        return [torch.stack(o) for o in out]

    def rhs(t, state, params):
        local = params["local"]
        diffs = diffusion_terms(state, local)
        if has_freeze:
            seg_end = params.get("_seg_end")
            freeze_now = torch.as_tensor(t < t_boundary)
            if seg_end is not None:
                freeze_now = freeze_now | (seg_end <= t_boundary)
        out = []
        for blk, diff, loc in zip(state, diffs, local):
            ydot = (diff if just_diffusion
                    else model.kinetics(blk, loc["b"]) + diff)
            if has_freeze:
                frozen = torch.where(loc["interior"], ydot, 0.0)
                ydot = torch.where(freeze_now.to(blk.device), frozen, ydot)
            if padded:
                ydot = torch.where(loc["valid"], ydot, 0.0)
            out.append(ydot)
        return Shards(out)

    return rhs


def mesh_pad_spec(cfg, mesh):
    """PadSpec for running cfg's grid on this mesh (parallel/padding.py);
    None when the grid divides the mesh evenly."""
    spec = pad_spec_for(cfg, *mesh.shape)
    return spec if spec.active else None


def sharded_params(problem: Problem, pad_spec=None) -> dict:
    """The global parameter tensors of the profile operator, wrap-padded to
    the mesh-divisible shape on a padded grid
    (crdmodel_tpu/parallel/sharded.py:258-420): "coeffs" (three (nx,)
    torus profiles or three flat scalars), "b" (scalar or (ny, 1) ramp),
    "interior" ((ny, 1) bool) and, padded, "valid" ((nyp, nxp) bool). Wrap
    fill keeps pad values inside the physical range, and gives the fused
    kernels' mirror-pad cells their sources' values."""
    cfg = problem.cfg
    dtype, device = problem.y0.dtype, problem.device
    padded = pad_spec is not None and pad_spec.active
    coeffs = problem.geometry.stencil_coeffs(dtype, device)
    b = beta_field(cfg, dtype, device)
    interior = interior_rows(cfg.ny, torch.bool, device)
    if padded:
        coeffs = tuple(pad_spec.pad_cols(c) if c.dim() == 1 else c
                       for c in coeffs)
        if b.dim() == 2:
            b = pad_spec.pad_rows(b)
        interior = pad_spec.pad_rows(interior)
    params = {"coeffs": coeffs, "b": b, "interior": interior}
    if padded:
        params["valid"] = torch.as_tensor(pad_spec.valid_mask(),
                                          device=device)
    return params


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
    for key in ("b", "interior", "valid"):
        if key in params:
            for loc, blk in zip(local, split(params[key])):
                loc[key] = blk
    out = {"local": tuple(local), "b": Shards(loc["b"] for loc in local)}
    if "valid" in params:
        out["valid"] = Shards(loc["valid"] for loc in local)
    return out


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
    431-451): explicit use_pallas wins; auto takes the kernels only with
    every shard on a CUDA device and a LOCAL block of at least
    PALLAS_AUTO_POINTS points (the per-device work is nyl*nxl). On the CPU
    the kernels' plain versions run, with use_pallas=True only (the JAX
    package's interpret=True)."""
    if cfg.use_pallas is not None:
        return bool(cfg.use_pallas)
    if any(d.type != "cuda" for d in mesh.device_list()):
        return False
    nyl, nxl = _local_block_shape(cfg, mesh)
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


def maybe_fused_shard_rkc(problem: Problem, mesh, rho_fn, pad_spec=None):
    """K9 (ops/fused_shard_rkc.py) when supported, else None
    (crdmodel_tpu/parallel/sharded.py:604-677, the profile branch)."""
    from crdmodel_tpu_torch.ops import fused_shard_rkc
    from crdmodel_tpu_torch.sim import _quiescent_autonomous
    cfg = problem.cfg
    if cfg.method != "rkc2":
        return None
    if cfg.use_pallas is None and _quiescent_autonomous(problem):
        return None   # the stage-budget cost model (sim.py)
    if not _shard_kernel_eligible(cfg, mesh):
        return None
    nyl, nxl = _local_block_shape(cfg, mesh, pad_spec)
    if not fused_shard_rkc.is_shard_rkc_supported(problem, problem.y0.dtype,
                                                  nyl, nxl):
        return None
    return fused_shard_rkc.build_fused_shard_rkc(problem, mesh, rho_fn,
                                                 pad_spec)


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
                            max_reduce=make_max_reduce(mesh))
    return _mask_rho(rho_fn) if pad_spec is not None else rho_fn


def build_local_run(problem: Problem, mesh):
    """run(y0, params) -> (traj, stats) of `problem` on `mesh`, with y0 a
    Shards of local blocks and params from shard_params, plus the pad_spec,
    the output times and whether a fused shard kernel takes the steps
    (crdmodel_tpu/parallel/sharded.py:751-918, without member_sync and the
    branches _unported names). traj is gathered on the control device,
    without the pad cells."""
    _unported(problem)
    cfg = problem.cfg
    model = problem.model
    kind = coeff_kind(problem.geometry.kind)
    touts = output_times(cfg)
    pad_spec = mesh_pad_spec(cfg, mesh)
    local_rhs = make_local_rhs(cfg, model, kind, mesh, pad_spec=pad_spec)
    global_size = problem.y0.numel()     # the PHYSICAL cell count
    breakpoints = solver_breakpoints(cfg)

    rho_fn = (sharded_rho_bound(problem, mesh, pad_spec)
              if cfg.method == "rkc2" else None)

    fused = maybe_fused_shard_step(problem, mesh, pad_spec=pad_spec)
    frkc = maybe_fused_shard_rkc(problem, mesh, rho_fn, pad_spec=pad_spec)
    kernel = fused if fused is not None else frkc

    def capture(y):
        return gather(kernel.unpad(y) if kernel is not None else y, mesh,
                      pad_spec)

    def run(y0, params):
        reduce_fn = make_reduce(mesh, params.get("valid"))
        kw = {}
        if fused is not None:
            kw = dict(step_err=lambda t, y, h, p, carry:
                      (*fused.step_err(t, y, h, p), ()),
                      err_order=TABLEAUS[cfg.method].err_order)
        elif frkc is not None:
            kw = dict(step_err=frkc.step_err, err_order=rkc.ERR_ORDER,
                      h_limit_fn=frkc.h_limit)
        if kernel is not None:
            kw["y_loop0"] = kernel.pad(y0)
        return integrate_to_outputs(
            local_rhs, y0, params, 0.0, touts, rtol=cfg.rtol, atol=cfg.atol,
            method=cfg.method, max_steps=cfg.max_steps,
            breakpoints=breakpoints, step_mode=cfg.step_mode,
            global_size=global_size, rho_fn=rho_fn, reduce_fn=reduce_fn,
            capture=capture, **kw)

    return run, pad_spec, touts, kernel is not None


def _sync(mesh):
    for d in dict.fromkeys(mesh.device_list()):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


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
        dev = torch.device(device)
        devices = None if dev.type == "cuda" else [dev] * (n_devices or 1)
        mesh = make_mesh(n_devices=n_devices, grid_shape=(cfg.ny, cfg.nx),
                         devices=devices)
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
