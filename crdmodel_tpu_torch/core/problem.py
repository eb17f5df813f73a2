"""Problem assembly: config -> (rhs, initial state, params) on the torch path
(counterpart of crdmodel_tpu/core/problem.py).

RHS semantics (reference src/FHNmodel_torus.cpp:504-667):
  ydot[0] = D*Lap(y[0]) + reaction_0     (diffusion acts on variable 0 only)
  ydot[1] =               reaction_1
  if t < tBoundary: rows j==0 and j==ny-1 are frozen (ydot=0, both variables).
  justDiffusion==1 skips the reaction block, freeze included.

Ported: the constant-D profile operator on the flat and torus surfaces;
the divergence-form (face-coefficient) operator with user-supplied
diffusion fields, no-flux domain walls and obstacle masks; the
curvature-coupled D(theta) of coupling="curvature"
(diffusion_field_from_cfg); the 2-D anisotropic tensor operator on the
flat and torus surfaces; the 3-D box with its 7-point divergence operator
and 19-point tensor operator (the state (nvars, nz, ny, nx)); their RKC2
spectral-radius bounds (make_rho_bound); the IMEX split
(make_rhs(split=True)) for ark324; and a time-dependent forcing term
(core/forcing.py), with its pulse edges as integrator breakpoints
(solver_breakpoints). Not ported yet: the tensor on surfaces of revolution
and pole coarsening (ROADMAP queue 1, item 12).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.core.forcing import SeparableForcing
from crdmodel_tpu_torch.core.grid import (Geometry, Grid, face_openness,
                                          face_openness3, make_geometry)
from crdmodel_tpu_torch.models import ReactionModel, barkley, get_model
from crdmodel_tpu_torch.ops.stencil import (anisotropic_laplacian,
                                            anisotropic_laplacian3,
                                            divergence_laplacian,
                                            divergence_laplacian3,
                                            flat_laplacian, torus_laplacian)


@dataclasses.dataclass(frozen=True)
class Problem:
    cfg: SimConfig
    model: ReactionModel
    geometry: Geometry
    rhs: Callable          # rhs(t, state, params) -> dstate, state (nvars, ny, nx)
    y0: torch.Tensor       # (nvars, ny, nx); (nvars, nz, ny, nx) on the box
    params: dict           # {"b": 0-d or (ny, 1) tensor}
    steady_state: tuple    # background fixed point used in ICs
    device: torch.device
    # the operator inputs (build_problem): diffusion_field, float64 numpy
    # D values (scalar, (nx,) or the grid's shape) when the operator takes
    # the divergence form, else None; face_mask, the face_openness (box:
    # face_openness3) masks of no-flux walls and obstacles, or None;
    # obstacle_mask, bool of the grid's shape with True = tissue, or None;
    # diffusion_tensor, the (Dxx, Dyy, Dxy) float64 numpy arrays (box:
    # (Dxx, Dyy, Dzz, Dxy, Dxz, Dyz)), each scalar or broadcastable to the
    # grid, of the anisotropic operator, or None; forcing, the optional
    # time-dependent forcing(t, state, params) -> dstate term
    # (core/forcing.py::SeparableForcing or any such callable), or None.
    diffusion_field: object = None
    face_mask: object = None
    obstacle_mask: object = None
    forcing: object = None
    diffusion_tensor: object = None

    @property
    def grid(self) -> Grid:
        return self.geometry.grid


def beta_field(cfg: SimConfig, dtype, device) -> torch.Tensor:
    """The bifurcation parameter as the RHS uses it: the scalar BETA as a 0-d
    tensor, or the linear-in-y ramp b(y) = betaMin + y*(betaMax-betaMin)/(YMAX-YMIN)
    (reference src/FHNmodel_torus.cpp:625-632), shape (ny, 1)."""
    if cfg.vary_beta == 0:
        return torch.tensor(cfg.beta, dtype=dtype, device=device)
    y = np.float64(cfg.ymin) + np.arange(cfg.ny, dtype=np.float64) * cfg.dy
    b = cfg.beta_min + y * (cfg.beta_max - cfg.beta_min) / (cfg.ymax - cfg.ymin)
    return torch.tensor(b[:, None], dtype=dtype, device=device)


def diffusion_field_from_cfg(cfg: SimConfig, geometry: Geometry):
    """The D field cfg.coupling implies, or None for constant D
    (crdmodel_tpu/core/problem.py:108-125).

    coupling="curvature": D(theta) = diffusion * C(theta)/mean(C), C the
    Kneer et al. (2014) coupling-strength profile, which the reference
    computes for visualisation only (util/GenCurvatureCoupling.py:29-43,
    90; viz/curvature.py::coupling_strength). Normalising by the
    theta-average keeps the mean diffusivity at cfg.diffusion, so that runs
    compare with the constant-D operator. float64 numpy, shape (nx,)."""
    if cfg.coupling == "none":
        return None
    from crdmodel_tpu_torch.viz.curvature import coupling_strength
    g = geometry.grid
    th = g.xmin + np.arange(g.nx, dtype=np.float64) * g.dx
    C = coupling_strength(th, geometry.r, geometry.R)
    return np.float64(cfg.diffusion) * C / np.mean(C)


def initial_state(cfg: SimConfig, model: ReactionModel, steady: tuple,
                  dtype, device, uniform=None) -> torch.Tensor:
    """Initial conditions, (nvars, ny, nx), computed in float64 numpy then
    cast (SURVEY.md C9); on the box the 2-D pattern extruded along z,
    (nvars, nz, ny, nx), for each of the nine families
    (crdmodel_tpu/core/problem.py:171-271).

    Goldbeter with varyBeta=1 and icType=2 draws both fields uniformly from
    [0, 1.4): the (2, ny, nx) float32 draws in [0, 1) come from `uniform`
    when given, else from a torch.Generator seeded with cfg.rng_seed. The
    JAX package draws them with a JAX PRNG key (crdmodel_tpu/core/
    problem.py:203-209), whose bits differ; a parity test passes the JAX
    draws in as `uniform`."""
    nx, ny = cfg.nx, cfg.ny
    xx = cfg.xmin + np.arange(nx, dtype=np.float64) * cfg.dx   # (nx,)
    yy = cfg.ymin + np.arange(ny, dtype=np.float64) * cfg.dy   # (ny,)
    X = xx[None, :]   # (1, nx)
    Y = yy[:, None]   # (ny, 1)

    wave_len = (cfg.ymax - cfg.ymin) * cfg.wave_length
    wave_wid = (cfg.xmax - cfg.xmin) * cfg.wave_width

    if cfg.surface == "torus":
        # segment centred at theta=pi (inside) or wrapping theta=0 (outside)
        # (src/FHNmodel_torus.cpp:284-300)
        if cfg.wave_inside == 1:
            wxmin = np.pi - wave_wid / 2.0
            wxmax = np.pi + wave_wid / 2.0
            in_x = (X >= wxmin) & (X <= wxmax)
        else:
            wxmin = -wave_wid / 2.0 + (cfg.xmax - cfg.xmin)
            wxmax = wave_wid / 2.0
            in_x = (X >= wxmin) | (X <= wxmax)
    else:
        # flat: segment centred at width/2 (src/FHNmodel_flat.cpp:280-282)
        mid = cfg.surface_width / 2.0
        wxmin = mid - wave_wid / 2.0
        wxmax = mid + wave_wid / 2.0
        in_x = (X >= wxmin) & (X <= wxmax)

    bg = np.zeros((model.nvars, ny, nx), dtype=np.float64)
    if cfg.model == "fhn":
        if cfg.vary_beta == 1:
            # all-ones field (src/FHNmodel_torus.cpp:349-352)
            bg[:] = 1.0
        else:
            us, vs = steady
            seg = in_x & (Y >= wave_len) & (Y <= 2.0 * wave_len)
            bg[0] = np.where(seg, us + 2.0, us)
            bg[1] = np.where(seg, vs + 1.5, vs)
    elif cfg.model != "goldbeter":
        _seed_other_family(cfg, steady, bg, in_x, Y, wave_len)
    elif cfg.vary_beta == 0:
        zs, ys = steady
        if cfg.surface == "torus":
            # y in [wl, 2wl] (src/GoldbeterModel_torus.cpp:347,363)
            seg = in_x & (Y >= wave_len) & (Y <= 2.0 * wave_len)
        else:
            # y in [2wl, 3wl] (src/GoldbeterModel_flat.cpp:328)
            seg = in_x & (Y >= 2.0 * wave_len) & (Y <= 3.0 * wave_len)
        bg[0] = np.where(seg, zs + 1.0, zs)
        bg[1] = np.where(seg, ys + 1.0, ys)
    elif cfg.ic_type == 0:
        bg[0], bg[1] = 0.4, 1.6
    elif cfg.ic_type == 1:
        # torus icType=1 uses the AND form even for waveInside=0
        # (src/GoldbeterModel_torus.cpp:392); flat identical
        seg = ((X >= wxmin) & (X <= wxmax)
               & (Y >= 2.0 * wave_len) & (Y <= 3.0 * wave_len))
        bg[0] = np.where(seg, 1.4, 0.4)
        bg[1] = np.where(seg, 2.6, 1.6)
    elif cfg.ic_type == 2:
        if uniform is None:
            gen = torch.Generator().manual_seed(int(cfg.rng_seed))
            uniform = torch.rand((2, ny, nx), generator=gen,
                                 dtype=torch.float32).numpy()
        bg[:] = 1.4 * np.asarray(uniform, np.float32).astype(np.float64)
    else:
        raise ValueError(f"icType must be 0/1/2, got {cfg.ic_type}")
    if cfg.surface == "box":
        # the 2-D seed extruded along z (crdmodel_tpu/core/problem.py:
        # 275-282): a broken front becomes a straight scroll-wave filament
        # through the depth
        bg = np.broadcast_to(bg[:, None], (model.nvars, cfg.nz, ny, nx))
    return torch.tensor(np.ascontiguousarray(bg), dtype=dtype, device=device)


def _seed_other_family(cfg, steady, bg, in_x, Y, wave_len):
    """The wave-segment seeds of the families beyond the reference's two
    into bg (crdmodel_tpu/core/problem.py:212-271): each seeds the segment
    in_x & wl <= y <= 2 wl of its background, the excitable ones
    (aliev_panfilov, barkley, oregonator) with a refractory band y < wl
    below it, so that the front is broken on one side."""
    seg = in_x & (Y >= wave_len) & (Y <= 2.0 * wave_len)
    below = np.broadcast_to(Y < wave_len, seg.shape)
    if cfg.model == "aliev_panfilov":
        bg[0] = np.where(seg, 1.0, 0.0)
        bg[1] = np.where(below, 2.0, 0.0)
    elif cfg.model == "barkley":
        bg[0] = np.where(seg, 1.0, 0.0)
        bg[1] = np.where(below, barkley.A / 2.0, 0.0)
    elif cfg.model == "oregonator":
        us, vs = steady
        bg[0] = np.where(seg, 0.8, us)
        bg[1] = np.where(below, vs + 0.3, vs)
    elif cfg.model == "grayscott":
        # Pearson's seeding: a patch of (0.5, 0.25) in the trivial state
        bg[0] = np.where(seg, 0.5, 1.0)
        bg[1] = np.where(seg, 0.25, 0.0)
    elif cfg.model == "brusselator":
        # an activator bump on the Turing-unstable steady state
        us, vs = steady
        bg[0] = np.where(seg, us + 0.5, us)
        bg[1] = vs
    elif cfg.model == "sir":
        # an infected patch in the susceptible background
        bg[0] = np.where(seg, 0.9, 1.0)
        bg[1] = np.where(seg, 0.1, 0.0)
        bg[2] = 0.0
    elif cfg.model == "lambdaomega":
        # the segment's phase flipped by pi, a quarter-cycle band below it
        bg[0] = np.where(seg, -1.0, 1.0)
        bg[1] = np.where(below, 1.0, 0.0)
        bg[0] = np.where(below, 0.0, bg[0])
    else:
        raise ValueError(cfg.model)


def interior_rows(ny: int, dtype, device) -> torch.Tensor:
    """(ny, 1) mask: 0 at rows j==0 and j==ny-1, 1 elsewhere."""
    m = torch.ones((ny, 1), dtype=dtype, device=device)
    m[0, 0] = 0
    m[-1, 0] = 0
    return m


def make_rhs(cfg: SimConfig, model: ReactionModel, geometry: Geometry, dtype,
             device, split: bool = False, diffusion_field=None,
             face_mask=None, obstacle_mask=None, diffusion_tensor=None,
             forcing=None):
    """rhs(t, state, params) for the full grid
    (crdmodel_tpu/core/problem.py:341-541). t and params["_seg_end"] may be
    0-d tensors: the freeze decision stays on the device.

    The constant-D profile operator, or with diffusion_field (float64 D
    values, scalar / (nx,) / (ny, nx)) the conservative divergence form
    (ops/stencil.py::divergence_laplacian; divergence_laplacian3 with the
    box's six faces), whose closed faces face_mask (core/grid.py::
    face_openness, face_openness3) zeroes. With diffusion_tensor, the SPD
    fields (Dxx, Dyy, Dxy), the anisotropic 9-point operator
    (ops/stencil.py::anisotropic_laplacian), or on the box (Dxx, Dyy, Dzz,
    Dxy, Dxz, Dyz), the 19-point anisotropic_laplacian3 (core/grid.py::
    tensor_coeffs64 with cfg.boundary's walls). obstacle_mask: bool of the
    grid's shape, True = tissue; the other cells get ydot = 0 and hold
    their IC. forcing(t, state, params) -> dstate joins the diffusion
    term, before the kinetics, the freeze and the tissue mask
    (kinetics + (diffusion + forcing)).

    split=True returns (rhs_ex, rhs_im), the explicit (diffusion and
    forcing) and implicit (pointwise kinetics) parts for ark324
    (integrate/imex.py), with the freeze and the tissue mask applied to
    each part, so that rhs_ex + rhs_im equals the composed rhs bitwise.
    The forcing is time-dependent but not stiff: it stays out of rhs_im,
    whose Newton stages stay pointwise and autonomous."""
    if diffusion_tensor is not None:
        faces, mixed, inv = geometry.tensor_coeffs(
            *diffusion_tensor, dtype, device, boundary=cfg.boundary)
        coeffs = None
        aniso = (anisotropic_laplacian3 if geometry.kind == "box"
                 else anisotropic_laplacian)

        def lap(u, _):
            return aniso(u, faces, mixed, inv)
    elif diffusion_field is not None:
        coeffs = geometry.divergence_coeffs(diffusion_field, dtype, device,
                                            face_mask=face_mask)
        lap = (divergence_laplacian3 if geometry.kind == "box"
               else divergence_laplacian)
    elif face_mask is not None:
        raise ValueError("face_mask needs the divergence operator: pass "
                         "diffusion_field (build_problem defaults it to the "
                         "constant cfg.diffusion)")
    else:
        coeffs = geometry.stencil_coeffs(dtype, device)
        lap = torus_laplacian if geometry.kind == "torus" else flat_laplacian
    tissue = None
    if obstacle_mask is not None:
        tissue = torch.tensor(np.broadcast_to(
            np.asarray(obstacle_mask, dtype=bool), geometry.grid.shape),
            device=device)
    just_diffusion = bool(cfg.just_diffusion)
    t_boundary = float(cfg.t_boundary)
    has_freeze = (t_boundary > 0.0) and not just_diffusion
    interior = interior_rows(geometry.grid.ny, torch.bool, device)
    dvars = tuple(model.diffusive_vars)
    ratios = tuple(model.diffusion_ratios)

    def diffusion_terms(state):
        out = []
        for v in range(model.nvars):
            if v in dvars:
                r = ratios[dvars.index(v)]
                term = lap(state[v], coeffs)
                out.append(term if r == 1.0 else r * term)
            else:
                out.append(torch.zeros_like(state[v]))
        return torch.stack(out)

    def apply_freeze(t, params, ydot):
        # A segment ending at or before tBoundary lies wholly on the frozen
        # piece (its last stage evaluates at the segment end, which must
        # still be frozen); otherwise the reference's t < tBoundary rule
        # (src/FHNmodel_torus.cpp:643-653).
        seg_end = params.get("_seg_end")
        freeze_now = torch.as_tensor(t < t_boundary)
        if seg_end is not None:
            freeze_now = freeze_now | (seg_end <= t_boundary)
        frozen = torch.where(interior, ydot, 0.0)
        return torch.where(freeze_now, frozen, ydot)

    def mask_tissue(ydot):
        return ydot if tissue is None else torch.where(tissue, ydot, 0.0)

    def rhs(t, state, params):
        diff = diffusion_terms(state)
        if forcing is not None:
            diff = diff + forcing(t, state, params)
        if just_diffusion:
            return mask_tissue(diff)
        ydot = model.kinetics(state, params["b"]) + diff
        if has_freeze:
            ydot = apply_freeze(t, params, ydot)
        return mask_tissue(ydot)

    if not split:
        return rhs

    def rhs_ex(t, state, params):
        diff = diffusion_terms(state)
        if forcing is not None:
            diff = diff + forcing(t, state, params)
        if has_freeze:
            diff = apply_freeze(t, params, diff)
        return mask_tissue(diff)

    def rhs_im(t, state, params):
        if just_diffusion:
            return torch.zeros_like(state)
        ydot = model.kinetics(state, params["b"])
        if has_freeze:
            ydot = apply_freeze(t, params, ydot)
        return mask_tissue(ydot)

    return rhs_ex, rhs_im


def make_rho_bound(cfg: SimConfig, model: ReactionModel, geometry: Geometry,
                   dtype, max_reduce=None, diffusion_field=None,
                   diffusion_tensor=None, face_mask=None):
    """Spectral-radius bound rho(t, y, params) for the RKC2 integrator
    (crdmodel_tpu/core/problem.py:544-629): the static Gershgorin bound of
    the diffusion operator (float64 numpy) plus the grid max of the model's
    pointwise kinetics Jacobian bound, a 0-d tensor on y's device.

    Ported: the constant-D torus and flat operators, the divergence form
    (diffusion_field, with face_mask closing faces) and the 2-D tensor
    operator (diffusion_tensor), and on the box the six-face divergence
    form and the 19-point tensor operator with its three mixed pairs.

    max_reduce(fn, y, b): for a sharded state, the max over the shards of
    fn(block, its beta) as one 0-d tensor on the control device
    (parallel/sharded.py::make_max_reduce; JAX's pmax), so that every shard
    takes the same stage count."""
    if diffusion_tensor is not None:
        # the axis part as the divergence bound below; the mixed pair has
        # a zero diagonal and 8 off-diagonal entries of magnitude at most
        # max|Dxy| inv4 a row, adding 8 max(inv4) max|Dxy| (inv4 is a
        # scalar on the flat surface, an (nx,) profile on the torus); the
        # box has three such pairs (xy, xz, yz), each with a scalar weight
        faces, mixed, inv = geometry.tensor_coeffs64(
            *diffusion_tensor, boundary=cfg.boundary)
        row_sum = 0.0
        for a in faces:
            row_sum = row_sum + a
        rho_diff = float(2.0 * np.max(row_sum))
        if geometry.kind == "box":
            for dab, inv_ab in zip(mixed, inv):
                rho_diff += float(8.0 * inv_ab * np.max(np.abs(dab)))
        else:
            rho_diff += float(8.0 * np.max(np.asarray(inv))
                              * np.max(np.abs(mixed)))
    elif diffusion_field is not None:
        # divergence form: the diagonal is the sum of the face coefficients
        # and so is the off-diagonal row sum: Gershgorin gives 2 max row sum
        # (closed faces only shrink it)
        row_sum = 0.0
        for a in geometry.divergence_coeffs64(diffusion_field, face_mask):
            row_sum = row_sum + a
        rho_diff = float(2.0 * np.max(row_sum))
    elif geometry.kind == "torus":
        coeffs = [c.numpy()
                  for c in geometry.stencil_coeffs(torch.float64, "cpu")]
        c_asym, c_th, c_phi = coeffs
        rho_diff = float(4.0 * np.max(c_th) + 4.0 * np.max(c_phi)
                         + 2.0 * np.max(np.abs(c_asym)))
    else:
        cu1, cu2, _ = (float(c)
                       for c in geometry.stencil_coeffs(torch.float64, "cpu"))
        rho_diff = 4.0 * cu1 + 4.0 * cu2
    rho_diff *= max(model.diffusion_ratios)
    just_diffusion = bool(cfg.just_diffusion)
    if model.jac_bound is None and not just_diffusion:
        raise ValueError(f"model {model.name} has no jac_bound; "
                         "rkc2 unsupported")

    def kinetics_max(y, b):
        return torch.max(model.jac_bound(y, b).to(dtype))

    def rho(t, y, params):
        if just_diffusion:
            return torch.full((), rho_diff, dtype=dtype, device=y.device)
        if max_reduce is None:
            jb = kinetics_max(y, params["b"])
        else:
            jb = max_reduce(kinetics_max, y, params["b"])
        return jb + rho_diff

    return rho


def solver_breakpoints(cfg: SimConfig, forcing=None) -> tuple:
    """Times the integrator must step exactly to: the tBoundary freeze
    release (reference src/FHNmodel_torus.cpp:643-653) and the declared
    discontinuities of a SeparableForcing (core/forcing.py's pulse edges)
    in (0, t_final); sorted (crdmodel_tpu/core/problem.py:632-645)."""
    pts = set()
    if 0.0 < cfg.t_boundary < cfg.t_final and not cfg.just_diffusion:
        pts.add(float(cfg.t_boundary))
    if isinstance(forcing, SeparableForcing):
        for e in forcing.breakpoints:
            if 0.0 < e < cfg.t_final:
                pts.add(float(e))
    return tuple(sorted(pts))


def build_problem(cfg: SimConfig, device="cuda", diffusion_field=None,
                  obstacle_mask=None, diffusion_tensor=None,
                  forcing=None) -> Problem:
    """Build the problem's tensors on `device` (the card unless the caller
    asks for the CPU); crdmodel_tpu/core/problem.py:648.

    diffusion_field: optional absolute D values (scalar, (nx,) or (ny, nx),
    non-negative) switching diffusion to the conservative divergence form;
    when omitted, cfg.coupling may imply one (diffusion_field_from_cfg: the
    theta-only D(theta) of coupling="curvature", which the profile kernels
    take through ops/kernel_common.py::kernel_stencil_coeffs).
    obstacle_mask: optional bool array broadcastable to (ny, nx), True =
    tissue; the other cells are inert: every face touching them closes and
    their kinetics freeze, so that they hold their IC exactly. It composes
    with cfg.boundary's no-flux walls; both take the divergence form, with
    the constant cfg.diffusion as the field when none is given.
    diffusion_tensor: optional anisotropic SPD tensor (Dxx, Dyy, Dxy), each
    scalar or broadcastable to (ny, nx), on the flat or torus surface: the
    9-point operator; on the box the full (Dxx, Dyy, Dzz, Dxy, Dxz, Dyz),
    each broadcastable to (nz, ny, nx): the 19-point operator. Its no-flux
    walls come from cfg.boundary (core/grid.py::tensor_coeffs64);
    cfg.diffusion is ignored. Mutually exclusive with diffusion_field and
    coupling, and refused with obstacle_mask.
    forcing: optional forcing(t, state, params) -> dstate added to the RHS
    (make_rhs): a core/forcing.py::SeparableForcing, whose rank-1 stimuli
    the fused kernels take, or any such callable, which the torch path
    evaluates at the true stage times. A stimulus's zprof needs the box.

    The box (crdmodel_tpu/core/problem.py:705-730, 761-764) always takes
    the divergence form, with the constant cfg.diffusion as the field when
    neither a field nor a tensor is given; its walls and 3-D obstacles
    close faces through core/grid.py::face_openness3."""
    cfg = cfg.validate()
    device = torch.device(device)
    if diffusion_tensor is not None and (diffusion_field is not None
                                         or cfg.coupling != "none"):
        raise ValueError("diffusion_tensor is mutually exclusive with "
                         "diffusion_field / coupling")
    if cfg.pole_coarsen:
        raise NotImplementedError(
            f"pole_coarsen={cfg.pole_coarsen!r} is not ported yet (ROADMAP "
            "queue 1, item 12)")
    dtype = getattr(torch, cfg.dtype)
    model = get_model(cfg.model)
    geometry = make_geometry(cfg)
    shape = geometry.grid.shape
    if diffusion_tensor is not None:
        if geometry.kind == "box":
            if len(diffusion_tensor) != 6:
                raise ValueError("diffusion_tensor must be (Dxx, Dyy, Dzz, "
                                 "Dxy, Dxz, Dyz) on the 3-D box")
        elif len(diffusion_tensor) != 3:
            raise ValueError("diffusion_tensor must be (Dxx, Dyy, Dxy) on "
                             "2-D surfaces (physical orthonormal-frame "
                             "components)")
        if obstacle_mask is not None:
            raise ValueError("obstacle_mask is unsupported with "
                             "diffusion_tensor (the mixed terms would need "
                             "mask-aware one-sided differences); no-flux "
                             "domain walls compose through cfg.boundary")
        diffusion_tensor = tuple(np.asarray(c, dtype=np.float64)
                                 for c in diffusion_tensor)
        # SPD validation: bad tensors fail at build time, not first step
        geometry.tensor_coeffs64(*diffusion_tensor, boundary=cfg.boundary)
    if diffusion_field is not None:
        diffusion_field = np.asarray(diffusion_field, dtype=np.float64)
        if not np.all(diffusion_field >= 0.0):
            raise ValueError("diffusion_field must be non-negative")
        try:
            np.broadcast_to(diffusion_field, shape)
        except ValueError:
            raise ValueError(
                f"diffusion_field shape {diffusion_field.shape} does not "
                f"broadcast to the grid {shape}") from None
    if diffusion_field is None and diffusion_tensor is None:
        diffusion_field = diffusion_field_from_cfg(cfg, geometry)
    if (diffusion_field is None and diffusion_tensor is None
            and geometry.kind == "box"):
        # the box has no constant-coefficient stencil form
        diffusion_field = np.float64(cfg.diffusion)
    face_mask = None
    if diffusion_tensor is None and (cfg.boundary != "periodic"
                                     or obstacle_mask is not None):
        if obstacle_mask is not None:
            try:
                obstacle_mask = np.broadcast_to(
                    np.asarray(obstacle_mask, dtype=bool), shape).copy()
            except ValueError:
                raise ValueError(
                    f"obstacle_mask shape {np.shape(obstacle_mask)} does not "
                    f"broadcast to the grid {shape}") from None
            if not obstacle_mask.any():
                raise ValueError("obstacle_mask is all-False (no tissue)")
        if geometry.kind == "box":
            face_mask = face_openness3(cfg.nz, cfg.ny, cfg.nx, cfg.boundary,
                                       obstacle_mask)
        else:
            face_mask = face_openness(cfg.ny, cfg.nx, cfg.boundary,
                                      obstacle_mask)
        if diffusion_field is None:
            # closed faces live in the face coefficients: the divergence
            # form even for constant D
            diffusion_field = np.float64(cfg.diffusion)
    if (isinstance(forcing, SeparableForcing) and geometry.kind != "box"
            and any(st.zprof is not None for st in forcing.stimuli)):
        raise ValueError("Stimulus.zprof is a depth profile for 3-D box "
                         "surfaces only (core/forcing.py)")
    steady = model.steady_state(cfg.beta)
    return Problem(
        cfg=cfg, model=model, geometry=geometry,
        rhs=make_rhs(cfg, model, geometry, dtype, device,
                     diffusion_field=diffusion_field, face_mask=face_mask,
                     obstacle_mask=obstacle_mask,
                     diffusion_tensor=diffusion_tensor, forcing=forcing),
        y0=initial_state(cfg, model, steady, dtype, device),
        params={"b": beta_field(cfg, dtype, device)},
        steady_state=steady, device=device, diffusion_field=diffusion_field,
        face_mask=face_mask, obstacle_mask=obstacle_mask,
        forcing=forcing, diffusion_tensor=diffusion_tensor)
