"""Host-side preparation shared by the fused kernels (counterpart of
crdmodel_tpu/ops/kernel_common.py).

The JAX package lane-pads every constant for its TPU layout; here the
state stays (nvars, ny, nx), contiguous and unpadded, and the constants
keep their natural shapes: the coefficient profiles (nx,) on the torus or
three 0-d scalars on the flat surface, beta as a 0-d scalar or an (ny, 1)
field, and the (ny, 1) interior-row mask. The divergence-form kernels take
their face coefficients aE, aW, aN and the tissue field as contiguous
(ny, nx) tensors (DivformConstants), the anisotropic kernel aE, aN and
Dxy/(4 dx dy) (AnisoConstants). The kinetics family travels to the device
code as an integer id (KINETICS_IDS, the Kinetics enum of
csrc/rhs_common.cuh).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from crdmodel_tpu_torch.core.problem import beta_field, interior_rows
from crdmodel_tpu_torch.ops.stencil import (divergence_laplacian,
                                            flat_laplacian, shift_e,
                                            shift_n, shift_s, shift_w,
                                            torus_laplacian)

SMEM_BYTES = 227 * 1024        # shared memory one H100 block may use
# the kinetics families with a device function (csrc/rhs_common.cuh, enum
# Kinetics): model name -> the id the launchers pass to the kernels
KINETICS_IDS = {"fhn": 0, "goldbeter": 1, "aliev_panfilov": 2}


def needs_divform(problem) -> bool:
    """True when the diffusion operator exists only in the divergence
    (face-coefficient) form, which the profile kernel cannot express:
    masked faces, full (ny, nx) diffusion fields, or any diffusion field on
    the flat surface (crdmodel_tpu/ops/kernel_common.py:27)."""
    if problem.face_mask is not None:
        return True
    df = problem.diffusion_field
    if df is None:
        return False
    if problem.geometry.kind != "torus":
        return True
    return np.ndim(df) > 1


def fused_forcing(problem):
    """The forcing the step kernel would evaluate in-kernel: None when the
    problem has none. The port has no forcing yet (ROADMAP queue 1, item 9),
    so a forcing, when there is one, is returned as False: not
    kernel-consumable (crdmodel_tpu/ops/kernel_common.py:62)."""
    return None if problem.forcing is None else False


def kernel_ready_kinetics(problem) -> bool:
    """The port-only rule every fused kernel's gate shares: kinetics with a
    device function (KINETICS_IDS), two variables of which variable 0
    alone diffuses at the full coefficient, and reaction on."""
    model = problem.model
    return (model.name in KINETICS_IDS and model.nvars == 2
            and tuple(model.diffusive_vars) == (0,)
            and tuple(model.diffusion_ratios) == (1.0,)
            and not problem.cfg.just_diffusion)


def coeff_kind(geometry_kind: str) -> str:
    """The kernels' coefficient layout: "torus" = three (nx,) profiles;
    "flat" = three scalars (crdmodel_tpu/ops/kernel_common.py:97)."""
    return "torus" if geometry_kind in ("torus", "revolution") else geometry_kind


@dataclasses.dataclass(frozen=True)
class KernelConstants:
    kind: str                 # coeff_kind of the geometry
    coeffs: tuple             # torus: 3 (nx,) profiles; flat: 3 0-d scalars
    b: torch.Tensor           # 0-d scalar or (ny, 1) field
    mask: torch.Tensor        # (ny, 1) interior-row mask, 0 on rows 0, ny-1
    has_freeze: bool
    model: object             # the ReactionModel whose kinetics the RHS runs

    @property
    def b_is_field(self) -> bool:
        return self.b.dim() == 2

    @property
    def kinetics_id(self) -> int:
        """The device code's id of the kinetics (KINETICS_IDS)."""
        if self.model.name not in KINETICS_IDS:
            raise ValueError(f"no kinetics device function for model "
                             f"{self.model.name!r}")
        return KINETICS_IDS[self.model.name]


@dataclasses.dataclass(frozen=True)
class DivformConstants(KernelConstants):
    """The divergence-form kernel's inputs: kind "divform", coeffs the face
    coefficients (aE, aW, aN) as contiguous (ny, nx) tensors (aS is
    roll_y(aN), read by the kernel from aN), tissue the (ny, nx) 0/1
    obstacle field or None."""
    tissue: object


@dataclasses.dataclass(frozen=True)
class AnisoConstants(KernelConstants):
    """The anisotropic kernel's inputs: kind "aniso", coeffs (aE, aN,
    dxyw) as contiguous (ny, nx) tensors, dxyw = Dxy/(4 dx dy) folded in
    float64. aW and aS are not shipped: aW is aE at (j, i-1), aS is aN at
    (j-1, i), both wrapped (exact: tensor_coeffs64 rolls them so)."""


def kernel_stencil_coeffs(problem, dtype, device):
    """The three coefficient profiles the profile kernels take
    (crdmodel_tpu/ops/kernel_common.py:308). Constant D: the geometry's
    stencil_coeffs. A theta-only diffusion field on the torus (which
    needs_divform leaves to the profile kernels): its face form maps onto
    the same three profiles,

      aE(uE-u) + aW(uW-u) + aN(uN-2u+uS)
        == ca(uE-uW) + ct(uE-2u+uW) + aN(uN-2u+uS),
      ca = (aE-aW)/2, ct = (aE+aW)/2   (aN == aS for theta-only D),

    equal to the torch path's divergence operator in real arithmetic, to
    rounding in floating point."""
    geometry = problem.geometry
    if problem.diffusion_field is None:
        return geometry.stencil_coeffs(dtype, device)
    aE, aW, aN, _ = geometry.divergence_coeffs64(problem.diffusion_field)
    if geometry.kind != "torus" or aE.ndim != 1:
        raise ValueError("the profile kernels take only theta-only "
                         "diffusion fields on the torus")
    return tuple(torch.tensor(c, dtype=dtype, device=device)
                 for c in (0.5 * (aE - aW), 0.5 * (aE + aW), aN))


def _rhs_inputs(problem, dtype, device) -> dict:
    """The inputs every kernel's RHS reads besides the operator: beta, the
    interior-row mask, whether there is a freeze, and the model."""
    cfg = problem.cfg
    return dict(
        b=beta_field(cfg, dtype, device),
        mask=interior_rows(cfg.ny, dtype, device),
        has_freeze=(float(cfg.t_boundary) > 0.0) and not cfg.just_diffusion,
        model=problem.model)


def prepare_constants(problem, dtype, device) -> KernelConstants:
    """The constant kernel inputs of `problem` on `device`
    (crdmodel_tpu/ops/kernel_common.py:353, without the lane padding)."""
    return KernelConstants(
        kind=coeff_kind(problem.geometry.kind),
        coeffs=kernel_stencil_coeffs(problem, dtype, device),
        **_rhs_inputs(problem, dtype, device))


def face_coeffs64(problem):
    """The four (ny, nx) float64 face-coefficient fields of the torch
    path's divergence operator, contiguous
    (crdmodel_tpu/ops/pallas_divform.py:94)."""
    geometry = problem.geometry
    faces = geometry.divergence_coeffs64(problem.diffusion_field,
                                         face_mask=problem.face_mask)
    return tuple(np.ascontiguousarray(np.broadcast_to(
        np.asarray(a, np.float64), geometry.grid.shape)) for a in faces)


def south_is_rolled_north(faces64) -> bool:
    """aS == roll_y(aN) exactly: the divergence kernel reads aS as aN of the
    row above (crdmodel_tpu/ops/pallas_divform.py:125-127). It holds where
    the cell weight varies along x only (flat, torus) and the masks close
    both sides of a face together."""
    _, _, aN, aS = faces64
    return bool(np.array_equal(aS, np.roll(aN, 1, axis=0)))


def prepare_divform_constants(problem, dtype, device) -> DivformConstants:
    """The divergence-form kernel's inputs of `problem` on `device`: aE, aW,
    aN broadcast to (ny, nx) and cast once from the float64 arrays the
    torch path casts, and the obstacle mask as a 0/1 field."""
    faces64 = face_coeffs64(problem)
    if not south_is_rolled_north(faces64):
        raise ValueError("aS != roll_y(aN): the divergence kernel cannot "
                         "read aS from aN (is_divform_supported declines)")
    tissue = None
    if problem.obstacle_mask is not None:
        tissue = torch.tensor(np.asarray(problem.obstacle_mask, np.float64),
                              dtype=dtype, device=device)
    return DivformConstants(
        kind="divform",
        coeffs=tuple(torch.tensor(a, dtype=dtype, device=device)
                     for a in faces64[:3]),
        tissue=tissue, **_rhs_inputs(problem, dtype, device))


def prepare_aniso_constants(problem, dtype, device) -> AnisoConstants:
    """The anisotropic kernel's inputs of `problem` on `device`
    (crdmodel_tpu/ops/pallas_aniso.py:123-144): aE, aN and Dxy * inv4 from
    the flat geometry's float64 tensor coefficients, each cast once."""
    if problem.geometry.kind != "flat":
        raise ValueError("the anisotropic kernel takes the flat surface "
                         "(its inv4 is a scalar)")
    (aE, _, aN, _), dxy, inv4 = problem.geometry.tensor_coeffs64(
        *problem.diffusion_tensor, boundary=problem.cfg.boundary)
    return AnisoConstants(
        kind="aniso",
        coeffs=tuple(torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                                  device=device)
                     for a in (aE, aN, dxy * inv4)),
        **_rhs_inputs(problem, dtype, device))


def check_tensor(name, x, shape, dtype, device):
    """Raise unless x is a contiguous `dtype` tensor of `shape` on `device`:
    what a kernel launcher takes."""
    if x.device != device or x.dtype != dtype:
        raise ValueError(f"{name}: {x.dtype} on {x.device}, the kernel "
                         f"needs {dtype} on {device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_constants(kc: KernelConstants, ny: int, nx: int, dtype, device):
    """check_tensor on every constant a kernel reads."""
    coeff_shape = {"torus": (nx,), "flat": (), "divform": (ny, nx),
                   "aniso": (ny, nx)}[kc.kind]
    for c in kc.coeffs:
        check_tensor("coefficient", c, coeff_shape, dtype, device)
    if getattr(kc, "tissue", None) is not None:
        check_tensor("tissue", kc.tissue, (ny, nx), dtype, device)
    check_tensor("beta", kc.b, (ny, 1) if kc.b_is_field else (), dtype,
                 device)
    check_tensor("mask", kc.mask, (ny, 1), dtype, device)


def _live(kc: KernelConstants, fz):
    """live = 1 - fz*(1 - mask), or None when the problem has no freeze."""
    return 1.0 - fz * (1.0 - kc.mask) if kc.has_freeze else None


def make_rhs_block(kc: KernelConstants, fz):
    """rhs_block(y) -> ydot: the kernels' per-tile RHS in plain torch, on
    the whole (2, ny, nx) state (crdmodel_tpu/ops/kernel_common.py:110):
    the model's kinetics plus the profile operator on variable 0, times
    live = 1 - fz*(1 - mask) when the problem has a freeze. The device
    functions of csrc/rhs_common.cuh compute the same expressions in the
    same order."""
    lap_of = torus_laplacian if kc.kind == "torus" else flat_laplacian
    live = _live(kc, fz)

    def rhs_block(y):
        react = kc.model.kinetics(y, kc.b)
        ydot = torch.stack([react[0] + lap_of(y[0], kc.coeffs), react[1]])
        return ydot * live if live is not None else ydot

    return rhs_block


def make_divform_rhs_block(dc: DivformConstants, fz):
    """rhs_block(y) -> ydot: the divergence kernel's RHS in plain torch on
    the whole (2, ny, nx) state (crdmodel_tpu/ops/kernel_common.py:165,
    without the mixed tensor terms and the dscale rescale): the kinetics
    plus the face-form operator on variable 0 (ops/stencil.py::
    divergence_laplacian's grouping, aS = roll_y(aN)), times live when the
    problem has a freeze, times the 0/1 tissue field when it has an
    obstacle. csrc/fused_divform.cu computes the same expressions in the
    same order."""
    aE, aW, aN = dc.coeffs
    faces = (aE, aW, aN, torch.roll(aN, 1, dims=0))
    live = _live(dc, fz)

    def rhs_block(y):
        react = dc.model.kinetics(y, dc.b)
        ydot = torch.stack([react[0] + divergence_laplacian(y[0], faces),
                            react[1]])
        if live is not None:
            ydot = ydot * live
        if dc.tissue is not None:
            ydot = ydot * dc.tissue
        return ydot

    return rhs_block


def aniso_kernel_laplacian(u, aE, aN, dxyw):
    """The anisotropic kernel's 9-point operator in plain torch
    (crdmodel_tpu/ops/pallas_aniso.py:149-162): aW and aS rolled from aE
    and aN, and the mixed terms on the folded dxyw = Dxy/(4 dx dy), with
    the JAX kernel's association axis + (t1 + t2). The XLA path's
    axis + inv4*(t1 + t2) (ops/stencil.py::anisotropic_laplacian) rounds
    differently, so the two agree to f32 rounding, not bitwise (ROADMAP
    queue 3). The JAX kernel's final ds * (...) is its sweep rescale
    (dscale, ROADMAP queue 1, item 14), 1 until then: multiplying by an
    exact 1 changes nothing, so it is left out."""
    ue, uw = shift_e(u), shift_w(u)
    un, us = shift_n(u), shift_s(u)
    axis = (aE * (ue - u) + shift_w(aE) * (uw - u)
            + aN * (un - u) + shift_s(aN) * (us - u))
    fx = dxyw * (un - us)
    t1 = shift_e(fx) - shift_w(fx)
    fy = dxyw * (ue - uw)
    t2 = shift_n(fy) - shift_s(fy)
    return axis + (t1 + t2)


def make_aniso_rhs_block(ac: AnisoConstants, fz):
    """rhs_block(y) -> ydot: the anisotropic kernel's RHS in plain torch on
    the whole (2, ny, nx) state (crdmodel_tpu/ops/pallas_aniso.py:164-178):
    the kinetics plus aniso_kernel_laplacian on variable 0, times live when
    the problem has a freeze. csrc/rhs_common.cuh::aniso_rhs computes the
    same expressions in the same order."""
    aE, aN, dxyw = ac.coeffs
    live = _live(ac, fz)

    def rhs_block(y):
        react = ac.model.kinetics(y, ac.b)
        ydot = torch.stack([react[0] + aniso_kernel_laplacian(y[0], aE, aN,
                                                              dxyw),
                            react[1]])
        return ydot * live if live is not None else ydot

    return rhs_block


def make_split_block(kc: KernelConstants, fz):
    """(ex_block, im_block, jac_block), the IMEX split of make_rhs_block
    for the fused IMEX step (crdmodel_tpu/ops/kernel_common.py:282):
    ex_block(y) the profile operator on variable 0 (0 on variable 1),
    im_block(y) the pointwise kinetics, jac_block(y) the kinetics' closed-
    form Jacobian (2, 2, ny, nx) (ReactionModel.jacobian), each times live
    when the problem has a freeze; ex + im equals make_rhs_block's value
    bitwise."""
    lap_of = torus_laplacian if kc.kind == "torus" else flat_laplacian
    live = _live(kc, fz)

    def masked(x):
        return x * live if live is not None else x

    def ex_block(y):
        lap = lap_of(y[0], kc.coeffs)
        return masked(torch.stack([lap, torch.zeros_like(lap)]))

    def im_block(y):
        return masked(kc.model.kinetics(y, kc.b))

    def jac_block(y):
        return masked(kc.model.jacobian(y, kc.b))

    return ex_block, im_block, jac_block


def freeze_scalar(params, has_freeze: bool, t_boundary: float, dtype):
    """1.0 while the integration segment lies in the frozen piece
    (t < tBoundary), from params['_seg_end'] as a 0-d tensor on its device:
    segments never straddle the discontinuity (integrate/erk.py)."""
    seg_end = params.get("_seg_end")
    if not has_freeze or seg_end is None:
        device = params["b"].device
        return torch.zeros((), dtype=dtype, device=device)
    return (seg_end <= t_boundary).to(dtype)
