"""Host-side preparation shared by the fused kernels (counterpart of
crdmodel_tpu/ops/kernel_common.py).

The JAX package lane-pads every constant for its TPU layout; here the
state stays (nvars, ny, nx), contiguous and unpadded, and the constants
keep their natural shapes: the coefficient profiles (nx,) on the torus or
three 0-d scalars on the flat surface, beta as a 0-d scalar or an (ny, 1)
field, and the (ny, 1) interior-row mask. The kinetics family travels to
the device code as an integer id (KINETICS_IDS, the Kinetics enum of
csrc/rhs_common.cuh).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from crdmodel_tpu_torch.core.problem import beta_field, interior_rows
from crdmodel_tpu_torch.ops.stencil import flat_laplacian, torus_laplacian

SMEM_BYTES = 227 * 1024        # shared memory one H100 block may use
# the kinetics families with a device function (csrc/rhs_common.cuh, enum
# Kinetics): model name -> the id the launchers pass to the kernels
KINETICS_IDS = {"fhn": 0, "goldbeter": 1}


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


def prepare_constants(problem, dtype, device) -> KernelConstants:
    """The constant kernel inputs of `problem` on `device`
    (crdmodel_tpu/ops/kernel_common.py:353, without the lane padding)."""
    cfg = problem.cfg
    geometry = problem.geometry
    return KernelConstants(
        kind=coeff_kind(geometry.kind),
        coeffs=geometry.stencil_coeffs(dtype, device),
        b=beta_field(cfg, dtype, device),
        mask=interior_rows(cfg.ny, dtype, device),
        has_freeze=(float(cfg.t_boundary) > 0.0) and not cfg.just_diffusion,
        model=problem.model)


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
    for c in kc.coeffs:
        check_tensor("coefficient", c, (nx,) if kc.kind == "torus" else (),
                     dtype, device)
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
