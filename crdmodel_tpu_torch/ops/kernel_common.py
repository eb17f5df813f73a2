"""Host-side preparation shared by the fused kernels (counterpart of
crdmodel_tpu/ops/kernel_common.py).

The JAX package lane-pads every constant for its TPU layout; here the
state stays (nvars, ny, nx), contiguous and unpadded, and the constants
keep their natural shapes: the coefficient profiles (nx,) on the torus or
three 0-d scalars on the flat surface, beta as a 0-d scalar or an (ny, 1)
field, and the (ny, 1) interior-row mask. The divergence-form kernels take
their face coefficients aE, aW, aN and the tissue field as contiguous
(ny, nx) tensors (DivformConstants), the anisotropic kernel aE, aN and
Dxy/(4 dx dy) (AnisoConstants). The 3-D box kernels (K6, K7) take one of
four operator modes, chosen by box_mode on the float64 faces: six
profiles (BoxProfileConstants), the profiles with a 0/1 tissue field
(BoxTissueConstants), three (nz, ny, nx) face fields (BoxFieldConstants)
or the 19-point tensor's six fields (BoxTensorConstants). The shard
kernels take each shard's constants halo-padded by the mesh's exchange:
K8, K9 and K10 the profile operator's (ShardConstants), K11 a stack of
face fields (ShardDivformConstants), K12 and K13 the box modes'
(ShardBoxConstants). The kinetics family travels to the
device code as an integer id (KINETICS_IDS, the Kinetics enum of
csrc/rhs_common.cuh). A structured forcing (core/forcing.py::
SeparableForcing, every stimulus rank-1) travels to K1, K2, K3 and K4 as
StimConstants (its row and column profiles) and an amplitude table the
step computes on the device (stage_amplitudes), to the box kernels K6 and
K7 with a depth table beside the profiles (StimConstants.z), and to the
shard kernels K8-K13 as each shard's StimConstants, its profiles
halo-padded like the shard's constants and the box's depth table whole
(prepare_shard_stim_constants); the kernels' plain versions add it as
stim_terms does.
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from crdmodel_tpu_torch.core.forcing import SeparableForcing
from crdmodel_tpu_torch.core.grid import face_openness3
from crdmodel_tpu_torch.core.problem import beta_field, interior_rows
from crdmodel_tpu_torch.ops.stencil import (anisotropic_laplacian,
                                            divergence_laplacian,
                                            flat_laplacian, shift_e,
                                            shift_n, shift_s, shift_w,
                                            torus_laplacian)

SMEM_BYTES = 227 * 1024        # shared memory one H100 block may use
# the kinetics families with a device function (csrc/rhs_common.cuh, enum
# Kinetics): model name -> the id the launchers pass to the kernels
KINETICS_IDS = {"fhn": 0, "goldbeter": 1, "aliev_panfilov": 2,
                "barkley": 3, "oregonator": 4, "grayscott": 5,
                "brusselator": 6, "lambdaomega": 7, "sir": 8}
# the families every fused kernel takes: two variables, variable 0 alone
# diffusing at the full coefficient
BASE_FAMILIES = ("fhn", "goldbeter", "aliev_panfilov")
# the other six, which K1, K2's profile branch, K3, K8, K9 and K10 take
# unforced (csrc/*_families.cu), each with the shape its compile-time
# trait has
# (csrc/rhs_common.cuh, crd::Family): nvars, the diffusing variables and
# their ratios
NEW_FAMILIES = {"barkley": (2, (0,), (1.0,)),
                "oregonator": (2, (0,), (1.0,)),
                "grayscott": (2, (0, 1), (1.0, 0.5)),
                "brusselator": (2, (0, 1), (1.0, 8.0)),
                "lambdaomega": (2, (0, 1), (1.0, 1.0)),
                "sir": (3, (1,), (1.0,))}
ALL_FAMILIES = BASE_FAMILIES + tuple(NEW_FAMILIES)
BASE_IDS = tuple(KINETICS_IDS[name] for name in BASE_FAMILIES)


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
    """The structured forcing the step kernels evaluate in-kernel
    (crdmodel_tpu/ops/kernel_common.py:62-77): the problem's
    SeparableForcing when every stimulus is rank-1 (core/forcing.py), None
    when the problem has no forcing, or False when it has one the kernels
    cannot take (a free-form callable, a full 2-D `spatial`, a depth
    profile off the box): the callers then decline to the torch path."""
    f = problem.forcing
    if f is None:
        return None
    if isinstance(f, SeparableForcing) and f.separable:
        if (problem.geometry.kind != "box"
                and any(st.zprof is not None for st in f.stimuli)):
            return False
        return f
    return False


def stage_amplitudes(forcing, t, h, c_nodes, params, dtype):
    """(n_stim, n_stages) amplitudes of a step's stages at the true stage
    times t + c_s h, a contiguous tensor on t's device
    (crdmodel_tpu/ops/kernel_common.py:80-94). c_nodes: the tableau's c
    as a 1-d tensor in `dtype` on that device, which the caller makes once
    (a host-to-device copy a step would wait for the device). Each
    waveform is evaluated once on the 1-d tensor of the stage times (the
    waveform contract of core/forcing.py), so a step costs a few launches
    and no host read. Segment-gated waveforms (pulse trains) take
    params["_seg_end"] instead, which makes their amplitude constant over
    the step."""
    return forcing_amplitudes(forcing, t + c_nodes * h, params, dtype)


def forcing_amplitudes(forcing, times, params, dtype):
    """(n_stim, len(times)) amplitudes of `forcing`'s stimuli at the 1-d
    tensor `times` (stage_amplitudes; K2's Chebyshev stage times): a
    segment-gated waveform at params["_seg_end"] where the drivers pass
    it, broadcast along the times (core/forcing.py::SeparableForcing.
    amplitudes: all pulse trains in one pass)."""
    seg = params.get("_seg_end") if isinstance(params, dict) else None
    return forcing.amplitudes(times, seg, dtype)


@dataclasses.dataclass(frozen=True)
class StimConstants:
    """A structured forcing's inputs of the fused kernels: the stimuli's
    row and column profiles as contiguous (n_stim, ny) and (n_stim, nx)
    tensors (ones where a stimulus has none), the variable each drives,
    the SeparableForcing whose waveforms give the amplitudes and, on the
    box (K6, K7, K12, K13), z: the (n_stim, nz) depth table, ones where a
    stimulus has no zprof (crdmodel_tpu/ops/pallas_box3d.py:385-390); None
    off the box. The 2-D kernels read a stimulus j at point (y, x) of
    amplitude column a as (amps[j, a] * rows[j, y]) * cols[j, x], the box
    kernels at plane k as ((amps[j, a] * z[j, k]) * rows[j, y]) * cols[j,
    x]; the points of a tile's rings are read at the wrapped indices their
    state is loaded from."""
    forcing: object
    rows: torch.Tensor
    cols: torch.Tensor
    vars: tuple
    z: object = None

    @property
    def n_stim(self) -> int:
        return len(self.vars)

    @property
    def var1_mask(self) -> int:
        """Bit j set: stimulus j drives variable 1 (else variable 0)."""
        return sum(1 << j for j, v in enumerate(self.vars) if v == 1)

    def launch_args(self, amps):
        """The launchers' forcing arguments: amps (n_stim, n_cols), the
        profiles, n_stim, n_cols and var1_mask; the box launchers' also the
        depth table after the profiles (csrc/box3d.cuh CRD_BOX_STIM_ARGS)."""
        check_tensor("amps", amps, (self.n_stim, amps.shape[-1]),
                     self.rows.dtype, self.rows.device)
        tables = (amps, self.rows, self.cols) + (
            () if self.z is None else (self.z,))
        return (*(t.data_ptr() for t in tables), self.n_stim,
                amps.shape[-1], self.var1_mask)


# the most stimuli a launch takes: the bits of its var1 mask, an int
# (csrc/rhs_common.cuh kStimMaskBits)
STIM_MASK_BITS = 31


def forcing_of(stim, amps, like):
    """fs(a) -> (F0, F1), the forcing at amplitude column a (stim_terms) for
    a kernel's plain version, or None without a forcing (stim None)."""
    if stim is None:
        return None
    return lambda a: stim_terms(stim, amps, a, like)


# the launchers' forcing arguments without a forcing: the unforced kernels
# (the box launchers': NO_BOX_STIM_ARGS, with a null depth table)
NO_STIM_ARGS = (None, None, None, 0, 0, 0)
NO_BOX_STIM_ARGS = (None, None, None, None, 0, 0, 0)


def stim_args(stim, amps, n_cols, box: bool = False):
    """The launchers' forcing arguments (StimConstants.launch_args) of an
    amplitude table with one of the column counts `n_cols` the kernel
    takes, or NO_STIM_ARGS (`box`: NO_BOX_STIM_ARGS) without a forcing
    (stim None). Raises unless a box launcher's StimConstants carry a
    depth table and a 2-D launcher's none."""
    if stim is None:
        return NO_BOX_STIM_ARGS if box else NO_STIM_ARGS
    if (stim.z is not None) != box:
        raise ValueError("the box kernels take a forcing with a depth "
                         "table (StimConstants.z), the 2-D kernels one "
                         "without")
    if amps.shape[-1] not in n_cols:
        raise ValueError(f"amps has {amps.shape[-1]} columns; the kernel "
                         f"takes {' or '.join(map(str, n_cols))}")
    return stim.launch_args(amps)


def stim_profiles64(problem):
    """(forcing, vars, rows, cols, z) of `problem`'s structured forcing:
    the stimuli's variables and their row and column profiles as float64
    (n_stim, ny) and (n_stim, nx) arrays, ones where a stimulus has none;
    z on the box the (n_stim, nz) depth table, ones where a stimulus has
    no zprof (crdmodel_tpu/ops/pallas_box3d.py:385-390), else None; None
    without a forcing (fused_forcing). Raises on what the kernels do not
    take."""
    forcing = fused_forcing(problem)
    if forcing is None:
        return None
    if forcing is False:
        raise ValueError("the fused kernels take only rank-1 stimuli "
                         "(kernel_common.fused_forcing)")
    vars_ = tuple(int(st.var) for st in forcing.stimuli)
    if len(vars_) > STIM_MASK_BITS:
        raise ValueError(f"{len(vars_)} stimuli: a launch takes at most "
                         f"{STIM_MASK_BITS} (its var1 mask's bits)")
    if any(v not in (0, 1) for v in vars_):
        raise ValueError(f"stimulus variables {vars_}: the kernels' models "
                         "have two variables (kernel_ready_kinetics)")
    ny, nx = problem.cfg.ny, problem.cfg.nx

    def stack(profiles, n):
        return np.stack([np.ones(n) if p is None
                         else np.asarray(p, np.float64).reshape(n)
                         for p in profiles])

    z = None
    if problem.geometry.kind == "box":
        z = stack([st.zprof for st in forcing.stimuli], problem.cfg.nz)
    return (forcing, vars_, stack([st.row for st in forcing.stimuli], ny),
            stack([st.col for st in forcing.stimuli], nx), z)


def prepare_stim_constants(problem, dtype, device):
    """StimConstants of `problem`'s structured forcing on `device` (with
    the depth table on the box), or None without one (fused_forcing)."""
    prof = stim_profiles64(problem)
    if prof is None:
        return None
    forcing, vars_, rows, cols, z = prof

    def cast(a):
        return None if a is None else torch.tensor(a, dtype=dtype,
                                                   device=device)

    return StimConstants(forcing=forcing, rows=cast(rows), cols=cast(cols),
                         vars=vars_, z=cast(z))


def stim_terms(sc: StimConstants, amps, col: int, like):
    """(F0, F1), the forcing of variables 0 and 1 at amplitude column `col`
    in plain torch, each of like[0]'s (ny, nx) shape, or (nz, ny, nx) on
    the box: the sum over the stimuli of each variable, in stimulus order
    from zero, of (amps[j, col] * rows[j, y]) * cols[j, x], on the box
    ((amps[j, col] * z[j, k]) * rows[j, y]) * cols[j, x], as the kernels
    add it (csrc/rhs_common.cuh::StimTable::at, BoxStimTable::at)."""
    f = [torch.zeros_like(like[0]), torch.zeros_like(like[0])]
    for j, v in enumerate(sc.vars):
        amp = amps[j, col]
        if sc.z is not None:
            amp = (amp * sc.z[j])[:, None, None]
        f[v] = f[v] + (amp * sc.rows[j][:, None]) * sc.cols[j]
    return f


def kernel_ready_kinetics(problem, families=BASE_FAMILIES) -> bool:
    """The port-only rule every fused kernel's gate shares: reaction on and
    a family of `families` whose model has its device code's shape: for
    BASE_FAMILIES two variables of which variable 0 alone diffuses at the
    full coefficient, for NEW_FAMILIES their trait's. Every kernel takes
    BASE_FAMILIES; K1, K2's profile branch, K3, K8, K9 and K10 pass
    kernel_families."""
    model = problem.model
    if problem.cfg.just_diffusion or model.name not in families:
        return False
    shape = (model.nvars, tuple(model.diffusive_vars),
             tuple(model.diffusion_ratios))
    return shape == NEW_FAMILIES.get(model.name, (2, (0,), (1.0,)))


def kernel_families(problem) -> tuple:
    """The families K1, K2's profile branch, K3, K8, K9 and K10 take for
    `problem`: all nine unforced, BASE_FAMILIES with a forcing (the new
    families' instantiations are unforced)."""
    return BASE_FAMILIES if problem.forcing is not None else ALL_FAMILIES


def launcher_symbol(base: str, kc) -> str:
    """The launcher of K1, K2, K3, K8, K9 or K10 for kc's family (a
    KernelConstants or a shard's ShardConstants): `base` for the
    BASE_FAMILIES, `base`_families for the NEW_FAMILIES, whose
    instantiations are compiled apart (csrc/*_families.cu)."""
    return base if kc.model.name in BASE_FAMILIES else base + "_families"


def check_state(y, kc):
    """Raise unless y is an (nvars, ny, nx) state of kc's model (a shard's
    halo-padded buffer for a ShardConstants)."""
    nv = kc.model.nvars
    if y.dim() != 3 or y.shape[0] != nv:
        raise ValueError(f"y must be ({nv}, ny, nx), got {tuple(y.shape)}")


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


@dataclasses.dataclass(frozen=True)
class ShardConstants(KernelConstants):
    """One shard's inputs of the shard kernels (K8, K9, K10; crdmodel_tpu/ops/
    kernel_common.py:535-673): kind "torus" or "flat"; coeffs the three
    profiles halo-padded to (nxl + 2 halo,) on the torus, three 0-d scalars
    on the flat surface; b a 0-d scalar or the halo-padded (nyl + 2 halo, 1)
    rows; mask the halo-padded (nyl + 2 halo, 1) interior-row mask.
    valid_rows x valid_cols: the physical cells at the start of the block;
    the others are mirror-pad cells of a padded mesh, which step like their
    sources (their constants are their sources') and stay out of the error
    sum, the counterpart of the JAX kernels' `_fused_vrow`/`_fused_cmask`."""
    halo: int
    valid_rows: int
    valid_cols: int


@dataclasses.dataclass(frozen=True)
class ShardDivformConstants(ShardConstants):
    """One shard's inputs of K11 (ops/fused_shard_divform.py; crdmodel_tpu/
    ops/pallas_shard_divform.py:212-265): kind "shard_divform" or
    "shard_aniso"; stack the (3 or 4, nyl + 2 halo, nxl + 2 halo)
    coefficient stack (aE, aW, aN, then the 0/1 tissue field of an
    obstacle or, in aniso mode, the raw Dxy), halo-padded by the mesh's
    exchange; coeffs its three face planes (views; aS is aN of the row
    below, read through the roll); tissue and dxy the fourth plane or None;
    inv4 the mixed pair's weight in aniso mode, a 0-d scalar (flat) or the
    halo-padded (nxl + 2 halo,) column profile (torus), else None."""
    stack: torch.Tensor
    tissue: object
    dxy: object
    inv4: object


def _shard_layout(cfg, mesh, pad_spec):
    """(nyl, nxl) of a shard's block, and whether each axis is padded."""
    py, px = mesh.shape
    nyl = pad_spec.y.blk if pad_spec is not None else cfg.ny // py
    nxl = pad_spec.x.blk if pad_spec is not None else cfg.nx // px
    return (nyl, nxl, pad_spec is not None and pad_spec.y.active,
            pad_spec is not None and pad_spec.x.active)


def _halo_rows(a, cfg, mesh, pad_spec, halo):
    """(ny, 1) -> each shard's halo-padded (nyl + 2 halo, 1) rows, on its
    device, mirror-aware along a padded y axis."""
    from crdmodel_tpu_torch.parallel import halo as hx
    nyl, _, pady, _ = _shard_layout(cfg, mesh, pad_spec)
    px = mesh.shape[1]
    if pad_spec is not None:
        a = pad_spec.pad_rows(a)
    blocks = [a[k // px * nyl:(k // px + 1) * nyl].to(d)
              for k, d in enumerate(mesh.device_list())]
    if pady:
        return hx.mirror_halo_pad_rows(blocks, mesh, halo, pad_spec.y.n,
                                       pad_spec.y.blk)
    return hx.halo_pad_rows(blocks, mesh, halo)


def _halo_cols(a, cfg, mesh, pad_spec, halo):
    """(nx,) -> each shard's halo-padded (nxl + 2 halo,) profile, on its
    device, mirror-aware along a padded x axis."""
    from crdmodel_tpu_torch.parallel import halo as hx
    _, nxl, _, padx = _shard_layout(cfg, mesh, pad_spec)
    px = mesh.shape[1]
    if pad_spec is not None:
        a = pad_spec.pad_cols(a)
    blocks = [a[k % px * nxl:(k % px + 1) * nxl].reshape(1, nxl).to(d)
              for k, d in enumerate(mesh.device_list())]
    if padx:
        out = hx.mirror_halo_pad_cols(blocks, mesh, halo, pad_spec.x.n,
                                      pad_spec.x.blk)
    else:
        out = hx.halo_pad_cols(blocks, mesh, halo)
    return [c.reshape(-1) for c in out]


def _shard_rhs_inputs(problem, mesh, pad_spec, halo: int, dtype):
    """Every shard's RHS inputs besides the operator, as ShardConstants
    keywords: b (0-d or the halo-padded rows), mask (the halo-padded
    interior-row mask), has_freeze, model, halo and the counts of physical
    rows and columns at the start of its block."""
    cfg = problem.cfg
    nyl, nxl, _, _ = _shard_layout(cfg, mesh, pad_spec)
    devices = mesh.device_list()
    px = mesh.shape[1]
    common = _rhs_inputs(problem, dtype, "cpu")
    b = (_halo_rows(common["b"], cfg, mesh, pad_spec, halo)
         if common["b"].dim() == 2 else [common["b"].to(d) for d in devices])
    mask = _halo_rows(common["mask"], cfg, mesh, pad_spec, halo)
    out = []
    for k in range(len(devices)):
        iy, ix = divmod(k, px)
        out.append(dict(b=b[k], mask=mask[k], has_freeze=common["has_freeze"],
                        model=common["model"], halo=halo,
                        valid_rows=min(nyl, max(0, cfg.ny - iy * nyl)),
                        valid_cols=min(nxl, max(0, cfg.nx - ix * nxl))))
    return out


def make_shard_constants(problem, mesh, pad_spec, halo: int, dtype):
    """Every shard's ShardConstants, in mesh order on its device: the
    global constants of K1 (prepare_constants) wrap-padded to the padded
    grid, split into blocks and halo-padded once by the mesh's exchange
    (parallel/halo.py), mirror-aware along a padded axis, as the JAX
    package's prepare_params does once a dispatch (kernel_common.py:625-
    671)."""
    kc = prepare_constants(problem, dtype, "cpu")
    devices = mesh.device_list()
    if kc.kind == "torus":
        profiles = [_halo_cols(c, problem.cfg, mesh, pad_spec, halo)
                    for c in kc.coeffs]
        coeffs = [tuple(p[k] for p in profiles) for k in range(len(devices))]
    else:
        coeffs = [tuple(c.to(d) for c in kc.coeffs) for d in devices]
    return [ShardConstants(kind=kc.kind, coeffs=coeffs[k], **rows)
            for k, rows in enumerate(_shard_rhs_inputs(problem, mesh,
                                                       pad_spec, halo,
                                                       dtype))]


def prepare_shard_stim_constants(problem, mesh, pad_spec, halo: int,
                                 dtype):
    """Every shard's StimConstants, in mesh order on its device, or None
    without a structured forcing: each stimulus's row profile halo-padded
    to (nyl + 2 halo,) and its column profile to (nxl + 2 halo,) by the
    mesh's exchange, mirror-aware along a padded axis (_halo_rows,
    _halo_cols), as make_shard_constants pads beta and the freeze mask and
    the JAX kernels' prepare_params pads the sharded "_stim_row_{i}" and
    "_stim_col_{i}" (crdmodel_tpu/ops/pallas_shard_step.py:149-187); on
    the box the (n_stim, nz) depth table whole on every shard, z not being
    sharded (crdmodel_tpu/ops/pallas_shard_box3d.py:196-213). A shard's
    kernel reads stimulus j at the halo-padded (r, c) its state comes from
    (csrc/rhs_common.cuh::HaloGrid), a mirror-pad cell its source's
    values."""
    prof = stim_profiles64(problem)
    if prof is None:
        return None
    forcing, vars_, rows64, cols64, z64 = prof
    cfg = problem.cfg
    rows = [_halo_rows(torch.tensor(r, dtype=dtype).reshape(-1, 1), cfg,
                       mesh, pad_spec, halo) for r in rows64]
    cols = [_halo_cols(torch.tensor(c, dtype=dtype), cfg, mesh, pad_spec,
                       halo) for c in cols64]
    return [StimConstants(
        forcing=forcing,
        rows=torch.stack([r[k].reshape(-1) for r in rows]).contiguous(),
        cols=torch.stack([c[k] for c in cols]).contiguous(), vars=vars_,
        z=None if z64 is None else torch.tensor(z64, dtype=dtype,
                                                device=device))
        for k, device in enumerate(mesh.device_list())]


def check_shard_stim(stim, nyl: int, nxl: int, halo: int, dtype, device):
    """check_tensor on a shard's StimConstants: its profiles halo-padded
    to the shard's buffer."""
    check_tensor("stimulus rows", stim.rows, (stim.n_stim, nyl + 2 * halo),
                 dtype, device)
    check_tensor("stimulus columns", stim.cols,
                 (stim.n_stim, nxl + 2 * halo), dtype, device)


def shard_divform_fields64(problem, aniso: bool):
    """K11's global float64 fields, each (ny, nx): aE, aW, aN, then the
    tissue field of an obstacle (divform mode) or the raw Dxy (aniso
    mode), and the mixed pair's weight inv4 (aniso mode: a scalar on the
    flat surface, an (nx,) profile on the torus; else None). Raises
    ValueError unless aS == roll_y(aN) exactly, which the kernel relies on
    (crdmodel_tpu/ops/pallas_shard_divform.py:128-136)."""
    shape = problem.geometry.grid.shape
    inv4 = None
    if aniso:
        faces, dxy, inv4 = problem.geometry.tensor_coeffs64(
            *problem.diffusion_tensor, boundary=problem.cfg.boundary)
        fourth = [dxy]
    else:
        faces = face_coeffs64(problem)
        fourth = ([] if problem.obstacle_mask is None
                  else [np.asarray(problem.obstacle_mask, np.float64)])
    if not south_is_rolled_north(faces):
        raise ValueError("aS != roll_y(aN): the shard divergence kernel "
                         "cannot read aS from aN (is_shard_divform_supported "
                         "declines)")
    fields = [np.broadcast_to(np.asarray(a, np.float64), shape)
              for a in (*faces[:3], *fourth)]
    return fields, inv4


def make_shard_divform_constants(problem, mesh, pad_spec, halo: int, dtype,
                                 aniso: bool = False):
    """Every shard's ShardDivformConstants, in mesh order on its device
    (crdmodel_tpu/ops/pallas_shard_divform.py:212-265): the coefficient
    stack cast once from the global float64 fields (shard_divform_fields64),
    wrap-padded to the padded grid, split into blocks and halo-padded once
    by the mesh's exchange, mirror-aware along a padded axis
    (parallel/halo.py::mirror_halo_pad), so that its corners carry the
    true diagonal neighbours; in aniso mode on the torus the inv4 column
    profile halo-padded the same way."""
    from crdmodel_tpu_torch.parallel import halo as hx
    cfg = problem.cfg
    fields, inv4 = shard_divform_fields64(problem, aniso)
    stack = torch.tensor(np.stack(fields), dtype=dtype)
    if pad_spec is not None:
        stack = pad_spec.pad_field(stack)
    nyl, nxl, _, _ = _shard_layout(cfg, mesh, pad_spec)
    devices = mesh.device_list()
    px = mesh.shape[1]
    blocks = [stack[:, k // px * nyl:(k // px + 1) * nyl,
                    k % px * nxl:(k % px + 1) * nxl].contiguous().to(d)
              for k, d in enumerate(devices)]
    stacks = hx.mirror_halo_pad(blocks, mesh, halo, pad_spec)
    if inv4 is None:
        inv4s = [None] * len(devices)
    elif np.ndim(inv4) > 0:
        inv4s = _halo_cols(torch.tensor(inv4, dtype=dtype), cfg, mesh,
                           pad_spec, halo)
    else:
        inv4s = [torch.tensor(inv4, dtype=dtype, device=d) for d in devices]
    fourth = len(fields) == 4
    out = []
    for k, rows in enumerate(_shard_rhs_inputs(problem, mesh, pad_spec, halo,
                                               dtype)):
        st = stacks[k]
        out.append(ShardDivformConstants(
            kind="shard_aniso" if aniso else "shard_divform",
            coeffs=(st[0], st[1], st[2]), stack=st,
            tissue=st[3] if fourth and not aniso else None,
            dxy=st[3] if aniso else None, inv4=inv4s[k], **rows))
    return out


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


def add_terms(react, lap, f):
    """ydot before the masks: kinetics + operator on variable 0, and with
    a forcing f = (F0, F1) (stim_terms) kinetics + (operator + F0) and
    kinetics + F1 (crdmodel_tpu/ops/kernel_common.py:133-149, the torch
    path's kinetics + (diffusion + forcing))."""
    if f is None:
        return torch.stack([react[0] + lap, react[1]])
    return torch.stack([react[0] + (lap + f[0]), react[1] + f[1]])


def diffusion_terms(model, y, lap_of):
    """{v: operator term} of each diffusing variable v of `model` on the
    (nvars, ...) state y: lap_of(y[v]), times v's ratio after the stencil
    where it is not 1 (crdmodel_tpu/ops/kernel_common.py:139-145)."""
    laps = {}
    for v, r in zip(model.diffusive_vars, model.diffusion_ratios):
        lap = lap_of(y[v])
        laps[v] = lap if r == 1.0 else r * lap
    return laps


def make_rhs_block(kc: KernelConstants, fz):
    """rhs_block(y, f=None) -> ydot: the kernels' per-tile RHS in plain
    torch, on the whole (nvars, ny, nx) state (crdmodel_tpu/ops/
    kernel_common.py:110-159): the model's kinetics plus the profile
    operator on each diffusing variable (react[v] + laps[v],
    diffusion_terms), plus the stage's forcing f = (F0, F1) (stim_terms;
    the base families only) when given, times live = 1 - fz*(1 - mask)
    when the problem has a freeze. The device functions of
    csrc/rhs_common.cuh compute the same expressions in the same order."""
    lap_of = torus_laplacian if kc.kind == "torus" else flat_laplacian
    live = _live(kc, fz)

    def rhs_block(y, f=None):
        react = kc.model.kinetics(y, kc.b)
        if f is not None:
            ydot = add_terms(react, lap_of(y[0], kc.coeffs), f)
        else:
            laps = diffusion_terms(kc.model, y,
                                   lambda u: lap_of(u, kc.coeffs))
            ydot = torch.stack([react[v] + laps[v] if v in laps else react[v]
                                for v in range(kc.model.nvars)])
        return ydot * live if live is not None else ydot

    return rhs_block


def make_divform_rhs_block(dc: DivformConstants, fz):
    """rhs_block(y, f=None) -> ydot: the divergence kernel's RHS in plain
    torch on the whole (2, ny, nx) state (crdmodel_tpu/ops/
    kernel_common.py:165, without the mixed tensor terms and the dscale
    rescale): the kinetics plus the face-form operator on variable 0
    (ops/stencil.py::divergence_laplacian's grouping, aS = roll_y(aN)),
    plus the stage's forcing f = (F0, F1) when given (add_terms), times
    live when the problem has a freeze, times the 0/1 tissue field when it
    has an obstacle (the forcing before the masks, as make_rhs's
    mask_tissue). csrc/fused_divform.cu computes the same expressions in
    the same order."""
    aE, aW, aN = dc.coeffs
    faces = (aE, aW, aN, torch.roll(aN, 1, dims=0))
    live = _live(dc, fz)

    def rhs_block(y, f=None):
        react = dc.model.kinetics(y, dc.b)
        ydot = add_terms(react, divergence_laplacian(y[0], faces), f)
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


def make_shard_divform_rhs_block(sc: ShardDivformConstants, fz):
    """rhs_block(y, f=None) -> ydot: K11's RHS in plain torch on a shard's
    whole halo-padded (2, nyl + 2 halo, nxl + 2 halo) buffer
    (crdmodel_tpu/ops/kernel_common.py:165-246): the kinetics plus, on
    variable 0, the face-form operator with aS = roll_y(aN)
    (ops/stencil.py::divergence_laplacian) or, in aniso mode, the XLA
    path's tensor operator axis + inv4*(t1 + t2) on the raw Dxy
    (ops/stencil.py::anisotropic_laplacian), which K5 associates otherwise
    (aniso_kernel_laplacian); plus the stage's forcing f = (F0, F1)
    (stim_terms on the shard's halo-padded profiles) when given
    (add_terms); times live with a freeze, times the tissue field with an
    obstacle (the forcing before the masks). The rolls wrap at the buffer's edge: the outer
    rings go wrong, as the stages consume them. csrc/rhs_common.cuh::
    divform_rhs and mixed_divform_rhs compute the same expressions in the
    same order."""
    aE, aW, aN = sc.coeffs
    faces = (aE, aW, aN, torch.roll(aN, 1, dims=0))
    live = _live(sc, fz)

    def lap_of(u):
        if sc.dxy is not None:
            return anisotropic_laplacian(u, faces, sc.dxy, sc.inv4)
        return divergence_laplacian(u, faces)

    def rhs_block(y, f=None):
        react = sc.model.kinetics(y, sc.b)
        ydot = add_terms(react, lap_of(y[0]), f)
        if live is not None:
            ydot = ydot * live
        if sc.tissue is not None:
            ydot = ydot * sc.tissue
        return ydot

    return rhs_block


def make_split_block(kc: KernelConstants, fz):
    """(ex_block, im_block, jac_block), the IMEX split of make_rhs_block
    for the fused IMEX step (crdmodel_tpu/ops/kernel_common.py:282-300):
    ex_block(y, f=None) the profile operator on each diffusing variable
    (diffusion_terms; 0 on the others), with the stage's forcing f = (F0,
    F1) (the base families) the operator plus F0 and F1 (the explicit
    part: make_rhs's rhs_ex), im_block(y) the pointwise kinetics,
    jac_block(y) the kinetics' closed-form Jacobian (nvars, nvars, ny, nx)
    (ReactionModel.jacobian), each times live when the problem has a
    freeze; ex + im equals make_rhs_block's value bitwise without a
    forcing."""
    lap_of = torus_laplacian if kc.kind == "torus" else flat_laplacian
    live = _live(kc, fz)

    def masked(x):
        return x * live if live is not None else x

    def ex_block(y, f=None):
        if f is not None:
            lap = lap_of(y[0], kc.coeffs)
            return masked(torch.stack([lap + f[0], f[1]]))
        laps = diffusion_terms(kc.model, y, lambda u: lap_of(u, kc.coeffs))
        return masked(torch.stack([
            laps[v] if v in laps else torch.zeros_like(y[v])
            for v in range(kc.model.nvars)]))

    def im_block(y):
        return masked(kc.model.kinetics(y, kc.b))

    def jac_block(y):
        return masked(kc.model.jacobian(y, kc.b))

    return ex_block, im_block, jac_block


# --- the 3-D box (K6, K7) ---------------------------------------------


@dataclasses.dataclass(frozen=True)
class BoxProfileConstants(KernelConstants):
    """The box kernels' profile mode: kind "box_profile", coeffs the six
    face profiles aE, aW (nx,), aN, aS (ny,), aU, aD (nz,) of constant D
    with optional no-flux walls."""


@dataclasses.dataclass(frozen=True)
class BoxTissueConstants(KernelConstants):
    """The box kernels' tissue mode: kind "box_tissue", coeffs the six
    wall-only face profiles (as BoxProfileConstants) and tissue the
    (nz, ny, nx) 0/1 obstacle field. The kernels recover each face's
    openness as the product of the tissue values on its two sides, exact
    for 0/1 factors, and zero the kinetics of inert cells."""
    tissue: torch.Tensor


@dataclasses.dataclass(frozen=True)
class BoxFieldConstants(KernelConstants):
    """The box kernels' field mode: kind "box_field", coeffs (aE, aN, aU)
    as contiguous (nz, ny, nx) tensors of a 3-D diffusion field with its
    masks folded in; aW, aS and aD are read as aE at i-1, aN at j-1
    (wrapped) and aU at k-1 (0 at k = 0). tissue: the 0/1 obstacle field
    or None."""
    tissue: object


@dataclasses.dataclass(frozen=True)
class BoxTensorConstants(KernelConstants):
    """The box kernels' tensor mode: kind "box_tensor", coeffs (aE, aN, aU,
    Dxy, Dxz, Dyz) as contiguous (nz, ny, nx) tensors (aW, aS, aD as in
    field mode) and invs the (3,) mixed-pair weights 1/(4 da db)."""
    invs: torch.Tensor


def _box_profiles(problem):
    """The six face coefficients as float64 1-D profiles (aE(x), aW(x),
    aN(y), aS(y), aU(z), aD(z)), or None when the operator is not
    profile-expressible (crdmodel_tpu/ops/pallas_box3d.py:116). With an
    obstacle the faces factor exactly as profile x tissue openness, so the
    profiles are built from the wall-only masks."""
    g = problem.geometry.grid
    face_mask = problem.face_mask
    if problem.obstacle_mask is not None:
        face_mask = face_openness3(g.nz, g.ny, g.nx, problem.cfg.boundary)
    faces = problem.geometry.divergence_coeffs64(problem.diffusion_field,
                                                 face_mask=face_mask)
    aE, aW, aN, aS, aU, aD = (np.asarray(a, np.float64) for a in faces)
    if aE.ndim > 1 or aW.ndim > 1:
        return None
    for a, n in ((aN, g.ny), (aS, g.ny)):
        if a.ndim not in (0, 2) or (a.ndim == 2 and a.shape != (n, 1)):
            return None
    for a in (aU, aD):
        if a.ndim not in (0, 3) or (a.ndim == 3 and a.shape != (g.nz, 1, 1)):
            return None
    return tuple(np.broadcast_to(a.reshape(-1), (n,)) for a, n in (
        (aE, g.nx), (aW, g.nx), (aN, g.ny), (aS, g.ny), (aU, g.nz),
        (aD, g.nz)))


def _rolls_hold(aE, aW, aN, aS, aU, aD) -> bool:
    """aW == roll_x(aE), aS == roll_y(aN) and aD == roll_z(aU) exactly on
    the float64 fields: the kernels read aW, aS and aD through them."""
    return (np.array_equal(aW, np.roll(aE, 1, axis=-1))
            and np.array_equal(aS, np.roll(aN, 1, axis=-2))
            and np.array_equal(aD, np.roll(aU, 1, axis=-3)))


def _box_field_faces(problem):
    """(aE, aN, aU) as float64 (nz, ny, nx) arrays when the operator is a
    3-D diffusion field, else None (crdmodel_tpu/ops/pallas_box3d.py:165).
    The roll identities the kernels rely on are checked explicitly, not
    asserted: where they fail the operator is not expressible and the
    problem keeps the torch path."""
    if problem.diffusion_field is None or np.ndim(
            problem.diffusion_field) <= 1:
        return None
    faces = problem.geometry.divergence_coeffs64(
        problem.diffusion_field, face_mask=problem.face_mask)
    faces = [np.asarray(a, np.float64) for a in faces]
    if faces[0].ndim != 3 or not _rolls_hold(*faces):
        return None
    return faces[0], faces[2], faces[4]


def _box_tensor_fields(problem):
    """((aE, aN, aU, Dxy, Dxz, Dyz) as float64 (nz, ny, nx) arrays, (inv4_xy,
    inv4_xz, inv4_yz)) of the 19-point operator, or None
    (crdmodel_tpu/ops/pallas_box3d.py:202). It needs closed z walls (aU at
    the top layer and the wall layers of Dxz and Dyz zero), so that the
    kernels' clamped z reads meet zero coefficients, and the roll
    identities."""
    faces, mixed, invs = problem.geometry.tensor_coeffs64(
        *problem.diffusion_tensor, boundary=problem.cfg.boundary)
    faces = [np.asarray(a, np.float64) for a in faces]
    dxy, dxz, dyz = (np.asarray(a, np.float64) for a in mixed)
    aU = faces[4]
    if np.any(aU[-1] != 0.0):
        return None
    if any(np.any(d[k] != 0.0) for d in (dxz, dyz) for k in (0, -1)):
        return None
    if not _rolls_hold(*faces):
        return None
    return (faces[0], faces[2], aU, dxy, dxz, dyz), tuple(
        float(v) for v in invs)


def _box_mode_uncached(problem):
    if problem.geometry.kind != "box":
        return None, None
    if problem.diffusion_tensor is not None:
        tf = _box_tensor_fields(problem)
        return ("tensor", tf) if tf is not None else (None, None)
    profs = _box_profiles(problem)
    if profs is not None:
        # the z walls must be closed: aU at the top, aD at the bottom zero
        if profs[4][-1] != 0.0 or profs[5][0] != 0.0:
            return None, None
        return "profile", profs
    fields = _box_field_faces(problem)
    if fields is None or np.any(fields[2][-1] != 0.0):
        return None, None       # aD[0] = roll_z(aU)[0] = aU[-1]
    return "field", fields


_BOX_MODE_CACHE: dict = {}


def box_mode(problem):
    """("profile", six float64 profiles) | ("field", (aE, aN, aU)) |
    ("tensor", (six fields, invs)) | (None, None) of a problem
    (crdmodel_tpu/ops/pallas_box3d.py:235-273): the operator mode of the box
    kernels, None where they cannot express it (open z walls, broken roll
    identities, not a box). Profile mode with an obstacle is the tissue
    mode. Cached per Problem (keyed by id, guarded by a weak reference):
    the gates and the builders each ask, and a field mode materialises
    full (nz, ny, nx) float64 arrays."""
    key = id(problem)
    hit = _BOX_MODE_CACHE.get(key)
    if hit is not None and hit[0]() is problem:
        return hit[1]
    result = _box_mode_uncached(problem)
    _BOX_MODE_CACHE[key] = (weakref.ref(
        problem, lambda _, k=key: _BOX_MODE_CACHE.pop(k, None)), result)
    return result


def prepare_box_constants(problem, dtype, device) -> KernelConstants:
    """The box kernels' inputs of `problem` on `device`: the constants of
    its box_mode, each cast once from float64. Raises ValueError where
    box_mode is None."""
    mode, data = box_mode(problem)
    common = _rhs_inputs(problem, dtype, device)

    def cast(arrays):
        return tuple(torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                                  device=device) for a in arrays)

    tissue = None
    if problem.obstacle_mask is not None:
        tissue = torch.tensor(np.asarray(problem.obstacle_mask, np.float64),
                              dtype=dtype, device=device)
    if mode == "profile" and tissue is None:
        return BoxProfileConstants(kind="box_profile", coeffs=cast(data),
                                   **common)
    if mode == "profile":
        return BoxTissueConstants(kind="box_tissue", coeffs=cast(data),
                                  tissue=tissue, **common)
    if mode == "field":
        return BoxFieldConstants(kind="box_field", coeffs=cast(data),
                                 tissue=tissue, **common)
    if mode == "tensor":
        fields, invs = data
        return BoxTensorConstants(
            kind="box_tensor", coeffs=cast(fields),
            invs=torch.tensor(invs, dtype=dtype, device=device), **common)
    raise ValueError("the box kernels cannot express this operator (open "
                     "z walls, or not a box): box_mode is None")


def _z_up(u):
    """u at plane k+1, clamped at the top (u[nz-1] at k = nz-1)."""
    return torch.cat([u[..., 1:, :, :], u[..., -1:, :, :]], dim=-3)


def _z_down(u):
    """u at plane k-1, clamped at the bottom (u[0] at k = 0)."""
    return torch.cat([u[..., :1, :, :], u[..., :-1, :, :]], dim=-3)


class _Volume:
    """The planes of box_operator's constants on the whole (nz, ny, nx)
    volume: a field as it is, its planes above and below (clamped), the
    plane below with 0 at k = 0, and a (nz,) z profile by plane."""
    at = staticmethod(lambda a: a)
    up = staticmethod(_z_up)
    down = staticmethod(_z_down)

    @staticmethod
    def below0(a):
        return torch.cat([torch.zeros_like(a[:1]), a[:-1]], dim=0)

    @staticmethod
    def profile(p):
        return p.reshape(-1, 1, 1)


class _Plane:
    """The same selections at plane q of nz (box_plane_rhs)."""

    def __init__(self, q: int, nz: int):
        self.q, self.kU, self.kD = q, min(q + 1, nz - 1), max(q - 1, 0)

    def at(self, a):
        return a[self.q]

    def up(self, a):
        return a[self.kU]

    def down(self, a):
        return a[self.kD]

    def below0(self, a):
        return a[self.q - 1] if self.q > 0 else torch.zeros_like(a[0])

    def profile(self, p):
        return p[self.q]


def box_operator(u, uu, ud, bc, z=_Volume):
    """The box kernels' operator on u, given its planes above (uu) and
    below (ud), clamped at the z walls, in plain torch (crdmodel_tpu/ops/
    pallas_box3d.py:557-645): x and y wrap, the six faces summed E, W, N,
    S, U, D as in ops/stencil.py::divergence_laplacian3 and the tensor's
    mixed pairs in the JAX kernel's association ((axis + ixy Txy) + ixz
    Txz) + iyz Tyz, which is also anisotropic_laplacian3's. z selects the
    constants' planes: _Volume for u (nz, ny, nx), _Plane(q, nz) for u the
    plane q. csrc/box3d.cuh and box_stream.cuh compute the same
    expressions in the same order."""
    kind = bc.kind
    ue, uw, un, us = shift_e(u), shift_w(u), shift_n(u), shift_s(u)
    if kind in ("box_profile", "box_tissue"):
        aE, aW, aN, aS, aU, aD = bc.coeffs
        aN, aS = aN.reshape(-1, 1), aS.reshape(-1, 1)
        aU, aD = z.profile(aU), z.profile(aD)
        if kind == "box_tissue":
            t = z.at(bc.tissue)
            aE = aE * (t * shift_e(t))
            aW = aW * (t * shift_w(t))
            aN = aN * (t * shift_n(t))
            aS = aS * (t * shift_s(t))
            aU = aU * (t * z.up(bc.tissue))
            aD = aD * (t * z.down(bc.tissue))
    else:
        aE, aN = z.at(bc.coeffs[0]), z.at(bc.coeffs[1])
        aU = z.at(bc.coeffs[2])
        aW, aS = shift_w(aE), shift_s(aN)
        aD = z.below0(bc.coeffs[2])
    lap = (aE * (ue - u) + aW * (uw - u) + aN * (un - u) + aS * (us - u)
           + aU * (uu - u) + aD * (ud - u))
    if kind != "box_tensor":
        return lap
    dxy, dxz, dyz = bc.coeffs[3:]
    ixy, ixz, iyz = bc.invs
    dxy = z.at(dxy)
    fa = dxy * (un - us)
    fb = dxy * (ue - uw)
    t_xy = (shift_e(fa) - shift_w(fa)) + (shift_n(fb) - shift_s(fb))
    dzs = uu - ud
    fa = z.at(dxz) * dzs
    t_xz = (shift_e(fa) - shift_w(fa)) + (
        z.up(dxz) * (shift_e(uu) - shift_w(uu))
        - z.down(dxz) * (shift_e(ud) - shift_w(ud)))
    fa = z.at(dyz) * dzs
    t_yz = (shift_n(fa) - shift_s(fa)) + (
        z.up(dyz) * (shift_n(uu) - shift_s(uu))
        - z.down(dyz) * (shift_n(ud) - shift_s(ud)))
    return ((lap + ixy * t_xy) + ixz * t_xz) + iyz * t_yz


def box_kernel_laplacian(u, bc):
    """The box kernels' operator on u (nz, ny, nx) in plain torch: z is
    clamped (exact under the closed z walls box_mode requires: the clamped
    reads meet zero coefficients where the torch path's periodic roll
    wraps); box_operator on the whole volume."""
    return box_operator(u, _z_up(u), _z_down(u), bc)


def make_box_rhs_block(bc: KernelConstants, fz):
    """rhs_block(y, f=None) -> ydot: the box kernels' RHS in plain torch on
    the whole (2, nz, ny, nx) state: the kinetics plus box_kernel_laplacian
    on variable 0, plus the evaluation's forcing f = (F0, F1) (stim_terms
    on the box: (nz, ny, nx) each) when given (add_terms), times live =
    1 - fz*(1 - mask) with a freeze (rows j = 0 and ny-1 of every plane),
    times the 0/1 tissue field with an obstacle: the forcing before the
    masks, as the JAX box kernels add it (crdmodel_tpu/ops/
    pallas_box3d.py:654-667). csrc/box3d.cuh computes the same expressions
    in the same order."""
    live = _live(bc, fz)
    tissue = getattr(bc, "tissue", None)

    def rhs_block(y, f=None):
        react = bc.model.kinetics(y, bc.b)
        ydot = add_terms(react, box_kernel_laplacian(y[0], bc), f)
        if live is not None:
            ydot = ydot * live
        if tissue is not None:
            ydot = ydot * tissue
        return ydot

    return rhs_block


def box_plane_rhs(bc: KernelConstants, fz, nz: int):
    """rhs(q, ud, yq, uu) -> ydot (2, ny, nx): make_box_rhs_block's RHS at
    plane q of a box of nz planes, from the state's two variables yq there and
    variable 0 on the planes below (ud) and above (uu), clamped at the z
    walls: the same operations on the same values, so each plane of it is
    bitwise the whole-volume RHS's (ops/box_stream.py::box_stream_model)."""
    live = _live(bc, fz)
    tissue = getattr(bc, "tissue", None)

    def rhs(q, ud, yq, uu):
        z = _Plane(q, nz)
        react = bc.model.kinetics(yq, bc.b)
        ydot = torch.stack([react[0] + box_operator(yq[0], uu, ud, bc, z),
                            react[1]])
        if live is not None:
            ydot = ydot * live
        if tissue is not None:
            ydot = ydot * tissue[q]
        return ydot

    return rhs


@dataclasses.dataclass(frozen=True)
class ShardBoxConstants(ShardConstants):
    """One shard's inputs of the box shard kernels (K12, K13; crdmodel_tpu/
    ops/pallas_shard_box3d.py:607-680): kind one of the box modes
    ("box_profile", "box_tissue", "box_field", "box_tensor"), its
    constants halo-padded in (y, x) like the shard's (nvars, nz, nyl +
    2 halo, nxl + 2 halo) buffer: aE, aW (nxl + 2 halo,), aN, aS (nyl +
    2 halo,) and aU, aD (nz,) replicated (z stays on the shard); the field
    and tensor modes' (nz, nyl + 2 halo, nxl + 2 halo) fields; tissue the
    halo-padded 0/1 obstacle field or None; invs the tensor's (3,) weights
    or None. b, mask, halo and the physical extent as ShardConstants."""
    tissue: object
    invs: object


def make_shard_box_constants(problem, mesh, pad_spec, halo: int, dtype):
    """Every shard's ShardBoxConstants, in mesh order on its device
    (crdmodel_tpu/ops/pallas_shard_box3d.py:607-680), built once a run:
    the float64 constants of box_mode cast once, wrap-padded to the padded
    grid, split into blocks and halo-padded by the mesh's exchange,
    mirror-aware along a padded axis, so that every read across a shard
    edge (a tissue neighbour's openness, aW = aE at i-1, aS = aN at j-1)
    meets the true neighbour's value. The z profiles and the tensor's
    weights are replicated: they never go through an axis test, so a z
    profile as long as nx or ny stays whole. Raises ValueError where
    box_mode is None."""
    from crdmodel_tpu_torch.parallel import halo as hx
    cfg = problem.cfg
    mode, data = box_mode(problem)
    if mode is None:
        raise ValueError("the box shard kernels cannot express this "
                         "operator (open z walls, or not a box)")
    nyl, nxl, _, _ = _shard_layout(cfg, mesh, pad_spec)
    devices = mesh.device_list()
    px = mesh.shape[1]

    def cast(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype)

    def halo_fields(arrays):
        """(nz, ny, nx) arrays -> each shard's halo-padded stack."""
        st = cast(np.stack([np.broadcast_to(a, problem.geometry.grid.shape)
                            for a in arrays]))
        if pad_spec is not None:
            st = pad_spec.pad_field(st)
        blocks = [st[..., k // px * nyl:(k // px + 1) * nyl,
                     k % px * nxl:(k % px + 1) * nxl].contiguous().to(d)
                  for k, d in enumerate(devices)]
        return hx.mirror_halo_pad(blocks, mesh, halo, pad_spec)

    tissue = invs = [None] * len(devices)
    if problem.obstacle_mask is not None:
        tissue = [st[0] for st in halo_fields(
            [np.asarray(problem.obstacle_mask, np.float64)])]
    if mode == "profile":
        aE, aW, aN, aS, aU, aD = data
        cols = [_halo_cols(cast(a), cfg, mesh, pad_spec, halo)
                for a in (aE, aW)]
        rows = [_halo_rows(cast(a).reshape(-1, 1), cfg, mesh, pad_spec, halo)
                for a in (aN, aS)]
        coeffs = [(cols[0][k], cols[1][k], rows[0][k].reshape(-1),
                   rows[1][k].reshape(-1), cast(aU).to(d), cast(aD).to(d))
                  for k, d in enumerate(devices)]
        kind = "box_profile" if problem.obstacle_mask is None else (
            "box_tissue")
    elif mode == "field":
        coeffs = [tuple(st) for st in halo_fields(data)]
        kind = "box_field"
    else:
        fields, weights = data
        coeffs = [tuple(st) for st in halo_fields(fields)]
        invs = [torch.tensor(weights, dtype=dtype, device=d) for d in devices]
        kind = "box_tensor"
    return [ShardBoxConstants(kind=kind, coeffs=coeffs[k], tissue=tissue[k],
                              invs=invs[k], **rows_k)
            for k, rows_k in enumerate(_shard_rhs_inputs(problem, mesh,
                                                         pad_spec, halo,
                                                         dtype))]


def freeze_scalar(params, has_freeze: bool, t_boundary: float, dtype):
    """1.0 while the integration segment lies in the frozen piece
    (t < tBoundary), from params['_seg_end'] as a 0-d tensor on its device:
    segments never straddle the discontinuity (integrate/erk.py)."""
    seg_end = params.get("_seg_end")
    if not has_freeze or seg_end is None:
        device = params["b"].device
        return torch.zeros((), dtype=dtype, device=device)
    return (seg_end <= t_boundary).to(dtype)
