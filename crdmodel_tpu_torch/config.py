"""Config system: ini loader + typed simulation config.

A copy of crdmodel_tpu/config.py, which is free of jax itself but cannot be
imported without running crdmodel_tpu/__init__.py, which imports jax. The
fields, derived geometry and validation are the same, so a config built by
either package compares equal field by field
(tests/test_torch_config.py). `validate` checks the model name against the
JAX package's families (MODEL_NAMES) rather than the port's registry:
a config may name a model the port has not ported yet, and
core/problem.py::build_problem refuses it there.

Replaces the reference's boost::property_tree ini parsing (C1 in SURVEY.md;
reference src/FHNmodel_torus.cpp:156-174) and the Python ConfigObj readers
(reference util/GenTorus.py:14-18) with one stdlib-based loader shared by the
solver and the post-processing tools.

Reads the reference's own ini files unchanged, tolerating the documented key
skew: the FHN mains read `Parameters.thetaMesh` while the shipped
data/FHNmodelArgs.ini defines `xMesh` (reference src/FHNmodel_flat.cpp:166 vs
data/FHNmodelArgs.ini:14) — we accept either spelling for every model.

Deliberate divergence from reference bugs (documented per SURVEY.md §2.3):
  - GoldbeterModel_torus never reads betaMin/betaMax/icType (reference
    src/GoldbeterModel_torus.cpp:174-187), silently using 0/0/0 with
    varyBeta=1. We implement the intended behavior (read the keys) for all
    model×surface combinations.
"""

from __future__ import annotations

import configparser
import dataclasses
import math
from typing import Optional

TWO_PI = 2.0 * math.pi

# use_pallas=None auto-threshold: grid points above which sim.py selects the
# fused step kernel (ops/fused_step.py). The value is the JAX package's;
# the crossover on the GPU has not been measured yet (ROADMAP).
PALLAS_AUTO_POINTS = 150_000

# use_pallas=None auto-threshold of the 3-D box's fused kernels
# (ops/fused_box3d.py, ops/fused_box3d_rkc.py), on nz*ny*nx points. The
# value is the JAX package's (crdmodel_tpu/config.py:36-42, measured on a
# TPU); it has not been re-derived on the GPU (PERF.md section 7).
PALLAS_BOX3D_AUTO_POINTS = 2_000_000

# every kinetics family of the JAX package (crdmodel_tpu/models/); the port
# registers those it has ported (models/)
MODEL_NAMES = ("aliev_panfilov", "barkley", "brusselator", "fhn",
               "goldbeter", "grayscott", "lambdaomega", "oregonator", "sir")


def load_ini(path: str) -> dict:
    """Parse a reference-style ini file into {section: {key: str}}.

    Keys are case-preserved (reference files use camelCase). Inline trailing
    whitespace/tabs (present throughout data/FHNmodelArgs.ini) are stripped.
    """
    cp = configparser.ConfigParser(inline_comment_prefixes=("#", ";"))
    cp.optionxform = str  # preserve case
    with open(path, "r") as fh:
        cp.read_string(fh.read())
    return {s: {k: v.strip() for k, v in cp.items(s)} for s in cp.sections()}


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Fully-resolved simulation configuration.

    Mirrors the union of the four reference programs' parameter globals
    (reference src/FHNmodel_torus.cpp:80-94, src/GoldbeterModel_torus.cpp:90-106)
    plus framework-level knobs (dtype, backend selection) that have no
    reference counterpart.
    """

    # --- model / surface selection (reference: which of 4 binaries) ---
    model: str = "fhn"   # any registered family: fhn | goldbeter | barkley
                         # | grayscott | oregonator | brusselator
    # "flat" | "torus" (the reference's two surfaces) plus beyond-reference
    # surfaces of revolution (core/grid.py::RevolutionGeometry):
    #   "sphere"            radius = surfaceLength/2pi; polar axis x=v in
    #                       (0, pi) with finite-volume pole closure, phi=y
    #   "revolution"        closed (torus-like) generic profile, v in
    #                       [0, 2pi]; build_problem(cfg, profile=...)
    #   "revolution_capped" capped (sphere-like) generic profile, v in
    #                       (0, pi) cell-centred; zero-flux end caps
    # and the 3-D volumetric domain (core/grid.py::BoxGeometry):
    #   "box"               rectangular slab [0,W]x[0,L]x[0,depth], state
    #                       (nvars, nz, ny, nx); needs zMesh + surfaceDepth.
    #                       The 2-D-only reference cannot express volumetric
    #                       tissue (scroll waves); conservative 7-point
    #                       face-coefficient operator, XLA compute path
    surface: str = "flat"

    # --- [Parameters] ---
    diffusion: float = 0.12
    beta: float = 1.25
    surface_width: float = 20.0    # minor circumference (torus) / width (flat)
    surface_length: float = 80.0   # major circumference (torus) / length (flat)
    wave_length: float = 0.1       # fraction of domain length (phi/y)
    wave_width: float = 0.5        # fraction of domain width (theta/x)
    wave_inside: int = 0           # torus only: segment at theta=pi (1) or 0 (0)
    output_timestep: int = 20      # Nt: number of output intervals
    t_boundary: float = 0.0        # absorbing-boundary turn-off time
    t_final: float = 50.0
    x_mesh: int = 400              # nx (theta/x mesh size)
    beta_min: float = 0.0
    beta_max: float = 0.0
    # Optional explicit phi/y mesh size (ini key yMesh). 0 = derived from
    # the surface (torus: nx*R/r; flat: nx*int(L/W); sphere: 2*nx — the
    # equator/meridian length ratio). Required (>0) for the generic
    # revolution surfaces, whose profile the config cannot see.
    y_mesh: int = 0
    # 3-D box only (surface="box"): depth-axis extent and mesh size (ini
    # keys surfaceDepth / zMesh). State gains a leading z axis:
    # (nvars, nz, ny, nx); z spacing follows the same duplicated-seam
    # (n-1) convention as x/y.
    surface_depth: float = 0.0
    z_mesh: int = 0

    # --- [System] ---
    include_all_vars: int = 0
    vary_beta: int = 0
    just_diffusion: int = 0        # goldbeter only in reference; honored for all
    ic_type: int = 0               # goldbeter varyBeta ICs: 0 homog, 1 perturb, 2 random

    # --- integrator (hardcoded in reference, src/FHNmodel_torus.cpp:197-198,372) ---
    rtol: float = 1.0e-5
    atol: float = 1.0e-10
    max_steps: int = 200_000       # max internal steps per output interval
    # integrator: embedded ERK tableaus "bs32" | "zonneveld43" | "dopri54",
    # "rkc2" (stabilized Chebyshev, for diffusion-CFL-limited fine grids), or
    # "ark324" (IMEX ARK3(2)4L[2]SA: implicit pointwise reaction via
    # vectorized Newton + explicit diffusion, for reaction-stiff kinetics
    # like Goldbeter — integrate/imex.py)
    method: str = "bs32"
    # output-time handling: "tstop" clamps the last step onto each tout
    # (framework default); "normal" = ARKode's ARK_NORMAL behavioural parity
    # (step freely past tout + cubic-Hermite dense output; batch driver only)
    step_mode: str = "tstop"

    # --- framework knobs (no reference counterpart) ---
    dtype: str = "float32"         # "float32" | "float64"
    rng_seed: int = 0              # explicit PRNG for ic_type=2 (reference: unseeded rand())
    # Fused step kernel (ops/fused_step.py; the JAX package's Pallas
    # kernel, hence the name). None = automatic: the kernel above
    # PALLAS_AUTO_POINTS grid points on a CUDA device; True/False force it
    # (True on a CPU device runs the kernel's plain torch version).
    use_pallas: Optional[bool] = None
    # Speculative K-step batching (crdmodel_tpu/integrate/erk.py::
    # integrate_interval_batched): K frozen-h steps a batch, on the torch
    # path, through K3, or through the K-step kernel K14 on K1's problems
    # (sim.py::make_run_fn). 0 = off; rkc2, ARK_NORMAL and the other
    # fused ERK kernels step one step at a time.
    speculative_k: int = 0
    # Spatially-varying diffusion (conservative flux form,
    # ops/stencil.py::divergence_laplacian). "none" = the reference's
    # constant-D operator; "curvature" = D(theta) modulated by the
    # Kneer et al. (2014) curvature-coupling profile the reference computes
    # but never simulates with (util/GenCurvatureCoupling.py:29-43),
    # normalised so the theta-average diffusivity equals `diffusion`
    # (torus only). Arbitrary fields: build_problem(cfg, diffusion_field=A).
    coupling: str = "none"
    # Domain boundary conditions (flat surface only; the torus is a closed
    # surface). "periodic" = the reference's wrap (src/FHNmodel_flat.cpp:
    # 489-566 with periods={1,1}); "noflux" / "noflux_x" / "noflux_y" close
    # the corresponding domain edges with zero-flux (reflecting/Neumann)
    # walls — the standard bounded-tissue setup (e.g. cardiac sheets).
    # Implemented by zeroing the divergence-form face coefficients across
    # closed faces (core/grid.py::face_openness): exactly conservative,
    # self-adjoint, and free on the sharded paths (halo values at closed
    # faces are multiplied by zero). Internal obstacles:
    # build_problem(cfg, obstacle_mask=...).
    boundary: str = "periodic"
    # Reduced (pole-coarsened) grid for capped revolution surfaces
    # (sphere): merge phi cells near the poles into power-of-2 blocks so
    # the effective phi cell width — and the diffusion spectral radius —
    # stays at the equatorial scale instead of growing ~nx^4
    # (core/grid.py::RevolutionGeometry.pole_group_sizes; the standard
    # climate-model answer to the lat-lon pole tax). Conservative and
    # self-adjoint (Galerkin block operator); phi resolution near the
    # poles drops to ~the equatorial physical resolution. Single-device
    # XLA path only this round (sharded drivers refuse; fused kernels
    # decline). 0 = off (full lat-lon grid).
    pole_coarsen: int = 0

    # ------------------------------------------------------------------
    # Derived geometry. Conventions reproduced exactly from the reference
    # for parity (SURVEY.md §7 "parity traps"):
    #   torus: r=W/2pi, R=L/2pi, ny=int(nx*R/r), domain [0,2pi]^2,
    #          dx=2pi/(nx-1) (duplicated periodic seam point)
    #          (src/FHNmodel_torus.cpp:188-193,233-234)
    #   flat:  ny=nx*int(L/W) (integer-truncated ratio), domain [0,W]x[0,L]
    #          (src/FHNmodel_flat.cpp:172-175,190-192,230-231)
    # ------------------------------------------------------------------

    @property
    def nx(self) -> int:
        return self.x_mesh

    @property
    def ny(self) -> int:
        if self.y_mesh > 0:
            return self.y_mesh
        if self.surface == "torus":
            radius_ratio = self.major_radius / self.minor_radius
            return int(self.x_mesh * radius_ratio)
        if self.surface == "sphere":
            # equator circumference (2 pi R) / meridian length (pi R) = 2
            return 2 * self.x_mesh
        if self.surface in ("revolution", "revolution_capped"):
            raise ValueError("generic revolution surfaces need an explicit "
                             "yMesh (the config cannot derive ny from a "
                             "profile it cannot see)")
        # reference truncates L/W to long int BEFORE multiplying
        # (box: same flat-sheet convention for the in-plane axes)
        return self.x_mesh * int(self.surface_length / self.surface_width)

    @property
    def nz(self) -> int:
        """Depth mesh size — 0 for every 2-D surface, z_mesh for the box."""
        return self.z_mesh if self.surface == "box" else 0

    @property
    def zmin(self) -> float:
        return 0.0

    @property
    def zmax(self) -> float:
        return self.surface_depth

    @property
    def dz(self) -> float:
        return (self.zmax - self.zmin) / (self.nz - 1.0)

    @property
    def minor_radius(self) -> float:
        return self.surface_width / TWO_PI

    @property
    def major_radius(self) -> float:
        return self.surface_length / TWO_PI

    @property
    def capped(self) -> bool:
        """Surfaces whose v-axis ends in zero-flux caps (poles / lids)
        rather than wrapping: cells sit at v_i = (i+1/2)h, h = pi/nx, so
        faces land exactly on v=0 and v=pi where the flux weight vanishes
        (or is forced to 0 — core/grid.py::RevolutionGeometry)."""
        return self.surface in ("sphere", "revolution_capped")

    @property
    def xmin(self) -> float:
        if self.capped:
            return 0.5 * math.pi / self.x_mesh
        return 0.0

    @property
    def xmax(self) -> float:
        if self.surface in ("torus", "revolution"):
            return TWO_PI
        if self.capped:
            return math.pi - 0.5 * math.pi / self.x_mesh
        return self.surface_width

    @property
    def ymin(self) -> float:
        return 0.0

    @property
    def ymax(self) -> float:
        if self.surface in ("flat", "box"):
            return self.surface_length
        return TWO_PI

    @property
    def dx(self) -> float:
        return (self.xmax - self.xmin) / (self.nx - 1.0)

    @property
    def dy(self) -> float:
        return (self.ymax - self.ymin) / (self.ny - 1.0)

    @property
    def program_name(self) -> str:
        """Reference binary name for file-format parity (e.g. FHNmodel_torus);
        framework models fall back to <Name>Model_<surface>."""
        base = {"fhn": "FHNmodel", "goldbeter": "GoldbeterModel",
                "barkley": "BarkleyModel", "grayscott": "GrayScottModel"}
        name = base.get(self.model, f"{self.model.capitalize()}Model")
        return f"{name}_{self.surface}"

    def validate(self) -> "SimConfig":
        if self.model not in MODEL_NAMES:
            raise ValueError(f"unknown model {self.model!r}; "
                             f"registered: {sorted(MODEL_NAMES)}")
        if self.surface not in ("flat", "torus", "sphere", "revolution",
                                "revolution_capped", "box"):
            raise ValueError(f"unknown surface {self.surface!r}")
        if self.y_mesh < 0:
            raise ValueError("yMesh must be >= 0 (0 = derived)")
        if self.surface == "box":
            if self.z_mesh < 3:
                raise ValueError("surface='box' needs zMesh >= 3")
            if self.surface_depth <= 0.0:
                raise ValueError("surface='box' needs surfaceDepth > 0")
            if self.pole_coarsen:
                raise ValueError("pole_coarsen is a capped-surface feature; "
                                 "the box has no poles")
            if self.coupling != "none":
                raise ValueError("coupling='curvature' lives in toroidal "
                                 "coordinates; the box is flat — pass "
                                 "build_problem(cfg, diffusion_field=...) "
                                 "for variable diffusivity")
        elif self.z_mesh or self.surface_depth:
            raise ValueError("zMesh / surfaceDepth are only meaningful for "
                             "surface='box'")
        if self.wave_inside not in (0, 1):
            raise ValueError("waveInside must be 0 or 1")
        if self.nx < 3 or self.ny < 3:
            raise ValueError(f"grid too small: {self.nx}x{self.ny}")
        if self.output_timestep < 1:
            raise ValueError("outputTimestep must be >= 1")
        if self.method not in ("bs32", "zonneveld43", "dopri54", "rkc2",
                               "ark324"):
            raise ValueError(f"unknown method {self.method!r}")
        if self.step_mode not in ("tstop", "normal"):
            raise ValueError(f"step_mode must be tstop|normal, "
                             f"got {self.step_mode!r}")
        if self.coupling not in ("none", "curvature"):
            raise ValueError(f"coupling must be none|curvature, "
                             f"got {self.coupling!r}")
        if self.coupling == "curvature" and self.surface != "torus":
            raise ValueError("coupling='curvature' needs surface='torus' "
                             "(the Kneer profile lives in toroidal "
                             "coordinates)")
        if self.boundary not in ("periodic", "noflux", "noflux_x",
                                 "noflux_y", "noflux_z"):
            raise ValueError(f"boundary must be periodic|noflux|noflux_x|"
                             f"noflux_y|noflux_z, got {self.boundary!r}")
        if self.boundary != "periodic" and self.surface not in ("flat",
                                                                "box"):
            raise ValueError("no-flux boundaries need surface='flat' or "
                             "'box' (torus/sphere/revolution surfaces are "
                             "closed; capped surfaces already carry "
                             "zero-flux end caps in their face coefficients)")
        if self.boundary == "noflux_z" and self.surface != "box":
            raise ValueError("boundary='noflux_z' needs surface='box'")
        if self.pole_coarsen and not self.capped:
            raise ValueError("pole_coarsen needs a capped revolution "
                             "surface (sphere / revolution_capped) — "
                             "other surfaces have no pole tax to reduce")
        return self


# ini key -> (dataclass field, type)
_PARAM_KEYS = {
    "diffusion": ("diffusion", float),
    "beta": ("beta", float),
    "surfaceWidth": ("surface_width", float),
    "surfaceLength": ("surface_length", float),
    "waveLength": ("wave_length", float),
    "waveWidth": ("wave_width", float),
    "waveInside": ("wave_inside", int),
    "outputTimestep": ("output_timestep", int),
    "tBoundary": ("t_boundary", float),
    "tFinal": ("t_final", float),
    "xMesh": ("x_mesh", int),
    "thetaMesh": ("x_mesh", int),   # FHN mains' spelling (src/FHNmodel_torus.cpp:170)
    "yMesh": ("y_mesh", int),       # framework extension (0 = derived)
    "zMesh": ("z_mesh", int),               # framework extension (3-D box)
    "surfaceDepth": ("surface_depth", float),  # framework extension (box)
    "betaMin": ("beta_min", float),
    "betaMax": ("beta_max", float),
}

_SYSTEM_KEYS = {
    "includeAllVars": ("include_all_vars", int),
    "varyBeta": ("vary_beta", int),
    "justDiffusion": ("just_diffusion", int),
    "icType": ("ic_type", int),
    # documented in the reference inis but never read by any main
    # (data/FHNmodelArgs.ini:38); accepted and ignored for compatibility
    "symmetricIC": (None, int),
    "poleCoarsen": ("pole_coarsen", int),   # framework extension
}


def config_from_ini(path: str, model: str, surface: str, **overrides) -> SimConfig:
    """Build a SimConfig from a reference-format ini file.

    `model`/`surface` select the program (the reference encodes this in the
    choice of binary, not the ini). Extra keyword overrides win over the file.
    """
    sections = load_ini(path)
    fields: dict = {"model": model, "surface": surface}
    for section, keymap in (("Parameters", _PARAM_KEYS), ("System", _SYSTEM_KEYS)):
        for key, raw in sections.get(section, {}).items():
            if key not in keymap:
                continue  # tolerate unknown keys like the Python readers do
            field, typ = keymap[key]
            if field is None:
                continue
            # ints written as "20" parse fine; floats written as "0.4" too
            fields[field] = typ(float(raw)) if typ is int else typ(raw)
    fields.update(overrides)
    return SimConfig(**fields).validate()
