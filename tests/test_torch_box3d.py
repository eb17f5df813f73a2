"""The port's 3-D box on the torch path (CPU) against the JAX package's
(CPU): BoxGeometry's face and tensor coefficients and face_openness3
bitwise; the 7- and 19-point operators, the RHS (composed and split) and
the RKC2 bound in f64 to 1e-13; the extruded initial state; build_problem's
errors; and whole torch-path runs on small boxes step for step against
JAX's XLA path in f64 (no-flux walls, noflux_z with periodic x and y, a
scar column, a 3-D diffusion field and a transmural tensor; bs32, dopri54,
rkc2 and ark324)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdmodel_tpu.config import SimConfig as JSimConfig
from crdmodel_tpu.core import grid as jgrid
from crdmodel_tpu.core import problem as jproblem
from crdmodel_tpu.ops import stencil as jstencil
from crdmodel_tpu.sim import simulate as jsimulate
from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.convert import inputs_from_numpy
from crdmodel_tpu_torch.core import grid as tgrid
from crdmodel_tpu_torch.core import problem as tproblem
from crdmodel_tpu_torch.ops import stencil as tstencil
from crdmodel_tpu_torch.sim import simulate

NZ, NY, NX = 6, 24, 24
# the JAX box tests' slab (tests/test_box3d_kernel.py::box_cfg) in f64
BOX = dict(model="aliev_panfilov", surface="box", x_mesh=NX,
           surface_width=10.0, surface_length=10.0, surface_depth=3.0,
           z_mesh=NZ, t_final=1.0, output_timestep=2, beta=0.0,
           dtype="float64", method="bs32", rtol=1e-6, atol=1e-9,
           boundary="noflux")


def scar_column():
    """A cylindrical inert column through every plane."""
    jj, ii = np.mgrid[0:NY, 0:NX]
    scar = (jj - 12) ** 2 + (ii - 11) ** 2 <= 9
    return np.broadcast_to(~scar, (NZ, NY, NX)).copy()


def dfield3():
    """A +-20% random 3-D diffusion field around D = 1."""
    return 0.8 + 0.4 * np.random.default_rng(5).random((NZ, NY, NX))


def transmural_tensor(nz=NZ, ny=NY, nx=NX, with_z=True):
    """The fibre rotating across the depth, with small z couplings inside
    the wall (tests/test_anisotropic3d.py::_transmural_tensor)."""
    z = np.linspace(0, 1, nz)[:, None, None] * np.ones((nz, ny, nx))
    th = (z - 0.5) * np.pi / 3
    dpar, dperp, dtrans = 0.3, 0.08, 0.02
    c, s = np.cos(th), np.sin(th)
    dxz = dyz = np.zeros_like(c)
    if with_z:
        dxz = np.where((z > 0.2) & (z < 0.8), 0.01, 0.0)
        dyz = np.where((z > 0.2) & (z < 0.8), -0.008, 0.0)
    return (dpar * c * c + dperp * s * s, dpar * s * s + dperp * c * c,
            np.full_like(c, dtrans), (dpar - dperp) * c * s, dxz, dyz)


# (label, config changes, build arguments): one box of each kernel mode
MODES = {
    "noflux": ({}, {}),
    "noflux_z": (dict(boundary="noflux_z"), {}),
    "scar": ({}, dict(obstacle_mask=scar_column())),
    "field": ({}, dict(diffusion_field=dfield3())),
    "tensor": (dict(boundary="noflux_z", beta=0.05),
               dict(diffusion_tensor=transmural_tensor())),
}


def _problems(label, **cfg_kw):
    kw, build = MODES[label]
    kw = {**BOX, **kw, **cfg_kw}
    jp = jproblem.build_problem(JSimConfig(**kw), **build)
    tp = tproblem.build_problem(SimConfig(**kw), "cpu", **build)
    return jp, tp


@pytest.mark.parametrize("boundary", ["periodic", "noflux", "noflux_x",
                                      "noflux_y", "noflux_z"])
@pytest.mark.parametrize("dkind", ["scalar", "x", "xyz", "scar"])
def test_box_faces_match_jax_bitwise(boundary, dkind):
    tissue = scar_column() if dkind == "scar" else None
    jo = jgrid.face_openness3(NZ, NY, NX, boundary, tissue)
    to = tgrid.face_openness3(NZ, NY, NX, boundary, tissue)
    assert (jo is None) == (to is None)
    for got, want in zip(to or (), jo or ()):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    kw = {**BOX, "boundary": boundary}
    jgeo = jgrid.make_geometry(JSimConfig(**kw))
    tgeo = tgrid.make_geometry(SimConfig(**kw))
    assert tgeo.kind == "box" and tgeo.grid.shape == (NZ, NY, NX)
    np.testing.assert_array_equal(tgeo.grid.z_coords(),
                                  np.asarray(jgeo.grid.z_coords(jnp.float64)))
    np.testing.assert_array_equal(
        tgeo.gaussian_curvature(torch.float64, "cpu").numpy(),
        np.asarray(jgeo.gaussian_curvature(jnp.float64)))
    d = {"scalar": 0.7, "x": 0.5 + 0.4 * np.random.default_rng(2).random(NX),
         "xyz": dfield3(), "scar": 1.0}[dkind]
    for got, want in zip(tgeo.divergence_coeffs64(d, to),
                         jgeo.divergence_coeffs64(d, jo)):
        assert np.shape(got) == np.shape(want)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("boundary", ["periodic", "noflux", "noflux_x",
                                      "noflux_y", "noflux_z"])
def test_tensor_coeffs_match_jax_bitwise(boundary):
    kw = {**BOX, "boundary": boundary}
    tensor = transmural_tensor()
    jf, jm, ji = jgrid.make_geometry(JSimConfig(**kw)).tensor_coeffs64(
        *tensor, boundary=boundary)
    tf, tm, ti = tgrid.make_geometry(SimConfig(**kw)).tensor_coeffs64(
        *tensor, boundary=boundary)
    for got, want in zip((*tf, *tm), (*jf, *jm)):
        np.testing.assert_array_equal(got, want)
    assert ti == ji
    bad = list(tensor)
    bad[3] = np.full((NZ, NY, NX), 0.5)      # |Dxy| > sqrt(Dxx Dyy) somewhere
    with pytest.raises(ValueError, match="SPD"):
        tgrid.make_geometry(SimConfig(**kw)).tensor_coeffs64(*bad)


def _close(got, want, tol=1e-13):
    want = np.asarray(want)
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * scale)


def test_stencils_match_jax():
    rng = np.random.default_rng(11)
    u = rng.uniform(-1.0, 1.0, (NZ, NY, NX))
    faces = [rng.uniform(0.1, 2.0, (NZ, NY, NX)) for _ in range(6)]
    mixed = [rng.uniform(-0.3, 0.3, (NZ, NY, NX)) for _ in range(3)]
    invs = (0.7, 1.3, 0.9)
    ut = torch.tensor(u)
    _close(tstencil.divergence_laplacian3(
               ut, [torch.tensor(a) for a in faces]),
           jstencil.divergence_laplacian3(jnp.asarray(u),
                                          [jnp.asarray(a) for a in faces]))
    _close(tstencil.anisotropic_laplacian3(
               ut, [torch.tensor(a) for a in faces],
               [torch.tensor(a) for a in mixed], invs),
           jstencil.anisotropic_laplacian3(
               jnp.asarray(u), [jnp.asarray(a) for a in faces],
               [jnp.asarray(a) for a in mixed], invs))
    for shift in ("shift_d", "shift_u3"):
        np.testing.assert_array_equal(
            getattr(tstencil, shift)(ut).numpy(),
            np.asarray(getattr(jstencil, shift)(jnp.asarray(u))))


@pytest.mark.parametrize("label", list(MODES))
def test_rhs_split_and_rho_match_jax(label):
    jp, tp = _problems(label, model="fhn", beta=1.25, t_boundary=0.5,
                       vary_beta=1, beta_min=0.7, beta_max=1.7)
    rng = np.random.default_rng(3)
    y_np = rng.uniform(-1.5, 1.5, np.shape(jp.y0))
    y_t, p_t = inputs_from_numpy(y_np, {k: np.asarray(v)
                                        for k, v in jp.params.items()},
                                 device="cpu", dtype=torch.float64)
    cfg = tp.cfg
    kw = dict(diffusion_field=tp.diffusion_field, face_mask=tp.face_mask,
              obstacle_mask=tp.obstacle_mask,
              diffusion_tensor=tp.diffusion_tensor)
    jkw = dict(diffusion_field=jp.diffusion_field, face_mask=jp.face_mask,
               obstacle_mask=jp.obstacle_mask,
               diffusion_tensor=jp.diffusion_tensor)
    tsplit = tproblem.make_rhs(cfg, tp.model, tp.geometry, torch.float64,
                               "cpu", split=True, **kw)
    jsplit = jproblem.make_rhs(jp.cfg, jp.model, jp.geometry, jnp.float64,
                               split=True, **jkw)
    for t, seg_end in ((0.2, 0.5), (0.7, 1.0)):
        jpar = {**jp.params, "_seg_end": jnp.float64(seg_end)}
        tpar = {**p_t, "_seg_end": torch.tensor(seg_end,
                                                dtype=torch.float64)}
        tt = torch.tensor(t, dtype=torch.float64)
        got = tp.rhs(tt, y_t, tpar)
        _close(got, jp.rhs(jnp.float64(t), jnp.asarray(y_np), jpar))
        parts = [f(tt, y_t, tpar) for f in tsplit]
        assert torch.equal(parts[0] + parts[1], got)
        for part, jf in zip(parts, jsplit):
            _close(part, jf(jnp.float64(t), jnp.asarray(y_np), jpar))
    rkw = dict(diffusion_field=tp.diffusion_field,
               diffusion_tensor=tp.diffusion_tensor, face_mask=tp.face_mask)
    trho = tproblem.make_rho_bound(cfg, tp.model, tp.geometry, torch.float64,
                                   **rkw)
    jrho = jproblem.make_rho_bound(jp.cfg, jp.model, jp.geometry,
                                   jnp.float64,
                                   diffusion_field=jp.diffusion_field,
                                   diffusion_tensor=jp.diffusion_tensor,
                                   face_mask=jp.face_mask)
    np.testing.assert_allclose(float(trho(0.0, y_t, p_t)),
                               float(jrho(0.0, jnp.asarray(y_np), jp.params)),
                               rtol=1e-13)


@pytest.mark.parametrize("model", ["aliev_panfilov", "fhn"])
def test_initial_state_is_the_jax_extrusion(model):
    jp, tp = _problems("noflux", model=model, beta=1.25 if model == "fhn"
                       else 0.1)
    assert tuple(tp.y0.shape) == (2, NZ, NY, NX)
    np.testing.assert_array_equal(tp.y0.numpy(), np.asarray(jp.y0))
    assert tp.diffusion_field == jp.diffusion_field == BOX.get(
        "diffusion", SimConfig().diffusion)


def test_build_problem_errors_match_jax():
    cfg = SimConfig(**BOX)
    jcfg = JSimConfig(**BOX)
    tensor = transmural_tensor()
    cases = [
        (dict(diffusion_tensor=tensor[:3]), r"\(Dxx, Dyy, Dzz"),
        (dict(diffusion_tensor=tensor, obstacle_mask=scar_column()),
         "obstacle_mask"),
        (dict(diffusion_tensor=tensor, diffusion_field=1.0),
         "mutually exclusive"),
        (dict(obstacle_mask=np.zeros((NZ, NY, NX), bool)), "all-False"),
        (dict(obstacle_mask=np.ones((NZ + 1, NY, NX), bool)), "broadcast"),
        (dict(diffusion_field=np.ones((NZ, NY + 1, NX))), "broadcast"),
        (dict(diffusion_field=-1.0), "non-negative"),
    ]
    for build, match in cases:
        with pytest.raises(ValueError, match=match):
            jproblem.build_problem(jcfg, **build)
        with pytest.raises(ValueError, match=match):
            tproblem.build_problem(cfg, "cpu", **build)


def _assert_same_run(got, want, atol):
    assert got.ok and bool(np.all(np.asarray(want.stats.status) == 0))
    for name in ("steps", "accepted", "rejected"):
        np.testing.assert_array_equal(
            getattr(got.stats, name).numpy(),
            np.asarray(getattr(want.stats, name)), err_msg=name)
    np.testing.assert_allclose(got.trajectory.numpy(),
                               np.asarray(want.trajectory), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("method", ["bs32", "dopri54", "rkc2", "ark324"])
@pytest.mark.parametrize("label", list(MODES))
def test_torch_path_runs_take_jax_f64_steps(label, method):
    """The torch path (use_pallas=False) against JAX's XLA path, both f64 on
    the CPU: the same accepted and rejected steps, trajectories to 1e-9
    (ark324's Newton stages over a shorter horizon, to keep the file
    quick)."""
    kw, build = MODES[label]
    kw = {**BOX, **kw, "method": method, "use_pallas": False,
          "t_final": 0.2 if method == "ark324" else 0.5}
    want = jsimulate(JSimConfig(**kw),
                     problem=jproblem.build_problem(JSimConfig(**kw),
                                                    **build))
    cfg = SimConfig(**kw)
    got = simulate(cfg, "cpu",
                   problem=tproblem.build_problem(cfg, "cpu", **build))
    assert not got.fused
    assert tuple(got.trajectory.shape) == (3, 2, NZ, NY, NX)
    _assert_same_run(got, want, 1e-9)
    if label == "scar":
        inert = ~build["obstacle_mask"]
        held = got.trajectory.numpy()[:, :, inert]
        assert np.array_equal(held, np.broadcast_to(held[:1], held.shape))


def test_auto_selection_on_the_box_keeps_the_torch_path_on_cpu():
    """use_pallas=None never takes a kernel on the CPU; the other kernels'
    gates all decline the box."""
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import (fused_aniso, fused_divform,
                                        fused_imex, fused_rkc, fused_step)
    from crdmodel_tpu_torch.sim import fused_eligible
    for label in MODES:
        _, tp = _problems(label, dtype="float32")
        assert not fused_eligible(tp)
        tab = TABLEAUS["bs32"]
        assert not fused_step.is_supported(tp, tab, torch.float32)
        assert not fused_divform.is_divform_supported(tp, tab, torch.float32)
        assert not fused_aniso.is_aniso_supported(tp, tab, torch.float32)
        assert not fused_rkc.is_rkc_supported(tp, torch.float32)
        assert not fused_imex.is_imex_supported(tp, torch.float32)
    _, tp = _problems("noflux", dtype="float32", use_pallas=True,
                      method="ark324")
    assert not fused_eligible(tp)        # ark324 on the box: torch path


def test_describe_names_the_box_grid():
    cfg = SimConfig(**{**BOX, "t_final": 0.1, "output_timestep": 1})
    res = simulate(cfg, "cpu")
    assert "grid 6x24x24" in res.describe()
    assert res.field(0).shape == (2, NZ, NY, NX)
    assert dataclasses.replace(cfg).nz == NZ
