"""The port's sharded run on the 3-D box (crdmodel_tpu_torch/parallel/
sharded.py: the box branches of sharded_params, shard_params,
make_local_rhs and the rho bound) on its torch path, against the JAX
package's XLA sharded path on the 8 virtual CPU devices, both in float64:
the same accepted and rejected steps and fields to 1e-12, on even, 1x4 and
uneven (padded) meshes, with bs32 and rkc2 (the stage count from the
cross-shard max of rho, over the physical cells on the uneven mesh), on the
profile slab, no-flux z walls with periodic x and y, a scar column, a 3-D
diffusion field and the transmural tensor; ark324 (the split RHS) against
the single-device port, whose box ark324 tests/test_torch_box3d.py holds
to JAX. Also the kernel selection on the box against JAX's (tests/test_shard_box3d.py:
64-88: K12 and K13 take the box, K8-K11 decline it), the local RHS
against the full grid's, and a box whose depth equals its blocks' width.
"""

import dataclasses

import numpy as np
import pytest
import torch

from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.core.problem import build_problem
from crdmodel_tpu_torch.parallel.mesh import make_mesh
from crdmodel_tpu_torch.parallel.sharded import (gather, make_local_rhs,
                                                 mesh_pad_spec,
                                                 select_shard_kernel,
                                                 shard_params,
                                                 sharded_params,
                                                 sharded_rho_bound,
                                                 simulate_sharded,
                                                 split_state, tensor_weight)
from crdmodel_tpu_torch.sim import simulate

BASE = dict(model="aliev_panfilov", surface="box", x_mesh=32,
            surface_width=10.0, surface_length=20.0, y_mesh=64,
            surface_depth=3.0, z_mesh=6, t_final=1.0, output_timestep=2,
            beta=0.0, dtype="float64", method="bs32", rtol=1e-6, atol=1e-9,
            boundary="noflux")
# tests/test_uneven.py:378-400: 51 x 17 on a 2x2 mesh pads to 52 x 18
UNEVEN = dict(x_mesh=17, surface_width=10.0, surface_length=30.0,
              y_mesh=51)


def _scar(cfg):
    """An inert column across both seams of a 2x2 mesh (tests/
    test_shard_box3d.py::scar_mask)."""
    mask = np.ones((cfg.nz, cfg.ny, cfg.nx), bool)
    mask[2:4, 28:38, 12:20] = False
    return dict(obstacle_mask=mask)


def _field(cfg):
    rng = np.random.default_rng(0)
    return dict(diffusion_field=0.08 + 0.04 * rng.random((cfg.nz, cfg.ny,
                                                          cfg.nx)))


def _tensor(cfg):
    """The transmural fibre rotation (tests/test_anisotropic3d.py), z
    couplings inside the wall."""
    nz, ny, nx = cfg.nz, cfg.ny, cfg.nx
    z = np.linspace(0, 1, nz)[:, None, None] * np.ones((nz, ny, nx))
    th = (z - 0.5) * np.pi / 3
    dpar, dperp, dtrans = 0.3, 0.08, 0.02
    c, s = np.cos(th), np.sin(th)
    inner = (z > 0.2) & (z < 0.8)
    return dict(diffusion_tensor=(
        dpar * c * c + dperp * s * s, dpar * s * s + dperp * c * c,
        np.full_like(c, dtrans), (dpar - dperp) * c * s,
        np.where(inner, 0.01, 0.0), np.where(inner, -0.008, 0.0)))


# name -> (config keywords, mesh shape, build arguments)
CASES = {
    "profile_bs32": (dict(), (2, 2), None),
    "profile_rkc2_1x4": (dict(method="rkc2"), (1, 4), None),
    "noflux_z_fhn_freeze": (dict(boundary="noflux_z", model="fhn",
                                 beta=1.25, vary_beta=1, beta_min=0.9,
                                 beta_max=1.5, t_boundary=0.4), (2, 2),
                            None),
    "scar_bs32": (dict(), (2, 2), _scar),
    "scar_rkc2": (dict(method="rkc2"), (2, 2), _scar),
    "field_bs32": (dict(), (2, 2), _field),
    "tensor_bs32": (dict(boundary="noflux_z", beta=0.05), (2, 2), _tensor),
    "tensor_rkc2": (dict(boundary="noflux_z", beta=0.05, method="rkc2",
                         t_final=0.5), (2, 2), _tensor),
    "uneven_bs32": (UNEVEN, (2, 2), None),
    "uneven_rkc2": (dict(UNEVEN, method="rkc2"), (2, 2), None),
    "uneven_tensor": (dict(UNEVEN, boundary="noflux_z", beta=0.05),
                      (2, 2), _tensor),
    "ark324_freeze": (dict(model="fhn", beta=1.25, method="ark324",
                           t_boundary=0.05, t_final=0.1), (2, 2), None),
}


def _cfg(name):
    kw, shape, _ = CASES[name]
    return {**BASE, **kw}, shape


def _build_kw(name, cfg):
    build = CASES[name][2]
    return build(cfg) if build is not None else {}


def _mesh(shape):
    return make_mesh(shape=shape, devices=["cpu"] * 8)


@pytest.fixture(scope="module",
                params=sorted(set(CASES) - {"ark324_freeze"}))
def pair(request):
    """(JAX XLA sharded run, the port's sharded run) of one case."""
    import jax

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild_problem
    from crdmodel_tpu.parallel.mesh import make_mesh as jmake_mesh
    from crdmodel_tpu.parallel.sharded import simulate_sharded as jsim
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    kw, shape = _cfg(request.param)
    cfg = SimConfig(**kw)
    build_kw = _build_kw(request.param, cfg)
    jcfg = JSimConfig(**kw)
    jres = jsim(jcfg, mesh=jmake_mesh(shape=shape),
                problem=jbuild_problem(jcfg, **build_kw))
    res = simulate_sharded(cfg, mesh=_mesh(shape),
                           problem=build_problem(cfg, "cpu", **build_kw))
    return request.param, build_kw, jres, res


def test_sharded_box_matches_jax_f64(pair):
    name, build_kw, jres, res = pair
    assert res.ok and not res.fused
    for key in ("steps", "accepted", "rejected", "status"):
        np.testing.assert_array_equal(
            getattr(res.stats, key).numpy(),
            np.asarray(getattr(jres.stats, key)), err_msg=f"{name} {key}")
    want = np.asarray(jres.trajectory)
    assert tuple(res.trajectory.shape) == want.shape
    np.testing.assert_allclose(res.trajectory.numpy(), want, rtol=0,
                               atol=1e-12, err_msg=name)
    if "obstacle_mask" in build_kw:
        inert = ~build_kw["obstacle_mask"]
        traj = res.trajectory.numpy()
        np.testing.assert_array_equal(
            traj[:, :, inert],
            np.broadcast_to(traj[:1, :, inert], traj[:, :, inert].shape))


@pytest.mark.parametrize("name", ["profile_rkc2_1x4", "scar_bs32",
                                  "uneven_tensor", "ark324_freeze"])
def test_sharded_box_matches_single_device(name):
    """The sharded port against the single-device port, f64: the same
    steps and fields to 1e-12 (the partial sums add in another order)."""
    kw, shape = _cfg(name)
    cfg = SimConfig(**kw)
    build_kw = _build_kw(name, cfg)
    single = simulate(cfg, device="cpu",
                      problem=build_problem(cfg, "cpu", **build_kw))
    res = simulate_sharded(cfg, mesh=_mesh(shape),
                           problem=build_problem(cfg, "cpu", **build_kw))
    np.testing.assert_array_equal(res.stats.steps.numpy(),
                                  single.stats.steps.numpy())
    np.testing.assert_allclose(res.trajectory.numpy(),
                               single.trajectory.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["uneven_tensor", "scar_bs32",
                                  "field_bs32"])
def test_local_rhs_matches_full_grid_rhs(name):
    """make_local_rhs on the box's shards equals the full grid's rhs (and
    its split rhs_ex + rhs_im the full grid's too), pad cells zero, with
    the freeze on."""
    from crdmodel_tpu_torch.parallel.sharded import with_dxy_halo
    kw, shape = _cfg(name)
    cfg = SimConfig(**{**kw, "model": "fhn", "beta": 1.25, "vary_beta": 1,
                       "beta_min": 0.9, "beta_max": 1.5, "t_boundary": 1.0})
    problem = build_problem(cfg, "cpu", **_build_kw(name, cfg))
    mesh = _mesh(shape)
    pad = mesh_pad_spec(cfg, mesh)
    rng = np.random.default_rng(1)
    y = torch.tensor(rng.uniform(-2, 2, problem.y0.shape))
    params = with_dxy_halo(shard_params(sharded_params(problem, pad), mesh,
                                        pad, cfg), mesh, pad)
    params["_seg_end"] = torch.tensor(0.5, dtype=torch.float64)
    operator = dict(divergence=True, tensor_inv4=tensor_weight(problem),
                    tissue=problem.obstacle_mask is not None)
    t = torch.tensor(0.3, dtype=torch.float64)
    ys = split_state(y, mesh, pad, cfg)
    got = make_local_rhs(cfg, problem.model, "box", mesh, pad,
                         **operator)(t, ys, params)
    ex, im = make_local_rhs(cfg, problem.model, "box", mesh, pad, split=True,
                            **operator)
    split = ex(t, ys, params) + im(t, ys, params)
    want = problem.rhs(t, y, {**problem.params, "_seg_end":
                              params["_seg_end"]}).numpy()
    for out in (got, split):
        np.testing.assert_allclose(gather(out, mesh, pad).numpy(), want,
                                   rtol=0, atol=1e-12)
    if pad is not None:
        full = gather(got, mesh).numpy()
        assert not full[..., cfg.ny:, :].any()
        assert not full[..., cfg.nx:].any()


def test_sharded_rho_bound_on_the_box():
    """rkc2's rho bound on the box's shards, max-reduced across them and
    masked to the physical cells on an uneven mesh, equals the full grid's
    bound."""
    from crdmodel_tpu_torch.core.problem import make_rho_bound
    kw, shape = _cfg("uneven_rkc2")
    cfg = SimConfig(**kw)
    problem = build_problem(cfg, "cpu")
    mesh = _mesh(shape)
    pad = mesh_pad_spec(cfg, mesh)
    y = torch.tensor(np.random.default_rng(2).uniform(
        -0.2, 1.2, problem.y0.shape))
    params = shard_params(sharded_params(problem, pad), mesh, pad, cfg)
    got = sharded_rho_bound(problem, mesh, pad)(
        0.0, split_state(y, mesh, pad, cfg), params)
    want = make_rho_bound(cfg, problem.model, problem.geometry, y.dtype,
                          diffusion_field=problem.diffusion_field)(
        0.0, y, problem.params)
    assert float(got) == float(want)


def test_gate_routing():
    """The box's kernel selection against JAX's (tests/test_shard_box3d.py:
    64-88): closed z walls, a scar and a 3-D field take K12, rkc2 K13;
    periodic z declines both; K8-K11 never take a box."""
    from crdmodel_tpu_torch.parallel.sharded import (
        maybe_fused_shard_divform, maybe_fused_shard_imex,
        maybe_fused_shard_rkc, maybe_fused_shard_step)
    mesh = _mesh((2, 2))
    f32 = dict(BASE, dtype="float32", use_pallas=True)

    def selected(build_kw=None, **kw):
        cfg = SimConfig(**{**f32, **kw})
        problem = build_problem(cfg, "cpu", **(build_kw or {}))
        rho_fn = (sharded_rho_bound(problem, mesh)
                  if cfg.method == "rkc2" else None)
        for other in (maybe_fused_shard_step, maybe_fused_shard_divform,
                      maybe_fused_shard_imex):
            assert other(problem, mesh) is None
        if cfg.method == "bs32":
            assert maybe_fused_shard_rkc(problem, mesh, rho_fn) is None
        return select_shard_kernel(problem, mesh, rho_fn=rho_fn)[0]

    cfg = SimConfig(**f32)
    # the 2-D kernels' own gates decline a box that K12 and K13 take
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import (fused_shard_divform, fused_shard_imex,
                                        fused_shard_rkc, fused_shard_step)
    box = build_problem(cfg, "cpu")
    f32_dtype, tab = torch.float32, TABLEAUS["bs32"]
    assert not fused_shard_step.is_shard_supported(box, tab, f32_dtype, 32,
                                                   32)
    assert not fused_shard_rkc.is_shard_rkc_supported(box, f32_dtype, 32, 32)
    assert not fused_shard_imex.is_shard_imex_supported(box, f32_dtype, 32,
                                                        32)
    for aniso in (False, True):
        assert not fused_shard_divform.is_shard_divform_supported(
            box, tab, f32_dtype, 32, 32, aniso=aniso)
    assert selected() == "K12"
    assert selected(boundary="periodic") is None
    assert selected(_scar(cfg)) == "K12"
    assert selected(_field(cfg)) == "K12"
    assert selected(_field(cfg), boundary="periodic") is None
    assert selected(method="rkc2") == "K13"
    assert selected(method="rkc2", boundary="periodic") is None
    assert selected(method="ark324") is None
    assert selected(use_pallas=False) is None


def test_box_auto_selection_reads_the_shard_volume():
    """Auto selection (use_pallas=None) compares a shard's volume nz*nyl*
    nxl with PALLAS_BOX3D_AUTO_POINTS (crdmodel_tpu/parallel/sharded.py:
    515-522), and takes no kernel on the CPU."""
    from crdmodel_tpu_torch.config import PALLAS_BOX3D_AUTO_POINTS
    from crdmodel_tpu_torch.parallel.sharded import _shard_kernel_eligible
    cuda = make_mesh(shape=(2, 2), devices=["cuda:0"] * 4)
    slab = SimConfig(model="aliev_panfilov", surface="box", x_mesh=512,
                     y_mesh=512, z_mesh=32, surface_width=32.0,
                     surface_length=32.0, surface_depth=2.0,
                     boundary="noflux")
    assert slab.nz * (slab.ny // 2) * (slab.nx // 2) >= (
        PALLAS_BOX3D_AUTO_POINTS)
    assert _shard_kernel_eligible(slab, cuda)
    assert not _shard_kernel_eligible(slab, _mesh((2, 2)))
    thin = dataclasses.replace(slab, z_mesh=16)
    assert not _shard_kernel_eligible(thin, cuda)


def test_depth_equal_to_the_blocks_width_stays_replicated():
    """A box whose depth nz equals nx and the blocks' nyl and nxl: the
    (nz, 1, 1) z faces stay whole on every shard, and the run matches the
    single-device run."""
    cfg = SimConfig(**{**BASE, "z_mesh": 16, "x_mesh": 16, "y_mesh": 32,
                       "surface_depth": 8.0, "surface_width": 16.0,
                       "surface_length": 32.0, "t_final": 0.5})
    problem = build_problem(cfg, "cpu")
    mesh = _mesh((2, 1))
    params = shard_params(sharded_params(problem), mesh, None, cfg)
    aU = problem.geometry.divergence_coeffs64(problem.diffusion_field,
                                              face_mask=problem.face_mask)[4]
    for loc in params["local"]:
        np.testing.assert_array_equal(loc["coeffs"][4].numpy(), aU)
    res = simulate_sharded(cfg, mesh=mesh, problem=problem)
    single = simulate(cfg, device="cpu")
    np.testing.assert_array_equal(res.stats.steps.numpy(),
                                  single.stats.steps.numpy())
    np.testing.assert_allclose(res.trajectory.numpy(),
                               single.trajectory.numpy(), rtol=0, atol=1e-12)
