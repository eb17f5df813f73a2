"""The port's sharded run (crdmodel_tpu_torch/parallel/sharded.py) on its
torch path, against the JAX package's XLA sharded path on the 8 virtual
CPU devices, both in float64: the same step sequence and fields to 1e-12,
on even and uneven (padded) meshes, with ERK, rkc2 (the stage count from
the cross-shard max of rho) and ark324 (the Newton shard-local), on the
profile operator, the divergence form (no-flux walls, an obstacle, 2-D and
theta-only diffusion fields) and the 2-D diffusion tensor (flat and torus).
The shards of the port are tensors on the CPU (make_mesh(devices=["cpu"] *
8)), the counterpart of JAX's virtual devices. Fields and masks come from
numpy with a seed and go to both packages' build_problem.
"""

import dataclasses

import numpy as np
import pytest
import torch

from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.core.problem import build_problem
from crdmodel_tpu_torch.parallel.mesh import make_mesh
from crdmodel_tpu_torch.parallel.sharded import (make_local_rhs,
                                                 simulate_sharded)
from crdmodel_tpu_torch.sim import simulate

BASE = dict(model="fhn", surface="torus", x_mesh=16, surface_width=20.0,
            surface_length=40.0, t_final=0.5, output_timestep=2,
            beta=1.25, dtype="float64", rtol=1e-6, atol=1e-9)
FLAT = dict(surface="flat", surface_width=10.0, surface_length=20.0)
# Aliev-Panfilov on a flat sheet with no-flux walls (the bounded tissue,
# small)
AP = dict(FLAT, model="aliev_panfilov", beta=0.1, boundary="noflux",
          wave_length=0.25, wave_width=0.5, t_final=1.0)
# 39x13 on a 2x4 mesh pads to 40x16: both axes uneven
UNEVEN = dict(x_mesh=13, surface_length=60.0, t_final=0.4)


def _obstacle(cfg):
    """A rectangular scar of inert cells (True = tissue)."""
    mask = np.ones((cfg.ny, cfg.nx), bool)
    mask[10:18, 5:10] = False
    return dict(obstacle_mask=mask)


def _field_2d(cfg):
    """A seeded 2-D diffusion field around D = 1."""
    rng = np.random.default_rng(3)
    return dict(diffusion_field=0.6 + 0.8 * rng.random((cfg.ny, cfg.nx)))


def _field_theta(cfg):
    """A theta-only (nx,) diffusion field on the torus."""
    return dict(diffusion_field=1.0 + 0.5 * np.sin(
        2 * np.pi * np.arange(cfg.nx) / cfg.nx))


def _fibres(cfg):
    """Rotating fibres (examples/anisotropic_fibers.py): d_par 1, d_perp
    0.2, the angle from 0 to pi/3 across x."""
    th = np.broadcast_to(np.linspace(0.0, np.pi / 3, cfg.nx)[None, :],
                         (cfg.ny, cfg.nx))
    c, s = np.cos(th), np.sin(th)
    return dict(diffusion_tensor=(1.0 * c * c + 0.2 * s * s,
                                  1.0 * s * s + 0.2 * c * c,
                                  0.8 * c * s))


CASES = {
    "fhn_flat": (FLAT, (2, 4), None),
    "fhn_torus_ramp_freeze": (dict(vary_beta=1, beta_min=0.7,
                                   beta_max=1.7, t_boundary=0.2), (4, 2),
                              None),
    "goldbeter": (dict(model="goldbeter", beta=0.4), (2, 2), None),
    "rkc2_ramp_freeze": (dict(vary_beta=1, beta_min=0.7, beta_max=1.7,
                              t_boundary=0.2, method="rkc2"), (2, 4), None),
    "uneven_bs32": (UNEVEN, (2, 4), None),
    "uneven_rkc2": (dict(UNEVEN, method="rkc2", t_boundary=0.1), (2, 4),
                    None),
    "ark324_fhn_freeze": (dict(method="ark324", t_boundary=0.2,
                               t_final=0.3), (2, 2), None),
    "ark324_goldbeter": (dict(model="goldbeter", beta=0.4, method="ark324",
                              t_final=0.3), (2, 2), None),
    "ark324_uneven": (dict(UNEVEN, method="ark324", t_final=0.2), (2, 4),
                      None),
    "ap_noflux_obstacle": (AP, (2, 2), _obstacle),
    "ap_noflux_obstacle_rkc2": (dict(AP, method="rkc2"), (2, 2), _obstacle),
    "flat_2d_field": (FLAT, (2, 2), _field_2d),
    "torus_theta_field": (dict(t_boundary=0.2), (2, 4), _field_theta),
    "flat_tensor": (FLAT, (2, 2), _fibres),
    "flat_tensor_uneven": (dict(FLAT, **UNEVEN, surface_width=10.0), (2, 4),
                           _fibres),
    "torus_tensor": (dict(), (2, 2), _fibres),
}


def _cfg(name):
    kw, shape, _ = CASES[name]
    return {**BASE, **kw}, shape


def _build_kw(name, cfg):
    """The case's numpy build arguments for either package's build_problem."""
    build = CASES[name][2]
    return build(cfg) if build is not None else {}


def _mesh(shape):
    return make_mesh(shape=shape, devices=["cpu"] * 8)


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    """(JAX XLA sharded run, the port's sharded run) of one case."""
    import jax

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.parallel.mesh import make_mesh as jmake_mesh
    from crdmodel_tpu.parallel.sharded import simulate_sharded as jsim
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    from crdmodel_tpu.core.problem import build_problem as jbuild_problem
    kw, shape = _cfg(request.param)
    cfg = SimConfig(**kw)
    build_kw = _build_kw(request.param, cfg)
    jcfg = JSimConfig(**kw)
    jres = jsim(jcfg, mesh=jmake_mesh(shape=shape),
                problem=jbuild_problem(jcfg, **build_kw))
    res = simulate_sharded(cfg, mesh=_mesh(shape),
                           problem=build_problem(cfg, "cpu", **build_kw))
    return request.param, jres, res


def test_sharded_matches_jax_f64(pair):
    name, jres, res = pair
    assert res.ok and not res.fused
    for key in ("steps", "accepted", "rejected", "status"):
        np.testing.assert_array_equal(
            getattr(res.stats, key).numpy(),
            np.asarray(getattr(jres.stats, key)), err_msg=f"{name} {key}")
    want = np.asarray(jres.trajectory)
    assert tuple(res.trajectory.shape) == want.shape
    np.testing.assert_allclose(res.trajectory.numpy(), want, rtol=0,
                               atol=1e-12, err_msg=name)
    np.testing.assert_allclose(res.touts, np.asarray(jres.touts), rtol=0,
                               atol=1e-15)


@pytest.mark.parametrize("name", ["fhn_torus_ramp_freeze", "uneven_rkc2",
                                  "ark324_uneven", "ap_noflux_obstacle",
                                  "torus_tensor"])
def test_sharded_matches_single_device(name):
    """The sharded port against the single-device port, f64: the same steps
    and fields to 1e-12 (the partial sums add in another order)."""
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


def test_default_mesh_on_the_cpu():
    """Without a mesh, device="cpu" puts n_devices shards on the CPU, a
    balanced factorisation of the grid."""
    kw, _ = _cfg("fhn_flat")
    cfg = SimConfig(**kw)
    res = simulate_sharded(cfg, n_devices=4, device="cpu")
    single = simulate(cfg, device="cpu")
    assert res.total_steps() == single.total_steps()
    np.testing.assert_allclose(res.trajectory.numpy(),
                               single.trajectory.numpy(), rtol=0, atol=1e-12)


def test_local_rhs_matches_full_grid_rhs():
    """make_local_rhs on the shards equals the full grid's rhs, pads zero,
    on an uneven mesh with the freeze on."""
    from crdmodel_tpu_torch.ops.kernel_common import coeff_kind
    from crdmodel_tpu_torch.parallel.sharded import (gather, mesh_pad_spec,
                                                     shard_params,
                                                     sharded_params,
                                                     split_state)
    kw, shape = _cfg("uneven_bs32")
    cfg = SimConfig(**{**kw, "vary_beta": 1, "beta_min": 0.7,
                       "beta_max": 1.7, "t_boundary": 1.0})
    problem = build_problem(cfg, "cpu")
    mesh = _mesh(shape)
    pad = mesh_pad_spec(cfg, mesh)
    rng = np.random.default_rng(1)
    y = torch.tensor(rng.uniform(-2, 2, problem.y0.shape))
    params = shard_params(sharded_params(problem, pad), mesh, pad, cfg)
    seg = torch.tensor(0.5, dtype=torch.float64)
    rhs = make_local_rhs(cfg, problem.model, coeff_kind("torus"), mesh, pad)
    got = rhs(torch.tensor(0.3, dtype=torch.float64),
              split_state(y, mesh, pad, cfg), {**params, "_seg_end": seg})
    want = problem.rhs(torch.tensor(0.3, dtype=torch.float64), y,
                       {**problem.params, "_seg_end": seg})
    np.testing.assert_allclose(gather(got, mesh, pad).numpy(), want.numpy(),
                               rtol=0, atol=1e-12)
    padded = gather(got, mesh)
    assert not padded[:, cfg.ny:].any() and not padded[:, :, cfg.nx:].any()


@pytest.mark.parametrize("change,item", [
    (dict(surface="box", x_mesh=16, y_mesh=16, z_mesh=4, surface_depth=1.0,
          boundary="noflux", surface_width=8.0, surface_length=8.0,
          model="aliev_panfilov", beta=0.1, dtype="float32",
          use_pallas=True, t_final=0.1), "K12")])
def test_unported_branches_raise(change, item):
    """The sharded box, which raised until kernel `item` was ported
    (ROADMAP item 15), runs through it; with a forcing, which raised until
    the mesh took forcing (item 9's mesh part) and which `item` declined
    until the box kernels took forcing (item 9's box part), it runs
    through `item` too, its depth profile in-kernel, to status ok and
    within 1e-5 of the sharded torch path."""
    from crdmodel_tpu_torch.core import forcing as tforcing
    from crdmodel_tpu_torch.parallel.sharded import select_shard_kernel
    kw, _ = _cfg("fhn_flat")
    cfg = SimConfig(**{**kw, **change})
    mesh = _mesh((2, 2))
    problem = build_problem(cfg, "cpu")
    assert select_shard_kernel(problem, mesh)[0] == item
    assert simulate_sharded(cfg, mesh=mesh, problem=problem).ok
    forced = build_problem(cfg, "cpu", forcing=tforcing.SeparableForcing(
        tforcing.Stimulus(waveform=tforcing.pulse_train([0.02], 0.05, 2.0),
                          row=tforcing.rect_profile(cfg.ny, 0, 4),
                          zprof=tforcing.gaussian_profile(cfg.nz, 0.0,
                                                          1.5))))
    assert select_shard_kernel(forced, mesh)[0] == item
    res = simulate_sharded(cfg, mesh=mesh, problem=forced)
    assert res.ok and res.fused
    plain = dataclasses.replace(cfg, use_pallas=False)
    torch_path = simulate_sharded(
        plain, mesh=mesh, problem=dataclasses.replace(forced, cfg=plain))
    assert torch_path.ok and not torch_path.fused
    np.testing.assert_allclose(res.trajectory.numpy(),
                               torch_path.trajectory.numpy(), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["uneven_bs32", "ap_noflux_obstacle",
                                  "flat_tensor_uneven", "torus_tensor",
                                  "torus_theta_field"])
def test_split_rhs_matches_full_grid(name):
    """make_local_rhs(split=True) on the shards: rhs_ex + rhs_im gathered
    is the single-device rhs, and each part its single-device split
    counterpart, to 1e-12 in f64, with the freeze on."""
    from crdmodel_tpu_torch.core.problem import make_rhs
    from crdmodel_tpu_torch.ops.kernel_common import coeff_kind
    from crdmodel_tpu_torch.parallel.sharded import (gather, mesh_pad_spec,
                                                     shard_params,
                                                     sharded_params,
                                                     split_state,
                                                     tensor_weight,
                                                     with_dxy_halo)
    kw, shape = _cfg(name)
    cfg = SimConfig(**{**kw, "t_boundary": 1.0})
    problem = build_problem(cfg, "cpu", **_build_kw(name, cfg))
    mesh = _mesh(shape)
    pad = mesh_pad_spec(cfg, mesh)
    y = torch.tensor(np.random.default_rng(4).uniform(0.0, 1.0,
                                                      problem.y0.shape))
    params = with_dxy_halo(shard_params(sharded_params(problem, pad), mesh,
                                        pad, cfg), mesh, pad)
    t = torch.tensor(0.3, dtype=torch.float64)
    seg = torch.tensor(0.5, dtype=torch.float64)
    ex, im = make_local_rhs(
        cfg, problem.model, coeff_kind(problem.geometry.kind), mesh, pad,
        split=True, divergence=problem.diffusion_field is not None,
        tensor_inv4=tensor_weight(problem),
        tissue=problem.obstacle_mask is not None)
    ys = split_state(y, mesh, pad, cfg)
    sp = {**params, "_seg_end": seg}
    got_ex, got_im = gather(ex(t, ys, sp), mesh, pad), gather(im(t, ys, sp),
                                                              mesh, pad)
    f_ex, f_im = make_rhs(cfg, problem.model, problem.geometry,
                          torch.float64, "cpu", split=True,
                          diffusion_field=problem.diffusion_field,
                          face_mask=problem.face_mask,
                          obstacle_mask=problem.obstacle_mask,
                          diffusion_tensor=problem.diffusion_tensor)
    full = {**problem.params, "_seg_end": seg}
    for got, want in ((got_ex + got_im, problem.rhs(t, y, full)),
                      (got_ex, f_ex(t, y, full)), (got_im, f_im(t, y, full))):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-12)


# the kernel each configuration's steps take, f32 with use_pallas=True:
# (case, change, mesh shape)
SELECTION = [
    ("fhn_flat", {}, (2, 2)),
    ("fhn_flat", dict(method="rkc2", x_mesh=64), (2, 2)),
    ("fhn_flat", dict(method="ark324"), (2, 2)),
    ("uneven_bs32", dict(method="ark324"), (3, 1)),
    ("torus_theta_field", {}, (2, 2)),
    ("torus_theta_field", dict(method="ark324"), (2, 2)),
    ("ap_noflux_obstacle", {}, (2, 2)),
    ("ap_noflux_obstacle", dict(method="ark324"), (2, 2)),
    ("ap_noflux_obstacle_rkc2", dict(x_mesh=64), (2, 2)),
    ("flat_2d_field", dict(method="dopri54"), (2, 2)),
    ("flat_tensor", {}, (2, 2)),
    ("flat_tensor_uneven", {}, (3, 1)),
    ("torus_tensor", {}, (2, 2)),
    ("torus_tensor", dict(method="ark324"), (2, 2)),
]


@pytest.mark.parametrize("name,change,shape", SELECTION)
def test_kernel_selection_matches_jax(name, change, shape):
    """select_shard_kernel, which build_local_run takes, picks the kernel
    that the JAX package's maybe_fused_shard_* chain picks on the same
    problem (interpret mode, use_pallas=True): K8, K9, K10, K11 or its
    aniso mode, or none."""
    import jax

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild_problem
    from crdmodel_tpu.parallel import sharded as jsh
    from crdmodel_tpu.parallel.mesh import make_mesh as jmake_mesh
    from crdmodel_tpu_torch.parallel.sharded import (mesh_pad_spec,
                                                     select_shard_kernel,
                                                     sharded_rho_bound)
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    kw, _ = _cfg(name)
    kw = {**kw, **change, "dtype": "float32", "use_pallas": True}
    cfg = SimConfig(**kw)
    build_kw = _build_kw(name, cfg)
    jcfg = JSimConfig(**kw)
    jp = jbuild_problem(jcfg, **build_kw)
    jmesh = jmake_mesh(shape=shape)
    jpad = jsh.mesh_pad_spec(jcfg, jmesh)
    jargs = dict(interpret=True, pad_spec=jpad)
    chain = [("K8", jsh.maybe_fused_shard_step(jp, jmesh, **jargs)),
             ("K11", jsh.maybe_fused_shard_divform(jp, jmesh, **jargs)),
             ("K11 aniso", jsh.maybe_fused_shard_aniso(jp, jmesh, **jargs)),
             ("K10", jsh.maybe_fused_shard_imex(jp, jmesh, **jargs))]
    if cfg.method == "rkc2":
        chain.append(("K9", jsh.maybe_fused_shard_rkc(
            jp, jmesh, lambda t, y, p: None, **jargs)))
    want = next((n for n, k in chain if k is not None), None)
    problem = build_problem(cfg, "cpu", **build_kw)
    mesh = _mesh(shape)
    pad = mesh_pad_spec(cfg, mesh)
    rho = (sharded_rho_bound(problem, mesh, pad) if cfg.method == "rkc2"
           else None)
    got, kernel = select_shard_kernel(problem, mesh, pad, rho)
    assert got == want, (name, change)
    assert (kernel is None) == (got is None)


@pytest.mark.parametrize("name", ["uneven_rkc2", "ap_noflux_obstacle",
                                  "torus_tensor", "torus_theta_field"])
def test_jax_params_carry_over(name):
    """convert.sharded_params_from_numpy carries the JAX package's
    sharded_params into the port's, f64: the same keys and values, the
    masks bool, and a run on them takes the steps of the run on the port's
    own."""
    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild_problem
    from crdmodel_tpu.parallel import sharded as jsh
    from crdmodel_tpu.parallel.mesh import make_mesh as jmake_mesh
    from crdmodel_tpu_torch.convert import sharded_params_from_numpy
    from crdmodel_tpu_torch.parallel.sharded import (build_local_run,
                                                     mesh_pad_spec,
                                                     shard_params,
                                                     sharded_params,
                                                     split_state)
    kw, shape = _cfg(name)
    cfg = SimConfig(**kw)
    build_kw = _build_kw(name, cfg)
    jcfg = JSimConfig(**kw)
    jp = jbuild_problem(jcfg, **build_kw)
    jpad = jsh.mesh_pad_spec(jcfg, jmake_mesh(shape=shape))
    jparams, _ = jsh.sharded_params(jp, jpad)
    got = sharded_params_from_numpy(
        {k: (tuple(np.asarray(c) for c in v) if k == "coeffs"
             else np.asarray(v)) for k, v in jparams.items()},
        device="cpu", dtype=torch.float64)
    problem = build_problem(cfg, "cpu", **build_kw)
    mesh = _mesh(shape)
    pad = mesh_pad_spec(cfg, mesh)
    want = sharded_params(problem, pad)
    assert sorted(got) == sorted(want)
    for key in want:
        pairs = (zip(got[key], want[key]) if key == "coeffs"
                 else [(got[key], want[key])])
        for g, w in pairs:
            assert g.dtype == w.dtype, key
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=1e-15, err_msg=key)
    run, _, _, _ = build_local_run(problem, mesh)
    _, stats = run(split_state(problem.y0, mesh, pad, cfg),
                   shard_params(got, mesh, pad, cfg))
    single = simulate_sharded(cfg, mesh=mesh, problem=problem)
    np.testing.assert_array_equal(stats.steps.numpy(),
                                  single.stats.steps.numpy())


@pytest.mark.parametrize("method", ["bs32", "rkc2", "ark324"])
def test_theta_field_through_profile_kernels(method):
    """A theta-only diffusion field on the torus takes K8, K9 or K10 through
    the profile remap (ops/kernel_common.py::kernel_stencil_coeffs), as in
    the JAX package; the plain kernels' f32 run takes the sharded torch
    path's steps, fields to 1e-5 (the remap regroups the face form's
    arithmetic, ROADMAP queue 3)."""
    import dataclasses

    from crdmodel_tpu_torch.parallel.sharded import (mesh_pad_spec,
                                                     select_shard_kernel,
                                                     sharded_rho_bound)
    kw, shape = _cfg("torus_theta_field")
    cfg = SimConfig(**{**kw, "x_mesh": 48, "t_final": 0.3, "method": method,
                       "dtype": "float32", "rtol": 1e-5, "atol": 1e-8,
                       "use_pallas": True})
    build_kw = _build_kw("torus_theta_field", cfg)
    mesh = _mesh((2, 2))
    problem = build_problem(cfg, "cpu", **build_kw)
    pad = mesh_pad_spec(cfg, mesh)
    rho = sharded_rho_bound(problem, mesh, pad) if method == "rkc2" else None
    name, _ = select_shard_kernel(problem, mesh, pad, rho)
    assert name == {"bs32": "K8", "rkc2": "K9", "ark324": "K10"}[method]
    fused = simulate_sharded(cfg, mesh=mesh, problem=problem)
    tcfg = dataclasses.replace(cfg, use_pallas=False)
    torch_path = simulate_sharded(tcfg, mesh=mesh, problem=build_problem(
        tcfg, "cpu", **build_kw))
    assert fused.fused and not torch_path.fused and fused.ok
    np.testing.assert_array_equal(fused.stats.steps.numpy(),
                                  torch_path.stats.steps.numpy())
    np.testing.assert_allclose(fused.trajectory.numpy(),
                               torch_path.trajectory.numpy(), rtol=0,
                               atol=1e-5)


def test_default_mesh_needs_cards():
    """On the card by default: one shard a visible card, and too few
    cards raise as in the JAX package."""
    if torch.cuda.is_available():
        pytest.skip("has a card")
    kw, _ = _cfg("fhn_flat")
    with pytest.raises(ValueError, match="devices"):
        simulate_sharded(SimConfig(**kw), n_devices=2)


def test_rho_max_reduce():
    """make_rho_bound(max_reduce=) bounds the sharded state by the max over
    shards: equal to the full grid's bound."""
    from crdmodel_tpu_torch.core.problem import make_rho_bound
    from crdmodel_tpu_torch.parallel.sharded import (make_max_reduce,
                                                     mesh_pad_spec,
                                                     shard_params,
                                                     sharded_params,
                                                     split_state)
    kw, shape = _cfg("rkc2_ramp_freeze")
    cfg = SimConfig(**kw)
    problem = build_problem(cfg, "cpu")
    mesh = _mesh(shape)
    pad = mesh_pad_spec(cfg, mesh)
    y = torch.tensor(np.random.default_rng(2).uniform(-2, 2,
                                                      problem.y0.shape))
    full = make_rho_bound(cfg, problem.model, problem.geometry,
                          torch.float64)(0.0, y, problem.params)
    sharded = make_rho_bound(cfg, problem.model, problem.geometry,
                             torch.float64, max_reduce=make_max_reduce(mesh))
    got = sharded(0.0, split_state(y, mesh, pad, cfg),
                  shard_params(sharded_params(problem, pad), mesh, pad, cfg))
    assert float(got) == float(full)
