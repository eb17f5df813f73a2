"""The port's sharded run (crdmodel_tpu_torch/parallel/sharded.py) on its
torch path, against the JAX package's XLA sharded path on the 8 virtual
CPU devices, both in float64: the same step sequence and fields to 1e-12,
on even and uneven (padded) meshes, with ERK and rkc2 (the stage count from
the cross-shard max of rho). The shards of the port are tensors on the CPU
(make_mesh(devices=["cpu"] * 8)), the counterpart of JAX's virtual devices.
"""

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
CASES = {
    "fhn_flat": (dict(surface="flat", surface_width=10.0,
                      surface_length=20.0), (2, 4)),
    "fhn_torus_ramp_freeze": (dict(vary_beta=1, beta_min=0.7,
                                   beta_max=1.7, t_boundary=0.2), (4, 2)),
    "goldbeter": (dict(model="goldbeter", beta=0.4), (2, 2)),
    "rkc2_ramp_freeze": (dict(vary_beta=1, beta_min=0.7, beta_max=1.7,
                              t_boundary=0.2, method="rkc2"), (2, 4)),
    # 39x13 on a 2x4 mesh pads to 40x16: both axes uneven
    "uneven_bs32": (dict(x_mesh=13, surface_length=60.0, t_final=0.4),
                    (2, 4)),
    "uneven_rkc2": (dict(x_mesh=13, surface_length=60.0, t_final=0.4,
                         method="rkc2", t_boundary=0.1), (2, 4)),
}


def _cfg(name):
    kw, shape = CASES[name]
    return {**BASE, **kw}, shape


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
    kw, shape = _cfg(request.param)
    jres = jsim(JSimConfig(**kw), mesh=jmake_mesh(shape=shape))
    res = simulate_sharded(SimConfig(**kw), mesh=_mesh(shape))
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


@pytest.mark.parametrize("name", ["fhn_torus_ramp_freeze", "uneven_rkc2"])
def test_sharded_matches_single_device(name):
    """The sharded port against the single-device port, f64: the same steps
    and fields to 1e-12 (the partial sums add in another order)."""
    kw, shape = _cfg(name)
    cfg = SimConfig(**kw)
    single = simulate(cfg, device="cpu")
    res = simulate_sharded(cfg, mesh=_mesh(shape))
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
    (dict(method="ark324"), "K10"),
    (dict(surface="box", x_mesh=8, z_mesh=4, surface_depth=1.0,
          boundary="noflux", surface_width=8.0, surface_length=8.0,
          model="aliev_panfilov"), "K12"),
    (dict(boundary="noflux", surface="flat"), "K11")])
def test_unported_branches_raise(change, item):
    kw, _ = _cfg("fhn_flat")
    cfg = SimConfig(**{**kw, **change})
    with pytest.raises(NotImplementedError, match=f"item 15.*{item}"):
        simulate_sharded(cfg, mesh=_mesh((2, 2)))


def test_split_rhs_raises():
    kw, _ = _cfg("fhn_flat")
    cfg = SimConfig(**kw)
    problem = build_problem(cfg, "cpu")
    with pytest.raises(NotImplementedError, match="item 15"):
        make_local_rhs(cfg, problem.model, "flat", _mesh((2, 2)), split=True)


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
