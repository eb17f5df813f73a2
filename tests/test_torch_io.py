"""The port's reference-format file IO (crdmodel_tpu_torch/io/,
native/) against the JAX package's: the row writers byte for byte (g++
and numpy), the rank decomposition, each package reading the other's
files, the npz, and the sharded writer's per-shard files reassembled to
the gathered trajectory."""

import filecmp
import os
import types

import numpy as np
import pytest
import torch

from crdmodel_tpu.io import decomp as jdecomp
from crdmodel_tpu.io import trajectory as jtraj
from crdmodel_tpu.native import build as jnative
from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.io import decomp, trajectory
from crdmodel_tpu_torch.models import get_model
from crdmodel_tpu_torch.native import build as native
from crdmodel_tpu_torch.parallel.mesh import make_mesh
from crdmodel_tpu_torch.parallel.sharded import (simulate_sharded,
                                                 simulate_sharded_streaming)

RNG = np.random.default_rng(18)


def _values():
    """Rows with the awkward cases of " %.16e": signs, zeros, subnormals,
    huge and tiny exponents, float32 values widened, infinities."""
    data = RNG.standard_normal((5, 37)) * 10.0 ** RNG.integers(-30, 30,
                                                               (5, 37))
    data[0, :8] = [0.0, -0.0, 5e-324, -2.2250738585072014e-308, 1e300,
                   -1e-300, np.inf, -np.inf]
    data[1] = RNG.standard_normal(37).astype(np.float32).astype(np.float64)
    return data


@pytest.mark.parametrize("writer", ["g++", "numpy"])
def test_write_rows_byte_identical_to_jax(writer, tmp_path, monkeypatch):
    if writer == "numpy":
        monkeypatch.setattr(native, "load", lambda: None)
        monkeypatch.setattr(jnative, "load", lambda: None)
    else:
        assert native.load() is not None and jnative.load() is not None
    data = _values()
    ours, theirs = str(tmp_path / "ours.txt"), str(tmp_path / "jax.txt")
    assert trajectory._write_rows(ours, data[:3]) == writer
    assert trajectory._write_rows(ours, data[3:], mode="a") == writer
    jtraj._write_rows(theirs, data[:3])
    jtraj._write_rows(theirs, data[3:], mode="a")
    assert filecmp.cmp(ours, theirs, shallow=False)
    back = np.vstack([np.fromstring(line, sep=" ")
                      for line in open(ours)])
    np.testing.assert_array_equal(back, data)


def test_native_library_builds_beside_the_kernels():
    """The g++ library is built into the port's gitignored _build/, not
    next to its source."""
    assert native.load() is not None
    path = native.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(os.path.dirname(path)) == native.BUILD_DIR
    assert not any(f.endswith(".so")
                   for f in os.listdir(os.path.dirname(native.SRC)))


@pytest.mark.parametrize("grid", [(16, 64), (400, 1600), (37, 101)])
def test_decompose_matches_jax(grid):
    nx, ny = grid
    for nprocs in range(1, 17):
        assert decomp.dims_create(nprocs) == jdecomp.dims_create(nprocs)
        ours = [tuple(vars(s).values())
                for s in decomp.decompose(nx, ny, nprocs)]
        theirs = [tuple(vars(s).values())
                  for s in jdecomp.decompose(nx, ny, nprocs)]
        assert ours == theirs


def _fake_result(include_all_vars=1, nt=4):
    """A result with a random f64 trajectory of the FHN torus at x_mesh=16,
    in both packages' shapes: only cfg, problem.model and trajectory are
    read by the writers."""
    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.models import get_model as jget_model
    kw = dict(model="fhn", surface="torus", x_mesh=16, surface_width=20,
              surface_length=40, t_final=2.0, output_timestep=nt - 1,
              include_all_vars=include_all_vars, dtype="float64")
    cfg = SimConfig(**kw)
    traj = RNG.standard_normal((nt, 2, cfg.ny, cfg.nx))
    ours = types.SimpleNamespace(
        cfg=cfg, problem=types.SimpleNamespace(model=get_model("fhn")),
        trajectory=torch.from_numpy(traj))
    theirs = types.SimpleNamespace(
        cfg=JSimConfig(**kw),
        problem=types.SimpleNamespace(model=jget_model("fhn")),
        trajectory=traj)
    return ours, theirs, traj


@pytest.mark.parametrize("nprocs", [1, 4, 6])
def test_reference_files_identical_and_cross_readable(nprocs, tmp_path):
    """The port's and the JAX package's writers write the same files byte
    for byte; each package's reader reassembles the other's exactly."""
    ours, theirs, traj = _fake_result()
    a, b = str(tmp_path / "ours"), str(tmp_path / "jax")
    paths = trajectory.write_reference_files(ours, a, nprocs=nprocs)
    jpaths = jtraj.write_reference_files(theirs, b, nprocs=nprocs)
    assert ([os.path.basename(p) for p in paths]
            == [os.path.basename(p) for p in jpaths])
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors
    prog = ours.cfg.program_name
    for v, var in enumerate(("u", "v")):
        got, meta = trajectory.read_reference_files(b, prog, var)
        np.testing.assert_array_equal(got, traj[:, v])
        back, jmeta = jtraj.read_reference_files(a, prog, var)
        np.testing.assert_array_equal(back, traj[:, v])
        assert meta == jmeta


def test_npz_round_trip(tmp_path):
    from crdmodel_tpu_torch.sim import simulate
    cfg = SimConfig(model="fhn", surface="flat", x_mesh=10,
                    surface_width=20, surface_length=40, t_final=0.5,
                    output_timestep=2, beta=1.25, include_all_vars=1,
                    dtype="float64", rtol=1e-6, atol=1e-10)
    res = simulate(cfg, device="cpu")
    path = str(tmp_path / "run.npz")
    trajectory.save_npz(res, path)
    z = trajectory.load_npz(path)
    np.testing.assert_array_equal(z["trajectory"], res.trajectory.numpy())
    np.testing.assert_array_equal(z["steps"], res.stats.steps.numpy())
    np.testing.assert_array_equal(z["touts"], res.touts)
    assert z["trajectory"].dtype == np.float64
    assert "'model': 'fhn'" in str(z["config"])


@pytest.mark.parametrize("shape,use_pallas", [((2, 2), None), ((2, 2), True),
                                              ((1, 3), True), ((3, 1), None)])
def test_sharded_writer_reassembles_gathered_trajectory(shape, use_pallas,
                                                        tmp_path):
    """ShardedReferenceWriter, fed by simulate_sharded_streaming on CPU
    shards, writes per-shard files whose union read_reference_files (and
    the JAX package's reader) reassembles to the gathered trajectory
    exactly, also on meshes whose blocks carry pad cells (1x3, 3x1)."""
    cfg = SimConfig(model="fhn", surface="torus", x_mesh=16,
                    surface_width=20, surface_length=40, t_final=1.0,
                    output_timestep=3, vary_beta=1, beta_min=0.7,
                    beta_max=1.7, t_boundary=0.4, include_all_vars=1,
                    dtype="float64", rtol=1e-6, atol=1e-10,
                    use_pallas=use_pallas)
    mesh = make_mesh(shape=shape, devices=["cpu"] * (shape[0] * shape[1]))
    model = get_model("fhn")
    writer = trajectory.ShardedReferenceWriter(str(tmp_path), cfg, model,
                                               mesh)
    res = simulate_sharded_streaming(cfg, mesh=mesh, on_snapshot=writer)
    assert res.ok
    assert trajectory.probe_nprocs(str(tmp_path), cfg.program_name) == \
        mesh.size
    batch = simulate_sharded(cfg, mesh=mesh)
    assert torch.equal(res.trajectory, batch.trajectory)
    for v, var in enumerate(("u", "v")):
        got, meta = trajectory.read_reference_files(str(tmp_path),
                                                    cfg.program_name, var)
        np.testing.assert_array_equal(got, batch.trajectory[:, v].numpy())
        jgot, _ = jtraj.read_reference_files(str(tmp_path),
                                             cfg.program_name, var)
        np.testing.assert_array_equal(jgot, got)
        assert (meta["nx"], meta["ny"]) == (cfg.nx, cfg.ny)


def test_sharded_writer_subdomains_match_jax(tmp_path):
    """On a 2x2 mesh the port's sharded writer numbers its ranks and states
    their extents as the JAX package's writer does for its devices: the
    subdomain files byte for byte, the rows within 1e-10 (two f64 runs)."""
    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild_problem
    from crdmodel_tpu.parallel.mesh import make_mesh as jmake_mesh
    from crdmodel_tpu.parallel.sharded import \
        simulate_sharded_streaming as jstream

    kw = dict(model="fhn", surface="torus", x_mesh=16, surface_width=20,
              surface_length=40, t_final=0.5, output_timestep=2,
              include_all_vars=1, dtype="float64", rtol=1e-6, atol=1e-10)
    cfg = SimConfig(**kw)
    mesh = make_mesh(shape=(2, 2), devices=["cpu"] * 4)
    a, b = str(tmp_path / "ours"), str(tmp_path / "jax")
    simulate_sharded_streaming(cfg, mesh=mesh, on_snapshot=(
        trajectory.ShardedReferenceWriter(a, cfg, get_model("fhn"), mesh)))
    jcfg = JSimConfig(**kw)
    jp = jbuild_problem(jcfg)
    jmesh = jmake_mesh(shape=(2, 2))
    jstream(jcfg, mesh=jmesh, problem=jp, on_snapshot=(
        jtraj.ShardedReferenceWriter(b, jcfg, jp.model, jmesh)))
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in sorted(os.listdir(a)):
        if "_subdomain." in name:
            assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                               shallow=False), name
        else:
            np.testing.assert_allclose(
                jtraj._read_values(os.path.join(a, name)),
                jtraj._read_values(os.path.join(b, name)), rtol=0,
                atol=1e-10, err_msg=name)
