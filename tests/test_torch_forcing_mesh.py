"""Structured forcing on a mesh (crdmodel_tpu_torch/parallel/sharded.py:
the stimulus profiles of sharded_params, the forcing term of
make_local_rhs; ops/kernel_common.py::prepare_shard_stim_constants)
against the JAX package's (crdmodel_tpu/parallel/sharded.py:155-176,
391-419), on the CPU.

The port's shards are tensors on the CPU (make_mesh(devices=["cpu"] * n)),
JAX's its 8 virtual CPU devices. Covered here: the profiles each shard
sees, bitwise the JAX sharded_params' slices on even and uneven meshes,
rank-1 and full-field; each shard's halo-padded (and mirror-padded)
profiles of the shard kernels, bitwise the JAX kernels' prepare_params
inputs at halo 8 (K8, K10, K11) and 24 (K9); the sharded torch path in
f64 taking JAX's XLA sharded steps and rejections exactly, trajectories
within 1e-10 (tests/test_forcing.py:166, 295, 322, 394, 670, 773: FHN flat
and torus bs32 with a pulse train and with smooth waveforms, ark324 with
the forcing in rhs_ex only, rkc2, no-flux walls with a scar, an uneven
mesh, a full 2-D stimulus, the box with a depth profile); and the
streaming driver taking simulate_sharded's steps bitwise. The kernels'
forced steps and runs are in tests/test_torch_forcing_mesh_kernels.py.
"""

import numpy as np
import pytest
import torch
from test_torch_forcing import jax_forcing, protocol, torch_forcing

from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.core import forcing as tforcing
from crdmodel_tpu_torch.core.problem import build_problem
from crdmodel_tpu_torch.ops.kernel_common import prepare_shard_stim_constants
from crdmodel_tpu_torch.parallel.mesh import make_mesh
from crdmodel_tpu_torch.parallel.sharded import (mesh_pad_spec, shard_params,
                                                 sharded_params,
                                                 simulate_sharded,
                                                 simulate_sharded_streaming)

BASE = dict(model="fhn", surface="torus", x_mesh=16, surface_width=20.0,
            surface_length=40.0, t_final=0.5, output_timestep=2,
            beta=1.25, dtype="float64", rtol=1e-6, atol=1e-9)
FLAT = dict(surface="flat", surface_width=10.0, surface_length=20.0)
# 39x13 on a 2x4 mesh pads to 40x16: both axes uneven
UNEVEN = dict(x_mesh=13, surface_length=60.0)
AP = dict(FLAT, model="aliev_panfilov", beta=0.1, boundary="noflux",
          wave_length=0.25, wave_width=0.5)
BOX = dict(model="aliev_panfilov", surface="box", x_mesh=16,
           surface_width=8.0, surface_length=16.0, y_mesh=32,
           surface_depth=2.0, z_mesh=4, t_final=0.4, output_timestep=1,
           beta=0.1, boundary="noflux", dtype="float64", rtol=1e-6,
           atol=1e-9)


def _mesh(shape):
    return make_mesh(shape=shape, devices=["cpu"] * (shape[0] * shape[1]))


def _jax_mesh(shape):
    import jax

    from crdmodel_tpu.parallel.mesh import make_mesh as jmake_mesh
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    return jmake_mesh(shape=shape)


def _scar(cfg):
    """A rectangular scar of inert cells (True = tissue)."""
    mask = np.ones((cfg.ny, cfg.nx), bool)
    mask[10:18, 5:10] = False
    return dict(obstacle_mask=mask)


def _spatial_stimulus(ny, nx, jax_side):
    """A full-field stimulus (pulse train on a seeded (ny, nx) field) and
    the paced protocol's rank-1 stimuli, for either package."""
    field = np.random.default_rng(5).random((ny, nx))
    stimuli = protocol(ny, nx)
    if jax_side:
        from crdmodel_tpu.core import forcing as jf
        rank1 = jax_forcing(stimuli).stimuli
        return jf.SeparableForcing(*rank1, jf.Stimulus(
            waveform=jf.pulse_train([0.1], 0.2, 2.0), spatial=field))
    rank1 = torch_forcing(stimuli).stimuli
    return tforcing.SeparableForcing(*rank1, tforcing.Stimulus(
        waveform=tforcing.pulse_train([0.1], 0.2, 2.0), spatial=field))


def _box_forcing(cfg, jax_side):
    """tests/test_forcing.py::TestFusedBoxForcing._box_protocol: a pulse
    train on a row band with a Gaussian depth profile and a smooth drive
    on a column band."""
    if jax_side:
        import jax.numpy as jnp

        from crdmodel_tpu.core import forcing as f
        wave = lambda t: 0.3 * jnp.cos(4.0 * t)  # noqa: E731
    else:
        f = tforcing
        wave = lambda t, seg_end=None: 0.3 * torch.cos(4.0 * t)  # noqa: E731
    return f.SeparableForcing(
        f.Stimulus(waveform=f.pulse_train([0.1, 0.35], 0.1, 1.0),
                   row=f.rect_profile(cfg.ny, 0, cfg.ny // 4),
                   zprof=f.gaussian_profile(cfg.nz, 0.0, 1.5)),
        f.Stimulus(waveform=wave, col=f.rect_profile(cfg.nx, 0, cfg.nx // 2)))


def _paced(smooth=False):
    def forcing(cfg, jax_side):
        stimuli = protocol(cfg.ny, cfg.nx, smooth)
        return (jax_forcing if jax_side else torch_forcing)(stimuli)
    return forcing


# name: (config keywords, mesh shape, forcing(cfg, jax_side), build(cfg))
CASES = {
    "bs32_flat_pulse": (FLAT, (2, 4), _paced(), None),
    "bs32_flat_smooth": (FLAT, (2, 4), _paced(True), None),
    "bs32_torus_ramp_freeze_pulse": (
        dict(vary_beta=1, beta_min=0.7, beta_max=1.7, t_boundary=0.2),
        (4, 2), _paced(), None),
    "rkc2_pulse": (dict(method="rkc2", t_boundary=0.2), (2, 4), _paced(),
                   None),
    "rkc2_smooth": (dict(method="rkc2"), (2, 2), _paced(True), None),
    # ark324's torch path steps slowly on the CPU (its pointwise Newton):
    # the shortest runs that cross the first pulse's edges and the freeze
    "ark324_goldbeter_pulse": (dict(model="goldbeter", beta=0.4,
                                    method="ark324", t_final=0.25,
                                    rtol=1e-5), (2, 2), _paced(), None),
    "ark324_fhn_freeze_smooth": (dict(method="ark324", t_boundary=0.2,
                                      t_final=0.25, rtol=1e-5), (2, 2),
                                 _paced(True), None),
    "noflux_scar": (dict(AP, t_final=0.6), (2, 2), _paced(), _scar),
    "uneven_pulse": (UNEVEN, (2, 4), _paced(), None),
    "uneven_rkc2_smooth": (dict(UNEVEN, method="rkc2", t_boundary=0.1),
                           (2, 4), _paced(True), None),
    "full_field": (FLAT, (2, 2), lambda c, j: _spatial_stimulus(c.ny, c.nx,
                                                                j), None),
    "box_zprof": (BOX, (2, 2), _box_forcing, None),
}


def _case(name):
    kw, shape, forcing, build = CASES[name]
    full = dict(BOX) if kw is BOX else {**BASE, **kw}
    cfg = SimConfig(**full)
    return full, cfg, shape, forcing, (build(cfg) if build else {})


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    """(JAX XLA sharded run, the port's sharded run, case name) of one
    forced case, both in f64 on the CPU."""
    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild
    from crdmodel_tpu.parallel.sharded import simulate_sharded as jsim
    kw, cfg, shape, forcing, build = _case(request.param)
    jcfg = JSimConfig(**kw)
    jres = jsim(jcfg, mesh=_jax_mesh(shape),
                problem=jbuild(jcfg, forcing=forcing(jcfg, True), **build))
    tres = simulate_sharded(cfg, mesh=_mesh(shape), problem=build_problem(
        cfg, "cpu", forcing=forcing(cfg, False), **build))
    return jres, tres, request.param


def test_torch_path_takes_jax_steps(pair):
    """The sharded torch path at f64 takes the JAX XLA sharded path's
    steps and rejections exactly, its fields within 1e-10."""
    jres, tres, _ = pair
    assert tres.ok and not tres.fused
    np.testing.assert_array_equal(tres.stats.steps.numpy(),
                                  np.asarray(jres.stats.steps))
    np.testing.assert_array_equal(tres.stats.rejected.numpy(),
                                  np.asarray(jres.stats.rejected))
    np.testing.assert_allclose(tres.trajectory.numpy(),
                               np.asarray(jres.trajectory), rtol=0,
                               atol=1e-10)


def test_forcing_moves_the_run(pair):
    """Each case's forcing changes its trajectory: the sharded run without
    it ends elsewhere (so the parity above exercised the forcing)."""
    _, tres, name = pair
    kw, cfg, shape, _, build = _case(name)
    bare = simulate_sharded(cfg, mesh=_mesh(shape),
                            problem=build_problem(cfg, "cpu", **build))
    assert float((tres.trajectory[-1] - bare.trajectory[-1]).abs().max()) > 1e-4


# the profiles each shard reads: (config keywords, mesh shape, forcing)
PROFILE_CASES = {
    "even_2x4": (FLAT, (2, 4), _paced()),
    "uneven_2x4": (UNEVEN, (2, 4), _paced()),
    "uneven_3x1": (dict(x_mesh=25), (3, 1), _paced()),
    "full_field_uneven_2x4": (UNEVEN, (2, 4),
                              lambda c, j: _spatial_stimulus(c.ny, c.nx, j)),
}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", sorted(PROFILE_CASES))
def test_shard_profiles_are_jax_slices(name, dtype):
    """Every shard's "_stim_*" profiles (sharded_params, then shard_params)
    are bitwise the slices of the JAX package's sharded_params along its
    PartitionSpecs, with the same pad plan: (nyl, 1) rows, (1, nxl)
    columns, (nyl, nxl) full fields, wrap-padded on an uneven mesh."""
    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild
    from crdmodel_tpu.parallel import sharded as jsh
    from crdmodel_tpu.parallel.padding import compute_pad_spec
    kw, shape, forcing = PROFILE_CASES[name]
    full = {**BASE, **kw, "dtype": dtype}
    cfg, jcfg = SimConfig(**full), JSimConfig(**full)
    mesh = _mesh(shape)
    pad = mesh_pad_spec(cfg, mesh)
    assert (pad is not None) == name.startswith(("uneven", "full"))
    jpad = (compute_pad_spec(cfg.ny, cfg.nx, *shape)
            if pad is not None else None)
    jparams, _ = jsh.sharded_params(jbuild(jcfg, forcing=forcing(jcfg, True)),
                                    jpad)
    tp = build_problem(cfg, "cpu", forcing=forcing(cfg, False))
    local = shard_params(sharded_params(tp, pad), mesh, pad, cfg)["local"]
    keys = sorted(k for k in jparams if k.startswith("_stim"))
    assert keys == sorted(k for k in local[0] if k.startswith("_stim"))
    assert keys
    ny, nx = jpad.padded_shape if jpad is not None else (cfg.ny, cfg.nx)
    nyl, nxl = ny // shape[0], nx // shape[1]
    for k, loc in enumerate(local):
        iy, ix = divmod(k, shape[1])
        for key in keys:
            want = np.asarray(jparams[key])
            if want.shape[-2] == ny:
                want = want[iy * nyl:(iy + 1) * nyl]
            if want.shape[-1] == nx:
                want = want[:, ix * nxl:(ix + 1) * nxl]
            got = loc[key].numpy()
            assert got.dtype == want.dtype and got.shape == want.shape, key
            np.testing.assert_array_equal(got, want, err_msg=key)


def _jax_halo_profiles(jcfg, jp, mesh, jpad, halo):
    """Every shard's halo-padded stimulus rows and columns as the JAX
    shard kernels' prepare_params builds them (pallas_shard_step.py:
    166-187, pallas_shard_rkc.py:144-160) from the sharded "_stim_*"
    params, under shard_map: (rows (py, px, n_stim, nyl + 2 halo), cols
    (py, px, n_stim, nxl + 2 halo))."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from crdmodel_tpu.parallel import sharded as jsh
    from crdmodel_tpu.parallel.halo import (halo_pad_cols, halo_pad_rows,
                                            mirror_halo_pad_cols,
                                            mirror_halo_pad_rows)
    from crdmodel_tpu.parallel.mesh import AXIS_X, AXIS_Y
    params, specs = jsh.sharded_params(jp, jpad)
    pady = jpad is not None and jpad.y.active
    padx = jpad is not None and jpad.x.active
    n_stim = len(jp.forcing.stimuli)
    dtype = jnp.dtype(jcfg.dtype)

    def local(params):
        rows, cols = [], []
        for i in range(n_stim):
            r = params[f"_stim_row_{i}"].astype(dtype)
            r = (mirror_halo_pad_rows(r, AXIS_Y, halo, jpad.y.n, jpad.y.blk)
                 if pady else halo_pad_rows(r, AXIS_Y, halo))
            c = params[f"_stim_col_{i}"].astype(dtype)
            c = (mirror_halo_pad_cols(c, AXIS_X, halo, jpad.x.n, jpad.x.blk)
                 if padx else halo_pad_cols(c, AXIS_X, halo))
            rows.append(r[:, 0])
            cols.append(c[0])
        return jnp.stack(rows)[None, None], jnp.stack(cols)[None, None]

    out = P(AXIS_Y, AXIS_X)
    fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(specs,),
                               out_specs=(out, out), check_vma=False))
    rows, cols = fn(params)
    return np.asarray(rows), np.asarray(cols)


# (config keywords, mesh shape): halo-padded profiles on an even mesh, an
# x-padded 1x3 mesh and a y-padded 2x1 mesh whose blocks the JAX kernels'
# 8-row layout takes as they are (47 rows: blocks of 24)
HALO_CASES = {"even_2x2": (dict(x_mesh=56), (2, 2)),
              "x_padded_1x3": (dict(x_mesh=80), (1, 3)),
              "y_padded_2x1": (dict(x_mesh=32, y_mesh=47), (2, 1))}


@pytest.mark.parametrize("halo", [8, 24])
@pytest.mark.parametrize("name", sorted(HALO_CASES))
def test_halo_padded_profiles_match_jax_kernel_inputs(name, halo):
    """prepare_shard_stim_constants gives each shard the rows and columns
    the JAX shard kernels' prepare_params gives theirs: halo-padded by the
    mesh's exchange, mirror-aware along a padded axis, f32 bitwise (the
    JAX columns' lane fill aside); at halo 8 also against K8's own
    prepare_params."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild
    from crdmodel_tpu.parallel import sharded as jsh
    from crdmodel_tpu.parallel.mesh import AXIS_X, AXIS_Y
    from crdmodel_tpu.parallel.padding import compute_pad_spec
    kw, shape = HALO_CASES[name]
    full = {**BASE, **FLAT, **kw, "dtype": "float32", "use_pallas": True}
    cfg, jcfg = SimConfig(**full), JSimConfig(**full)
    mesh, jmesh = _mesh(shape), _jax_mesh(shape)
    pad = mesh_pad_spec(cfg, mesh)
    jpad = (compute_pad_spec(cfg.ny, cfg.nx, *shape)
            if pad is not None else None)
    jp = jbuild(jcfg, forcing=_paced()(jcfg, True))
    tp = build_problem(cfg, "cpu", forcing=_paced()(cfg, False))
    stims = prepare_shard_stim_constants(tp, mesh, pad, halo, torch.float32)
    rows, cols = _jax_halo_profiles(jcfg, jp, jmesh, jpad, halo)
    for k, st in enumerate(stims):
        iy, ix = divmod(k, shape[1])
        np.testing.assert_array_equal(st.rows.numpy(), rows[iy, ix])
        np.testing.assert_array_equal(st.cols.numpy(), cols[iy, ix])
    if halo != 8:
        return
    fused = jsh.maybe_fused_shard_step(jp, jmesh, interpret=True,
                                       pad_spec=jpad)
    assert fused is not None
    params, specs = jsh.sharded_params(jp, jpad)

    def local(params):
        p = fused.prepare_params(params)
        return (p["_fused_stim_rows"][None, None],
                p["_fused_stim_cols"][None, None])

    out = P(AXIS_Y, AXIS_X)
    fn = jax.jit(jax.shard_map(local, mesh=jmesh, in_specs=(specs,),
                               out_specs=(out, out), check_vma=False))
    krows, kcols = (np.asarray(a) for a in fn(params))
    for k, st in enumerate(stims):
        iy, ix = divmod(k, shape[1])
        width = st.cols.shape[1]
        np.testing.assert_array_equal(st.rows.numpy(), krows[iy, ix, ..., 0])
        np.testing.assert_array_equal(st.cols.numpy(),
                                      kcols[iy, ix, :, 0, :width])
    assert jnp.dtype(jcfg.dtype) == jnp.float32


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["torch_path", "plain_k8"])
def test_streaming_takes_simulate_sharded_steps(use_pallas):
    """simulate_sharded_streaming takes a forced problem's breakpoints and
    kernel as simulate_sharded does: the same steps and rows, bitwise, on
    an uneven mesh (34x17 on 2x2: blocks of 17x9)."""
    kw = {**BASE, **FLAT, "x_mesh": 17, "dtype": "float32", "rtol": 1e-4,
          "atol": 1e-6, "use_pallas": use_pallas, "output_timestep": 3}
    cfg = SimConfig(**kw)
    mesh = _mesh((2, 2))
    stimuli = protocol(cfg.ny, cfg.nx)
    res = simulate_sharded(cfg, mesh=mesh, problem=build_problem(
        cfg, "cpu", forcing=torch_forcing(stimuli)))
    stream = simulate_sharded_streaming(cfg, mesh=mesh, problem=build_problem(
        cfg, "cpu", forcing=torch_forcing(stimuli)))
    assert res.ok and res.fused == stream.fused == use_pallas
    assert torch.equal(stream.stats.steps, res.stats.steps)
    assert torch.equal(stream.trajectory, res.trajectory)


def test_free_form_forcing_runs_per_shard():
    """A free-form forcing(t, state, params) is called on each shard with
    its local block and params, as under shard_map: a uniform drive on a
    2x2 mesh gives the single-device run's steps, fields within 1e-12."""
    from crdmodel_tpu_torch.sim import simulate

    def drive(t, state, params):
        f0 = 0.7 * torch.cos(3.0 * t) * torch.ones_like(state[0])
        return torch.stack([f0, torch.zeros_like(f0)])

    cfg = SimConfig(**{**BASE, **FLAT, "t_final": 1.0})
    one = simulate(cfg, device="cpu", problem=build_problem(cfg, "cpu",
                                                            forcing=drive))
    four = simulate_sharded(cfg, mesh=_mesh((2, 2)), problem=build_problem(
        cfg, "cpu", forcing=drive))
    assert one.ok and four.ok and not four.fused
    assert one.total_steps() == four.total_steps()
    np.testing.assert_allclose(four.trajectory.numpy(),
                               one.trajectory.numpy(), rtol=0, atol=1e-12)
