"""Structured forcing on the 3-D box: the box kernels K6
(ops/fused_box3d.py), K7 (ops/fused_box3d_rkc.py), K12
(ops/fused_shard_box3d.py) and K13 (ops/fused_shard_box3d_rkc.py) with a
SeparableForcing whose stimuli carry a depth profile (zprof), against the
JAX package's (crdmodel_tpu/ops/pallas_box3d.py, pallas_box3d_rkc.py,
pallas_shard_box3d.py, pallas_shard_box3d_rkc.py).

On the CPU, at the JAX suite's own box (tests/test_forcing.py:621-642:
Aliev-Panfilov on 4x32x16, no-flux walls, _box_protocol: a pulse train on
a row band with a Gaussian depth profile, a smooth drive on a column
band), f32, from a numpy-seeded state:
- the depth table K6 and K7 take bitwise the JAX kernels' stim_z input,
  and each shard's halo-padded rows and columns and depth table bitwise
  the JAX K12 and K13 inputs (their prepare_params under shard_map);
- one forced step of each kernel's plain version against the JAX kernel
  in interpret mode, in a pulse and out of it, frozen and not: K6 with
  bs32 and dopri54, K7 gated (one amplitude column) and smooth (a column
  a Chebyshev stage time) at s = 2, 5, 7, K12 and K13 likewise on a 2x2
  mesh, with the kernels' own tests' limits: y within 2e-6 (K6), 4e-6
  (K7), 5e-6 (K12) and 1e-5 (K13) of the state's scale, the step's WRMS
  error norm within 5e-5 (K7 2e-3) plus 1e-4 of itself
  (tests/test_torch_fused_box3d*.py, test_torch_fused_shard_box3d*.py);
- whole forced runs through the plain kernels against the JAX XLA path,
  one device and a 2x2 mesh, bs32 and rkc2: a step gap of at most 1 an
  interval, trajectories within 1e-4 (the JAX test's own limits);
- the gates against the JAX gates for rank-1 stimuli with a depth
  profile, a full-field stimulus and a free-form forcing.
On a CUDA card (marker `cuda`): each forced kernel against its plain
version, y_new (a shard's block) and every partial sum bitwise, f32 and
f64, frozen and not, with a stimulus on each variable:

    python -m pytest tests/test_torch_forcing_box.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.core import forcing as tforcing
from crdmodel_tpu_torch.core.problem import build_problem
from crdmodel_tpu_torch.integrate import rkc as trkc
from crdmodel_tpu_torch.integrate.erk import TABLEAUS
from crdmodel_tpu_torch.ops import fused_box3d as f6
from crdmodel_tpu_torch.ops import fused_box3d_rkc as f7
from crdmodel_tpu_torch.ops import fused_shard_box3d as f12
from crdmodel_tpu_torch.ops import fused_shard_box3d_rkc as f13
from crdmodel_tpu_torch.ops.kernel_common import (
    freeze_scalar, prepare_shard_stim_constants, prepare_stim_constants)
from crdmodel_tpu_torch.parallel.mesh import make_mesh
from crdmodel_tpu_torch.parallel.sharded import (gather, make_reduce,
                                                 mesh_pad_spec,
                                                 select_shard_kernel,
                                                 shard_params,
                                                 sharded_params,
                                                 sharded_rho_bound,
                                                 simulate_sharded,
                                                 split_state)
from crdmodel_tpu_torch.sim import fused_eligible, simulate

# tests/test_forcing.py::TestFusedBoxForcing._box_cfg, with a freeze that
# releases between the two pulses
BOX = dict(model="aliev_panfilov", surface="box", x_mesh=16,
           surface_width=8.0, surface_length=16.0, y_mesh=32,
           surface_depth=2.0, z_mesh=4, t_final=0.6, output_timestep=1,
           beta=0.1, dtype="float32", rtol=1e-4, atol=1e-6,
           boundary="noflux", use_pallas=True)
T_BOUNDARY = 0.2
# (t, seg_end) of a step: pulses on [0.1, 0.2) and [0.35, 0.45), frozen
# while seg_end <= T_BOUNDARY
WINDOWS = {"in_pulse_frozen": (0.12, 0.15), "in_pulse": (0.37, 0.4),
           "off_pulse_frozen": (0.02, 0.05), "off_pulse": (0.25, 0.3)}
H = 2e-3
K7_STAGES = (2, 5, 7)


def _stimuli(cfg, smooth=True, cross=False):
    """_box_protocol's stimuli as data; without `smooth` its pulse train
    alone (every stimulus segment-gated: K7's one amplitude column); with
    `cross` one more on variable 1 (on a Gaussian column band with a depth
    profile of its own: a smooth drive, or without `smooth` a pulse
    train), so that both variables are forced."""
    out = [dict(var=0, row=tforcing.rect_profile(cfg.ny, 0, cfg.ny // 4),
                zprof=tforcing.gaussian_profile(cfg.nz, 0.0, 1.5),
                pulses=([0.1, 0.35], 0.1, 1.0))]
    if smooth:
        out.append(dict(var=0, col=tforcing.rect_profile(cfg.nx, 0,
                                                         cfg.nx // 2),
                        wave=(0.3, 4.0)))
    if cross:
        out.append(dict(var=1, col=tforcing.gaussian_profile(
            cfg.nx, cfg.nx / 2, cfg.nx / 8),
            zprof=tforcing.gaussian_profile(cfg.nz, cfg.nz - 1.0, 2.0),
            **(dict(wave=(0.2, 5.0)) if smooth
               else dict(pulses=([0.1, 0.35], 0.1, 0.5)))))
    return out


def _forcing(stimuli, jax_side):
    """The SeparableForcing of `stimuli` in the JAX package or the port."""
    if jax_side:
        import jax.numpy as jnp

        from crdmodel_tpu.core import forcing as jf

        def wave(a, w):
            return lambda t: a * jnp.cos(w * t)

        return jf.SeparableForcing(*(jf.Stimulus(
            waveform=(jf.pulse_train(*st["pulses"]) if "pulses" in st
                      else wave(*st["wave"])),
            var=st["var"], row=st.get("row"), col=st.get("col"),
            zprof=st.get("zprof")) for st in stimuli))

    def wave(a, w):
        return lambda t, seg_end=None: a * torch.cos(w * t)

    return tforcing.SeparableForcing(*(tforcing.Stimulus(
        waveform=(tforcing.pulse_train(*st["pulses"]) if "pulses" in st
                  else wave(*st["wave"])),
        var=st["var"], row=st.get("row"), col=st.get("col"),
        zprof=st.get("zprof")) for st in stimuli))


def _problems(kw, smooth=True, build_kw=None):
    """(port problem on the CPU, JAX problem) of the box `kw` forced."""
    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild
    build_kw = build_kw or {}
    cfg = SimConfig(**kw)
    stimuli = _stimuli(cfg, smooth)
    return (build_problem(cfg, "cpu", forcing=_forcing(stimuli, False),
                          **build_kw),
            jbuild(JSimConfig(**kw), forcing=_forcing(stimuli, True),
                   **build_kw))


def _state(cfg, seed=7):
    rng = np.random.default_rng(seed)
    shape = (cfg.nz, cfg.ny, cfg.nx)
    return np.stack([rng.uniform(-0.1, 1.1, shape),
                     rng.uniform(0.0, 2.0, shape)]).astype(np.float32)


def _mesh(shape, device="cpu"):
    return make_mesh(shape=shape, devices=[device] * (shape[0] * shape[1]))


def _wrms_close(ss, ss_want, n, floor):
    """The WRMS error norms of two sums of squares over n values agree
    within `floor` plus 1e-4 of the norm."""
    got, want = np.sqrt(ss / n), np.sqrt(ss_want / n)
    assert abs(got - want) <= floor + 1e-4 * want


def _h_for(s):
    """A step the gates' stage count s stabilizes at this box's rho."""
    return 1e-3 if s == 2 else 4e-3


class _Captured(Exception):
    """The inputs of a pallas_call, caught before the kernel runs."""


def _capture_call(monkeypatch, module):
    """Make the kernels that `module`'s build functions make raise
    _Captured with their call's arguments instead of running."""
    def pallas_call(kernel, **kw):
        def recorded(*args):
            raise _Captured(args)
        return recorded

    monkeypatch.setattr(module.pl, "pallas_call", pallas_call)


# the argument index of the depth table stim_z in the JAX K6's call
# (pallas_box3d.py:796-799; K7 builds its own alike, pallas_box3d_rkc.py:
# 185-190)
STIM_Z_ARG = 6


def test_depth_table_matches_jax_kernel_input(monkeypatch):
    """prepare_stim_constants' (n_stim, nz) depth table, ones where a
    stimulus has no zprof, is bitwise the stim_z the JAX box kernel takes
    (pallas_box3d.py:385-390), and the 2-D kernels get none."""
    import jax.numpy as jnp

    from crdmodel_tpu.integrate import erk as jerk
    from crdmodel_tpu.ops import pallas_box3d
    _capture_call(monkeypatch, pallas_box3d)
    tp, jp = _problems(dict(BOX, t_boundary=T_BOUNDARY))
    fs = pallas_box3d.build_fused_box3d_step(
        jp, jerk.TABLEAUS["bs32"], jnp.float32, interpret=True)
    with pytest.raises(_Captured) as call:
        fs.step_err(jnp.float32(0.12), fs.pad(jnp.asarray(_state(tp.cfg))),
                    jnp.float32(H), {**jp.params,
                                     "_seg_end": jnp.float32(0.15)})
    want = np.asarray(call.value.args[0][STIM_Z_ARG])
    z = prepare_stim_constants(tp, torch.float32, "cpu").z
    assert z.dtype == torch.float32 and z.is_contiguous()
    np.testing.assert_array_equal(z.numpy(), want)
    assert not np.all(want[0] == 1.0) and np.all(want[1] == 1.0)
    flat = SimConfig(model="fhn", surface="flat", x_mesh=16,
                     surface_width=10.0, surface_length=20.0)
    flat_p = build_problem(flat, "cpu", forcing=_forcing(
        _stimuli(flat)[1:], False))
    assert prepare_stim_constants(flat_p, torch.float32, "cpu").z is None


def _jax_rho(jp, dtype, max_reduce):
    """The JAX package's rkc2 spectral-radius bound of jp, max-reduced by
    `max_reduce` (the box's walls through its face mask)."""
    from crdmodel_tpu.core.problem import make_rho_bound
    return make_rho_bound(jp.cfg, jp.model, jp.geometry, dtype,
                          max_reduce=max_reduce,
                          diffusion_field=jp.diffusion_field,
                          diffusion_tensor=jp.diffusion_tensor,
                          face_mask=jp.face_mask)


def _jax_shard_profiles(jp, jmesh, kernel):
    """Every shard's halo-padded stimulus rows and columns as the JAX K12
    or K13 prepare_params builds them under shard_map: (rows (py, px,
    n_stim, nyl + 2P), cols (py, px, n_stim, nxp))."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from crdmodel_tpu.parallel import sharded as jsh
    from crdmodel_tpu.parallel.mesh import AXIS_X, AXIS_Y
    if kernel == "K12":
        fused = jsh.maybe_fused_shard_box3d(jp, jmesh, interpret=True)
    else:
        rho = _jax_rho(jp, jnp.float32,
                       lambda x: lax.pmax(x, (AXIS_Y, AXIS_X)))
        fused = jsh.maybe_fused_shard_rkc(jp, jmesh, rho, interpret=True)
    assert fused is not None
    params, specs = jsh.sharded_params(jp, None)

    def local(params):
        p = fused.prepare_params(params)
        return (p["_fused_stim_rows"][None, None],
                p["_fused_stim_cols"][None, None])

    out = P(AXIS_Y, AXIS_X)
    fn = jax.jit(jax.shard_map(local, mesh=jmesh, in_specs=(specs,),
                               out_specs=(out, out), check_vma=False))
    return tuple(np.asarray(a) for a in fn(params))


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)], ids=["2x2", "4x1"])
@pytest.mark.parametrize("kernel", ["K12", "K13"])
def test_shard_profiles_match_jax_kernel_inputs(kernel, shape):
    """prepare_shard_stim_constants gives each box shard the rows and
    columns the JAX K12 and K13 prepare_params give theirs
    (pallas_shard_box3d.py:196-213, pallas_shard_box3d_rkc.py:166-181),
    halo-padded to 8 rings, f32 bitwise (the JAX columns' lane fill
    aside), and the whole box's depth table on every shard, bitwise the
    single-device kernels' (z is not sharded)."""
    import jax

    from crdmodel_tpu.parallel.mesh import make_mesh as jmake_mesh
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    method = "bs32" if kernel == "K12" else "rkc2"
    tp, jp = _problems(dict(BOX, method=method))
    mesh = _mesh(shape)
    stims = prepare_shard_stim_constants(tp, mesh, None, f12.HALO,
                                         torch.float32)
    rows, cols = _jax_shard_profiles(jp, jmake_mesh(shape=shape), kernel)
    z = prepare_stim_constants(tp, torch.float32, "cpu").z
    for k, st in enumerate(stims):
        iy, ix = divmod(k, shape[1])
        width = st.cols.shape[1]
        np.testing.assert_array_equal(st.rows.numpy(), rows[iy, ix, ..., 0])
        np.testing.assert_array_equal(st.cols.numpy(),
                                      cols[iy, ix, :, 0, :width])
        assert torch.equal(st.z, z)


# the JAX reference steps, each jitted once and shared by the cases that
# take its kernel and forcing: {(kernel, method, smooth): step}
_JAX_STEPS = {}


def _traced_stages(jrkc, s):
    """A context in which the JAX package's choose_stages returns s (a
    traced int32): the JAX RKC steps pick s themselves from h and rho."""
    import contextlib

    @contextlib.contextmanager
    def pinned():
        saved = jrkc.choose_stages
        jrkc.choose_stages = lambda h, r: s
        try:
            yield
        finally:
            jrkc.choose_stages = saved
    return pinned()


def _jax_box_step(kernel, method, smooth):
    """step(y, t, seg_end, h, s) -> (y_new, err_ss): one forced step of the
    JAX K6 (`method`) or K7 (at stage count s) in interpret mode on the box
    of BOX with a freeze, jitted once for every t, h and s."""
    import jax
    import jax.numpy as jnp

    from crdmodel_tpu.integrate import erk as jerk
    from crdmodel_tpu.integrate import rkc as jrkc
    from crdmodel_tpu.ops import pallas_box3d, pallas_box3d_rkc
    key = (kernel, method, smooth)
    if key in _JAX_STEPS:
        return _JAX_STEPS[key]
    _, jp = _problems(dict(BOX, t_boundary=T_BOUNDARY, method=method),
                      smooth)
    if kernel == "K6":
        fs = pallas_box3d.build_fused_box3d_step(
            jp, jerk.TABLEAUS[method], jnp.float32, interpret=True)
    else:
        fs = pallas_box3d_rkc.build_fused_box3d_rkc_step(
            jp, jnp.float32, interpret=True)

    @jax.jit
    def run(y, t, seg_end, h, s):
        with _traced_stages(jrkc, s):
            out = fs.step_err(t, fs.pad(y), h,
                              {**jp.params, "_seg_end": seg_end})
        return fs.unpad(out[0]), out[1]

    def step(y_np, t, seg_end, h, s=2):
        y_new, ss = run(jnp.asarray(y_np), jnp.float32(t),
                        jnp.float32(seg_end), jnp.float32(h), jnp.int32(s))
        return np.asarray(y_new), float(ss)
    _JAX_STEPS[key] = step
    return step


def _port_box_step(tp, kernel, method, y_np, t, h, seg_end):
    """The same step through the port's plain K6 or K7 (build_fused_*'s
    step_err, the amplitudes computed as a run computes them)."""
    if kernel == "K6":
        step_err = f6.build_fused_box3d_step(tp, TABLEAUS[method])
    else:
        step_err = f7.build_fused_box3d_rkc_step(tp).step_err
    out = step_err(torch.tensor(t), torch.tensor(y_np), torch.tensor(h),
                   {**tp.params, "_seg_end": torch.tensor(seg_end)})
    return out[0].numpy(), float(out[1])


# (kernel, method or stage count, smooth): the step cases
STEP_CASES = {"K6_bs32": ("K6", "bs32", True),
              "K6_dopri54": ("K6", "dopri54", True),
              **{f"K7_gated_s{s}": ("K7", s, False) for s in K7_STAGES},
              **{f"K7_smooth_s{s}": ("K7", s, True) for s in K7_STAGES}}
# each kernel's limits: y relative to the state's scale, the WRMS floor
STEP_LIMITS = {"K6": (2e-6, 5e-5), "K7": (4e-6, 2e-3), "K12": (5e-6, 5e-5),
               "K13": (1e-5, 2e-3)}


def _variant(kernel, variant, monkeypatch):
    """(method, h, s) of a step case; pins the port's choose_stages to an
    RKC case's s."""
    if kernel in ("K6", "K12"):
        return variant, H, 2
    monkeypatch.setattr(trkc, "choose_stages",
                        lambda h, r: torch.tensor(variant,
                                                  dtype=torch.int32))
    return "rkc2", _h_for(variant), variant


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_plain_forced_step_matches_jax_kernel(name, monkeypatch):
    """One forced step of K6's or K7's plain version against the JAX kernel
    in interpret mode in each window (in a pulse and out of it, frozen and
    not), within the kernels' own tests' limits."""
    kernel, variant, smooth = STEP_CASES[name]
    method, h, s = _variant(kernel, variant, monkeypatch)
    tp, _ = _problems(dict(BOX, t_boundary=T_BOUNDARY, method=method),
                      smooth)
    y_np = _state(tp.cfg)
    scale = float(np.abs(y_np).max())
    y_lim, floor = STEP_LIMITS[kernel]
    jax_step = _jax_box_step(kernel, method, smooth)
    for t, seg in WINDOWS.values():
        got, ss = _port_box_step(tp, kernel, method, y_np, t, h, seg)
        want, ss_want = jax_step(y_np, t, seg, h, s)
        assert np.max(np.abs(got - want)) <= y_lim * scale
        _wrms_close(ss, ss_want, y_np.size, floor)


def _port_shard_step(tp, kernel, method, shape, y_np, t, h, seg_end):
    """One forced sharded step of the port's K12 (`method`) or K13 through
    the plain versions: (y_new, err sum)."""
    cfg = tp.cfg
    mesh = _mesh(shape)
    if kernel == "K12":
        fused = f12.build_fused_shard_box3d(tp, TABLEAUS[method], mesh)
    else:
        fused = f13.build_fused_shard_box3d_rkc(
            tp, mesh, sharded_rho_bound(tp, mesh))
    y = split_state(torch.tensor(y_np), mesh, None, cfg)
    params = {**shard_params(sharded_params(tp), mesh, None, cfg),
              "_seg_end": torch.tensor(seg_end)}
    out = fused.step_err(torch.tensor(t), fused.pad(y), torch.tensor(h),
                         params)
    return (gather(fused.unpad(out[0]), mesh).numpy(),
            float(make_reduce(mesh)(out[1])))


def _jax_shard_step(kernel, method, smooth, shape):
    """step(y, t, seg_end, h, s) -> (y_new, psum'd error sum): the same
    step through the JAX K12 (`method`) or K13 in interpret mode under
    shard_map (K13's rho pmax'd), jitted once for every t, h and s."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from crdmodel_tpu.integrate import rkc as jrkc
    from crdmodel_tpu.parallel import sharded as jsh
    from crdmodel_tpu.parallel.mesh import AXIS_X, AXIS_Y
    from crdmodel_tpu.parallel.mesh import make_mesh as jmake_mesh
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    key = (kernel, method, smooth, shape)
    if key in _JAX_STEPS:
        return _JAX_STEPS[key]
    _, jp = _problems(dict(BOX, t_boundary=T_BOUNDARY, method=method),
                      smooth)
    mesh = jmake_mesh(shape=shape)
    f32 = jnp.float32
    if kernel == "K12":
        fused = jsh.maybe_fused_shard_box3d(jp, mesh, interpret=True)
    else:
        rho = _jax_rho(jp, f32, lambda x: lax.pmax(x, (AXIS_Y, AXIS_X)))
        fused = jsh.maybe_fused_shard_rkc(jp, mesh, rho, interpret=True)
    assert fused is not None
    params, specs = jsh.sharded_params(jp, None)

    def local(y, params, t, seg_end, h, s):
        p = fused.prepare_params({**params, "_seg_end": seg_end})
        with _traced_stages(jrkc, s):
            out = fused.step_err(t, fused.pad(y), h, p)
        return fused.unpad(out[0]), lax.psum(jnp.sum(out[1]),
                                             (AXIS_Y, AXIS_X))

    state = P(None, None, AXIS_Y, AXIS_X)
    fn = jax.jit(jax.shard_map(local, mesh=mesh,
                               in_specs=(state, specs, P(), P(), P(), P()),
                               out_specs=(state, P()), check_vma=False))

    def step(y_np, t, seg_end, h, s=2):
        y_new, ss = fn(jnp.asarray(y_np), params, f32(t), f32(seg_end),
                       f32(h), jnp.int32(s))
        return np.asarray(y_new), float(ss)
    _JAX_STEPS[key] = step
    return step


# (kernel, method or stage count, smooth, windows): the sharded step cases
SHARD_CASES = {
    "K12_bs32": ("K12", "bs32", True, ("in_pulse_frozen", "off_pulse")),
    "K12_dopri54": ("K12", "dopri54", True, ("in_pulse", "off_pulse_frozen")),
    **{f"K13_gated_s{s}": ("K13", s, False, ("in_pulse", "in_pulse_frozen"))
       for s in K7_STAGES},
    **{f"K13_smooth_s{s}": ("K13", s, True, ("in_pulse_frozen", "off_pulse"))
       for s in K7_STAGES}}


@pytest.mark.parametrize("name", sorted(SHARD_CASES))
def test_plain_forced_shard_step_matches_jax_kernel(name, monkeypatch):
    """One forced step of K12's or K13's plain version on a 2x2 mesh of
    CPU shards against the JAX kernel in interpret mode under shard_map,
    frozen and not, within the kernels' own tests' limits."""
    kernel, variant, smooth, windows = SHARD_CASES[name]
    method, h, s = _variant(kernel, variant, monkeypatch)
    tp, _ = _problems(dict(BOX, t_boundary=T_BOUNDARY, method=method),
                      smooth)
    y_np = _state(tp.cfg, seed=11)
    scale = float(np.abs(y_np).max())
    y_lim, floor = STEP_LIMITS[kernel]
    jax_step = _jax_shard_step(kernel, method, smooth, (2, 2))
    for window in windows:
        t, seg = WINDOWS[window]
        got, ss = _port_shard_step(tp, kernel, method, (2, 2), y_np, t, h,
                                   seg)
        want, ss_want = jax_step(y_np, t, seg, h, s)
        assert np.max(np.abs(got - want)) <= y_lim * scale
        _wrms_close(ss, ss_want, y_np.size, floor)


@pytest.mark.parametrize("mesh_shape", [None, (2, 2)],
                         ids=["one_device", "2x2"])
@pytest.mark.parametrize("method", ["bs32", "rkc2"])
def test_forced_run_through_plain_kernel_matches_xla(method, mesh_shape):
    """A forced run through the plain box kernel (K6, K7; on a 2x2 mesh of
    CPU shards K12, K13) against the JAX package's XLA path on the same
    problem: every step through the kernel, a step gap of at most 1 an
    interval, trajectories within 1e-4 (tests/test_forcing.py:644-696)."""
    import jax

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild
    from crdmodel_tpu.parallel.mesh import make_mesh as jmake_mesh
    from crdmodel_tpu.parallel.sharded import simulate_sharded as jsim
    from crdmodel_tpu.sim import simulate as jsimulate
    kw = dict(BOX, method=method)
    tp, _ = _problems(kw)
    jkw = {**kw, "use_pallas": False}
    jp = jbuild(JSimConfig(**jkw), forcing=_forcing(_stimuli(tp.cfg), True))
    kernel = (f6.fused_box3d_step if method == "bs32"
              else f7.fused_box3d_rkc_step)
    if mesh_shape is None:
        jres = jsimulate(JSimConfig(**jkw), problem=jp)
        tres = simulate(tp.cfg, "cpu", problem=tp)
        assert fused_eligible(tp)
    else:
        if len(jax.devices()) < 8:
            pytest.skip("needs the 8 virtual CPU devices of "
                        "tests/conftest.py")
        jres = jsim(JSimConfig(**jkw), mesh=jmake_mesh(shape=mesh_shape),
                    problem=jp)
        mesh = _mesh(mesh_shape)
        want = "K12" if method == "bs32" else "K13"
        assert select_shard_kernel(tp, mesh, None,
                                   sharded_rho_bound(tp, mesh))[0] == want
        tres = simulate_sharded(tp.cfg, mesh=mesh, problem=tp)
    assert tres.ok and tres.fused
    assert kernel.launches == 0      # the plain version: no kernel here
    assert bool(np.all(np.asarray(jres.stats.status) == 0))
    gap = np.abs(tres.stats.steps.numpy() - np.asarray(jres.stats.steps))
    assert gap.max() <= 1, gap
    np.testing.assert_allclose(tres.trajectory.numpy(),
                               np.asarray(jres.trajectory), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("forcing", ["rank1_zprof", "full_field",
                                     "free_form"])
@pytest.mark.parametrize("method", ["bs32", "dopri54", "rkc2"])
def test_gates_match_jax(method, forcing):
    """The box gates (K6 or K7 on one device; select_shard_kernel's K12 or
    K13 on a 2x2 mesh) take a forcing exactly where the JAX gates
    (is_box3d_supported, is_box3d_rkc_supported, maybe_fused_shard_box3d,
    maybe_fused_shard_rkc) take it: rank-1 stimuli with or without a depth
    profile; neither a full-field stimulus nor a free-form forcing."""
    import jax.numpy as jnp

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core import forcing as jf
    from crdmodel_tpu.core.problem import build_problem as jbuild
    from crdmodel_tpu.integrate import erk as jerk
    from crdmodel_tpu.ops.pallas_box3d import is_box3d_supported
    from crdmodel_tpu.ops.pallas_box3d_rkc import is_box3d_rkc_supported
    from crdmodel_tpu.parallel import sharded as jsh
    from crdmodel_tpu.parallel.mesh import make_mesh as jmake_mesh
    kw = dict(BOX, method=method)
    cfg, jcfg = SimConfig(**kw), JSimConfig(**kw)
    field = np.random.default_rng(5).random((cfg.nz, cfg.ny, cfg.nx))
    if forcing == "rank1_zprof":
        tfrc = _forcing(_stimuli(cfg), False)
        jfrc = _forcing(_stimuli(cfg), True)
    elif forcing == "full_field":
        tfrc = tforcing.SeparableForcing(tforcing.Stimulus(
            waveform=tforcing.pulse_train([0.1], 0.2, 2.0), spatial=field))
        jfrc = jf.SeparableForcing(jf.Stimulus(
            waveform=jf.pulse_train([0.1], 0.2, 2.0), spatial=field))
    else:
        def tfrc(t, state, params):
            return torch.zeros_like(state)

        def jfrc(t, state, params):
            return 0.0 * state
    tp = build_problem(cfg, "cpu", forcing=tfrc)
    jp = jbuild(jcfg, forcing=jfrc)
    if method == "rkc2":
        got = f7.is_box3d_rkc_supported(tp, torch.float32)
        want = is_box3d_rkc_supported(jp, jnp.float32)
    else:
        got = f6.is_box3d_supported(tp, TABLEAUS[method], torch.float32)
        want = is_box3d_supported(jp, jerk.TABLEAUS[method], jnp.float32)
    assert got == want == (forcing == "rank1_zprof")
    mesh, jmesh = _mesh((2, 2)), jmake_mesh(shape=(2, 2))
    name, _ = select_shard_kernel(tp, mesh, None,
                                  sharded_rho_bound(tp, mesh))
    if method == "rkc2":
        rho = _jax_rho(jp, jnp.float32, lambda x: x)
        jgate = jsh.maybe_fused_shard_rkc(jp, jmesh, rho, interpret=True)
        kernel = "K13"
    else:
        jgate = jsh.maybe_fused_shard_box3d(jp, jmesh, interpret=True)
        kernel = "K12"
    assert (name == kernel) == (jgate is not None) == (
        forcing == "rank1_zprof")
    if name != kernel:
        assert name is None


# ---------------------------------------------------------------------------
# On the card: each forced box kernel bitwise its plain version


def _cuda_problem(kw, smooth=True):
    cfg = SimConfig(**kw)
    frc = _forcing(_stimuli(cfg, smooth, cross=True), False)
    return frc, build_problem(cfg, "cuda", forcing=frc)


def _cuda_windows(dtype):
    return [tuple(torch.tensor(v, dtype=dtype, device="cuda") for v in w)
            for w in (WINDOWS["in_pulse_frozen"], WINDOWS["in_pulse"])]


def _assert_forced_trace(fn, tag):
    from crdmodel_tpu_torch.ops import trace
    names = trace.kernel_names(fn)
    mine = [n for n in names if tag in n]
    assert mine and all("StimTable" in n for n in mine), names


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs an NVIDIA GPU and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_cuda_forced_box_kernel_bitwise(name, dtype):
    """K6 or K7 with a forcing on both variables on a 6x40x24 box (tiles
    that do not divide it), in a pulse frozen and released: y_new and
    every partial sum bitwise the plain version's (the stream schemes'
    tile sums; the persistent schemes' totals to rounding), two launches
    equal, the launch the forced instantiation."""
    from crdmodel_tpu_torch.ops import box_stream
    from crdmodel_tpu_torch.ops.fused_rkc import (stage_times_amplitudes,
                                                  stage_times_table,
                                                  static_stage_tables)
    from crdmodel_tpu_torch.ops.kernel_common import (prepare_box_constants,
                                                      stage_amplitudes)
    kernel, variant, smooth = STEP_CASES[name]
    kw = dict(BOX, x_mesh=24, y_mesh=40, z_mesh=6, surface_width=12.0,
              surface_length=20.0, surface_depth=3.0,
              t_boundary=T_BOUNDARY, method="rkc2" if kernel == "K7"
              else variant)
    frc, p = _cuda_problem(kw, smooth)
    bc = prepare_box_constants(p, dtype, "cuda")
    stim = prepare_stim_constants(p, dtype, "cuda")
    y = torch.tensor(_state(p.cfg), dtype=dtype, device="cuda")
    for t, seg in _cuda_windows(dtype):
        fzt = freeze_scalar({"_seg_end": seg}, bc.has_freeze, T_BOUNDARY,
                            dtype)
        if kernel == "K6":
            tab = TABLEAUS[variant]
            h = torch.tensor(H, dtype=dtype, device="cuda")
            amps = stage_amplitudes(frc, t, h, torch.tensor(
                tab.c, dtype=dtype, device="cuda"), {"_seg_end": seg}, dtype)
            args = (y, h, fzt, bc, tab, 1e-4, 1e-6, stim, amps)
            step, ref = f6.fused_box3d_step, f6.fused_box3d_step_reference
            sums = (f6.fused_box3d_tile_sums
                    if box_stream.uses_stream(tab) else None)
            tag = box_stream.kernel_name(tab)
        else:
            mu1, ctab = static_stage_tables(f7.C_RKC, dtype, "cuda")
            h = torch.tensor(_h_for(variant), dtype=dtype, device="cuda")
            st = torch.tensor(variant, dtype=torch.int32, device="cuda")
            amps = stage_times_amplitudes(
                frc, t, h, st, stage_times_table(f7.C_RKC, dtype, "cuda"),
                {"_seg_end": seg}, dtype)
            assert amps.shape[1] == (f7.C_RKC + 2 if smooth else 1)
            args = (y, h, fzt, st, mu1, ctab, bc, 1e-4, 1e-6, stim, amps)
            step = f7.fused_box3d_rkc_step
            ref = f7.fused_box3d_rkc_step_reference
            sums = (f7.fused_box3d_rkc_tile_sums
                    if box_stream.rkc_uses_stream(bc.kind) else None)
            tag = box_stream.rkc_kernel_name(bc.kind)
        _assert_forced_trace(lambda: step(*args), tag)
        y_k, ss_k = step(*args)
        y_k2, ss_k2 = step(*args)
        y_r, ss_r = ref(*args)
        assert torch.equal(y_k, y_k2) and torch.equal(ss_k, ss_k2)
        assert torch.equal(y_k, y_r)
        if sums is not None:
            assert torch.equal(ss_k, sums(*args))
        else:
            assert abs(float(ss_k.sum()) - float(ss_r.sum())) <= (
                1e-5 if dtype == torch.float32 else 1e-12) * float(ss_r.sum())


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs an NVIDIA GPU and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_cuda_forced_shard_box_kernel_bitwise(name, dtype):
    """K12 or K13 with a forcing on both variables on every shard of a 2x2
    mesh of a 6x40x34 box (the last column of blocks holding mirror-pad
    cells), in a pulse frozen and released: y_new's block and every
    partial sum bitwise the plain version's (the persistent schemes'
    totals to rounding), two launches equal, the forced instantiation."""
    from crdmodel_tpu_torch.ops import box_stream
    from crdmodel_tpu_torch.ops.fused_rkc import (stage_times_amplitudes,
                                                  stage_times_table,
                                                  static_stage_tables)
    from crdmodel_tpu_torch.ops.kernel_common import (
        make_shard_box_constants, stage_amplitudes)
    from crdmodel_tpu_torch.parallel.halo import mirror_halo_pad
    kernel, variant, smooth = STEP_CASES[name]
    kw = dict(BOX, x_mesh=33, y_mesh=40, z_mesh=6, surface_width=16.5,
              surface_length=20.0, surface_depth=3.0,
              t_boundary=T_BOUNDARY, method="rkc2" if kernel == "K7"
              else variant)
    frc, p = _cuda_problem(kw, smooth)
    mesh = _mesh((2, 2), "cuda")
    pad = mesh_pad_spec(p.cfg, mesh)
    consts = make_shard_box_constants(p, mesh, pad, f12.HALO, dtype)
    stims = prepare_shard_stim_constants(p, mesh, pad, f12.HALO, dtype)
    y = torch.tensor(_state(p.cfg), dtype=dtype, device="cuda")
    bufs = mirror_halo_pad(list(split_state(y, mesh, pad, p.cfg)), mesh,
                           f12.HALO, pad)
    inner = f12.interior
    for t, seg in _cuda_windows(dtype):
        fzt = freeze_scalar({"_seg_end": seg}, consts[0].has_freeze,
                            T_BOUNDARY, dtype)
        if kernel == "K6":
            tab = TABLEAUS[variant]
            h = torch.tensor(H, dtype=dtype, device="cuda")
            amps = stage_amplitudes(frc, t, h, torch.tensor(
                tab.c, dtype=dtype, device="cuda"), {"_seg_end": seg}, dtype)

            def make(buf, sc, stim):
                return (buf, h, fzt, sc, tab, 1e-4, 1e-6, stim, amps)
            step = f12.fused_shard_box3d_step
            ref = f12.fused_shard_box3d_step_reference
            sums = (f12.fused_shard_box3d_tile_sums
                    if box_stream.uses_stream(tab) else None)
            tag = box_stream.kernel_name(tab, shard=True)
        else:
            mu1, ctab = static_stage_tables(f13.C_RKC, dtype, "cuda")
            h = torch.tensor(_h_for(variant), dtype=dtype, device="cuda")
            st = torch.tensor(variant, dtype=torch.int32, device="cuda")
            amps = stage_times_amplitudes(
                frc, t, h, st, stage_times_table(f13.C_RKC, dtype, "cuda"),
                {"_seg_end": seg}, dtype)

            def make(buf, sc, stim):
                return (buf, h, fzt, st, mu1, ctab, sc, 1e-4, 1e-6, stim,
                        amps)
            step = f13.fused_shard_box3d_rkc_step
            ref = f13.fused_shard_box3d_rkc_step_reference
            sums = (f13.fused_shard_box3d_rkc_tile_sums
                    if box_stream.rkc_uses_stream(consts[0].kind) else None)
            tag = box_stream.rkc_kernel_name(consts[0].kind, shard=True)
        first = make(bufs[0], consts[0], stims[0])
        _assert_forced_trace(lambda: step(*first), tag)
        for buf, sc, stim in zip(bufs, consts, stims):
            args = make(buf, sc, stim)
            y_k, ss_k = step(*args)
            y_k2, ss_k2 = step(*args)
            y_r, ss_r = ref(*args)
            halo = sc.halo
            assert torch.equal(inner(y_k, halo), inner(y_k2, halo))
            assert torch.equal(ss_k, ss_k2)
            assert torch.equal(inner(y_k, halo), inner(y_r, halo))
            if sums is not None:
                assert torch.equal(ss_k, sums(*args))
            else:
                assert abs(float(ss_k.sum()) - float(ss_r.sum())) <= (
                    1e-5 if dtype == torch.float32 else 1e-12) * float(
                        ss_r.sum())
