"""The shard kernels with a structured forcing: K8 (ops/fused_shard_step.py),
K9 (ops/fused_shard_rkc.py), K10 (ops/fused_shard_imex.py) and K11
(ops/fused_shard_divform.py, both modes), against the JAX package's
(crdmodel_tpu/ops/pallas_shard_*.py).

On the CPU: one forced sharded step through each kernel's plain version
against the JAX kernel in interpret mode under shard_map on its 8 virtual
devices, f32, from a numpy-seeded state, in a pulse and out of it, with
the limits of the kernels' own tests (tests/test_torch_fused_shard_*.py:
y on the physical cells to 2e-5 of the state's scale, the error sum to
1e-3 relative; K10 y to 2e-6 and the sum to 1e-4); K9 gated (pulse trains:
one amplitude column) and smooth (a column a Chebyshev stage time) at
stage counts around its chunk boundaries; whole forced runs through the
plain kernels against the JAX XLA sharded path (a step gap of at most 1 an
interval, trajectories within 1e-4, 1e-3 for ark324: tests/
test_forcing.py's limits); the kernel selection against the JAX package's
maybe_fused_shard_* for rank-1, full-field and free-form forcings. On a
CUDA card (marker `cuda`): each forced kernel against its plain version on
every shard, even and mirror-padded meshes, f32 and f64, y_new's block and
every partial sum bitwise:

    python -m pytest tests/test_torch_forcing_mesh_kernels.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.core import forcing as tforcing
from crdmodel_tpu_torch.core.problem import build_problem
from crdmodel_tpu_torch.integrate.erk import TABLEAUS
from crdmodel_tpu_torch.ops import fused_shard_divform as f11
from crdmodel_tpu_torch.ops import fused_shard_imex as f10
from crdmodel_tpu_torch.ops import fused_shard_rkc as f9
from crdmodel_tpu_torch.ops import fused_shard_step as f8
from crdmodel_tpu_torch.parallel.mesh import make_mesh
from crdmodel_tpu_torch.parallel.sharded import (gather, make_reduce,
                                                 mesh_pad_spec,
                                                 select_shard_kernel,
                                                 shard_params,
                                                 sharded_params,
                                                 sharded_rho_bound,
                                                 simulate_sharded,
                                                 split_state)

TORUS = dict(model="fhn", surface="torus", x_mesh=32, surface_width=20.0,
             surface_length=40.0, t_final=0.5, output_timestep=5, beta=1.25,
             beta_min=0.7, beta_max=1.7, vary_beta=1, t_boundary=0.1,
             dtype="float32", rtol=1e-4, atol=1e-6, use_pallas=True)
FLAT = dict(TORUS, surface="flat", vary_beta=0, surface_width=10.0,
            surface_length=20.0)
AP = dict(FLAT, model="aliev_panfilov", beta=0.1, boundary="noflux",
          wave_length=0.25, wave_width=0.5)
GB = dict(TORUS, model="goldbeter", beta=0.4, vary_beta=0, method="ark324",
          wave_inside=1, wave_length=0.2, rtol=1e-5, atol=1e-7)
# the paced protocol (tests/test_torch_forcing.py::protocol): pulses on
# [0.05, 0.2) and [0.45, 0.6) on a row band (variable 0), a smooth drive
# on a Gaussian column band (variable 1)
PULSES = ([0.05, 0.45], 0.15, 1.5)
# (t, seg_end) of a step in the first pulse and of one between the pulses
WINDOWS = {"in_pulse": (0.1, 0.15), "off_pulse": (0.25, 0.3)}


def _scar(cfg):
    mask = np.ones((cfg.ny, cfg.nx), bool)
    mask[20:30, 10:18] = False
    return dict(obstacle_mask=mask)


def _fibres(cfg):
    th = np.broadcast_to(np.linspace(0.0, np.pi / 3, cfg.nx)[None, :],
                         (cfg.ny, cfg.nx))
    c, s = np.cos(th), np.sin(th)
    return dict(diffusion_tensor=(1.0 * c * c + 0.2 * s * s,
                                  1.0 * s * s + 0.2 * c * c, 0.8 * c * s))


def _stimuli(cfg, smooth=True):
    """The paced protocol's data; without `smooth`, its pulse train only
    (every stimulus segment-gated: K9's one amplitude column)."""
    band = tforcing.rect_profile(cfg.ny, 0, cfg.ny // 4)
    gauss = tforcing.gaussian_profile(cfg.nx, cfg.nx / 2, cfg.nx / 8)
    out = [dict(var=0, row=band, pulses=PULSES)]
    if smooth:
        out.append(dict(var=1, col=gauss, wave="cos"))
    return out


def _forcing(stimuli, jax_side):
    if jax_side:
        import jax.numpy as jnp

        from crdmodel_tpu.core import forcing as jf
        return jf.SeparableForcing(*(jf.Stimulus(
            waveform=(jf.pulse_train(*st["pulses"]) if "pulses" in st
                      else lambda t: 0.4 * jnp.cos(3.0 * t)),
            var=st["var"], row=st.get("row"), col=st.get("col"))
            for st in stimuli))
    from crdmodel_tpu_torch.convert import forcing_from_numpy
    return forcing_from_numpy([
        {k: v for k, v in st.items() if k != "wave"}
        if "pulses" in st else
        dict(var=st["var"], row=st.get("row"), col=st.get("col"),
             waveform=lambda t, seg_end=None: 0.4 * torch.cos(3.0 * t))
        for st in stimuli])


# name: (kernel, config keywords, build(cfg), mesh shape, smooth); the
# ERK kernels' h: K8 0.1 (tests/test_torch_fused_shard_step.py's H), K11
# 0.01, K10 0.01; K9's from the stage count
KERNEL_CASES = {
    "K8_torus_2x2": ("K8", TORUS, None, (2, 2), True),
    "K8_flat_uneven_1x3": ("K8", dict(FLAT, x_mesh=28), None, (1, 3), True),
    "K10_goldbeter_2x2": ("K10", GB, None, (2, 2), True),
    "K11_noflux_scar_2x2": ("K11", AP, _scar, (2, 2), True),
    "K11_aniso_torus_2x2": ("K11 aniso", dict(TORUS, beta=1.25), _fibres,
                            (2, 2), True),
}
H = {"K8": 0.1, "K10": 0.01, "K11": 0.01, "K11 aniso": 0.01}


def _mesh(shape, device="cpu"):
    return make_mesh(shape=shape, devices=[device] * (shape[0] * shape[1]))


def _state(cfg, y0, seed=7):
    rng = np.random.default_rng(seed)
    if cfg.model == "goldbeter":
        return y0 + 0.05 * rng.standard_normal(y0.shape)
    lo, hi = (0.0, 1.0) if cfg.model == "aliev_panfilov" else (-2.0, 2.0)
    return rng.uniform(lo, hi, y0.shape)


def _port_kernel(kernel, problem, mesh, pad):
    method = problem.cfg.method
    if kernel == "K8":
        return f8.build_fused_shard_step(problem, TABLEAUS[method], mesh, pad)
    if kernel == "K10":
        return f10.build_fused_shard_imex(problem, mesh, pad)
    if kernel == "K9":
        return f9.build_fused_shard_rkc(
            problem, mesh, sharded_rho_bound(problem, mesh, pad), pad)
    return f11.build_fused_shard_divform(problem, TABLEAUS[method], mesh, pad,
                                         aniso=kernel == "K11 aniso")


def port_step(kernel, kw, build_kw, stimuli, shape, y_np, t, h, seg_end):
    """One forced step of the port's sharded kernel path through the plain
    versions: (physical y_new, err sum)."""
    cfg = SimConfig(**kw)
    problem = build_problem(cfg, "cpu", forcing=_forcing(stimuli, False),
                            **build_kw)
    mesh = _mesh(shape)
    pad = mesh_pad_spec(cfg, mesh)
    fused = _port_kernel(kernel, problem, mesh, pad)
    f32 = torch.float32
    y = split_state(torch.tensor(y_np, dtype=f32), mesh, pad, cfg)
    params = {**shard_params(sharded_params(problem, pad), mesh, pad, cfg),
              "_seg_end": torch.tensor(seg_end, dtype=f32)}
    out = fused.step_err(torch.tensor(t, dtype=f32), fused.pad(y),
                         torch.tensor(h, dtype=f32), params)
    return (gather(fused.unpad(out[0]), mesh, pad).numpy(),
            float(make_reduce(mesh)(out[1])))


def jax_step(kernel, kw, build_kw, stimuli, shape, y_np, t, h, seg_end):
    """The same step through the JAX package's kernel in interpret mode
    under shard_map (K9's rho pmax'd): (physical y_new, psum'd error
    sum). Its blocks may be taller (8-row rounding), so only physical
    cells compare."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild
    from crdmodel_tpu.core.problem import make_rho_bound as jrho
    from crdmodel_tpu.parallel import sharded as jsh
    from crdmodel_tpu.parallel.mesh import AXIS_X, AXIS_Y
    from crdmodel_tpu.parallel.mesh import make_mesh as jmake_mesh
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    cfg = JSimConfig(**kw)
    jp = jbuild(cfg, forcing=_forcing(stimuli, True), **build_kw)
    mesh = jmake_mesh(shape=shape)
    pad = jsh.mesh_pad_spec(cfg, mesh)
    f32 = jnp.float32
    if kernel == "K9":
        rho = jrho(cfg, jp.model, jp.geometry, f32,
                   max_reduce=lambda x: lax.pmax(x, (AXIS_Y, AXIS_X)))
        if pad is not None:
            rho = jsh._mask_rho(rho)
        fused = jsh.maybe_fused_shard_rkc(jp, mesh, rho, interpret=True,
                                          pad_spec=pad)
    else:
        maybe = {"K8": jsh.maybe_fused_shard_step,
                 "K10": jsh.maybe_fused_shard_imex,
                 "K11": jsh.maybe_fused_shard_divform,
                 "K11 aniso": jsh.maybe_fused_shard_aniso}[kernel]
        fused = maybe(jp, mesh, interpret=True, pad_spec=pad)
    assert fused is not None
    params, specs = jsh.sharded_params(jp, pad)

    def local(y, params):
        p = fused.prepare_params({**params,
                                  "_seg_end": jnp.asarray(seg_end, f32)})
        out = fused.step_err(jnp.asarray(t, f32), fused.pad(y),
                             jnp.asarray(h, f32), p)
        return fused.unpad(out[0]), lax.psum(jnp.sum(out[1]),
                                             (AXIS_Y, AXIS_X))

    state = P(None, AXIS_Y, AXIS_X)
    fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(state, specs),
                               out_specs=(state, P()), check_vma=False))
    y = pad.pad_field(y_np) if pad is not None else y_np
    y_new, ss = fn(jnp.asarray(y, f32), params)
    return np.asarray(y_new)[:, :cfg.ny, :cfg.nx], float(ss)


def _limits(kernel):
    """(y limit relative to the state's scale, error sum's relative
    limit): the kernels' own tests' f32 limits."""
    return (2e-6, 1e-4) if kernel == "K10" else (2e-5, 1e-3)


def _compare(kernel, kw, build_kw, stimuli, shape, y_np, t, h, seg_end):
    got, ss = port_step(kernel, kw, build_kw, stimuli, shape, y_np, t, h,
                        seg_end)
    want, ss_want = jax_step(kernel, kw, build_kw, stimuli, shape, y_np, t,
                             h, seg_end)
    y_lim, ss_lim = _limits(kernel)
    scale = 1.0 if kernel == "K10" else max(1.0, float(np.abs(y_np).max()))
    assert np.max(np.abs(got - want)) <= y_lim * scale
    assert abs(ss - ss_want) <= ss_lim * ss_want


@pytest.mark.parametrize("window", sorted(WINDOWS))
@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_plain_forced_step_matches_jax_kernel(name, window):
    kernel, kw, build, shape, smooth = KERNEL_CASES[name]
    cfg = SimConfig(**kw)
    build_kw = build(cfg) if build else {}
    y0 = build_problem(cfg, "cpu", **build_kw).y0.numpy()
    y_np = _state(cfg, y0).astype(np.float32)
    t, seg = WINDOWS[window]
    _compare(kernel, kw, build_kw, _stimuli(cfg, smooth), shape, y_np, t,
             H[kernel], seg)


# K9 on the 96x48 torus's 2x2 shards (blocks of 48x24 >= P_RKC): s + 1
# evaluations at 6 (one chunk), 7 (two) and 13 (three)
K9_KW = dict(TORUS, x_mesh=48, method="rkc2")
K9_STAGES = (5, 6, 12)


def _h_for_stages(kw, y_np, s):
    """An h at which choose_stages picks s for the state y_np (rho from
    the port's max-reduced bound), mid-way in s's interval."""
    cfg = SimConfig(**kw)
    problem = build_problem(cfg, "cpu")
    mesh = _mesh((2, 2))
    rho = float(sharded_rho_bound(problem, mesh)(
        torch.tensor(0.0), split_state(torch.tensor(y_np), mesh, None, cfg),
        shard_params(sharded_params(problem), mesh, None, cfg)))
    return 0.65 * ((s - 1.5) ** 2 - 1.0) / rho


@pytest.mark.parametrize("s", K9_STAGES)
@pytest.mark.parametrize("smooth", [False, True], ids=["gated", "smooth"])
def test_plain_forced_k9_step_matches_jax_kernel(smooth, s):
    """K9 at stage counts around its chunk boundaries, in the first pulse:
    the gated table's one column, or the smooth table's columns at the
    Chebyshev stage times of the s every shard runs."""
    cfg = SimConfig(**K9_KW)
    y_np = _state(cfg, np.zeros((2, cfg.ny, cfg.nx))).astype(np.float32)
    h = _h_for_stages(K9_KW, y_np, s)
    t, seg = WINDOWS["in_pulse"]
    _compare("K9", K9_KW, {}, _stimuli(cfg, smooth), (2, 2), y_np, t, h,
             seg)


# whole forced runs through the plain kernels: (kernel, config keywords,
# build, mesh shape, smooth, trajectory limit)
RUN_CASES = {
    "K8_torus_2x2": ("K8", dict(TORUS, t_final=0.8), None, (2, 2), True,
                     1e-4),
    "K8_flat_uneven_2x2": ("K8", dict(FLAT, x_mesh=17, t_final=0.8), None,
                           (2, 2), True, 1e-4),
    "K9_gated_2x2": ("K9", dict(K9_KW, t_final=0.6), None, (2, 2), False,
                     1e-4),
    "K9_smooth_2x2": ("K9", dict(K9_KW, t_final=0.6), None, (2, 2), True,
                      1e-4),
    "K10_goldbeter_2x2": ("K10", dict(GB, t_final=0.3, output_timestep=3),
                          None, (2, 2), True, 1e-3),
    "K11_noflux_scar_2x2": ("K11", dict(AP, t_final=0.6), _scar, (2, 2),
                            True, 1e-4),
    "K11_aniso_torus_2x2": ("K11 aniso", dict(TORUS, t_final=0.4), _fibres,
                            (2, 2), True, 1e-4),
}


@pytest.mark.parametrize("name", sorted(RUN_CASES))
def test_forced_run_through_plain_kernel_matches_xla(name):
    """A forced run through the plain kernel on a mesh of CPU shards
    against the JAX package's XLA sharded path: every step through the
    kernel, a step gap of at most 1 an interval, trajectories within the
    case's limit (tests/test_forcing.py's fused-vs-XLA limits)."""
    import jax

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild
    from crdmodel_tpu.parallel.mesh import make_mesh as jmake_mesh
    from crdmodel_tpu.parallel.sharded import simulate_sharded as jsim
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    kernel, kw, build, shape, smooth, atol = RUN_CASES[name]
    cfg = SimConfig(**kw)
    build_kw = build(cfg) if build else {}
    stimuli = _stimuli(cfg, smooth)
    jcfg = JSimConfig(**{**kw, "use_pallas": False})
    jres = jsim(jcfg, mesh=jmake_mesh(shape=shape), problem=jbuild(
        jcfg, forcing=_forcing(stimuli, True), **build_kw))
    mesh = _mesh(shape)
    problem = build_problem(cfg, "cpu", forcing=_forcing(stimuli, False),
                            **build_kw)
    assert select_shard_kernel(problem, mesh, mesh_pad_spec(cfg, mesh),
                               sharded_rho_bound(problem, mesh))[0] == kernel
    tres = simulate_sharded(cfg, mesh=mesh, problem=problem)
    assert tres.ok and tres.fused
    assert bool(np.all(np.asarray(jres.stats.status) == 0))
    gap = np.abs(tres.stats.steps.numpy() - np.asarray(jres.stats.steps))
    assert gap.max() <= 1, gap
    np.testing.assert_allclose(tres.trajectory.numpy(),
                               np.asarray(jres.trajectory), rtol=0,
                               atol=atol)


# the selection's cases: (config keywords, build, mesh shape)
SELECT_CASES = {"bs32": (TORUS, None), "dopri54": (dict(TORUS,
                                                        method="dopri54"),
                                                   None),
                "rkc2": (K9_KW, None), "ark324": (GB, None),
                "noflux_scar": (AP, _scar), "aniso_torus": (TORUS, _fibres)}


@pytest.mark.parametrize("forcing", ["rank1", "full_field", "free_form"])
@pytest.mark.parametrize("name", sorted(SELECT_CASES))
def test_selection_matches_jax(name, forcing):
    """select_shard_kernel names, for a forced problem, the kernel whose
    JAX gate (maybe_fused_shard_*) takes it: K8, K9, K10, K11 or K11's
    aniso mode for rank-1 stimuli; the torch path, where every JAX gate
    declines, for a full-field or a free-form forcing."""
    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core import forcing as jf
    from crdmodel_tpu.core.problem import build_problem as jbuild
    from crdmodel_tpu.core.problem import make_rho_bound as jrho
    from crdmodel_tpu.parallel import sharded as jsh
    from crdmodel_tpu.parallel.mesh import make_mesh as jmake_mesh
    kw, build = SELECT_CASES[name]
    cfg, jcfg = SimConfig(**kw), JSimConfig(**kw)
    build_kw = build(cfg) if build else {}
    field = np.random.default_rng(5).random((cfg.ny, cfg.nx))
    if forcing == "rank1":
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
    mesh, jmesh = _mesh((2, 2)), jmake_mesh(shape=(2, 2))
    problem = build_problem(cfg, "cpu", forcing=tfrc, **build_kw)
    jp = jbuild(jcfg, forcing=jfrc, **build_kw)
    got, _ = select_shard_kernel(problem, mesh, None,
                                 sharded_rho_bound(problem, mesh))
    rho = jrho(jcfg, jp.model, jp.geometry, np.float32,
               max_reduce=lambda x: x)
    jax_gates = {"K8": jsh.maybe_fused_shard_step(jp, jmesh, interpret=True),
                 "K11": jsh.maybe_fused_shard_divform(jp, jmesh,
                                                      interpret=True),
                 "K11 aniso": jsh.maybe_fused_shard_aniso(jp, jmesh,
                                                          interpret=True),
                 "K10": jsh.maybe_fused_shard_imex(jp, jmesh,
                                                   interpret=True),
                 "K9": jsh.maybe_fused_shard_rkc(jp, jmesh, rho,
                                                 interpret=True)}
    taken = [k for k, v in jax_gates.items() if v is not None]
    assert taken == ([got] if got is not None else [])
    assert (got is None) == (forcing != "rank1")


# ---------------------------------------------------------------------------
# On the card: each forced kernel bitwise its plain version


def _cuda_cases():
    """(kernel, config keywords, build, mesh shape) on an even and a
    mirror-padded mesh for each forced kernel."""
    return [("K8", dict(TORUS, x_mesh=64), None, (2, 2)),
            ("K8", dict(TORUS, x_mesh=37), None, (3, 2)),
            ("K10", dict(GB, x_mesh=64), None, (2, 2)),
            ("K10", dict(GB, x_mesh=50), None, (3, 1)),
            ("K11", dict(AP, x_mesh=64), _scar, (2, 2)),
            ("K11", dict(AP, x_mesh=75), _scar, (1, 3)),
            ("K11 aniso", dict(TORUS, x_mesh=64), _fibres, (2, 2)),
            ("K9", dict(K9_KW, x_mesh=64), None, (2, 2)),
            ("K9", dict(K9_KW, x_mesh=50), None, (3, 1))]


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs an NVIDIA GPU and nvcc")
@pytest.mark.parametrize("smooth", [False, True], ids=["gated", "smooth"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", range(len(_cuda_cases())))
def test_cuda_forced_kernel_bitwise(case, dtype, smooth):
    """A forced kernel on every shard, in the first pulse, frozen and not
    (K9 at s = 2, 6 and 23): y_new's block bitwise the plain version's,
    two launches equal, every partial sum bitwise the plain partial sums
    over the physical cells; the first launch of each stage count runs the
    forced instantiation."""
    from crdmodel_tpu_torch.integrate import imex
    from crdmodel_tpu_torch.ops import trace
    from crdmodel_tpu_torch.ops.fused_rkc import (stage_times_amplitudes,
                                                  static_stage_tables)
    from crdmodel_tpu_torch.ops.kernel_common import (
        make_shard_constants, make_shard_divform_constants,
        prepare_shard_stim_constants, stage_amplitudes)
    from crdmodel_tpu_torch.parallel.halo import mirror_halo_pad

    kernel, kw, build, shape = _cuda_cases()[case]
    cfg = SimConfig(**kw)
    build_kw = build(cfg) if build else {}
    frc = _forcing(_stimuli(cfg, smooth), False)
    problem = build_problem(cfg, "cuda", forcing=frc, **build_kw)
    mesh = _mesh(shape, "cuda")
    pad = mesh_pad_spec(cfg, mesh)
    halo = {"K9": f9.P_RKC, "K10": f10.HALO}.get(kernel, f8.HALO)
    y = torch.tensor(_state(cfg, problem.y0.cpu().numpy()), dtype=dtype,
                     device="cuda")
    bufs = mirror_halo_pad(list(split_state(y, mesh, pad, cfg)), mesh, halo,
                           pad)
    if kernel.startswith("K11"):
        consts = make_shard_divform_constants(
            problem, mesh, pad, halo, dtype, aniso=kernel == "K11 aniso")
    else:
        consts = make_shard_constants(problem, mesh, pad, halo, dtype)
    stims = prepare_shard_stim_constants(problem, mesh, pad, halo, dtype)
    t, seg = (torch.tensor(v, dtype=dtype, device="cuda")
              for v in WINDOWS["in_pulse"])
    params = {"_seg_end": seg}
    p = f8.interior
    if kernel == "K9":
        mu1, ctab, ctimes = static_stage_tables(f9.S_MAX_KERNEL, dtype,
                                                "cuda", with_times=True)
        calls = []
        # a step every stage count stabilizes: the bits are the point
        h = torch.tensor(1e-4, dtype=dtype, device="cuda")
        for s in (2, 6, 23):
            st = torch.tensor(s, dtype=torch.int32, device="cuda")
            amps = stage_times_amplitudes(frc, t, h, st, ctimes, params,
                                          dtype)
            calls.append((f9.fused_shard_rkc_step,
                          f9.fused_shard_rkc_step_reference,
                          f9.fused_shard_rkc_tile_sums,
                          lambda buf, fz, sc, stim, a=amps, st=st:
                          (buf, h, fz, st, mu1, ctab, sc, cfg.rtol,
                           cfg.atol, stim, a)))
        tag = "fused_rkc_chunk_kernel"
    else:
        h = torch.tensor(H[kernel], dtype=dtype, device="cuda")
        if kernel == "K10":
            c = imex.C
            mods = (f10.fused_shard_imex_step,
                    f10.fused_shard_imex_step_reference,
                    f10.fused_shard_imex_tile_sums)
            tag = "fused_imex_slots_kernel"
        else:
            c = TABLEAUS["bs32"].c
            mod, name = ((f8, "fused_shard_step") if kernel == "K8"
                         else (f11, "fused_shard_divform_step"))
            tiles = ("fused_shard_step_tile_sums" if kernel == "K8"
                     else "fused_shard_divform_tile_sums")
            mods = (getattr(mod, name), getattr(mod, name + "_reference"),
                    getattr(mod, tiles))
            tag = "fused_erk_slots_kernel"
        amps = stage_amplitudes(frc, t, h, torch.tensor(
            c, dtype=dtype, device="cuda"), params, dtype)
        if kernel == "K10":
            def make(buf, fz, sc, stim):
                return (buf, h, fz, sc, cfg.rtol, cfg.atol, stim, amps)
        else:
            def make(buf, fz, sc, stim):
                return (buf, h, fz, sc, TABLEAUS["bs32"], cfg.rtol,
                        cfg.atol, stim, amps)
        calls = [(*mods, make)]
    for step, reference, tile_sums, make in calls:
        args = make(bufs[0], torch.zeros((), dtype=dtype, device="cuda"),
                    consts[0], stims[0])
        names = trace.kernel_names(lambda: step(*args))
        mine = [n for n in names if tag in n]
        assert mine and all("StimTable" in n for n in mine), names
        for fz in (0.0, 1.0):
            fzt = torch.tensor(fz, dtype=dtype, device="cuda")
            for buf, sc, stim in zip(bufs, consts, stims):
                args = make(buf, fzt, sc, stim)
                y_k, ss_k = step(*args)
                y_k2, ss_k2 = step(*args)
                y_r, _ = reference(*args)
                sums = tile_sums(*args)
                torch.cuda.synchronize()
                halo = sc.halo
                assert torch.equal(p(y_k, halo), p(y_k2, halo))
                assert torch.equal(ss_k, ss_k2)
                assert torch.equal(p(y_k, halo), p(y_r, halo))
                assert ss_k.shape == sums.shape and torch.equal(ss_k, sums)
