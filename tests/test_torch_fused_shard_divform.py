"""Kernel K11, the fused ERK step of the divergence form, or of the 2-D
diffusion tensor, on one shard of a mesh
(crdmodel_tpu_torch/ops/fused_shard_divform.py).

On the CPU: one sharded step through the kernel's plain version against
the JAX package's K11 run in interpret mode under shard_map on its 8
virtual devices, f32, from a numpy-seeded state, in both modes (no-flux
walls with a scar, a flat 2-D diffusion field, rotating fibres on the flat
surface and on the torus), on even and uneven meshes: physical cells to
2e-5 and the error sum to 1e-3 relative (K8's limits); each mode's plain
version in f64 against a step of the sharded torch path to 1e-12; whole
small runs through the plain K11 against the sharded torch path; the scar
held bitwise at its IC; the mirror-pad invariant of uneven meshes; the
plain partial sums (fused_shard_divform_tile_sums: one a tile of the
block, over the physical cells) against the plain total, and their length
at a 2x2 shard of the bounded tissue and at odd blocks. On a CUDA card
(marker `cuda`): the CUDA kernel against its plain version, y_new's block
bitwise, and every partial sum bitwise the plain version's, on both modes,
an uneven 2x2 mesh with mirror pads on both axes, and each tableau the
gate takes:

    python -m pytest tests/test_torch_fused_shard_divform.py -m cuda --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.core.problem import build_problem
from crdmodel_tpu_torch.integrate.erk import TABLEAUS
from crdmodel_tpu_torch.ops import erk_slots
from crdmodel_tpu_torch.ops import fused_shard_divform as f11
from crdmodel_tpu_torch.parallel.mesh import make_mesh
from crdmodel_tpu_torch.parallel.sharded import (gather, make_reduce,
                                                 mesh_pad_spec, shard_params,
                                                 sharded_params,
                                                 simulate_sharded,
                                                 split_state)

FLAT = dict(model="fhn", surface="flat", x_mesh=32, surface_width=10.0,
            surface_length=20.0, t_final=0.3, output_timestep=2, beta=1.25,
            vary_beta=1, beta_min=0.7, beta_max=1.7, t_boundary=0.2,
            dtype="float32", rtol=1e-5, atol=1e-8, use_pallas=True)
TORUS = dict(FLAT, surface="torus", surface_width=20.0, surface_length=40.0)
AP = dict(FLAT, model="aliev_panfilov", beta=0.1, vary_beta=0,
          boundary="noflux", wave_length=0.25, wave_width=0.5)


def _scar(cfg):
    mask = np.ones((cfg.ny, cfg.nx), bool)
    mask[20:30, 10:18] = False
    return dict(obstacle_mask=mask)


def _field(cfg):
    rng = np.random.default_rng(5)
    return dict(diffusion_field=0.6 + 0.8 * rng.random((cfg.ny, cfg.nx)))


def _fibres(cfg):
    th = np.broadcast_to(np.linspace(0.0, np.pi / 3, cfg.nx)[None, :],
                         (cfg.ny, cfg.nx))
    c, s = np.cos(th), np.sin(th)
    return dict(diffusion_tensor=(1.0 * c * c + 0.2 * s * s,
                                  1.0 * s * s + 0.2 * c * c, 0.8 * c * s))


# name: (config, build, method, aniso mode, h); h = 0.01 inside the
# stages' stability region (rho of the operators here about 100), where a
# step's error stands well above f32 rounding
CASES = {
    "noflux_scar": (AP, _scar, "bs32", False, 0.01),
    "flat_2d_field": (FLAT, _field, "dopri54", False, 0.01),
    "flat_fibres": (FLAT, _fibres, "bs32", True, 0.01),
    "torus_fibres": (TORUS, _fibres, "bs32", True, 0.01),
}


def _case(name, **over):
    kw, build, method, aniso, h = CASES[name]
    kw = {**kw, "method": method, **over}
    return kw, build(SimConfig(**kw)), aniso, h


def _state(cfg, seed=7):
    """A seeded state: Aliev-Panfilov's u in [0, 1], v in [0, 1]; FHN's in
    [-2, 2]."""
    lo, hi = (0.0, 1.0) if cfg.model == "aliev_panfilov" else (-2.0, 2.0)
    return np.random.default_rng(seed).uniform(lo, hi, (2, cfg.ny, cfg.nx))


def _mesh(shape, device="cpu"):
    return make_mesh(shape=shape, devices=[device] * 8)


def port_step(kw, build_kw, aniso, shape, y_np, h, seg_end, dtype):
    """One step of the port's sharded K11 path: (physical y_new, err sum)."""
    cfg = SimConfig(**kw)
    problem = build_problem(cfg, "cpu", **build_kw)
    mesh = _mesh(shape)
    pad = mesh_pad_spec(cfg, mesh)
    fused = f11.build_fused_shard_divform(problem, TABLEAUS[cfg.method],
                                          mesh, pad, aniso=aniso)
    y = split_state(torch.tensor(y_np, dtype=dtype), mesh, pad, cfg)
    params = shard_params(sharded_params(problem, pad), mesh, pad, cfg)
    y_new, ss = fused.step_err(
        torch.tensor(0.0, dtype=dtype), fused.pad(y),
        torch.tensor(h, dtype=dtype),
        {**params, "_seg_end": torch.tensor(seg_end, dtype=dtype)})
    return (gather(fused.unpad(y_new), mesh, pad).numpy(),
            float(make_reduce(mesh)(ss)))


def jax_step(kw, build_kw, aniso, shape, y_np, h, seg_end):
    """The same step through the JAX package's K11 in interpret mode under
    shard_map: (physical y_new, psum'd error sum). Its blocks may be taller
    (8-row rounding), so only physical cells compare."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild
    from crdmodel_tpu.parallel import sharded as jsh
    from crdmodel_tpu.parallel.mesh import AXIS_X, AXIS_Y
    from crdmodel_tpu.parallel.mesh import make_mesh as jmake_mesh
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    cfg = JSimConfig(**kw)
    jp = jbuild(cfg, **build_kw)
    mesh = jmake_mesh(shape=shape)
    pad = jsh.mesh_pad_spec(cfg, mesh)
    maybe = jsh.maybe_fused_shard_aniso if aniso else (
        jsh.maybe_fused_shard_divform)
    fused = maybe(jp, mesh, interpret=True, pad_spec=pad)
    assert fused is not None
    params, specs = jsh.sharded_params(jp, pad)
    f32 = jnp.float32

    def local(y, params):
        p = fused.prepare_params({**params,
                                  "_seg_end": jnp.asarray(seg_end, f32)})
        y_new, ss = fused.step_err(jnp.asarray(0.0, f32), fused.pad(y),
                                   jnp.asarray(h, f32), p)
        return fused.unpad(y_new), lax.psum(jnp.sum(ss), (AXIS_Y, AXIS_X))

    state = P(None, AXIS_Y, AXIS_X)
    fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(state, specs),
                               out_specs=(state, P()), check_vma=False))
    y = pad.pad_field(y_np) if pad is not None else y_np
    y_new, ss = fn(jnp.asarray(y, f32), params)
    return np.asarray(y_new)[:, :cfg.ny, :cfg.nx], float(ss)


@pytest.mark.parametrize("shape", [(2, 2), (3, 1), (1, 3)])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_step_matches_jax_kernel(name, shape):
    kw, build_kw, aniso, h = _case(name)
    y_np = _state(SimConfig(**kw)).astype(np.float32)
    for seg_end in (0.1, 0.3):           # frozen, released
        got, ss = port_step(kw, build_kw, aniso, shape, y_np, h, seg_end,
                            torch.float32)
        want, ss_want = jax_step(kw, build_kw, aniso, shape, y_np, h,
                                 seg_end)
        assert np.max(np.abs(got - want)) <= 2e-5 * max(1.0,
                                                        np.abs(y_np).max())
        assert abs(ss - ss_want) <= 1e-3 * ss_want


@pytest.mark.parametrize("shape", [(2, 2), (3, 1)])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_f64_matches_sharded_torch_path(name, shape):
    """Each mode's plain version in f64 takes the sharded torch path's step
    (make_local_rhs through the ERK stepper) to 1e-12: K11 associates as
    the XLA path does."""
    from crdmodel_tpu_torch.integrate.erk import make_default_step_err
    from crdmodel_tpu_torch.ops.kernel_common import coeff_kind
    from crdmodel_tpu_torch.parallel.sharded import (make_local_rhs,
                                                     tensor_weight,
                                                     with_dxy_halo)
    kw, build_kw, aniso, h = _case(name, dtype="float64")
    y_np = _state(SimConfig(**kw))
    got, ss = port_step(kw, build_kw, aniso, shape, y_np, h, 0.3,
                        torch.float64)
    cfg = SimConfig(**kw)
    problem = build_problem(cfg, "cpu", **build_kw)
    mesh = _mesh(shape)
    pad = mesh_pad_spec(cfg, mesh)
    rhs = make_local_rhs(cfg, problem.model, coeff_kind(cfg.surface), mesh,
                         pad, divergence=problem.diffusion_field is not None,
                         tensor_inv4=tensor_weight(problem),
                         tissue=problem.obstacle_mask is not None)
    step_err, init_carry = make_default_step_err(
        TABLEAUS[cfg.method], rhs, cfg.rtol, cfg.atol)
    params = {**with_dxy_halo(shard_params(sharded_params(problem, pad),
                                           mesh, pad, cfg), mesh, pad),
              "_seg_end": torch.tensor(0.3, dtype=torch.float64)}
    y = split_state(torch.tensor(y_np), mesh, pad, cfg)
    # past tBoundary, as the kernel's released step (fz from _seg_end)
    t = torch.tensor(0.25, dtype=torch.float64)
    y_new, err_ss, _ = step_err(t, y, torch.tensor(h, dtype=torch.float64),
                                params, init_carry(t, y, params))
    want = gather(y_new, mesh, pad).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ss, float(make_reduce(mesh)(err_ss)),
                               rtol=1e-12)


@pytest.mark.parametrize("shape", [(2, 2), (1, 3)])
@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_run_through_plain_kernel(name, shape):
    """A whole small run through the plain K11 takes the sharded torch
    path's steps, fields to f32 rounding; a scar holds its IC bitwise."""
    kw, build_kw, _, _ = _case(name)
    cfg = SimConfig(**kw)
    mesh = _mesh(shape)
    fused = simulate_sharded(cfg, mesh=mesh,
                             problem=build_problem(cfg, "cpu", **build_kw))
    tcfg = dataclasses.replace(cfg, use_pallas=False)
    torch_path = simulate_sharded(tcfg, mesh=mesh, problem=build_problem(
        tcfg, "cpu", **build_kw))
    assert fused.fused and not torch_path.fused and fused.ok
    np.testing.assert_array_equal(fused.stats.steps.numpy(),
                                  torch_path.stats.steps.numpy())
    np.testing.assert_allclose(fused.trajectory.numpy(),
                               torch_path.trajectory.numpy(), rtol=0,
                               atol=1e-6)
    if "obstacle_mask" in build_kw:
        inert = torch.as_tensor(~build_kw["obstacle_mask"])
        held = fused.trajectory[:, :, inert]
        assert torch.equal(held, held[:1].expand_as(held))


def test_mirror_pad_cells_stay_copies():
    """On an uneven mesh the pad cells evolve as bitwise copies of their
    wrapped physical sources, step after step: the coefficient stack's
    halo follows the periodic extension."""
    kw, build_kw, aniso, h = _case("flat_2d_field")
    cfg = SimConfig(**kw)
    problem = build_problem(cfg, "cpu", **build_kw)
    mesh = _mesh((3, 2))
    pad = mesh_pad_spec(cfg, mesh)
    assert pad.y.active and not pad.x.active
    fused = f11.build_fused_shard_divform(problem, TABLEAUS["bs32"], mesh,
                                          pad)
    params = {**shard_params(sharded_params(problem, pad), mesh, pad, cfg),
              "_seg_end": torch.tensor(0.5)}
    yp = fused.pad(split_state(torch.tensor(_state(cfg), dtype=torch.float32),
                               mesh, pad, cfg))
    for _ in range(3):
        yp, _ = fused.step_err(torch.tensor(0.0), yp, torch.tensor(h),
                               params)
        full = gather(fused.unpad(yp), mesh).numpy()
        rows = np.arange(pad.y.n_pad) % cfg.ny
        np.testing.assert_array_equal(full, full[:, rows])
    assert [c.valid_rows for c in fused.constants] == [22, 22, 22, 22, 20, 20]


def test_gate():
    tab = TABLEAUS["bs32"]
    kw, build_kw, _, _ = _case("noflux_scar")
    walls = build_problem(SimConfig(**kw), "cpu", **build_kw)
    assert f11.is_shard_divform_supported(walls, tab, torch.float32, 8, 8)
    assert not f11.is_shard_divform_supported(walls, tab, torch.float32, 7,
                                              64)
    assert not f11.is_shard_divform_supported(walls, tab, torch.float64, 64,
                                              64)
    assert not f11.is_shard_divform_supported(walls, tab, torch.float32, 64,
                                              64, aniso=True)
    profile = build_problem(SimConfig(**FLAT), "cpu")
    assert not f11.is_shard_divform_supported(profile, tab, torch.float32,
                                              64, 64)
    kw, build_kw, _, _ = _case("torus_fibres")
    tensor = build_problem(SimConfig(**kw), "cpu", **build_kw)
    assert f11.is_shard_divform_supported(tensor, tab, torch.float32, 64, 64,
                                          aniso=True)
    assert not f11.is_shard_divform_supported(tensor, tab, torch.float32, 64,
                                              64)


@pytest.mark.parametrize("name", ["noflux_scar", "torus_fibres"])
def test_cpu_wrapper_is_the_plain_version(name):
    kw, build_kw, aniso, h = _case(name)
    cfg = SimConfig(**kw)
    problem = build_problem(cfg, "cpu", **build_kw)
    consts = f11.build_fused_shard_divform(
        problem, TABLEAUS[cfg.method], _mesh((2, 2)), None,
        aniso=aniso).constants
    yp = torch.tensor(_state(cfg)[:, :48, :32], dtype=torch.float32)
    args = (yp, torch.tensor(h), torch.tensor(1.0), consts[0],
            TABLEAUS[cfg.method], cfg.rtol, cfg.atol)
    before = f11.fused_shard_divform_step.launches
    a = f11.fused_shard_divform_step(*args)
    b = f11.fused_shard_divform_step_reference(*args)
    assert f11.fused_shard_divform_step.launches == before
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs an NVIDIA GPU and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(2, 2), (1, 3)])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_version(name, shape, dtype):
    """The CUDA kernel against its plain version on every shard: y_new's
    block bitwise, the error sums to rounding, two launches bitwise."""
    from crdmodel_tpu_torch.ops.fused_shard_step import interior
    from crdmodel_tpu_torch.ops.kernel_common import (
        make_shard_divform_constants)
    from crdmodel_tpu_torch.parallel.halo import mirror_halo_pad

    kw, build_kw, aniso, h = _case(name)
    cfg = SimConfig(**kw)
    problem = build_problem(cfg, "cuda", **build_kw)
    mesh = _mesh(shape, "cuda")
    pad = mesh_pad_spec(cfg, mesh)
    y = torch.tensor(_state(cfg), dtype=dtype, device="cuda")
    bufs = mirror_halo_pad(list(split_state(y, mesh, pad, cfg)), mesh,
                           f11.HALO, pad)
    consts = make_shard_divform_constants(problem, mesh, pad, f11.HALO,
                                          dtype, aniso=aniso)
    for fz in (0.0, 1.0):
        for buf, sc in zip(bufs, consts):
            args = (buf, torch.tensor(h, dtype=dtype, device="cuda"),
                    torch.tensor(fz, dtype=dtype, device="cuda"), sc,
                    TABLEAUS[cfg.method], cfg.rtol, cfg.atol)
            y_k, ss_k = f11.fused_shard_divform_step(*args)
            y_k2, ss_k2 = f11.fused_shard_divform_step(*args)
            y_r, ss_r = f11.fused_shard_divform_step_reference(*args)
            torch.cuda.synchronize()
            p = f11.HALO
            assert torch.equal(interior(y_k, p), interior(y_k2, p))
            assert torch.equal(ss_k, ss_k2)
            assert torch.equal(interior(y_k, p), interior(y_r, p))
            tol = 1e-10 if dtype == torch.float64 else 1e-3
            assert abs(float(ss_k.sum()) - float(ss_r.sum())) <= (
                tol * float(ss_r.sum()))


# an odd grid on a 2x2 mesh: 37x37 in blocks of 19 whose last row and
# column are mirror-pad cells, one partial tile a block
UNEVEN = {"noflux_uneven": (dict(AP, x_mesh=37, surface_length=19.0),
                            lambda cfg: {}, "bs32", False, 0.01)}


def _any_case(name, **over):
    if name in UNEVEN:
        kw, build, method, aniso, h = UNEVEN[name]
        kw = {**kw, "method": method, **over}
        return kw, build(SimConfig(**kw)), aniso, h
    return _case(name, **over)


def _shard_inputs(kw, build_kw, aniso, shape, dtype, device):
    """Every shard's halo-padded buffer of the seeded state, its halo
    exchanged, and its K11 constants."""
    from crdmodel_tpu_torch.ops.kernel_common import (
        make_shard_divform_constants)
    from crdmodel_tpu_torch.parallel.halo import mirror_halo_pad

    cfg = SimConfig(**kw)
    problem = build_problem(cfg, device, **build_kw)
    mesh = _mesh(shape, device)
    pad = mesh_pad_spec(cfg, mesh)
    y = torch.tensor(_state(cfg), dtype=dtype, device=device)
    bufs = mirror_halo_pad(list(split_state(y, mesh, pad, cfg)), mesh,
                           f11.HALO, pad)
    return bufs, make_shard_divform_constants(problem, mesh, pad, f11.HALO,
                                              dtype, aniso=aniso)


@pytest.mark.parametrize("kw,shape,want", [
    (dict(AP, x_mesh=400, surface_length=40.0), (2, 2), 175),
    (dict(AP, x_mesh=101, surface_length=40.0), (2, 2), 14),
    (dict(AP, x_mesh=75, surface_length=40.0), (1, 3), 10)])
def test_shard_partial_sums_one_a_tile(kw, shape, want):
    """The plain partial sums number the kernel's tiles of the block: 175
    at a 2x2 shard (800x200) of the bounded tissue's 1600x400, and the
    partial tiles of odd blocks (202x51, 300x25)."""
    bufs, consts = _shard_inputs(kw, {}, False, shape, torch.float32, "cpu")
    sc = consts[0]
    nyl = bufs[0].shape[1] - 2 * f11.HALO
    nxl = bufs[0].shape[2] - 2 * f11.HALO
    assert -(-nxl // 32) * -(-nyl // 32) == want
    sums = f11.fused_shard_divform_tile_sums(
        bufs[0], torch.tensor(0.01), torch.tensor(0.0), sc,
        TABLEAUS["bs32"], 1e-5, 1e-8)
    assert sums.shape == (want,)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(2, 2), (1, 3)])
@pytest.mark.parametrize("name", sorted(CASES) + sorted(UNEVEN))
def test_shard_tile_sums_add_to_the_plain_total(name, shape, dtype):
    """The plain partial sums of every shard, in the kernel's tile order
    over the physical cells, add up to the plain version's total to
    rounding, for each tableau, frozen and not."""
    kw, build_kw, aniso, h = _any_case(name)
    bufs, consts = _shard_inputs(kw, build_kw, aniso, shape, dtype, "cpu")
    rel = 1e-5 if dtype == torch.float32 else 1e-12
    for method in sorted(TABLEAUS):
        for fz in (0.0, 1.0):
            for buf, sc in zip(bufs, consts):
                args = (buf, torch.tensor(h, dtype=dtype),
                        torch.tensor(fz, dtype=dtype), sc, TABLEAUS[method],
                        kw["rtol"], kw["atol"])
                sums = f11.fused_shard_divform_tile_sums(*args)
                _, total = f11.fused_shard_divform_step_reference(*args)
                np.testing.assert_allclose(float(sums.sum()), float(total),
                                           rtol=rel)


def test_uneven_mesh_pads_both_axes():
    """The uneven case's 2x2 mesh pads both axes: each shard's block is
    19x19, the last shards' last row or column mirror-pad cells."""
    kw, build_kw, aniso, _ = _any_case("noflux_uneven")
    bufs, consts = _shard_inputs(kw, build_kw, aniso, (2, 2),
                                 torch.float32, "cpu")
    assert all(b.shape == (2, 19 + 2 * f11.HALO, 19 + 2 * f11.HALO)
               for b in bufs)
    assert sorted((sc.valid_rows, sc.valid_cols) for sc in consts) == [
        (18, 18), (18, 19), (19, 18), (19, 19)]


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs an NVIDIA GPU and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("method", sorted(TABLEAUS))
@pytest.mark.parametrize("name", sorted(CASES) + sorted(UNEVEN))
def test_cuda_shard_partial_sums_bitwise(name, method, dtype):
    """Both schemes, both modes, on every shard of a 2x2 mesh, frozen and
    not: y_new's block bitwise the plain version's, two launches equal,
    every partial sum bitwise the plain version's over the physical cells
    (fused_shard_divform_tile_sums); the launch runs the kernel the
    dispatch names, and the register-resident kernel's shared bytes are
    slots_plan's."""
    from crdmodel_tpu_torch.ops import trace
    from crdmodel_tpu_torch.ops.fused_shard_step import interior

    kw, build_kw, aniso, h = _any_case(name)
    bufs, consts = _shard_inputs(kw, build_kw, aniso, (2, 2), dtype, "cuda")
    tab = TABLEAUS[method]
    p = f11.HALO
    for fz in (0.0, 1.0):
        for buf, sc in zip(bufs, consts):
            args = (buf, torch.tensor(h, dtype=dtype, device="cuda"),
                    torch.tensor(fz, dtype=dtype, device="cuda"), sc, tab,
                    kw["rtol"], kw["atol"])
            # a trace can miss kernels, or hold none: pooled traces
            names = trace.kernel_names(
                lambda: f11.fused_shard_divform_step(*args))
            assert any(erk_slots.kernel_name(tab) in n for n in names), names
            y_k, ss_k = f11.fused_shard_divform_step(*args)
            y_k2, ss_k2 = f11.fused_shard_divform_step(*args)
            y_r, _ = f11.fused_shard_divform_step_reference(*args)
            sums = f11.fused_shard_divform_tile_sums(*args)
            torch.cuda.synchronize()
            assert torch.equal(interior(y_k, p), interior(y_k2, p))
            assert torch.equal(ss_k, ss_k2)
            assert torch.equal(interior(y_k, p), interior(y_r, p))
            assert ss_k.shape == sums.shape and torch.equal(ss_k, sums)
    if erk_slots.uses_slots(tab):
        info = erk_slots.kernel_info("crd_fused_shard_divform_info", dtype,
                                     int(aniso), consts[0].kinetics_id)
        smem = erk_slots.slots_plan(bufs[0].element_size(), int(aniso))[3]
        assert info["shared_bytes"] == smem
        assert info["blocks_per_sm"] >= (2 if dtype == torch.float32 else 1)
