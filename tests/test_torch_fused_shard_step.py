"""Kernel K8, the fused ERK step on one shard of a mesh
(crdmodel_tpu_torch/ops/fused_shard_step.py).

On the CPU: one sharded step through the kernel's plain version against
the JAX package's K8 run in interpret mode under shard_map on its 8
virtual devices, f32, from a numpy-seeded state (physical cells to 2e-5,
the error sum to 1e-3 relative: the limits of K1's test), on even and
uneven meshes; whole small
runs through the plain K8 against the port's sharded torch path; and the
mirror-pad invariant of uneven meshes; the launcher's dispatch on the
stage count (ops/erk_slots.py) for each tableau the gate takes, the
partial sums' length (one a tile of the block) at the main path's shard
and odd blocks, and the plain partial sums (fused_shard_step_tile_sums)
against the plain total. On a CUDA card (marker `cuda`): the CUDA kernel
against its plain version, y_new's block bitwise; and y_new's block and
every partial sum bitwise on the torus, the flat surface, Goldbeter,
Aliev–Panfilov and a padded mesh, with each tableau:

    python -m pytest tests/test_torch_fused_shard_step.py -m cuda --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.core.problem import build_problem
from crdmodel_tpu_torch.integrate.erk import TABLEAUS
from crdmodel_tpu_torch.ops import fused_shard_step as f8
from crdmodel_tpu_torch.parallel.mesh import make_mesh
from crdmodel_tpu_torch.parallel.sharded import (gather, make_reduce,
                                                 mesh_pad_spec, shard_params,
                                                 sharded_params,
                                                 simulate_sharded,
                                                 split_state)

BASE = dict(model="fhn", surface="torus", x_mesh=32, surface_width=20.0,
            surface_length=40.0, t_final=0.5, output_timestep=2, beta=1.25,
            beta_min=0.7, beta_max=1.7, vary_beta=1, t_boundary=0.3,
            dtype="float32", rtol=1e-5, atol=1e-8, use_pallas=True)
FLAT = dict(surface="flat", vary_beta=0, surface_width=10.0,
            surface_length=20.0)
# a step long enough that the error estimate stands well above f32
# rounding (dopri54's 5th-order error at h=0.02 is near the rounding level)
H = 0.1


def _state(shape, seed=11):
    return np.random.default_rng(seed).uniform(-2.0, 2.0, shape)


def _mesh(shape, device="cpu"):
    return make_mesh(shape=shape, devices=[device] * 8)


def port_step(kw, shape, y_np, h, seg_end, method):
    """One step of the port's sharded K8 path: (physical y_new, err sum)."""
    cfg = SimConfig(**kw)
    problem = build_problem(cfg, "cpu")
    mesh = _mesh(shape)
    pad = mesh_pad_spec(cfg, mesh)
    fused = f8.build_fused_shard_step(problem, TABLEAUS[method], mesh, pad)
    y = split_state(torch.tensor(y_np, dtype=torch.float32), mesh, pad, cfg)
    params = shard_params(sharded_params(problem, pad), mesh, pad, cfg)
    seg = torch.tensor(seg_end, dtype=torch.float32)
    y_new, ss = fused.step_err(torch.tensor(0.0), fused.pad(y),
                               torch.tensor(h, dtype=torch.float32),
                               {**params, "_seg_end": seg})
    return (gather(fused.unpad(y_new), mesh, pad).numpy(),
            float(make_reduce(mesh)(ss)))


def jax_step(kw, shape, y_np, h, seg_end, method):
    """The same step through the JAX package's K8 in interpret mode under
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
    jp = jbuild(cfg)
    mesh = jmake_mesh(shape=shape)
    pad = jsh.mesh_pad_spec(cfg, mesh)
    fused = jsh.maybe_fused_shard_step(jp, mesh, interpret=True,
                                       pad_spec=pad)
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
@pytest.mark.parametrize("method", ["bs32", "dopri54"])
@pytest.mark.parametrize("surface", ["torus", "flat"])
@pytest.mark.parametrize("seg_end", [0.2, 0.5])      # frozen, released
def test_plain_step_matches_jax_kernel(surface, method, shape, seg_end):
    kw = {**BASE, **(FLAT if surface == "flat" else {}), "method": method}
    y_np = _state((2, SimConfig(**kw).ny, SimConfig(**kw).nx))
    got, ss = port_step(kw, shape, y_np, H, seg_end, method)
    want, ss_want = jax_step(kw, shape, y_np, H, seg_end, method)
    assert np.max(np.abs(got - want)) <= 2e-5 * max(1.0, np.abs(y_np).max())
    assert abs(ss - ss_want) <= 1e-3 * ss_want


@pytest.mark.parametrize("shape", [(2, 2), (3, 1), (2, 3)])
@pytest.mark.parametrize("method", ["bs32", "dopri54"])
def test_sharded_run_through_plain_kernel(method, shape):
    """A whole small run through the plain K8 takes the sharded torch
    path's steps, fields to f32 rounding."""
    cfg = SimConfig(**{**BASE, "method": method})
    mesh = _mesh(shape)
    fused = simulate_sharded(cfg, mesh=mesh)
    torch_path = simulate_sharded(dataclasses.replace(cfg, use_pallas=False),
                                  mesh=mesh)
    assert fused.fused and not torch_path.fused and fused.ok
    np.testing.assert_array_equal(fused.stats.steps.numpy(),
                                  torch_path.stats.steps.numpy())
    np.testing.assert_allclose(fused.trajectory.numpy(),
                               torch_path.trajectory.numpy(), rtol=0,
                               atol=1e-6)


def test_mirror_pad_cells_stay_copies():
    """On an uneven mesh the pad cells evolve as bitwise copies of their
    wrapped physical sources, step after step (tests/test_uneven.py:
    302-313), and only the physical cells enter the error sum."""
    cfg = SimConfig(**BASE)
    problem = build_problem(cfg, "cpu")
    mesh = _mesh((3, 2))
    pad = mesh_pad_spec(cfg, mesh)
    assert pad.y.active and pad.x.active is False
    fused = f8.build_fused_shard_step(problem, TABLEAUS["bs32"], mesh, pad)
    params = {**shard_params(sharded_params(problem, pad), mesh, pad, cfg),
              "_seg_end": torch.tensor(0.5)}
    y_np = _state((2, cfg.ny, cfg.nx))
    yp = fused.pad(split_state(torch.tensor(y_np, dtype=torch.float32), mesh,
                               pad, cfg))
    for _ in range(3):
        yp, _ = fused.step_err(torch.tensor(0.0), yp, torch.tensor(H), params)
        full = gather(fused.unpad(yp), mesh).numpy()
        rows = np.arange(pad.y.n_pad) % cfg.ny
        np.testing.assert_array_equal(full, full[:, rows])
    assert [c.valid_rows for c in fused.constants] == [22, 22, 22, 22, 20, 20]


def test_gate():
    cfg = SimConfig(**BASE)
    problem = build_problem(cfg, "cpu")
    tab = TABLEAUS["bs32"]
    assert f8.is_shard_supported(problem, tab, torch.float32, 8, 8)
    assert not f8.is_shard_supported(problem, tab, torch.float32, 7, 64)
    assert not f8.is_shard_supported(problem, tab, torch.float64, 64, 64)
    walls = build_problem(SimConfig(**{**BASE, **FLAT,
                                       "boundary": "noflux"}), "cpu")
    assert not f8.is_shard_supported(walls, tab, torch.float32, 64, 64)


def test_cpu_wrapper_is_the_plain_version():
    cfg = SimConfig(**BASE)
    problem = build_problem(cfg, "cpu")
    mesh = _mesh((2, 2))
    consts = f8.build_fused_shard_step(problem, TABLEAUS["bs32"], mesh,
                                       None).constants
    yp = torch.tensor(_state((2, 48, 32)), dtype=torch.float32)
    args = (yp, torch.tensor(H), torch.tensor(1.0), consts[0],
            TABLEAUS["bs32"], cfg.rtol, cfg.atol)
    before = f8.fused_shard_step.launches
    a, b = f8.fused_shard_step(*args), f8.fused_shard_step_reference(*args)
    assert f8.fused_shard_step.launches == before
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs an NVIDIA GPU and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(2, 2), (1, 3)])
@pytest.mark.parametrize("method", ["bs32", "dopri54"])
def test_kernel_matches_plain_version(method, shape, dtype):
    """The CUDA kernel against its plain version on every shard: y_new's
    block bitwise, the error sums to rounding, two launches bitwise."""
    from crdmodel_tpu_torch.ops.kernel_common import make_shard_constants
    from crdmodel_tpu_torch.parallel.halo import mirror_halo_pad

    cfg = SimConfig(**{**BASE, "x_mesh": 64})
    problem = build_problem(cfg, "cuda")
    mesh = _mesh(shape, "cuda")
    pad = mesh_pad_spec(cfg, mesh)
    y = torch.tensor(_state((2, cfg.ny, cfg.nx)), dtype=dtype, device="cuda")
    bufs = mirror_halo_pad(list(split_state(y, mesh, pad, cfg)), mesh,
                           f8.HALO, pad)
    consts = make_shard_constants(problem, mesh, pad, f8.HALO, dtype)
    for fz in (0.0, 1.0):
        for buf, sc in zip(bufs, consts):
            args = (buf, torch.tensor(H, dtype=dtype, device="cuda"),
                    torch.tensor(fz, dtype=dtype, device="cuda"), sc,
                    TABLEAUS[method], cfg.rtol, cfg.atol)
            y_k, ss_k = f8.fused_shard_step(*args)
            y_k2, ss_k2 = f8.fused_shard_step(*args)
            y_r, ss_r = f8.fused_shard_step_reference(*args)
            torch.cuda.synchronize()
            block = f8.interior
            assert torch.equal(block(y_k, f8.HALO), block(y_k2, f8.HALO))
            assert torch.equal(ss_k, ss_k2)
            assert torch.equal(block(y_k, f8.HALO), block(y_r, f8.HALO))
            tol = 1e-10 if dtype == torch.float64 else 1e-3
            assert abs(float(ss_k.sum()) - float(ss_r.sum())) <= (
                tol * float(ss_r.sum()))


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs an NVIDIA GPU and nvcc")
@pytest.mark.parametrize("cards", [2, 4])
@pytest.mark.parametrize("method", ["bs32", "rkc2"])
def test_shards_on_separate_cards(method, cards):
    """A mesh with shard i on cuda:i takes every step through K8 (bs32) or
    K9 (rkc2) and gives the run of the same mesh with every shard on
    cuda:0, bitwise: the launches go to each shard's card."""
    from crdmodel_tpu_torch.ops import fused_shard_rkc as f9
    if torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} cards")
    cfg = SimConfig(**{**BASE, "x_mesh": 64, "method": method})
    shape = (cards // 2, 2) if cards == 4 else (2, 1)
    wrapper = f9.fused_shard_rkc_step if method == "rkc2" else (
        f8.fused_shard_step)
    runs = []
    for devices in ([f"cuda:{i}" for i in range(cards)], ["cuda:0"] * cards):
        wrapper.launches = 0
        res = simulate_sharded(cfg, mesh=make_mesh(shape=shape,
                                                   devices=devices))
        assert res.ok and res.fused
        assert wrapper.launches >= cards * res.total_steps()
        runs.append(res)
    spread, one_card = runs
    np.testing.assert_array_equal(spread.stats.steps.cpu().numpy(),
                                  one_card.stats.steps.cpu().numpy())
    assert torch.equal(spread.trajectory.cpu(), one_card.trajectory.cpu())


# The register-resident scheme's cases on a mesh (csrc/erk_slots.cuh,
# SlotOrigin<HaloGrid>): (config keywords, mesh shape, state, h); the
# blocks of the 2x2 meshes are 64x32 (full tiles), the padded 3x2 mesh's
# 25x19 with mirror-pad cells on both axes (partial tiles only)
GB = dict(model="goldbeter", beta=0.4, vary_beta=0, wave_inside=1,
          wave_length=0.2)
AP = dict(model="aliev_panfilov", beta=0.15, vary_beta=0, diffusion=1.0,
          wave_length=0.25, wave_width=0.5)


def _gb_state(y0, seed=11):
    return y0 * np.exp(0.05 * np.random.default_rng(seed).standard_normal(
        y0.shape))


def _ap_state(y0, seed=11):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-0.1, 1.1, y0.shape[1:]),
                     rng.uniform(0.0, 2.0, y0.shape[1:])])


SLOT_CASES = {
    "torus": (dict(BASE, x_mesh=64), (2, 2), lambda y0: _state(y0.shape), H),
    "flat": (dict(BASE, **FLAT, x_mesh=64), (2, 2),
             lambda y0: _state(y0.shape), H),
    "goldbeter": (dict(BASE, **GB, x_mesh=64), (2, 2), _gb_state, 0.01),
    "aliev_panfilov": (dict(BASE, **AP, x_mesh=64), (2, 2), _ap_state, 0.02),
    "padded_3x2": (dict(BASE, x_mesh=37), (3, 2),
                   lambda y0: _state(y0.shape), H)}


def _shard_inputs(name, dtype, device, shape=None, **over):
    """Every shard's halo-padded buffer of a SLOT_CASES case's seeded
    state, its halo exchanged, its K8 constants, and the case's h."""
    from crdmodel_tpu_torch.ops.kernel_common import make_shard_constants
    from crdmodel_tpu_torch.parallel.halo import mirror_halo_pad

    kw, mesh_shape, state, h = SLOT_CASES[name]
    cfg = SimConfig(**{**kw, **over})
    problem = build_problem(cfg, device)
    mesh = _mesh(shape or mesh_shape, device)
    pad = mesh_pad_spec(cfg, mesh)
    y = torch.tensor(state(problem.y0.cpu().numpy()), dtype=dtype,
                     device=device)
    bufs = mirror_halo_pad(list(split_state(y, mesh, pad, cfg)), mesh,
                           f8.HALO, pad)
    return (bufs, make_shard_constants(problem, mesh, pad, f8.HALO, dtype),
            torch.tensor(h, dtype=dtype, device=device), cfg)


@pytest.mark.parametrize("method", sorted(TABLEAUS))
def test_dispatch_names_a_kernel_for_each_tableau(method):
    """Every tableau the gate takes has a kernel: bs32 the
    register-resident scheme, the others erk_tile.cuh's."""
    from crdmodel_tpu_torch.ops import erk_slots
    problem = build_problem(SimConfig(**BASE), "cpu")
    tab = TABLEAUS[method]
    assert f8.is_shard_supported(problem, tab, torch.float32, 64, 32)
    assert erk_slots.uses_slots(tab) == (method == "bs32")
    assert erk_slots.kernel_name(tab) == (
        erk_slots.SLOTS_KERNEL if method == "bs32" else
        erk_slots.TILE_KERNEL)


@pytest.mark.parametrize("x_mesh,shape,want", [(400, (2, 2), 175),
                                               (101, (2, 2), 14),
                                               (75, (1, 3), 10)])
def test_shard_partial_sums_one_a_tile(x_mesh, shape, want):
    """The plain partial sums number the kernel's tiles of the block: 175
    at a 2x2 shard (800x200) of the canonical torus's 1600x400, and the
    partial tiles of odd blocks (202x51, 300x25)."""
    bufs, consts, h, _ = _shard_inputs("torus", torch.float32, "cpu", shape,
                                       x_mesh=x_mesh, surface_length=80.0)
    nyl = bufs[0].shape[1] - 2 * f8.HALO
    nxl = bufs[0].shape[2] - 2 * f8.HALO
    assert -(-nxl // 32) * -(-nyl // 32) == want
    sums = f8.fused_shard_step_tile_sums(bufs[0], h, torch.tensor(0.0),
                                         consts[0], TABLEAUS["bs32"], 1e-5,
                                         1e-8)
    assert sums.shape == (want,)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(SLOT_CASES))
def test_shard_tile_sums_add_to_the_plain_total(name, dtype):
    """The plain partial sums of every shard, in the kernel's tile order
    over the physical cells, add up to the plain version's total to
    rounding, for each tableau, frozen and not."""
    bufs, consts, h, cfg = _shard_inputs(name, dtype, "cpu")
    rel = 1e-5 if dtype == torch.float32 else 1e-12
    for method in sorted(TABLEAUS):
        for fz in (0.0, 1.0):
            for buf, sc in zip(bufs, consts):
                args = (buf, h, torch.tensor(fz, dtype=dtype), sc,
                        TABLEAUS[method], cfg.rtol, cfg.atol)
                sums = f8.fused_shard_step_tile_sums(*args)
                _, total = f8.fused_shard_step_reference(*args)
                np.testing.assert_allclose(float(sums.sum()), float(total),
                                           rtol=rel)


def test_padded_case_pads_both_axes():
    """The padded case's 3x2 mesh pads both axes: each block is 25x19,
    the last shards' last rows or column mirror-pad cells."""
    bufs, consts, _, cfg = _shard_inputs("padded_3x2", torch.float32, "cpu")
    assert (cfg.ny, cfg.nx) == (74, 37)
    assert all(b.shape == (2, 25 + 2 * f8.HALO, 19 + 2 * f8.HALO)
               for b in bufs)
    assert sorted({(sc.valid_rows, sc.valid_cols) for sc in consts}) == [
        (24, 18), (24, 19), (25, 18), (25, 19)]


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs an NVIDIA GPU and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("method", sorted(TABLEAUS))
@pytest.mark.parametrize("name", sorted(SLOT_CASES))
def test_cuda_shard_partial_sums_bitwise(name, method, dtype):
    """Both schemes on every shard of each case, frozen and not: y_new's
    block bitwise the plain version's, two launches equal, every partial
    sum bitwise the plain version's over the physical cells
    (fused_shard_step_tile_sums); the launch runs the kernel the dispatch
    names, and the register-resident kernel's shared bytes are
    slots_plan's."""
    from crdmodel_tpu_torch.ops import erk_slots, trace

    bufs, consts, h, cfg = _shard_inputs(name, dtype, "cuda")
    tab = TABLEAUS[method]
    p = f8.HALO
    for fz in (0.0, 1.0):
        for buf, sc in zip(bufs, consts):
            args = (buf, h, torch.tensor(fz, dtype=dtype, device="cuda"), sc,
                    tab, cfg.rtol, cfg.atol)
            # a trace can miss kernels, or hold none: pooled traces
            names = trace.kernel_names(lambda: f8.fused_shard_step(*args))
            assert any(erk_slots.kernel_name(tab) in n for n in names), names
            y_k, ss_k = f8.fused_shard_step(*args)
            y_k2, ss_k2 = f8.fused_shard_step(*args)
            y_r, _ = f8.fused_shard_step_reference(*args)
            sums = f8.fused_shard_step_tile_sums(*args)
            torch.cuda.synchronize()
            assert torch.equal(f8.interior(y_k, p), f8.interior(y_k2, p))
            assert torch.equal(ss_k, ss_k2)
            assert torch.equal(f8.interior(y_k, p), f8.interior(y_r, p))
            assert ss_k.shape == sums.shape and torch.equal(ss_k, sums)
    if erk_slots.uses_slots(tab):
        info = erk_slots.kernel_info("crd_fused_shard_step_info", dtype,
                                     consts[0].kinetics_id)
        assert info["shared_bytes"] == erk_slots.slots_plan(
            bufs[0].element_size())[3]
        assert info["blocks_per_sm"] >= (2 if dtype == torch.float32 else 1)
