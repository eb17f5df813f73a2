"""Kernel K12, the fused ERK step on one shard of the 3-D box
(crdmodel_tpu_torch/ops/fused_shard_box3d.py).

On the CPU: one sharded step through the kernel's plain version against
the JAX package's K12 in interpret mode under shard_map on its 8 virtual
devices, f32, from a numpy-seeded state, in each operator mode (profile,
tissue, field, tensor), with FitzHugh-Nagumo's beta ramp and freeze, and
on an uneven mesh: physical cells within 5e-6 of the state's scale (JAX's
own bar for K12 against its XLA path, tests/test_shard_box3d.py:52) and
the step's WRMS error norm to 5e-5 plus 1e-4 of itself (K6's bar,
tests/test_torch_fused_box3d.py: the rounding of the stage sums over
rtol |y|, where the controller accepts at 1); whole small runs through
the plain K12 against the port's sharded torch path (the same steps,
fields to f32 rounding); the mirror-pad invariant of uneven meshes; the
gate. The z-streaming scheme on a shard (ops/box_stream.py): its
schedule's model against the plain step, the block bitwise, in every
mode, on the uneven and (1,4) meshes, f32 and f64; its partial sums,
every physical cell in exactly one (the mirror-pad cells in none, also on
a padded 1x3 mesh), adding up to the plain step's error sum; the plan's
tiles at the sharded slab's shard. On a CUDA card (marker `cuda`): the
CUDA kernel against its plain version, y_new's block bitwise, a bs32
launch's every partial sum bitwise in the kernel's order, the launched
kernel the dispatch names, the stream kernel's shared bytes and blocks an
SM. The JAX package is imported inside the tests that use it, so that the
card tests run where JAX is not installed:

    python -m pytest tests/test_torch_fused_shard_box3d.py -m cuda --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.core.problem import build_problem
from crdmodel_tpu_torch.integrate.erk import TABLEAUS
from crdmodel_tpu_torch.ops import box_stream as bs
from crdmodel_tpu_torch.ops import fused_shard_box3d as f12
from crdmodel_tpu_torch.parallel.mesh import make_mesh
from crdmodel_tpu_torch.parallel.sharded import (gather, make_reduce,
                                                 mesh_pad_spec, shard_params,
                                                 sharded_params,
                                                 simulate_sharded,
                                                 split_state)

NZ, NY, NX = 6, 32, 32


def box_kw(**kw):
    """The JAX sharded box suite's slab (tests/test_shard_box3d.py::
    box_cfg), 32x32 in (y, x)."""
    base = dict(model="aliev_panfilov", surface="box", x_mesh=NX,
                surface_width=10.0, surface_length=10.0, y_mesh=NY,
                surface_depth=3.0, z_mesh=NZ, t_final=1.0,
                output_timestep=2, beta=0.0, dtype="float32",
                method="bs32", rtol=1e-4, atol=1e-7, boundary="noflux",
                use_pallas=True)
    base.update(kw)
    return base


def scar_column(nz=NZ, ny=NY, nx=NX):
    """An inert column through every plane around the corner where the
    four shards of a 2x2 mesh meet, so that it crosses every shard edge."""
    jj, ii = np.mgrid[0:ny, 0:nx]
    scar = (jj - ny // 2) ** 2 + (ii - nx // 2) ** 2 <= 16
    return np.broadcast_to(~scar, (nz, ny, nx)).copy()


def field_3d(nz=NZ, ny=NY, nx=NX, seed=0):
    rng = np.random.default_rng(seed)
    return 0.8 + 0.4 * rng.random((nz, ny, nx))


def transmural_tensor(nz=NZ, ny=NY, nx=NX):
    """The transmural fibre rotation (tests/test_anisotropic3d.py::
    _transmural_tensor), z couplings inside the wall."""
    z = np.linspace(0, 1, nz)[:, None, None] * np.ones((nz, ny, nx))
    th = (z - 0.5) * np.pi / 3
    dpar, dperp, dtrans = 0.3, 0.08, 0.02
    c, s = np.cos(th), np.sin(th)
    inner = (z > 0.2) & (z < 0.8)
    return (dpar * c * c + dperp * s * s, dpar * s * s + dperp * c * c,
            np.full_like(c, dtrans), (dpar - dperp) * c * s,
            np.where(inner, 0.01, 0.0), np.where(inner, -0.008, 0.0))


# name -> (config keywords, build arguments, mesh shape)
CASES = {
    "profile": (box_kw(), {}, (2, 2)),
    "tissue": (box_kw(), dict(obstacle_mask=scar_column()), (2, 2)),
    "field": (box_kw(), dict(diffusion_field=field_3d()), (2, 2)),
    "tensor": (box_kw(boundary="noflux_z", beta=0.05),
               dict(diffusion_tensor=transmural_tensor()), (2, 2)),
    "fhn_ramp_freeze": (box_kw(model="fhn", beta=1.25, vary_beta=1,
                               beta_min=0.9, beta_max=1.5,
                               boundary="noflux_z"), {}, (1, 4)),
    # 40 x 17 on a 2x2 mesh: blocks of 20 x 9, the last column of blocks
    # holding a mirror-pad column (JAX's own blocks differ: compare
    # physical cells)
    "uneven": (box_kw(x_mesh=17, y_mesh=40, surface_width=17.0,
                      surface_length=40.0), {}, (2, 2)),
}
H = 2e-3
SEG = {"frozen": 0.2, "released": 2.0}


def _state(shape, seed=11):
    return np.random.default_rng(seed).uniform(-0.2, 1.2, shape)


def _mesh(shape, device="cpu"):
    return make_mesh(shape=shape, devices=[device] * 8)


def port_step(kw, build_kw, shape, y_np, h, seg_end):
    """One step of the port's sharded K12 path: (physical y_new, err sum)."""
    cfg = SimConfig(**kw)
    problem = build_problem(cfg, "cpu", **build_kw)
    mesh = _mesh(shape)
    pad = mesh_pad_spec(cfg, mesh)
    fused = f12.build_fused_shard_box3d(problem, TABLEAUS[cfg.method], mesh,
                                        pad)
    y = split_state(torch.tensor(y_np, dtype=torch.float32), mesh, pad, cfg)
    params = shard_params(sharded_params(problem, pad), mesh, pad, cfg)
    seg = torch.tensor(seg_end, dtype=torch.float32)
    y_new, ss = fused.step_err(torch.tensor(0.0), fused.pad(y),
                               torch.tensor(h, dtype=torch.float32),
                               {**params, "_seg_end": seg})
    return (gather(fused.unpad(y_new), mesh, pad).numpy(),
            float(make_reduce(mesh)(ss)))


def jax_shard_step(kw, build_kw, shape, y_np, h, seg_end, kernel):
    """The same step through the JAX package's box shard kernel `kernel`
    ("k12" or "k13") in interpret mode under shard_map: (physical y_new,
    psum'd error sum). Its blocks may be taller (8-row rounding), so only
    physical cells compare."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild
    from crdmodel_tpu.core.problem import make_rho_bound
    from crdmodel_tpu.parallel import sharded as jsh
    from crdmodel_tpu.parallel.mesh import AXIS_X, AXIS_Y
    from crdmodel_tpu.parallel.mesh import make_mesh as jmake_mesh
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    cfg = JSimConfig(**kw)
    jp = jbuild(cfg, **build_kw)
    mesh = jmake_mesh(shape=shape)
    pad = jsh.mesh_pad_spec(cfg, mesh)
    f32 = jnp.float32
    if kernel == "k12":
        fused = jsh.maybe_fused_shard_box3d(jp, mesh, interpret=True,
                                            pad_spec=pad)
    else:
        rho_fn = make_rho_bound(
            cfg, jp.model, jp.geometry, f32,
            max_reduce=lambda x: lax.pmax(x, (AXIS_Y, AXIS_X)),
            diffusion_field=jp.diffusion_field,
            diffusion_tensor=jp.diffusion_tensor, face_mask=jp.face_mask)
        if pad is not None:
            rho_fn = jsh._mask_rho(rho_fn)
        fused = jsh.maybe_fused_shard_rkc(jp, mesh, rho_fn, interpret=True,
                                          pad_spec=pad)
    assert fused is not None
    params, specs = jsh.sharded_params(jp, pad)

    def local(y, params):
        p = {**params, "_seg_end": jnp.asarray(seg_end, f32)}
        if "dxy" in p:
            p["_dxy_pad"] = jsh.halo_pad(
                p["dxy"], seam_y=pad.seam_y() if pad else None,
                seam_x=pad.seam_x() if pad else None)
        p = fused.prepare_params(p)
        out = fused.step_err(jnp.asarray(0.0, f32), fused.pad(y),
                             jnp.asarray(h, f32), p)
        return fused.unpad(out[0]), lax.psum(jnp.sum(out[1]),
                                             (AXIS_Y, AXIS_X))

    state = P(None, None, AXIS_Y, AXIS_X)
    fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(state, specs),
                               out_specs=(state, P()), check_vma=False))
    y = pad.pad_field(y_np) if pad is not None else y_np
    y_new, ss = fn(jnp.asarray(y, f32), params)
    return np.asarray(y_new)[..., :cfg.ny, :cfg.nx], float(ss)


@pytest.mark.parametrize("name,seg", [(name, "frozen") for name in sorted(CASES)]
                         + [(name, "released") for name in ("fhn_ramp_freeze",
                                                            "tissue")])
def test_plain_step_matches_jax_kernel(name, seg):
    kw, build_kw, shape = CASES[name]
    kw = {**kw, "t_boundary": 0.5}
    cfg = SimConfig(**kw)
    y_np = _state((2, cfg.nz, cfg.ny, cfg.nx))
    got, ss = port_step(kw, build_kw, shape, y_np, H, SEG[seg])
    want, ss_want = jax_shard_step(kw, build_kw, shape, y_np, H, SEG[seg],
                                   "k12")
    assert np.max(np.abs(got - want)) <= 5e-6 * max(1.0, np.abs(y_np).max())
    assert_wrms_close(ss, ss_want, y_np.size)


def assert_wrms_close(ss, ss_want, n):
    """The WRMS error norms of two sums of squares over n values agree to
    5e-5 plus 1e-4 of the norm."""
    got, want = np.sqrt(ss / n), np.sqrt(ss_want / n)
    assert abs(got - want) <= 5e-5 + 1e-4 * want


@pytest.mark.parametrize("name", ["profile", "tissue", "field", "tensor",
                                  "uneven"])
def test_sharded_run_through_plain_kernel(name):
    """A whole small run through the plain K12 takes the sharded torch
    path's steps, fields to f32 rounding; scar cells hold their IC
    bitwise."""
    kw, build_kw, shape = CASES[name]
    cfg = SimConfig(**kw)
    mesh = _mesh(shape)
    runs = [simulate_sharded(c, mesh=mesh,
                             problem=build_problem(c, "cpu", **build_kw))
            for c in (cfg, dataclasses.replace(cfg, use_pallas=False))]
    fused, torch_path = runs
    assert fused.fused and not torch_path.fused and fused.ok
    np.testing.assert_array_equal(fused.stats.steps.numpy(),
                                  torch_path.stats.steps.numpy())
    np.testing.assert_allclose(fused.trajectory.numpy(),
                               torch_path.trajectory.numpy(), rtol=0,
                               atol=1e-6)
    if "obstacle_mask" in build_kw:
        inert = ~build_kw["obstacle_mask"]
        traj = fused.trajectory.numpy()
        np.testing.assert_array_equal(traj[:, :, inert],
                                      np.broadcast_to(traj[:1, :, inert],
                                                      traj[:, :, inert].shape))


def test_mirror_pad_cells_stay_copies():
    """On an uneven mesh the pad cells evolve as bitwise copies of their
    wrapped physical sources, step after step, in every plane, and only
    the physical cells enter the error sum."""
    kw, build_kw, shape = CASES["uneven"]
    cfg = SimConfig(**kw)
    problem = build_problem(cfg, "cpu", **build_kw)
    mesh = _mesh(shape)
    pad = mesh_pad_spec(cfg, mesh)
    assert pad.x.active and not pad.y.active
    fused = f12.build_fused_shard_box3d(problem, TABLEAUS["bs32"], mesh, pad)
    params = {**shard_params(sharded_params(problem, pad), mesh, pad, cfg),
              "_seg_end": torch.tensor(2.0)}
    y_np = _state((2, cfg.nz, cfg.ny, cfg.nx))
    yp = fused.pad(split_state(torch.tensor(y_np, dtype=torch.float32), mesh,
                               pad, cfg))
    for _ in range(3):
        yp, _ = fused.step_err(torch.tensor(0.0), yp, torch.tensor(H), params)
        full = gather(fused.unpad(yp), mesh).numpy()
        cols = np.arange(pad.x.n_pad) % cfg.nx
        np.testing.assert_array_equal(full, full[..., cols])
    assert [(c.valid_rows, c.valid_cols) for c in fused.constants] == [
        (20, 9), (20, 8), (20, 9), (20, 8)]


def test_z_profiles_stay_whole():
    """The box's z profiles (aU, aD: (nz,) in the kernels' constants,
    (nz, 1, 1) on the torch path) stay replicated where nz equals the
    block's or the grid's x or y extent, and the kernel's run takes the
    torch path's steps there."""
    kw = box_kw(z_mesh=16, x_mesh=16, y_mesh=32, surface_depth=8.0,
                surface_width=16.0, surface_length=32.0, t_final=0.5)
    cfg = SimConfig(**kw)
    problem = build_problem(cfg, "cpu")
    mesh = _mesh((2, 1))       # blocks of 16 x 16: nz == nyl == nxl == nx
    consts = f12.build_fused_shard_box3d(problem, TABLEAUS["bs32"], mesh,
                                         None).constants
    _, _, _, _, aU, aD = problem.geometry.divergence_coeffs64(
        problem.diffusion_field, face_mask=problem.face_mask)
    for sc in consts:
        assert tuple(sc.coeffs[4].shape) == (cfg.nz,)
        np.testing.assert_array_equal(sc.coeffs[4].numpy(),
                                      np.float32(np.ravel(aU)))
        np.testing.assert_array_equal(sc.coeffs[5].numpy(),
                                      np.float32(np.ravel(aD)))
    params = shard_params(sharded_params(problem), mesh, None, cfg)
    for loc in params["local"]:
        assert tuple(loc["coeffs"][4].shape) == (cfg.nz, 1, 1)
    fused = simulate_sharded(cfg, mesh=mesh, problem=problem)
    torch_path = simulate_sharded(dataclasses.replace(cfg, use_pallas=False),
                                  mesh=mesh)
    assert fused.fused and fused.ok
    np.testing.assert_array_equal(fused.stats.steps.numpy(),
                                  torch_path.stats.steps.numpy())
    np.testing.assert_allclose(fused.trajectory.numpy(),
                               torch_path.trajectory.numpy(), rtol=0,
                               atol=1e-6)


def test_gate():
    cfg = SimConfig(**box_kw())
    problem = build_problem(cfg, "cpu")
    tab = TABLEAUS["bs32"]
    assert f12.is_shard_box3d_supported(problem, tab, torch.float32, 8, 8)
    assert not f12.is_shard_box3d_supported(problem, tab, torch.float32, 7,
                                            64)
    assert not f12.is_shard_box3d_supported(problem, tab, torch.float64, 16,
                                            16)
    periodic = build_problem(SimConfig(**box_kw(boundary="periodic")), "cpu")
    assert not f12.is_shard_box3d_supported(periodic, tab, torch.float32, 16,
                                            16)
    # a constant 6-tensor in a periodic box couples across the z seam
    # (tests/test_anisotropic3d.py:195-207)
    const_tensor = build_problem(
        SimConfig(**box_kw(boundary="periodic")), "cpu",
        diffusion_tensor=(0.20, 0.10, 0.05, 0.04, 0.03, 0.02))
    assert not f12.is_shard_box3d_supported(const_tensor, tab, torch.float32,
                                            16, 16)


def test_cpu_wrapper_is_the_plain_version():
    cfg = SimConfig(**box_kw())
    problem = build_problem(cfg, "cpu")
    mesh = _mesh((2, 2))
    consts = f12.build_fused_shard_box3d(problem, TABLEAUS["bs32"], mesh,
                                         None).constants
    yp = torch.tensor(_state((2, NZ, 32, 32)), dtype=torch.float32)
    args = (yp, torch.tensor(H), torch.tensor(1.0), consts[0],
            TABLEAUS["bs32"], cfg.rtol, cfg.atol)
    before = f12.fused_shard_box3d_step.launches
    a = f12.fused_shard_box3d_step(*args)
    b = f12.fused_shard_box3d_step_reference(*args)
    assert f12.fused_shard_box3d_step.launches == before
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def shard_case(name, dtype, mesh_shape=None, device="cpu"):
    """(buffers, constants) of CASES[name] on its mesh (or mesh_shape),
    halo-padded, from a seeded state, t_boundary 0.5."""
    from crdmodel_tpu_torch.ops.kernel_common import make_shard_box_constants
    from crdmodel_tpu_torch.parallel.halo import mirror_halo_pad

    kw, build_kw, shape = CASES[name]
    cfg = SimConfig(**{**kw, "t_boundary": 0.5})
    problem = build_problem(cfg, device, **build_kw)
    mesh = _mesh(mesh_shape or shape, device)
    pad = mesh_pad_spec(cfg, mesh)
    y = torch.tensor(_state((2, cfg.nz, cfg.ny, cfg.nx)), dtype=dtype,
                     device=device)
    bufs = mirror_halo_pad(list(split_state(y, mesh, pad, cfg)), mesh,
                           f12.HALO, pad)
    return bufs, make_shard_box_constants(problem, mesh, pad, f12.HALO,
                                          dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(CASES))
def test_stream_model_matches_plain_shard_step(name, dtype):
    """The stream scheme's schedule (box_stream_model) on each shard's
    buffer gives the plain step's block bitwise, y_new and the error, in
    the plan's z chunks and in chunks of 1 and 4 planes."""
    from crdmodel_tpu_torch.ops.fused_step import erk_stages_reference
    from crdmodel_tpu_torch.ops.kernel_common import make_box_rhs_block

    bufs, consts = shard_case(name, dtype)
    tab = TABLEAUS["bs32"]
    h = torch.tensor(H, dtype=dtype)
    p = f12.HALO
    for buf, sc in zip(bufs, consts):
        plan_chunk = bs.stream_plan(buf.element_size(), tuple(buf.shape[1:]),
                                    p)[1]
        for fz in (0.0, 1.0):
            fzt = torch.tensor(fz, dtype=dtype)
            want_y, want_err = erk_stages_reference(
                buf, h, make_box_rhs_block(sc, fzt), tab)
            for z_chunk in sorted({1, 4, plan_chunk}):
                got_y, got_err = bs.box_stream_model(buf, h, fzt, sc, tab,
                                                     z_chunk)
                assert torch.equal(f12.interior(got_y, p),
                                   f12.interior(want_y, p))
                assert torch.equal(f12.interior(got_err, p),
                                   f12.interior(want_err, p))


@pytest.mark.parametrize("name,mesh_shape", [("uneven", None),
                                             ("profile", (1, 3)),
                                             ("fhn_ramp_freeze", None)])
def test_stream_tile_sums_cover_physical_cells_once(name, mesh_shape):
    """Each shard's partial sums add every physical cell of its block once
    and no mirror-pad cell: unit squares (err 1, y 0, atol 1) sum to twice
    the physical cells of each tile and chunk."""
    bufs, consts = shard_case(name, torch.float32, mesh_shape)
    p = f12.HALO
    padded = False
    for buf, sc in zip(bufs, consts):
        nz, nyl, nxl = buf.shape[1], buf.shape[2] - 2 * p, buf.shape[3] - 2 * p
        padded |= (sc.valid_rows, sc.valid_cols) != (nyl, nxl)
        sq = f12.physical_squares(torch.ones_like(buf), torch.zeros_like(buf),
                                  sc, 0.0, 1.0)
        tile_y, z_chunk, tiles, _ = bs.stream_plan(4, tuple(buf.shape[1:]), p)
        got = bs.stream_tile_sums(sq, tile_y, z_chunk)
        assert got.shape == (tiles,)
        want = []
        for z0 in range(0, nz, z_chunk):
            dz = min(z_chunk, nz - z0)
            for y0 in range(0, nyl, tile_y):
                for x0 in range(0, nxl, bs.TILE_X):
                    rows = max(0, min(y0 + tile_y, sc.valid_rows) - y0)
                    cols = max(0, min(x0 + bs.TILE_X, sc.valid_cols) - x0)
                    want.append(2.0 * dz * rows * cols)
        assert got.tolist() == want
        assert float(got.sum()) == 2.0 * nz * sc.valid_rows * sc.valid_cols
    assert padded == (name != "fhn_ramp_freeze")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["profile", "tissue", "uneven"])
def test_stream_tile_sums_add_up_to_error_sum(name, dtype):
    bufs, consts = shard_case(name, dtype)
    for buf, sc in zip(bufs, consts):
        args = (buf, torch.tensor(H, dtype=dtype), torch.tensor(1.0,
                                                                dtype=dtype),
                sc, TABLEAUS["bs32"], 1e-4, 1e-7)
        sums = f12.fused_shard_box3d_tile_sums(*args)
        _, ss = f12.fused_shard_box3d_step_reference(*args)
        rel = abs(float(sums.sum()) - float(ss)) / float(ss)
        assert rel <= (1e-5 if dtype == torch.float32 else 1e-13)


def test_stream_plan_fills_the_card_at_the_slab_shard():
    """The sharded slab's shard, (2, 32, 272, 272) with a halo of 8: its
    256 x 256 block's 128 tiles of 32 x 16 in three z chunks, at least two
    blocks for each of the H100's 132 SMs; bs32 takes the stream kernel,
    dopri54 the persistent one."""
    tile_y, z_chunk, tiles, _ = bs.stream_plan(4, (32, 272, 272), f12.HALO)
    assert tiles >= 264
    assert (tile_y, z_chunk, tiles) == (16, 11, 384)
    assert bs.kernel_name(TABLEAUS["bs32"], shard=True) == bs.STREAM_KERNEL
    assert bs.kernel_name(TABLEAUS["dopri54"], shard=True) == (
        "fused_shard_box3d_kernel")


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs an NVIDIA GPU and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("method", ["bs32", "dopri54"])
def test_kernel_matches_plain_version(method, name, dtype):
    """The CUDA kernel against its plain version on every shard, frozen
    and released: y_new's block bitwise, two launches bitwise; a bs32
    launch's partial sums bitwise the plain version's in the stream
    kernel's order, a dopri54 launch's total to rounding; the launched
    kernel the dispatch names; the stream kernel's shared bytes the plan's
    and, in f32, at least two blocks an SM."""
    from crdmodel_tpu_torch.ops import trace
    from crdmodel_tpu_torch.ops.fused_box3d import MODE_IDS

    kw, _, _ = CASES[name]
    cfg = SimConfig(**kw)
    bufs, consts = shard_case(name, dtype, device="cuda")
    tab = TABLEAUS[method]
    want, other = bs.kernels(shard=True)
    if not bs.uses_stream(tab):
        want, other = other, want
    for fz in (0.0, 1.0):
        for buf, sc in zip(bufs, consts):
            args = (buf, torch.tensor(H, dtype=dtype, device="cuda"),
                    torch.tensor(fz, dtype=dtype, device="cuda"), sc,
                    tab, cfg.rtol, cfg.atol)
            y_k, ss_k = f12.fused_shard_box3d_step(*args)
            y_k2, ss_k2 = f12.fused_shard_box3d_step(*args)
            y_r, ss_r = f12.fused_shard_box3d_step_reference(*args)
            torch.cuda.synchronize()
            block = f12.interior
            assert torch.equal(block(y_k, f12.HALO), block(y_k2, f12.HALO))
            assert torch.equal(ss_k, ss_k2)
            assert torch.equal(block(y_k, f12.HALO), block(y_r, f12.HALO))
            if bs.uses_stream(tab):
                sums = f12.fused_shard_box3d_tile_sums(*args)
                assert ss_k.shape == sums.shape and torch.equal(ss_k, sums)
            else:
                tol = 1e-10 if dtype == torch.float64 else 1e-3
                assert abs(float(ss_k.sum()) - float(ss_r.sum())) <= (
                    tol * float(ss_r.sum()))
            names = trace.kernel_names(
                lambda: f12.fused_shard_box3d_step(*args))
            assert any(want in n for n in names), names
            assert not any(other in n for n in names), names
    if bs.uses_stream(tab):
        info = bs.kernel_info("crd_fused_shard_box3d_info", dtype,
                              MODE_IDS[consts[0].kind], consts[0].kinetics_id)
        assert info["shared_bytes"] == bs.stream_plan(
            bufs[0].element_size(), tuple(bufs[0].shape[1:]), f12.HALO,
            consts[0].kind)[3]
        assert info["blocks_per_sm"] >= (2 if dtype == torch.float32
                                         else 1)
