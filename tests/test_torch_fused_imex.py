"""Kernel K3, the fused IMEX ARK3(2)4L[2]SA step
(crdmodel_tpu_torch/ops/fused_imex.py).

On the CPU: the kernel's plain version against the JAX package's Pallas
kernel run in interpret mode (f32) and against the port's torch-path
ark324 step (f64); simulate() through the fused path against the JAX
package's fused run in interpret mode; the launch's plan (slots_plan) and
the plain version of the kernel's partial sums (fused_imex_tile_sums:
their number, and their total against the plain step's sum) on the
4-column torus, an odd flat grid and a torus, at both plans' tiles.
On a CUDA card (marker `cuda`): the CUDA kernel against the plain version,
y_new and every partial sum bitwise, at the plan sized to the grid and at
the 32x32 plan. The JAX package is imported inside the tests that use it,
so that the card tests run where JAX is not installed:

    python -m pytest tests/test_torch_fused_imex.py -m cuda --noconftest
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.convert import inputs_from_numpy
from crdmodel_tpu_torch.core.problem import build_problem, make_rhs
from crdmodel_tpu_torch.integrate import imex
from crdmodel_tpu_torch.ops import fused_imex as fi
from crdmodel_tpu_torch.ops.kernel_common import SMEM_BYTES, prepare_constants

# tests/test_imex.py's fused-kernel case (test_fused_imex_kernel_
# interpreter_matches_xla): tBoundary=1.0, f32, rtol 1e-5
BETAS = {"fhn": 1.25, "goldbeter": 0.5, "aliev_panfilov": 0.1}
CASES = [(m, s) for m in sorted(BETAS) for s in ("torus", "flat")]
IDS = [f"{m}-{s}" for m, s in CASES]
# (t, seg_end, fz): a step in the frozen piece, and one after the release
SEGMENTS = ((0.3, 0.8, 1.0), (1.3, 2.0, 0.0))
# The steps of each model against the JAX kernel, (h, whether the sums are
# compared), and the limit on y. JAX on the CPU contracts a*b + c into one
# FMA, and the port rounds every operation, so the two differ by ulps. The
# sum carries (1/NEWTON_TOL)^2 times the squared scaled last Newton update,
# which is itself a few ulps: at FHN's h = 0.01 (tests/test_imex.py's step)
# that rounding is 11% of the sum, so only y is compared there. At h = 0.1
# the error estimate dominates, and the sums agree to 3e-5. Goldbeter's y:
# the JAX kernel differentiates the kinetics, the port evaluates the
# closed-form Jacobian (1.2e-6 measured; the JAX package's own kernel
# agrees with its XLA path to 1e-6 on Goldbeter,
# docs/PERF_NOTES.md:390-392).
STEPS = {"fhn": ((0.01, False), (0.1, True)), "goldbeter": ((0.01, True),),
         "aliev_panfilov": ((0.01, False), (0.1, True))}
Y_ATOL = {"fhn": 5e-7, "goldbeter": 2e-6, "aliev_panfilov": 2e-6}


def _cfg(model, surface, **over):
    return {**dict(model=model, surface=surface, x_mesh=16,
                   surface_width=20, surface_length=80, t_boundary=1.0,
                   t_final=2.0, beta=BETAS[model], dtype="float32",
                   rtol=1e-5, atol=1e-8, method="ark324"), **over}


def _state(y0, seed=0):
    """tests/test_imex.py's state: the IC plus 0.05 N(0, 1) noise."""
    return y0 + 0.05 * np.random.default_rng(seed).standard_normal(y0.shape)


@pytest.mark.parametrize("model,surface", CASES, ids=IDS)
def test_plain_step_matches_jax_kernel(model, surface):
    """fused_imex_step_reference through build_fused_imex_step against the
    JAX Pallas kernel in interpret mode, f32, frozen and released;
    tests/test_imex.py's tolerances (atol 5e-7 on y, rtol 1e-4 on the
    sum), with Goldbeter's y to 2e-6 (STEPS and Y_ATOL above)."""
    import jax.numpy as jnp

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild_problem
    from crdmodel_tpu.ops import pallas_imex

    kw = _cfg(model, surface)
    jp = jbuild_problem(JSimConfig(**kw))
    jfused = pallas_imex.build_fused_imex_step(jp, jnp.float32,
                                               interpret=True)
    tp = build_problem(SimConfig(**kw), device="cpu")
    assert fi.is_imex_supported(tp, torch.float32)
    step_err = fi.build_fused_imex_step(tp)
    y_np = _state(np.asarray(jp.y0)).astype(np.float32)
    y_t, _ = inputs_from_numpy(y_np, {}, device="cpu", dtype=torch.float32)
    for (t, seg_end, fz), (h, sums) in itertools.product(SEGMENTS,
                                                         STEPS[model]):
        jpar = {**jp.params, "_seg_end": jnp.asarray(seg_end, jnp.float32)}
        tpar = {**tp.params, "_seg_end": torch.tensor(seg_end)}
        y2p, ss2 = jfused.step_err(jnp.asarray(t, jnp.float32),
                                   jfused.pad(jnp.asarray(y_np)),
                                   jnp.asarray(h, jnp.float32), jpar)
        y_new, ss = step_err(torch.tensor(t), y_t, torch.tensor(h), tpar)
        assert ss.dim() == 0
        np.testing.assert_allclose(y_new.numpy(),
                                   np.asarray(jfused.unpad(y2p)), rtol=0,
                                   atol=Y_ATOL[model])
        if sums:
            np.testing.assert_allclose(float(ss), float(ss2), rtol=1e-4)
        if fz:
            # frozen rows hold still
            np.testing.assert_array_equal(y_new[:, [0, -1]].numpy(),
                                          y_np[:, [0, -1]])


@pytest.mark.parametrize("model,surface", CASES, ids=IDS)
def test_plain_step_f64_matches_torch_path(model, surface):
    """In f64 the plain K3 (closed-form Jacobian) is the port's torch-path
    ark324 step (AD Jacobian, integrate/imex.py) to 1e-13."""
    kw = _cfg(model, surface, dtype="float64")
    tp = build_problem(SimConfig(**kw), device="cpu")
    kc = prepare_constants(tp, torch.float64, "cpu")
    f_ex, f_im = make_rhs(tp.cfg, tp.model, tp.geometry, torch.float64,
                          "cpu", split=True)
    tstep, _ = imex.make_imex_step_err(f_ex, f_im, kw["rtol"], kw["atol"])
    y = torch.tensor(_state(tp.y0.numpy(), seed=1))
    for t, seg_end, fz in SEGMENTS:
        par = {**tp.params, "_seg_end": torch.tensor(seg_end,
                                                     dtype=torch.float64)}
        h = torch.tensor(STEPS[model][-1][0], dtype=torch.float64)
        want_y, want_ss, _ = tstep(torch.tensor(t, dtype=torch.float64), y,
                                   h, par, ())
        got_y, got_ss = fi.fused_imex_step_reference(
            y, h, torch.tensor(fz, dtype=torch.float64), kc, kw["rtol"],
            kw["atol"])
        scale = max(1.0, float(want_y.abs().max()))
        assert float((got_y - want_y).abs().max()) <= 1e-13 * scale
        np.testing.assert_allclose(float(got_ss), float(want_ss), rtol=1e-13)


# x_mesh=16 on the torus: the JAX kernel's strip plan needs ny % 8 == 0
SIM_CFG = dict(model="goldbeter", surface="torus", x_mesh=16,
               surface_width=20, surface_length=40, beta=0.4, wave_inside=1,
               wave_length=0.2, wave_width=0.5, t_boundary=0.4, t_final=1.0,
               output_timestep=5, dtype="float32", rtol=1e-4, atol=1e-6,
               method="ark324", use_pallas=True)


def test_fused_simulate_matches_jax_fused(monkeypatch):
    """simulate() on the CPU through the plain K3 against the JAX package's
    fused run in interpret mode: the same attempted, accepted and rejected
    steps in every interval. The trajectory is held to the JAX package's
    own f32 spread, as chip_smoke.py holds the probes: within 2x the JAX
    fused run's distance to its f64 run, plus 1e-4, of the f64 run. The
    wave front amplifies rounding at rtol 1e-4: the JAX package's own fused
    and XLA f32 runs of this config differ by 9.8e-4, its fused f32 and
    f64 runs by 1.6e-3."""
    import jax

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild_problem
    from crdmodel_tpu.sim import make_run_fn

    from crdmodel_tpu_torch.integrate.erk import SYNC_EVERY, merge_stops
    from crdmodel_tpu_torch.sim import output_times, simulate

    from crdmodel_tpu.sim import simulate as jsimulate

    jp = jbuild_problem(JSimConfig(**SIM_CFG))
    tj, sj = jax.jit(make_run_fn(jp, interpret=True)[0])(jp.y0, jp.params)
    j64 = np.asarray(jsimulate(JSimConfig(**{
        **SIM_CFG, "dtype": "float64", "use_pallas": False})).trajectory[1:])

    calls = {"plain_k3": 0}
    plain = fi.fused_imex_step_reference

    def counted(*args, **kw):
        calls["plain_k3"] += 1
        return plain(*args, **kw)

    def no_torch_path(*args, **kw):
        raise AssertionError("the fused run built the torch-path stepper")

    monkeypatch.setattr(fi, "fused_imex_step_reference", counted)
    monkeypatch.setattr(imex, "make_imex_step_err", no_torch_path)
    res = simulate(SimConfig(**SIM_CFG), device="cpu")

    assert res.fused and res.ok
    n_stops = len(merge_stops(output_times(res.cfg), (0.4,))[0])
    assert (res.total_steps() <= calls["plain_k3"]
            <= res.total_steps() + SYNC_EVERY * n_stops)
    for name in ("steps", "accepted", "rejected"):
        np.testing.assert_array_equal(getattr(res.stats, name).numpy(),
                                      np.asarray(getattr(sj, name)),
                                      err_msg=name)
    limit = 2.0 * np.abs(np.asarray(tj) - j64).max() + 1e-4
    assert np.abs(res.trajectory[1:].numpy() - j64).max() <= limit


@pytest.mark.parametrize("use_pallas", [None, False])
def test_selection_on_cpu(use_pallas):
    """Auto mode takes K3 only on CUDA; False forces the torch path."""
    from crdmodel_tpu_torch.sim import simulate

    res = simulate(SimConfig(**{**SIM_CFG, "use_pallas": use_pallas,
                                "t_final": 0.2, "output_timestep": 1}),
                   device="cpu")
    assert not res.fused and res.ok


def test_gate():
    p = build_problem(SimConfig(**_cfg("goldbeter", "torus")), "cpu")
    assert fi.is_imex_supported(p, torch.float32)
    assert fi.is_imex_supported(
        build_problem(SimConfig(**_cfg("fhn", "flat")), "cpu"), torch.float32)
    assert not fi.is_imex_supported(p, torch.float64)
    assert not fi.is_imex_supported(dataclasses.replace(p, forcing=object()),
                                    torch.float32)
    assert not fi.is_imex_supported(
        dataclasses.replace(p, diffusion_field=np.ones((64, 16))),
        torch.float32)
    two_diffusing = dataclasses.replace(p, model=dataclasses.replace(
        p.model, diffusive_vars=(0, 1), diffusion_ratios=(1.0, 1.0)))
    assert not fi.is_imex_supported(two_diffusing, torch.float32)
    p_jd = build_problem(SimConfig(**_cfg("goldbeter", "torus",
                                          just_diffusion=1)), "cpu")
    assert not fi.is_imex_supported(p_jd, torch.float32)


# the shared memory and registers of one H100 SM
SM_SHARED_BYTES = 228 * 1024
SM_REGISTERS = 65536
# (ny, nx) and the plan's (tile_y, blocks): the canonical Goldbeter torus
# (32x32 tiles would fill 52 of the 132 SMs: 32x16), the 2.56M-point one,
# the 4-column torus, an odd grid, and the smallest 32x32 plan
PLANS = [(400, 100, 16, 100), (3200, 800, 32, 2500), (16, 4, 16, 1),
         (75, 37, 16, 10), (384, 352, 32, 132)]


@pytest.mark.parametrize("ny,nx,tile_y,blocks", PLANS)
@pytest.mark.parametrize("itemsize", [4, 8])
def test_slots_plan(ny, nx, tile_y, blocks, itemsize, monkeypatch):
    """32x16 tiles where 32x32 ones number fewer than the SMs, else 32x32;
    the threads cover the tile in whole slots, the Newton's three rings
    and the outer ring one point each; the shared bytes fit a block and,
    in f32, two blocks of 64 registers a thread an SM."""
    plan = fi.slots_plan(ny, nx, itemsize)
    assert (plan.tile_y, plan.tile_x, plan.blocks) == (tile_y, 32, blocks)
    assert blocks == -(-nx // 32) * -(-ny // tile_y)
    width, rows = 32 + 2 * fi.HALO, tile_y + 2 * fi.HALO
    tile = 32 * tile_y
    assert plan.threads == fi.THREADS
    assert tile == (plan.slots - 1) * plan.threads
    assert (width - 2) * (rows - 2) - tile <= plan.threads
    assert 2 * (width + rows) - 4 <= plan.threads
    assert plan.shared_bytes == fi.slots_bytes(tile_y, itemsize)
    assert plan.shared_bytes <= SMEM_BYTES - 1024
    if itemsize == 4:
        assert 2 * plan.shared_bytes <= SM_SHARED_BYTES
        assert 2 * plan.threads * 64 <= SM_REGISTERS
    monkeypatch.setattr(fi, "SMS", 0)
    assert fi.slots_plan(ny, nx, itemsize).tile_y == 32


# the partial sums' cases: the 4-column torus, which the wrap covers many
# times; an odd flat grid with the beta ramp, partial tiles on both axes;
# Aliev-Panfilov on a torus
SUM_CASES = {
    "goldbeter_torus_4_columns": ("goldbeter", "torus", dict(x_mesh=4)),
    "fhn_flat_odd": ("fhn", "flat", dict(x_mesh=37, y_mesh=75, vary_beta=1)),
    "aliev_panfilov_torus": ("aliev_panfilov", "torus", dict(x_mesh=24)),
}


def _sum_cfg(name):
    model, surface, over = SUM_CASES[name]
    return _cfg(model, surface, **over)


def _sum_case(name, dtype):
    kw = _sum_cfg(name)
    p = build_problem(SimConfig(**kw), device="cpu")
    kc = prepare_constants(p, dtype, "cpu")
    y = torch.tensor(_state(p.y0.numpy(), seed=2), dtype=dtype)
    return kw, kc, y


@pytest.mark.parametrize("tile_y", [16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(SUM_CASES))
def test_tile_sums_add_to_the_plain_total(name, dtype, tile_y):
    """The plain partial sums at both plans' tiles, one a tile, add up to
    the plain step's sum (the error and the Newton's updates) within f32
    rounding (f64: 1e-13), frozen and released."""
    _, kc, y = _sum_case(name, dtype)
    _, ny, nx = y.shape
    for fz in (0.0, 1.0):
        args = (y, torch.tensor(0.01, dtype=dtype),
                torch.tensor(fz, dtype=dtype), kc, 1e-5, 1e-8)
        _, err, dys = fi.imex_stages_reference(*args[:4])
        sums = fi.imex_tile_sums(err, dys, y, 1e-5, 1e-8, tile_y)
        _, total = fi.fused_imex_step_reference(*args)
        assert sums.shape == (-(-nx // 32) * -(-ny // tile_y),)
        rel = 1e-5 if dtype == torch.float32 else 1e-13
        np.testing.assert_allclose(float(sums.sum()), float(total), rtol=rel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(SUM_CASES))
def test_tile_sums_follow_the_plan(name, dtype, monkeypatch):
    """fused_imex_tile_sums has one sum a block of slots_plan, each the
    replay on the plan's tiles: 32x16 on these small grids, 32x32 where
    the plan takes it (SMS forced to 0)."""
    _, kc, y = _sum_case(name, dtype)
    _, ny, nx = y.shape
    args = (y, torch.tensor(0.01, dtype=dtype), torch.tensor(1.0, dtype=dtype),
            kc, 1e-5, 1e-8)
    _, err, dys = fi.imex_stages_reference(*args[:4])
    for sms, tile_y in ((fi.SMS, 16), (0, 32)):
        monkeypatch.setattr(fi, "SMS", sms)
        plan = fi.slots_plan(ny, nx, y.element_size())
        assert plan.tile_y == tile_y
        sums = fi.fused_imex_tile_sums(*args)
        assert sums.shape == (plan.blocks,)
        assert torch.equal(sums, fi.imex_tile_sums(err, dys, y, 1e-5, 1e-8,
                                                   tile_y))


def test_wrapper_refuses_other_devices():
    p = build_problem(SimConfig(**_cfg("goldbeter", "flat")), "cpu")
    kc = prepare_constants(p, torch.float32, "cpu")
    y = torch.empty(p.y0.shape, device="meta")
    with pytest.raises(ValueError, match="no fused IMEX step kernel"):
        fi.fused_imex_step(y, torch.tensor(0.1), torch.tensor(0.0), kc,
                           1e-5, 1e-8)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card and nvcc")
@pytest.mark.parametrize("plan", ["grid", "32x32"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", IDS + sorted(SUM_CASES))
def test_cuda_kernel_matches_plain(name, dtype, plan, monkeypatch):
    """The CUDA kernel against the plain version: y_new and every partial
    sum bitwise (fused_imex_tile_sums), two launches bitwise equal, frozen
    and released, at h = 2.5e-3 and 2e-2, on the plan sized to the grid
    (32x16 tiles here) and on the 32x32 plan; the launch runs the slots
    kernel, whose shared bytes are the plan's, two blocks an SM in f32."""
    from crdmodel_tpu_torch.ops import trace

    if plan == "32x32":
        monkeypatch.setattr(fi, "SMS", 0)
    if name in SUM_CASES:
        kw = _sum_cfg(name)
    else:
        # x_mesh=40: ragged tiles in both directions (nx=40, ny=160)
        model, surface = name.split("-")
        kw = _cfg(model, surface, x_mesh=40,
                  vary_beta=int(surface == "flat"))
    p = build_problem(SimConfig(**kw), device="cuda")
    kc = prepare_constants(p, dtype, "cuda")
    y = torch.tensor(_state(p.y0.cpu().numpy()), dtype=dtype, device="cuda")
    for h_val in (2.5e-3, 2e-2):
        h = torch.tensor(h_val, dtype=dtype, device="cuda")
        for fz in (0.0, 1.0):
            fzt = torch.tensor(fz, dtype=dtype, device="cuda")
            args = (y, h, fzt, kc, 1e-5, 1e-8)
            # a trace can miss kernels, or hold none: pooled traces
            names = trace.kernel_names(lambda: fi.fused_imex_step(*args))
            assert all(fi.SLOTS_KERNEL in n for n in names), names
            before = fi.fused_imex_step.launches
            y_k, ss_k = fi.fused_imex_step(*args)
            y_k2, ss_k2 = fi.fused_imex_step(*args)
            assert fi.fused_imex_step.launches == before + 2
            y_r, _ = fi.fused_imex_step_reference(*args)
            sums = fi.fused_imex_tile_sums(*args)
            torch.cuda.synchronize()
            assert bool(torch.isfinite(y_r).all())
            assert torch.equal(y_k, y_k2) and torch.equal(ss_k, ss_k2)
            assert torch.equal(y_k, y_r)
            assert ss_k.shape == sums.shape and torch.equal(ss_k, sums)
    want = fi.slots_plan(*y.shape[1:], y.element_size())
    assert want.tile_y == (32 if plan == "32x32" else 16)
    info = fi.kernel_info(dtype, kc.kinetics_id, want.tile_y)
    assert info["shared_bytes"] == want.shared_bytes
    assert info["blocks_per_sm"] >= (2 if dtype == torch.float32 else 1)
