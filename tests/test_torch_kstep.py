"""Kernel K14, the speculative K-step fused ERK kernel
(crdmodel_tpu_torch/ops/fused_kstep.py), and its selection (sim.py).

On the CPU: the kernel's plain version against the JAX package's Pallas
kernel run in interpret mode (pallas_call patched with interpret=True for
the test's duration), f32, from numpy-seeded states; against j plain K1
steps, bitwise; a whole kernel-batched run against the port's torch-path
batched run (f64) and against JAX's integrate_to_outputs with its K14 and
K1 in interpret mode (f32); the gate and the route table against JAX's.
On a CUDA card (marker `cuda`): the CUDA kernel against the plain version
and against K1's launches, bitwise. The JAX package is imported inside the
tests that use it, so that the card tests run where JAX is not installed:

    python -m pytest tests/test_torch_kstep.py -m cuda --noconftest
"""

import dataclasses
import functools
import inspect

import numpy as np
import pytest
import torch

from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.core.problem import build_problem
from crdmodel_tpu_torch.integrate.erk import TABLEAUS, integrate_to_outputs
from crdmodel_tpu_torch.ops import fused_kstep as fk
from crdmodel_tpu_torch.ops import fused_step as fs
from crdmodel_tpu_torch.ops.kernel_common import SMEM_BYTES, prepare_constants
from crdmodel_tpu_torch.sim import make_run_fn, output_times, simulate

# 64 rows: the JAX kernel's deepest halo (P = 32 at K = 10) on 32 rows is
# degenerate (NaN error sums in its interpret mode, and in K1 with that
# halo), a property of the reference
BASE = dict(model="fhn", x_mesh=32, surface_width=20, surface_length=40,
            t_final=1.0, output_timestep=2, beta=1.25, beta_min=0.7,
            beta_max=1.7, t_boundary=0.4, dtype="float32", rtol=1e-4,
            atol=1e-6)
SURFACES = {"torus": dict(surface="torus", vary_beta=1),    # beta ramp
            "flat": dict(surface="flat", vary_beta=0)}
BATCHES = [("bs32", 2), ("bs32", 5), ("bs32", 10), ("dopri54", 2)]
# frozen-h sub-steps with error estimates well above f32 rounding
# (dopri54's 5th-order error at h = 0.01 is at the rounding level)
H = 0.01
H_OF = {"bs32": H, "dopri54": 0.1}
# K1's f32 limit (tests/test_torch_fused_step.py::_close) and the
# sub-step sums' relative limit
Y_TOL = 2e-5
SS_TOL = 1e-3


def _state(shape, seed=11):
    return np.random.default_rng(seed).uniform(-2.0, 2.0, shape)


def _close(got, want, y_scale):
    err = np.max(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)))
    assert err <= Y_TOL * max(1.0, y_scale), err


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Every pallas_call built while the test runs is in interpret mode."""
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("surface", sorted(SURFACES))
def test_plain_kstep_matches_jax_kernel(surface, interpret_pallas):
    """The plain K14 against JAX's K14 in interpret mode: bs32 K = 2, 5,
    10 and dopri54 K = 2; frozen and released; n_commit 0, 1 and K; the
    committed state to K1's f32 limit, every sub-step's error sum to 1e-3
    relative."""
    import jax
    import jax.numpy as jnp

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild_problem
    from crdmodel_tpu.integrate.erk import TABLEAUS as JTABLEAUS
    from crdmodel_tpu.ops import pallas_kstep

    kw = {**BASE, **SURFACES[surface]}
    jp = jbuild_problem(JSimConfig(**kw))
    tp = build_problem(SimConfig(**kw), device="cpu")
    kc = prepare_constants(tp, torch.float32, "cpu")
    y_np = _state(np.shape(jp.y0)).astype(np.float32)
    y_t = torch.tensor(y_np)
    for method, k in BATCHES:
        h_t = torch.tensor(H_OF[method], dtype=torch.float32)
        ks = pallas_kstep.build_fused_kstep(jp, JTABLEAUS[method], k,
                                            jnp.float32)
        call = jax.jit(lambda yp, h, nc, seg: ks.call(
            0.0, yp, h, nc, {**jp.params, "_seg_end": seg}))
        for seg_end, fz in ((0.4, 1.0), (1.0, 0.0)):
            for n_commit in (0, 1, k):
                yp_new, sss = call(ks.pad(jnp.asarray(y_np)),
                                   jnp.float32(H_OF[method]),
                                   jnp.int32(n_commit), jnp.float32(seg_end))
                y_new, sums = fk.fused_kstep(
                    y_t, h_t, torch.tensor(fz), n_commit, kc,
                    TABLEAUS[method], k, kw["rtol"], kw["atol"])
                _close(y_new.numpy(), ks.unpad(yp_new), np.abs(y_np).max())
                want = np.asarray(sss, np.float64).sum(axis=0)
                got = sums.numpy().astype(np.float64).sum(axis=0)
                assert want.shape == got.shape == (k,)
                assert np.all(np.abs(got - want) <= SS_TOL * want), (
                    method, k, fz, n_commit, got, want)
                if n_commit == 0:
                    assert torch.equal(y_new, y_t)
                if fz and n_commit:
                    # frozen rows hold still
                    np.testing.assert_array_equal(
                        y_new[:, [0, -1]].numpy(), y_np[:, [0, -1]])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("method,k", BATCHES)
def test_plain_kstep_is_plain_k1_steps(method, k, dtype):
    """Sub-step j of the plain K14 is bitwise j plain K1 steps, its error
    sum bitwise the j-th step's, frozen and released."""
    tp = build_problem(SimConfig(**{**BASE, **SURFACES["torus"]}), "cpu")
    kc = prepare_constants(tp, dtype, "cpu")
    tab = TABLEAUS[method]
    y0 = torch.tensor(_state(tuple(tp.y0.shape)), dtype=dtype)
    h = torch.tensor(H, dtype=dtype)
    for fz in (0.0, 1.0):
        fzt = torch.tensor(fz, dtype=dtype)
        _, sums = fk.fused_kstep(y0, h, fzt, k, kc, tab, k, 1e-4, 1e-6)
        y = y0
        for j in range(k + 1):
            y_c, _ = fk.fused_kstep(y0, h, fzt, j, kc, tab, k, 1e-4, 1e-6)
            assert torch.equal(y_c, y), (j, fz)
            if j < k:
                y, ss = fs.fused_step_reference(y, h, fzt, kc, tab, 1e-4,
                                                1e-6)
                assert torch.equal(sums[:, j], ss), (j, fz)


def test_plain_kstep_recovery_and_skip_codes():
    """The loop's device codes: n_commit < 0 gives y; a recovery launch
    (full=False) computes the committed prefix only; work_counts counts the
    launches that did work."""
    tp = build_problem(SimConfig(**{**BASE, **SURFACES["flat"]}), "cpu")
    kc = prepare_constants(tp, torch.float32, "cpu")
    tab = TABLEAUS["bs32"]
    y = torch.tensor(_state(tuple(tp.y0.shape)), dtype=torch.float32)
    h, fz = torch.tensor(H), torch.tensor(0.0)
    counts = fk.work_counts("cpu")
    before = counts.clone()
    full2, sums = fk.fused_kstep(y, h, fz, 2, kc, tab, 4, 1e-4, 1e-6)
    rec2, rec_sums = fk.fused_kstep(y, h, fz, 2, kc, tab, 4, 1e-4, 1e-6,
                                    full=False)
    assert torch.equal(full2, rec2)
    assert torch.equal(rec_sums[:, :2], sums[:, :2])
    assert torch.isnan(rec_sums[:, 2:]).all()
    for n, full in ((-1, True), (-1, False), (-2, False)):
        y_c, _ = fk.fused_kstep(y, h, fz, n, kc, tab, 4, 1e-4, 1e-6,
                                full=full)
        assert torch.equal(y_c, y)
    assert (counts - before).tolist() == [1, 1]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("method,k", BATCHES)
def test_kstep_plan_fits(method, k, itemsize):
    """K14's blocks for each tableau and K the gate takes: K1's tile with
    n - 1 rings, an instantiated (stages, tile) pair, the threads' slots
    covering the region, static shared memory within a block's 48 KB (and
    so the 227 KB an H100 block may use), at most K grid barriers."""
    tab = TABLEAUS[method]
    tile_y, halo, slots, smem = fk.kstep_plan(tab.stages, itemsize)
    assert tile_y == fs.tile_plan(tab.stages, itemsize)[1]
    assert halo == tab.stages - 1
    assert (tab.stages, tile_y) in fk.KERNEL_TILES[itemsize]
    region = (fs.TILE_X + 2 * halo) * (tile_y + 2 * halo)
    assert slots * fk.THREADS >= region > (slots - 1) * fk.THREADS
    assert smem <= 48 * 1024 <= SMEM_BYTES
    assert fk.grid_barriers(k) <= k
    assert fk.THREADS % 256 == 0      # K1's 256-thread order fits whole


def test_tile_error_sums_order():
    """tile_error_sums' per-tile partials add up to error_sum, and a tile
    is K1's: 32 columns, tile_y rows, row-major over the tiles."""
    rng = np.random.default_rng(3)
    err = torch.tensor(rng.standard_normal((2, 40, 70)))
    y = torch.tensor(rng.uniform(-2, 2, (2, 40, 70)))
    for tile_y in (8, 16, 32):
        parts = fk.tile_error_sums(err, y, 1e-4, 1e-6, tile_y)
        assert parts.shape == (-(-70 // 32) * -(-40 // tile_y),)
        total = float(fs.error_sum(err, y, 1e-4, 1e-6))
        assert abs(float(parts.sum()) - total) <= 1e-12 * total
        w = err / (1e-4 * y.abs() + 1e-6)
        first = torch.sum(w[:, :tile_y, :32] ** 2)
        assert abs(float(parts[0]) - float(first)) <= 1e-12 * float(first)


def _kstep_run_inputs(kw, k, dtype):
    cfg = SimConfig(**{**kw, "dtype": dtype})
    problem = build_problem(cfg, "cpu")
    tab = TABLEAUS[cfg.method]
    kstep = fk.build_fused_kstep(problem, tab, k)
    step = fs.build_fused_step(problem, tab)
    run_kw = dict(rtol=cfg.rtol, atol=cfg.atol, method=cfg.method,
                  max_steps=cfg.max_steps,
                  breakpoints=(cfg.t_boundary,), spec_k=k,
                  kstep_call=kstep.call, err_order=tab.err_order,
                  step_err=lambda t, y, h, p, c: (*step(t, y, h, p), ()))
    return cfg, problem, run_kw


RUN_KW = dict(BASE, surface="torus", vary_beta=1, x_mesh=16, t_final=2.0,
              t_boundary=0.7, rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("k", [2, 5])
def test_kernel_batched_run_takes_torch_path_steps(k):
    """In f64 the plain K14 with the plain K1 tail takes the port's
    torch-path batched run's steps, and ends within 1e-12 of it."""
    cfg, problem, run_kw = _kstep_run_inputs(RUN_KW, k, "float64")
    traj, stats = integrate_to_outputs(problem.rhs, problem.y0,
                                       problem.params, 0.0,
                                       output_times(cfg), **run_kw)
    ref = simulate(dataclasses.replace(cfg, speculative_k=k,
                                       use_pallas=False), device="cpu")
    for field in ("steps", "accepted", "rejected", "status"):
        assert getattr(stats, field).tolist() == \
            getattr(ref.stats, field).tolist(), field
    assert float((traj - ref.trajectory[1:]).abs().max()) <= 1e-12


def test_kernel_batched_run_matches_jax(interpret_pallas):
    """In f32 the port's kernel-batched run (plain K14, plain K1 tail)
    against JAX's integrate_to_outputs with its K14 and K1 in interpret
    mode: steps within 2 an interval, fields within 1e-4 (f32 rounding
    through some 40 steps of an O(1) wave)."""
    import jax
    import jax.numpy as jnp

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild_problem
    from crdmodel_tpu.core.problem import solver_breakpoints
    from crdmodel_tpu.integrate.erk import TABLEAUS as JTABLEAUS
    from crdmodel_tpu.integrate.erk import \
        integrate_to_outputs as jintegrate
    from crdmodel_tpu.ops import pallas_kstep, pallas_step

    k = 2
    kw = dict(RUN_KW, x_mesh=32, rtol=1e-5, atol=1e-8)
    cfg, problem, run_kw = _kstep_run_inputs(kw, k, "float32")
    traj, stats = integrate_to_outputs(problem.rhs, problem.y0,
                                       problem.params, 0.0,
                                       output_times(cfg), **run_kw)

    jcfg = JSimConfig(**kw)
    jp = jbuild_problem(jcfg)
    tab = JTABLEAUS["bs32"]
    P = pallas_kstep.halo_for(tab, k)
    fused = pallas_step.build_fused_step(jp, tab, jnp.float32, halo=P,
                                         interpret=True)
    ks = pallas_kstep.build_fused_kstep(jp, tab, k, jnp.float32)

    def run(y0, params):
        return jintegrate(
            jp.rhs, y0, params, 0.0, output_times(cfg), rtol=jcfg.rtol,
            atol=jcfg.atol, method="bs32", max_steps=jcfg.max_steps,
            breakpoints=solver_breakpoints(jcfg, jp.forcing), spec_k=k,
            kstep_call=ks.call, err_order=tab.err_order,
            step_err=lambda t, y, h, p, c: (*fused.step_err(t, y, h, p), ()),
            y_loop0=fused.pad(y0), capture=fused.unpad)

    jtraj, jstats = jax.jit(run)(jp.y0, jp.params)
    steps, jsteps = stats.steps.numpy(), np.asarray(jstats.steps)
    assert np.all(np.abs(steps - jsteps) <= 2), (steps, jsteps)
    assert np.all(np.asarray(jstats.status) == 0)
    assert stats.status.tolist() == [0] * len(steps)
    err = float(np.max(np.abs(traj.numpy() - np.asarray(jtraj))))
    assert err <= 1e-4, err


def _jax_problem(kw, **build_kw):
    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild_problem
    return jbuild_problem(JSimConfig(**kw), **build_kw)


def test_gate_matches_jax():
    """halo_for, max_k and is_kstep_supported against JAX's: forcing,
    zonneveld43 (not FSAL), k < 1, the divergence form, f64; and a
    diffusion tensor, which JAX's gate accepts (its K1 gate leaves tensors
    to the driver, which routes them to K5 first) and the port's declines
    (ROADMAP queue 3)."""
    import jax.numpy as jnp

    from crdmodel_tpu.integrate.erk import TABLEAUS as JTABLEAUS
    from crdmodel_tpu.ops import pallas_kstep

    for name in ("bs32", "zonneveld43", "dopri54"):
        for k in range(0, 21):
            assert fk.halo_for(TABLEAUS[name], k) == \
                pallas_kstep.halo_for(JTABLEAUS[name], k)
        for halo in (8, 16, 32, 64):
            assert fk.max_k(TABLEAUS[name], halo) == \
                pallas_kstep.max_k(JTABLEAUS[name], halo)
    assert fk.max_k(TABLEAUS["bs32"]) == pallas_kstep.max_k(JTABLEAUS["bs32"])

    kw = {**BASE, **SURFACES["flat"]}
    cases = [(kw, {}, "bs32", k, "float32") for k in (-1, 0, 1, 2, 5, 10)]
    cases += [(kw, {}, "zonneveld43", 2, "float32"),
              (kw, {}, "dopri54", 2, "float32"),
              (kw, {}, "bs32", 2, "float64"),
              ({**kw, "boundary": "noflux"}, {}, "bs32", 2, "float32")]
    for ckw, build_kw, method, k, dtype in cases:
        jp = _jax_problem(ckw, **build_kw)
        tp = build_problem(SimConfig(**ckw), "cpu", **build_kw)
        want = pallas_kstep.is_kstep_supported(jp, JTABLEAUS[method],
                                               jnp.dtype(dtype), k)
        got = fk.is_kstep_supported(tp, TABLEAUS[method],
                                    getattr(torch, dtype), k)
        assert got == want, (method, k, dtype, ckw.get("boundary"))
    tp = build_problem(SimConfig(**kw), "cpu")
    forced = dataclasses.replace(tp, forcing=object())
    assert not fk.is_kstep_supported(forced, TABLEAUS["bs32"],
                                     torch.float32, 2)

    shape = (64, 32)
    tensor = (np.ones(shape), np.full(shape, 0.5), np.full(shape, 0.1))
    jp = _jax_problem(kw, diffusion_tensor=tensor)
    tp = build_problem(SimConfig(**kw), "cpu", diffusion_tensor=tensor)
    assert pallas_kstep.is_kstep_supported(jp, JTABLEAUS["bs32"],
                                           jnp.float32, 2)
    assert not fk.is_kstep_supported(tp, TABLEAUS["bs32"], torch.float32, 2)


def test_gate_takes_canonical_tori():
    """K = 2, 5 and 10 with bs32 on the canonical FHN (1600x400) and
    Goldbeter (400x100) tori, as JAX's gate does."""
    from crdmodel_tpu_torch.config import config_from_ini
    for ini, model in (("data/FHNmodelArgs.ini", "fhn"),
                       ("data/GoldbeterModelArgs.ini", "goldbeter")):
        p = build_problem(config_from_ini(ini, model=model, surface="torus"),
                          "cpu")
        for k in (2, 5, 10):
            assert fk.is_kstep_supported(p, TABLEAUS["bs32"], torch.float32,
                                         k), (model, k)


def _route(run):
    """(spec_k, K14 selected) of a make_run_fn closure, the port's or
    JAX's."""
    nonlocals = inspect.getclosurevars(run).nonlocals
    kstep = (nonlocals.get("kstep") is not None
             or "kstep_call" in nonlocals.get("kw", {}))
    return int(nonlocals["spec_k"]), kstep


ROUTE_KW = dict(BASE, surface="flat", x_mesh=8, speculative_k=4)


@pytest.mark.parametrize("name,kw,build_kw", [
    ("torch path", dict(use_pallas=False), {}),
    ("rkc2", dict(method="rkc2", use_pallas=True), {}),
    ("normal", dict(step_mode="normal", use_pallas=True), {}),
    ("K3", dict(method="ark324", use_pallas=True), {}),
    ("torch ark324", dict(method="ark324", use_pallas=False), {}),
    ("K4", dict(boundary="noflux", use_pallas=True), {}),
    ("K5", dict(use_pallas=True), {"tensor": True}),
    ("K6", dict(surface="box", z_mesh=4, surface_depth=2.0,
                boundary="noflux", model="aliev_panfilov", beta=0.15,
                use_pallas=True), {}),
])
def test_route_matches_jax(name, kw, build_kw):
    """sim.make_run_fn's speculation decision against JAX's make_run_fn
    (interpret=True, its kernels in interpret mode) where both take the
    same kernels."""
    from crdmodel_tpu.sim import make_run_fn as jmake_run_fn

    ckw = {**ROUTE_KW, **kw}
    if build_kw.get("tensor"):
        shape = (16, 8)
        build_kw = dict(diffusion_tensor=(np.ones(shape),
                                          np.full(shape, 0.5),
                                          np.full(shape, 0.1)))
    jrun, _ = jmake_run_fn(_jax_problem(ckw, **build_kw), interpret=True)
    run, _, _ = make_run_fn(build_problem(SimConfig(**ckw), "cpu",
                                          **build_kw))
    assert _route(run) == _route(jrun), name
    assert _route(run)[1] is False


def test_route_k14_on_cpu():
    """K1's route with use_pallas=True on the CPU: the port selects K14's
    plain version (spec_k = K); JAX's interpret=True never selects K14 and
    steps per step through its K1 (spec_k = 0), the one deliberate
    difference (ROADMAP queue 3)."""
    from crdmodel_tpu.sim import make_run_fn as jmake_run_fn

    ckw = dict(ROUTE_KW, use_pallas=True)
    run, _, fused = make_run_fn(build_problem(SimConfig(**ckw), "cpu"))
    jrun, _ = jmake_run_fn(_jax_problem(ckw), interpret=True)
    assert fused and _route(run) == (4, True)
    assert _route(jrun) == (0, False)


def test_kstep_run_through_simulate():
    """simulate() with speculative_k on K1's route takes K14's plain
    version (batches counted, no launch) with the plain K1 tail, and
    agrees with the per-step K1 run to the integrator's tolerance."""
    kw = dict(RUN_KW, dtype="float32", rtol=1e-5, atol=1e-8,
              use_pallas=True)
    launches = fk.fused_kstep.launches
    counts = fk.work_counts("cpu").clone()
    res = simulate(SimConfig(**kw, speculative_k=5), device="cpu")
    per_step = simulate(SimConfig(**kw), device="cpu")
    assert res.ok and res.fused and per_step.ok
    assert fk.fused_kstep.launches == launches
    batches, recoveries = (fk.work_counts("cpu") - counts).tolist()
    assert batches > 0 and 0 <= recoveries <= batches
    assert res.total_steps() >= 5 * (batches - recoveries)
    err = float((res.trajectory - per_step.trajectory).abs().max())
    assert err <= 1e-3, err


CUDA = pytest.mark.skipif("not torch.cuda.is_available()",
                          reason="needs a CUDA card and nvcc")


@pytest.mark.cuda
@CUDA
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("method,k", BATCHES)
@pytest.mark.parametrize("surface", sorted(SURFACES))
def test_cuda_kernel_matches_plain(surface, method, k, dtype):
    """The CUDA K14 bitwise its plain version (state and every partial
    sum, in K1's tile order) and j K1 launches, n_commit 0, 1, K-1, K,
    frozen and released; two launches bitwise equal; launches counted."""
    cfg = SimConfig(**{**BASE, **SURFACES[surface], "x_mesh": 48,
                       "surface_length": 80})
    p = build_problem(cfg, device="cuda")
    kc = prepare_constants(p, dtype, "cuda")
    tab = TABLEAUS[method]
    y = torch.tensor(_state(tuple(p.y0.shape)), dtype=dtype, device="cuda")
    h = torch.tensor(H, dtype=dtype, device="cuda")
    _, tile_y, _ = fs.tile_plan(tab.stages, y.element_size())
    for fz in (0.0, 1.0):
        fzt = torch.tensor(fz, dtype=dtype, device="cuda")
        y1, ss1 = y, []
        k1_states = [y]
        for _ in range(k):
            y1, ss = fs.fused_step(y1, h, fzt, kc, tab, 1e-4, 1e-6)
            k1_states.append(y1)
            ss1.append(ss)
        for n_commit in sorted({0, 1, k - 1, k}):
            before = fk.fused_kstep.launches
            args = (y, h, fzt, n_commit, kc, tab, k, 1e-4, 1e-6)
            y_k, ss_k = fk.fused_kstep(*args)
            y_k2, ss_k2 = fk.fused_kstep(*args)
            assert fk.fused_kstep.launches == before + 2
            y_r, ss_r = fk.fused_kstep_reference(*args, tile_y=tile_y)
            torch.cuda.synchronize()
            assert torch.equal(y_k, y_k2) and torch.equal(ss_k, ss_k2)
            assert torch.equal(y_k, y_r) and torch.equal(ss_k, ss_r)
            assert torch.equal(y_k, k1_states[n_commit])
            assert torch.equal(ss_k, torch.stack(ss1, dim=1))


@pytest.mark.cuda
@CUDA
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("method,k", [("bs32", 5), ("dopri54", 2)])
def test_cuda_kernel_on_a_grid_smaller_than_its_halo(method, k, dtype):
    """K14 on a 4-column torus, fewer columns than a tile's halo wraps
    onto: bitwise its plain version and j K1 launches, n_commit 0, 1,
    K-1, K; the kernel's static shared bytes are kstep_plan's."""
    cfg = SimConfig(**{**BASE, **SURFACES["torus"], "x_mesh": 4,
                       "surface_length": 40})
    p = build_problem(cfg, device="cuda")
    kc = prepare_constants(p, dtype, "cuda")
    tab = TABLEAUS[method]
    y = torch.tensor(_state(tuple(p.y0.shape)), dtype=dtype, device="cuda")
    h = torch.tensor(H_OF[method], dtype=dtype, device="cuda")
    tile_y = fk.kstep_plan(tab.stages, y.element_size())[0]
    fzt = torch.tensor(1.0, dtype=dtype, device="cuda")
    k1_states, ss1 = [y], []
    for _ in range(k):
        y1, ss = fs.fused_step(k1_states[-1], h, fzt, kc, tab, 1e-4, 1e-6)
        k1_states.append(y1)
        ss1.append(ss)
    for n_commit in sorted({0, 1, k - 1, k}):
        args = (y, h, fzt, n_commit, kc, tab, k, 1e-4, 1e-6)
        y_k, ss_k = fk.fused_kstep(*args)
        y_r, ss_r = fk.fused_kstep_reference(*args, tile_y=tile_y)
        torch.cuda.synchronize()
        assert torch.equal(y_k, y_r) and torch.equal(ss_k, ss_r)
        assert torch.equal(y_k, k1_states[n_commit])
        assert torch.equal(ss_k, torch.stack(ss1, dim=1))
    info = fk.kernel_info(dtype, kc.kinetics_id, tab.stages)
    assert info["shared_bytes"] == fk.kstep_plan(tab.stages,
                                                 y.element_size())[3]
    assert info["blocks_per_sm"] >= 1
