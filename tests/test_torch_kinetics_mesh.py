"""K8, K9 and K10 on the six kinetics families beyond the base three
(csrc/fused_shard_step_families.cu, fused_shard_rkc_families.cu,
fused_shard_imex_families.cu; ops/fused_shard_step.py, fused_shard_rkc.py,
fused_shard_imex.py), and the sharded runs of those families.

On the CPU: one sharded step of each family through each kernel's plain
version on a 2x2 mesh, against the JAX package's shard kernel run in
interpret mode under shard_map on its 8 virtual devices, f32, from a
numpy-seeded state (the IC plus 0.05 N(0, 1)): K8 with bs32 and dopri54
at h rho = 1, K9 at s = 5 and s = 23, K10 at h rho = 1, the physical cells
of y to 2e-5 of its scale and the error sum to 1e-3 relative (the limits
of tests/test_torch_kinetics_kernels.py; K10's plain version takes the
closed-form Jacobian where the JAX kernel differentiates the kinetics);
the port's sharded torch path of Gray-Scott (flat and torus) and SIR
against JAX's XLA sharded path in f64 on a 2x2 mesh, step statistics
equal and fields to 1e-12; the plain partial sums against the plain
totals, also on an uneven mesh with mirror-pad rows. The families and
the rest (whole sharded runs through the plain K8, K9 and K10 against the
port's sharded torch path, as tests/test_sharding.py:237-266 holds the
JAX package's fused shard kernels; the gates: K8-K10 take the families
unforced where the JAX shard gates take them, the port's own rules
aside, and K1-K3 and K8-K10 decline them with a structured forcing) are
split between this file and tests/test_torch_kinetics_mesh2.py, so that
pytest-xdist's loadfile spreads them.
On a CUDA card (marker `cuda`): each family's K8, K9 and K10 launch
bitwise its plain version, y_new's block and every partial sum, f32 and
f64, on an even and an uneven mesh. The JAX package is imported inside the
tests that use it, so that the card tests run where JAX is not installed:

    python -m pytest tests/test_torch_kinetics_mesh*.py -m cuda --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.convert import inputs_from_numpy
from crdmodel_tpu_torch.core.problem import build_problem, make_rho_bound
from crdmodel_tpu_torch.integrate import rkc
from crdmodel_tpu_torch.integrate.erk import TABLEAUS
from crdmodel_tpu_torch.ops import fused_shard_imex as f10
from crdmodel_tpu_torch.ops import fused_shard_rkc as f9
from crdmodel_tpu_torch.ops import fused_shard_step as f8
from crdmodel_tpu_torch.ops.fused_rkc import static_stage_tables
from crdmodel_tpu_torch.ops.kernel_common import (NEW_FAMILIES,
                                                  make_shard_constants)
from crdmodel_tpu_torch.parallel.halo import mirror_halo_pad
from crdmodel_tpu_torch.parallel.mesh import make_mesh
from crdmodel_tpu_torch.parallel.sharded import (gather, make_reduce,
                                                 mesh_pad_spec, shard_params,
                                                 sharded_params,
                                                 sharded_rho_bound,
                                                 simulate_sharded,
                                                 split_state)

BETAS = {"barkley": 0.05, "oregonator": 1.5, "grayscott": 0.03,
         "brusselator": 1.9, "lambdaomega": 0.5, "sir": 1.5}
FAMILIES = ("barkley", "grayscott", "lambdaomega")
# the shard steps: (kernel, method, h rho); K9's h rho gives s = 5 and 23
STEPS = (("k8", "bs32", 1.0), ("k8", "dopri54", 1.0), ("k9", "rkc2", 8.0),
         ("k9", "rkc2", 300.0), ("k10", "ark324", 1.0))
Y_TOL = 2e-5
SUM_RTOL = 1e-3
# a step in the frozen piece
SEG_END = 0.8


def _kw(model, **over):
    """A family's small torus: 96x48, 48x24 blocks on a 2x2 mesh (K9's
    P_RKC = 24 deep), fine enough with D = 1 that diffusion sets rho."""
    return {**dict(model=model, surface="torus", x_mesh=48, surface_width=5,
                   surface_length=10, wave_length=0.2, wave_width=0.5,
                   beta=BETAS[model], diffusion=1.0, t_boundary=1.0,
                   t_final=2.0, output_timestep=2, dtype="float32",
                   rtol=1e-5, atol=1e-8, use_pallas=True),
            **over}


def _state(y0, seed=1):
    return y0 + 0.05 * np.random.default_rng(seed).standard_normal(
        np.shape(y0))


def _mesh(shape, device="cpu"):
    return make_mesh(shape=shape, devices=[device] * 8)


def _rho(kw, y_np):
    tp = build_problem(SimConfig(**kw), device="cpu")
    y_t, _ = inputs_from_numpy(y_np, {}, device="cpu", dtype=torch.float32)
    return float(make_rho_bound(tp.cfg, tp.model, tp.geometry,
                                torch.float32)(0.0, y_t, tp.params))


def port_step(kernel, kw, shape, y_np, h):
    """One sharded step through the port's K8, K9 or K10 (the plain
    versions, on CPU shards): (physical y_new, error sum)."""
    cfg = SimConfig(**kw)
    problem = build_problem(cfg, "cpu")
    mesh = _mesh(shape)
    pad = mesh_pad_spec(cfg, mesh)
    if kernel == "k8":
        fused = f8.build_fused_shard_step(problem, TABLEAUS[cfg.method],
                                          mesh, pad)
    elif kernel == "k9":
        fused = f9.build_fused_shard_rkc(
            problem, mesh, sharded_rho_bound(problem, mesh, pad), pad)
    else:
        fused = f10.build_fused_shard_imex(problem, mesh, pad)
    y = split_state(torch.tensor(y_np, dtype=torch.float32), mesh, pad, cfg)
    params = {**shard_params(sharded_params(problem, pad), mesh, pad, cfg),
              "_seg_end": torch.tensor(SEG_END, dtype=torch.float32)}
    out = fused.step_err(torch.tensor(0.0), fused.pad(y),
                         torch.tensor(h, dtype=torch.float32), params)
    return (gather(fused.unpad(out[0]), mesh, pad).numpy(),
            float(make_reduce(mesh)(out[1])))


def jax_step(kernel, kw, shape, y_np, h):
    """The same step through the JAX package's shard kernel in interpret
    mode under shard_map (K9's rho pmax'd): (physical y_new, psum'd error
    sum)."""
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
    jp = jbuild(cfg)
    mesh = jmake_mesh(shape=shape)
    pad = jsh.mesh_pad_spec(cfg, mesh)
    f32 = jnp.float32
    if kernel == "k8":
        fused = jsh.maybe_fused_shard_step(jp, mesh, interpret=True,
                                           pad_spec=pad)
    elif kernel == "k9":
        rho = jrho(cfg, jp.model, jp.geometry, f32,
                   max_reduce=lambda x: lax.pmax(x, (AXIS_Y, AXIS_X)))
        fused = jsh.maybe_fused_shard_rkc(jp, mesh, rho, interpret=True,
                                          pad_spec=pad)
    else:
        fused = jsh.maybe_fused_shard_imex(jp, mesh, interpret=True,
                                           pad_spec=pad)
    assert fused is not None
    params, specs = jsh.sharded_params(jp, pad)

    def local(y, params):
        p = fused.prepare_params({**params,
                                  "_seg_end": jnp.asarray(SEG_END, f32)})
        out = fused.step_err(jnp.asarray(0.0, f32), fused.pad(y),
                             jnp.asarray(h, f32), p)
        return fused.unpad(out[0]), lax.psum(jnp.sum(out[1]),
                                             (AXIS_Y, AXIS_X))

    state = P(None, AXIS_Y, AXIS_X)
    fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(state, specs),
                               out_specs=(state, P()), check_vma=False))
    y_new, ss = fn(jnp.asarray(y_np, f32), params)
    return np.asarray(y_new)[:, :cfg.ny, :cfg.nx], float(ss)


def plain_matches_jax(model):
    """K8 (bs32, dopri54), K9 (s = 5, 23) and K10 of `model`: one step of
    the port's sharded path through the plain versions against the JAX
    shard kernels in interpret mode, in the frozen piece (K8's and K10's
    frozen rows held still)."""
    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild

    base = _kw(model)
    y_np = _state(np.asarray(jbuild(JSimConfig(**base)).y0)).astype(
        np.float32)
    scale = float(np.abs(y_np).max())
    rho = _rho(base, y_np)
    for kernel, method, h_rho in STEPS:
        kw = dict(base, method=method)
        h = np.float32(h_rho / rho)
        if kernel == "k9":
            s = int(rkc.choose_stages(torch.tensor(h), torch.tensor(rho)))
            assert s == (5 if h_rho < 10 else 23)
        got, ss = port_step(kernel, kw, (2, 2), y_np, h)
        want, ss_want = jax_step(kernel, kw, (2, 2), y_np, h)
        name = f"{model} {kernel} {method} h rho {h_rho}"
        err = float(np.max(np.abs(got - want)))
        assert err <= Y_TOL * max(1.0, scale), (name, err)
        assert abs(ss - ss_want) <= SUM_RTOL * ss_want, (name, ss, ss_want)
        if kernel != "k9":
            # the freeze: the first and last rows hold still (RKC2's
            # recurrence rounds at a stationary cell, in both packages)
            np.testing.assert_array_equal(got[:, [0, -1]],
                                          y_np[:, [0, -1]])


@pytest.mark.parametrize("model", FAMILIES)
def test_plain_shard_kernels_match_jax_kernels(model):
    plain_matches_jax(model)


# the sharded torch path against JAX's XLA sharded path in f64 (the
# families the JAX package's own fused shard tests run: Gray-Scott, both
# species diffusing, flat and torus; SIR, three variables, the diffusing
# one at index 1), and the whole runs through the plain kernels
TORCH_PATH_CASES = {
    "grayscott_flat": dict(model="grayscott", surface="flat", beta=0.03,
                           surface_width=10.0, surface_length=20.0),
    "grayscott_torus": dict(model="grayscott", surface="torus", beta=0.03,
                            surface_width=20.0, surface_length=40.0),
    "sir_flat": dict(model="sir", surface="flat", beta=1.5,
                     surface_width=10.0, surface_length=20.0),
}
RUN_BASE = dict(x_mesh=48, t_final=0.5, output_timestep=2,
                wave_length=0.2, wave_width=0.5, diffusion=1.0)


@pytest.mark.parametrize("case", sorted(TORCH_PATH_CASES))
def test_sharded_torch_path_matches_jax_f64(case):
    import jax

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.parallel.mesh import make_mesh as jmake_mesh
    from crdmodel_tpu.parallel.sharded import simulate_sharded as jsim
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    kw = dict(RUN_BASE, **TORCH_PATH_CASES[case], dtype="float64",
              rtol=1e-6, atol=1e-9, t_boundary=0.2)
    jres = jsim(JSimConfig(**kw), mesh=jmake_mesh(shape=(2, 2)))
    res = simulate_sharded(SimConfig(**kw), mesh=_mesh((2, 2)))
    assert res.ok and not res.fused
    for key in ("steps", "accepted", "rejected", "status"):
        np.testing.assert_array_equal(
            getattr(res.stats, key).numpy(),
            np.asarray(getattr(jres.stats, key)), err_msg=f"{case} {key}")
    np.testing.assert_allclose(res.trajectory.numpy(),
                               np.asarray(jres.trajectory), rtol=0,
                               atol=1e-12, err_msg=case)


# the whole runs through the plain K8, K9 and K10: (case, method, the
# field's limit against the torch path). bs32 runs the torch path's
# arithmetic (every step's sum in another order only); rkc2's recurrence
# scalars come from f64 tables where the torch path forms them in f32
# (tests/test_torch_fused_shard_rkc.py's limit, 1e-4; 7.5e-6 measured);
# ark324's closed-form Jacobian rounds apart from the torch path's
# forward-mode one in f32, within rtol
PLAIN_RUNS = (("grayscott_flat", "bs32", 0.0),
              ("grayscott_torus", "rkc2", 1e-4),
              ("sir_flat", "rkc2", 1e-4),
              ("grayscott_torus", "ark324", 1e-5),
              ("sir_flat", "ark324", 1e-5))


def run_through_plain_kernels(case, method, atol):
    """A whole sharded f32 run through the plain K8, K9 or K10 takes the
    sharded torch path's steps, its fields within `atol` (mirroring
    tests/test_sharding.py:237-266 on the JAX package's fused shard
    kernels)."""
    cfg = SimConfig(**dict(RUN_BASE, **TORCH_PATH_CASES[case],
                           method=method, dtype="float32", rtol=1e-4,
                           atol=1e-6, use_pallas=True))
    mesh = _mesh((2, 2))
    fused = simulate_sharded(cfg, mesh=mesh)
    torch_path = simulate_sharded(dataclasses.replace(cfg, use_pallas=False),
                                  mesh=mesh)
    assert fused.fused and not torch_path.fused and fused.ok
    np.testing.assert_array_equal(fused.stats.steps.numpy(),
                                  torch_path.stats.steps.numpy())
    np.testing.assert_allclose(fused.trajectory.numpy(),
                               torch_path.trajectory.numpy(), rtol=0,
                               atol=atol)


def shard_steps(model, device, dtype, shape=(2, 2), fz=0.0, **over):
    """[(name, wrapper, plain version, tile sums, args)] of K8 (bs32,
    dopri54), K9 (s = 2, 5, 23) and K10 steps of `model` on the first and
    last shards of `shape` on `device`: a numpy-seeded state near the IC
    split and halo-exchanged (mirror-aware), h rho = 1 (K9: the coverage
    of s - 1 stages)."""
    cfg = SimConfig(**_kw(model, **over))
    problem = build_problem(cfg, device="cpu")
    mesh = _mesh(shape, device)
    pad = mesh_pad_spec(cfg, mesh)
    y = torch.tensor(_state(problem.y0.numpy()), dtype=dtype)
    rho = float(make_rho_bound(cfg, problem.model, problem.geometry, dtype)(
        0.0, y, problem.params))
    blocks = list(split_state(y.to(device), mesh, pad, cfg))
    dev = dict(dtype=dtype, device=device)
    fzt = torch.tensor(fz, **dev)
    out = []
    for halo in (f8.HALO, f9.P_RKC):
        bufs = mirror_halo_pad(blocks, mesh, halo, pad)
        consts = make_shard_constants(problem, mesh, pad, halo, dtype)
        for k in (0, mesh.size - 1):
            if halo == f8.HALO:
                h = torch.tensor(1.0 / rho, **dev)
                out += [(f"k8 {m} shard {k}", f8.fused_shard_step,
                         f8.fused_shard_step_reference,
                         f8.fused_shard_step_tile_sums,
                         (bufs[k], h, fzt, consts[k], TABLEAUS[m], 1e-5,
                          1e-8)) for m in ("bs32", "dopri54")]
                out.append((f"k10 shard {k}", f10.fused_shard_imex_step,
                            f10.fused_shard_imex_step_reference,
                            f10.fused_shard_imex_tile_sums,
                            (bufs[k], h, fzt, consts[k], 1e-5, 1e-8)))
                continue
            mu1, ctab = static_stage_tables(f9.S_MAX_KERNEL, dtype, device)
            for s in (2, 5, 23):
                hs = torch.tensor(0.65 * (s - 1) ** 2 / rho, **dev)
                st = torch.tensor(s, dtype=torch.int32, device=device)
                out.append((f"k9 s={s} shard {k}", f9.fused_shard_rkc_step,
                            f9.fused_shard_rkc_step_reference,
                            f9.fused_shard_rkc_tile_sums,
                            (bufs[k], hs, fzt, st, mu1, ctab, consts[k],
                             1e-5, 1e-8)))
    return out


# an uneven mesh: 97x48 on a 3x1 mesh, blocks of 33 rows, the last with 31
# physical rows and 2 mirror-pad rows
UNEVEN = dict(surface_length=10.2)


@pytest.mark.parametrize("shape,over", [((2, 2), {}), ((3, 1), UNEVEN)])
@pytest.mark.parametrize("model", FAMILIES)
def test_plain_tile_sums_add_to_the_plain_total(model, shape, over):
    """The CPU wrappers are the plain versions (no launch), and the plain
    partial sums in each kernel's order add to the plain step's sum over
    the physical cells."""
    for name, call, plain, sums, args in shard_steps(
            model, "cpu", torch.float64, shape, **over):
        before = call.launches
        y_a, ss_a = call(*args)
        y_b, ss_b = plain(*args)
        assert call.launches == before
        assert torch.equal(y_a, y_b) and torch.equal(ss_a, ss_b), name
        tiles = sums(*args)
        np.testing.assert_allclose(float(tiles.sum()), float(ss_b.sum()),
                                   rtol=1e-12, err_msg=name)


def gates_take_the_families_as_the_jax_gates():
    """Unforced, K8, K9 and K10 take every family case the JAX shard gates
    take, but for the port's own rules (f32 only, the profile operator, a
    block at least the halo deep), and exactly the cases those rules
    allow (the JAX gates' TPU strip rules are not the port's); with a
    structured forcing K1, K2, K3, K8, K9 and K10 decline the six
    families."""
    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild
    from crdmodel_tpu.integrate.erk import TABLEAUS as JTABLEAUS
    from crdmodel_tpu.ops import (pallas_shard_imex, pallas_shard_rkc,
                                  pallas_shard_step)

    from crdmodel_tpu_torch.core.forcing import (SeparableForcing,
                                                 Stimulus, pulse_train)
    from crdmodel_tpu_torch.ops import fused_imex, fused_rkc, fused_step

    bs32 = "bs32"
    for model in NEW_FAMILIES:
        for boundary in ("periodic", "noflux"):
            kw = _kw(model, surface="flat", boundary=boundary,
                     surface_width=10.0, surface_length=20.0)
            tp = build_problem(SimConfig(**kw), "cpu")
            jp = jbuild(JSimConfig(**kw))
            for dtype, jdtype in ((torch.float32, "float32"),
                                  (torch.float64, "float64")):
                for nyl, nxl in ((64, 64), (32, 24), (16, 8), (8, 7),
                                 (20, 30)):
                    port_rules = (dtype == torch.float32
                                  and boundary == "periodic")
                    cases = (
                        (f8.is_shard_supported(tp, TABLEAUS[bs32], dtype,
                                               nyl, nxl),
                         pallas_shard_step.is_shard_supported(
                             jp, JTABLEAUS[bs32], jdtype, nyl, nxl),
                         f8.HALO),
                        (f9.is_shard_rkc_supported(tp, dtype, nyl, nxl),
                         pallas_shard_rkc.is_shard_rkc_supported(
                             jp, jdtype, nyl, nxl), f9.P_RKC),
                        (f10.is_shard_imex_supported(tp, dtype, nyl, nxl),
                         pallas_shard_imex.is_shard_imex_supported(
                             jp, jdtype, nyl, nxl), f10.HALO))
                    for port, jax_gate, halo in cases:
                        # the port's rules; the JAX gates' TPU strip rules
                        # are not the port's, so the port may take more
                        rules = port_rules and nyl >= halo and nxl >= halo
                        where = (model, boundary, dtype, nyl, nxl, halo)
                        assert port == rules, where
                        assert port or not (jax_gate and rules), where
                        if (nyl, nxl) == (64, 64) and port_rules:
                            assert jax_gate, where
        forcing = SeparableForcing(Stimulus(
            waveform=pulse_train([0.1], 0.2, 1.0),
            row=np.ones(SimConfig(**_kw(model)).ny)))
        forced = build_problem(SimConfig(**_kw(model)), "cpu",
                               forcing=forcing)
        f32 = torch.float32
        assert not f8.is_shard_supported(forced, TABLEAUS[bs32], f32, 64, 64)
        assert not f9.is_shard_rkc_supported(forced, f32, 64, 64)
        assert not f10.is_shard_imex_supported(forced, f32, 64, 64)
        assert not fused_step.is_supported(forced, TABLEAUS[bs32], f32)
        assert not fused_rkc.is_rkc_supported(forced, f32)
        assert not fused_imex.is_imex_supported(forced, f32)


def cuda_matches_plain(model, dtype):
    """Each K8, K9 and K10 launch of `model` bitwise its plain version on
    the card (y_new's block and every partial sum), and two launches
    bitwise equal, frozen and released, on the first and last shards of a
    2x2 mesh and of an uneven 3x1 mesh with mirror-pad rows."""
    for shape, over in (((2, 2), {}), ((3, 1), UNEVEN)):
        for fz in (0.0, 1.0):
            for name, call, plain, sums, args in shard_steps(
                    model, "cuda", dtype, shape, fz, **over):
                halo = next(a for a in args if hasattr(a, "halo")).halo
                y_k, ss_k = call(*args)
                y_k2, ss_k2 = call(*args)
                y_r, _ = plain(*args)
                torch.cuda.synchronize()
                block = (Ellipsis, slice(halo, -halo), slice(halo, -halo))
                assert bool(torch.isfinite(y_r[block]).all()), name
                assert torch.equal(y_k[block], y_k2[block]), name
                assert torch.equal(ss_k, ss_k2), name
                assert torch.equal(y_k[block], y_r[block]), name
                assert torch.equal(ss_k, sums(*args)), name


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs an NVIDIA GPU and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("model", FAMILIES)
def test_cuda_shard_kernels_match_plain(model, dtype):
    cuda_matches_plain(model, dtype)
