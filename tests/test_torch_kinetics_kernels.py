"""K1, K2 and K3 on the six kinetics families beyond the base three
(csrc/fused_step_families.cu, fused_rkc_families.cu,
fused_imex_families.cu; ops/fused_step.py, fused_rkc.py, fused_imex.py).

On the CPU: each kernel's plain version, through the port's
build_fused_*_step, against the JAX package's Pallas kernel run in
interpret mode, f32, one step from a numpy-seeded state (the IC plus
0.05 N(0, 1)), frozen and released: K1 with bs32 and dopri54 at
h rho = 1, K2 at s = 5 and s = 23, K3 at h rho = 1; and the plain partial
sums (fused_step_tile_sums, fused_rkc_tile_sums, fused_imex_tile_sums)
against the plain totals. The grid is fine enough, with D = 1, that
diffusion sets rho, so that the deep RKC2 step stays on the kinetics'
time scale. The limits: y to 2e-5 of its scale (f32 rounding through a
step; measured at most 1.7e-5 of it, SIR's at K2's s = 23 across 24
evaluations), the sums to 1e-3 (measured at most 1.3e-4, dopri54's
5th-order estimate near the f32 rounding floor). K3's plain version takes
the closed-form Jacobian where the JAX kernel differentiates the
kinetics, so the Newton iterates round apart within these limits.
The families are split between this file and
tests/test_torch_kinetics_kernels2.py, so that pytest-xdist's loadfile
spreads them.
On a CUDA card (marker `cuda`): each family's K1, K2 and K3 launch
bitwise its plain version, y_new and every partial sum, f32 and f64,
frozen and released, on an odd 148x37 torus. The JAX package is imported
inside the tests that use it, so that the card tests run where JAX is
not installed:

    python -m pytest tests/test_torch_kinetics_kernels*.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.convert import inputs_from_numpy
from crdmodel_tpu_torch.core.problem import build_problem, make_rho_bound
from crdmodel_tpu_torch.integrate import rkc
from crdmodel_tpu_torch.integrate.erk import TABLEAUS
from crdmodel_tpu_torch.ops import fused_imex as fi
from crdmodel_tpu_torch.ops import fused_rkc as fr
from crdmodel_tpu_torch.ops import fused_step as fs
from crdmodel_tpu_torch.ops.kernel_common import prepare_constants

BETAS = {"barkley": 0.05, "oregonator": 1.5, "grayscott": 0.03,
         "brusselator": 1.9, "lambdaomega": 0.5, "sir": 1.5}
FAMILIES = ("barkley", "grayscott", "lambdaomega")
# (t, seg_end, fz): a step in the frozen piece, and one after the release
SEGMENTS = ((0.3, 0.8, 1.0), (1.5, 2.0, 0.0))
# h rho of K2's shallow and deep steps: s = 5 and s = 23
K2_H_RHO = {5: 8.0, 23: 300.0}
Y_TOL = 2e-5
SUM_RTOL = 1e-3


def _kw(model, **over):
    return {**dict(model=model, surface="torus", x_mesh=64, surface_width=5,
                   surface_length=10, wave_length=0.2, wave_width=0.5,
                   beta=BETAS[model], diffusion=1.0, t_boundary=1.0,
                   t_final=2.0, dtype="float32", rtol=1e-5, atol=1e-8),
            **over}


def _state(y0, seed=1):
    return y0 + 0.05 * np.random.default_rng(seed).standard_normal(
        np.shape(y0))


def _check(name, got_y, want_y, got_ss, want_ss, scale):
    err = float(np.max(np.abs(np.asarray(got_y) - np.asarray(want_y))))
    assert err <= Y_TOL * max(1.0, scale), (name, err)
    rel = abs(float(got_ss) - float(want_ss)) / float(want_ss)
    assert rel <= SUM_RTOL, (name, rel)


def plain_matches_jax(model):
    """K1 (bs32, dopri54), K2 (s = 5, 23) and K3 of `model`: the port's
    step through its plain version against the JAX kernel in interpret
    mode, frozen and released."""
    import jax
    import jax.numpy as jnp

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild_problem
    from crdmodel_tpu.integrate.erk import TABLEAUS as JTABLEAUS
    from crdmodel_tpu.ops import pallas_imex, pallas_rkc, pallas_step

    kw = _kw(model)
    jp = jbuild_problem(JSimConfig(**kw))
    tp = build_problem(SimConfig(**kw), device="cpu")
    y_np = _state(np.asarray(jp.y0)).astype(np.float32)
    y_t, _ = inputs_from_numpy(y_np, {}, device="cpu", dtype=torch.float32)
    scale = float(np.abs(y_np).max())
    rho = float(make_rho_bound(tp.cfg, tp.model, tp.geometry,
                               torch.float32)(0.0, y_t, tp.params))
    k1 = {m: (pallas_step.build_fused_step(jp, JTABLEAUS[m], jnp.float32,
                                           interpret=True),
              fs.build_fused_step(tp, TABLEAUS[m]))
          for m in ("bs32", "dopri54")}
    jk2 = pallas_rkc.build_fused_rkc_step(jp, jnp.float32, interpret=True)
    jk2_step = jax.jit(jk2.step_err)
    tk2 = fr.build_fused_rkc_step(tp)
    jk3 = pallas_imex.build_fused_imex_step(jp, jnp.float32, interpret=True)
    tk3 = fi.build_fused_imex_step(tp)
    h1 = np.float32(1.0 / rho)
    for t, seg_end, fz in SEGMENTS:
        jpar = {**jp.params, "_seg_end": jnp.float32(seg_end)}
        tpar = {**tp.params, "_seg_end": torch.tensor(seg_end)}
        tt, jt = torch.tensor(t), jnp.float32(t)
        for method, (jf, tstep) in k1.items():
            yj, sj = jax.jit(jf.step_err)(jt, jf.pad(jnp.asarray(y_np)),
                                          jnp.float32(h1), jpar)
            yk, sk = tstep(tt, y_t, torch.tensor(h1), tpar)
            _check(f"k1 {method} fz={fz}", yk.numpy(), jf.unpad(yj), sk, sj,
                   scale)
        for s, h_rho in K2_H_RHO.items():
            h = np.float32(h_rho / rho)
            assert int(rkc.choose_stages(torch.tensor(h),
                                         torch.tensor(rho))) == s
            yj, sj, _ = jk2_step(jt, jk2.pad(jnp.asarray(y_np)),
                                 jnp.float32(h), jpar)
            yk, sk, _ = tk2.step_err(tt, y_t, torch.tensor(h), tpar)
            _check(f"k2 s={s} fz={fz}", yk.numpy(), jk2.unpad(yj), sk, sj,
                   scale)
        yj, sj = jk3.step_err(jt, jk3.pad(jnp.asarray(y_np)),
                              jnp.float32(h1), jpar)
        yk, sk = tk3(tt, y_t, torch.tensor(h1), tpar)
        _check(f"k3 fz={fz}", yk.numpy(), jk3.unpad(yj), sk, sj, scale)
        if fz:
            # frozen rows hold still
            np.testing.assert_array_equal(yk[:, [0, -1]].numpy(),
                                          y_np[:, [0, -1]])


@pytest.mark.parametrize("model", FAMILIES)
def test_plain_kernels_match_jax_kernels(model):
    plain_matches_jax(model)


def kernel_steps(model, device, dtype, fz=0.0, **over):
    """[(name, wrapper, plain version, tile sums, args)] of K1 (bs32,
    dopri54), K2 (s = 2, 5, 23) and K3 steps of `model` on `device`: a
    numpy-seeded state near the IC, h rho = 1 (K2: the coverage of s - 1
    stages)."""
    p = build_problem(SimConfig(**_kw(model, **over)), device=device)
    kc = prepare_constants(p, dtype, device)
    y = torch.tensor(_state(p.y0.cpu().numpy()), dtype=dtype, device=device)
    rho = float(make_rho_bound(p.cfg, p.model, p.geometry, dtype)(
        0.0, y, p.params))
    dev = dict(dtype=dtype, device=device)
    h, fzt = torch.tensor(1.0 / rho, **dev), torch.tensor(fz, **dev)
    out = [(m, fs.fused_step, fs.fused_step_reference,
            fs.fused_step_tile_sums,
            (y, h, fzt, kc, TABLEAUS[m], 1e-5, 1e-8))
           for m in ("bs32", "dopri54")]
    mu1, ctab = fr.static_stage_tables(fr.S_MAX_KERNEL, dtype, device)
    for s in (2, 5, 23):
        hs = torch.tensor(0.65 * (s - 1) ** 2 / rho, **dev)
        st = torch.tensor(s, dtype=torch.int32, device=device)
        out.append((f"rkc2 s={s}", fr.fused_rkc_step,
                    fr.fused_rkc_step_reference, fr.fused_rkc_tile_sums,
                    (y, hs, fzt, st, mu1, ctab, kc, 1e-5, 1e-8)))
    out.append(("ark324", fi.fused_imex_step, fi.fused_imex_step_reference,
                fi.fused_imex_tile_sums, (y, h, fzt, kc, 1e-5, 1e-8)))
    return out


@pytest.mark.parametrize("model", FAMILIES)
def test_plain_tile_sums_add_to_the_plain_total(model):
    """The CPU wrappers are the plain versions (no launch), and the plain
    partial sums in each kernel's order add to the plain step's sum."""
    for name, call, plain, sums, args in kernel_steps(model, "cpu",
                                                      torch.float64):
        before = call.launches
        y_a, ss_a = call(*args)
        y_b, ss_b = plain(*args)
        assert call.launches == before
        assert torch.equal(y_a, y_b) and torch.equal(ss_a, ss_b)
        tiles = sums(*args)
        np.testing.assert_allclose(float(tiles.sum()), float(ss_b.sum()),
                                   rtol=1e-12, err_msg=name)


def cuda_matches_plain(model, dtype):
    """Each K1, K2 and K3 launch of `model` bitwise its plain version on
    the card (y_new and every partial sum), and two launches bitwise
    equal, frozen and released, on an odd 148x37 torus."""
    for fz in (0.0, 1.0):
        for name, call, plain, sums, args in kernel_steps(
                model, "cuda", dtype, fz, x_mesh=37, surface_length=20):
            y_k, ss_k = call(*args)
            y_k2, ss_k2 = call(*args)
            y_r, _ = plain(*args)
            torch.cuda.synchronize()
            assert bool(torch.isfinite(y_r).all()), name
            assert torch.equal(y_k, y_k2) and torch.equal(ss_k, ss_k2), name
            assert torch.equal(y_k, y_r), name
            assert torch.equal(ss_k, sums(*args)), name


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs an NVIDIA GPU and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("model", FAMILIES)
def test_cuda_kernels_match_plain(model, dtype):
    cuda_matches_plain(model, dtype)
