"""Kernel K4, the fused divergence-form ERK step
(crdmodel_tpu_torch/ops/fused_divform.py).

On the CPU: the kernel's plain version against the JAX package's Pallas
kernel (ops/pallas_divform.py) run in interpret mode, f32, one step from a
numpy-seeded state, on three cases: no-flux walls with a scar
(Aliev–Panfilov, with a freeze), a torus obstacle (FitzHugh–Nagumo) and a
flat 2-D diffusion field (dopri54); and the gate.
On a CUDA card (marker `cuda`): the CUDA kernel against the plain version,
y_new bitwise. The JAX package is imported inside the test that uses it, so
that the card tests run where JAX is not installed:

    python -m pytest tests/test_torch_fused_divform.py -m cuda --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.convert import inputs_from_numpy
from crdmodel_tpu_torch.core.grid import face_openness
from crdmodel_tpu_torch.core.problem import build_problem
from crdmodel_tpu_torch.integrate.erk import TABLEAUS
from crdmodel_tpu_torch.ops import fused_divform as fd
from crdmodel_tpu_torch.ops.kernel_common import prepare_divform_constants

FLAT = dict(surface="flat", x_mesh=48, surface_width=20.0,
            surface_length=20.0)
COMMON = dict(t_final=2.0, dtype="float32", rtol=1e-4, atol=1e-7,
              wave_length=0.25, wave_width=0.5)


def _scar(ny, nx, rows, cols):
    mask = np.ones((ny, nx), bool)
    mask[rows, cols] = False
    return mask


# name: (config, build arguments, method, h)
CASES = {
    "ap_noflux_scar": (
        dict(FLAT, model="aliev_panfilov", beta=0.1, diffusion=1.0,
             boundary="noflux", t_boundary=0.4),
        dict(obstacle_mask=_scar(48, 48, slice(20, 30), slice(22, 34))),
        "bs32", 0.02),
    "fhn_torus_obstacle": (
        dict(model="fhn", surface="torus", x_mesh=40, beta=1.25),
        dict(obstacle_mask=_scar(160, 40, slice(60, 80), slice(10, 18))),
        "bs32", 0.05),
    "fhn_flat_xy_field": (
        dict(FLAT, model="fhn", beta=1.25),
        dict(diffusion_field=0.05 + 0.1 * np.random.default_rng(7).random(
            (48, 48))),
        "dopri54", 0.05),
}
# (t, segment end, fz): frozen and released where the case has a freeze
# (segments never straddle tBoundary)
SEGMENTS = ((0.1, 0.4, 1.0), (0.5, 1.0, 0.0))


def _state(shape, model, seed=3):
    rng = np.random.default_rng(seed)
    if model == "aliev_panfilov":
        return np.stack([rng.uniform(-0.1, 1.1, shape[1:]),
                         rng.uniform(0.0, 2.0, shape[1:])])
    return rng.uniform(-2.0, 2.0, shape)


def _case(name, **over):
    kw, build, method, h = CASES[name]
    return {**COMMON, **kw, **over}, build, method, h


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_step_matches_jax_kernel(name):
    """fused_divform_step_reference through build_fused_divform_step against
    the JAX Pallas kernel in interpret mode, f32: y within 2e-5 of the
    state's scale (f32 rounding: JAX on the CPU contracts a*b + c into
    FMAs, the port rounds every operation, as tests/test_torch_fused_step.py
    holds K1), the error sum to 1e-3 relative, and the scar cells bitwise
    at their start (tests/test_divform_kernel.py's bar)."""
    import jax
    import jax.numpy as jnp

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild_problem
    from crdmodel_tpu.integrate.erk import TABLEAUS as JTABLEAUS
    from crdmodel_tpu.ops import pallas_divform

    kw, build, method, h = _case(name)
    jp = jbuild_problem(JSimConfig(**kw), **build)
    fused = pallas_divform.build_fused_divform_step(
        jp, JTABLEAUS[method], jnp.float32, interpret=True)
    jstep = jax.jit(lambda yp, hh, seg: fused.step_err(
        0.0, yp, hh, {**jp.params, "_seg_end": seg}))
    tp = build_problem(SimConfig(**kw), "cpu", **build)
    assert fd.is_divform_supported(tp, TABLEAUS[method], torch.float32)
    step_err = fd.build_fused_divform_step(tp, TABLEAUS[method])
    y_np = _state(np.shape(jp.y0), kw["model"]).astype(np.float32)
    y_t, _ = inputs_from_numpy(y_np, {}, device="cpu", dtype=torch.float32)
    scale = max(1.0, float(np.abs(y_np).max()))
    for t, seg_end, fz in SEGMENTS:
        yp_new, ss_j = jstep(fused.pad(jnp.asarray(y_np)), jnp.float32(h),
                             jnp.float32(seg_end))
        params = {**tp.params, "_seg_end": torch.tensor(seg_end)}
        y_new, ss = step_err(torch.tensor(t), y_t, torch.tensor(h), params)
        want = np.asarray(fused.unpad(yp_new))
        assert np.max(np.abs(y_new.numpy() - want)) <= 2e-5 * scale
        ss_j = float(ss_j)
        assert abs(float(ss) - ss_j) <= 1e-3 * ss_j
        if tp.obstacle_mask is not None:
            scar = ~tp.obstacle_mask
            np.testing.assert_array_equal(y_new.numpy()[:, scar],
                                          y_np[:, scar])
            np.testing.assert_array_equal(want[:, scar], y_np[:, scar])
        if kw.get("t_boundary", 0.0) > 0 and fz:
            np.testing.assert_array_equal(y_new[:, [0, -1]].numpy(),
                                          y_np[:, [0, -1]])


def test_plain_step_f64_is_the_torch_path_step():
    """In f64 the plain K4 takes the torch path's bs32 step on the bounded
    case: the same operator and the same stage order, to 1e-14."""
    from crdmodel_tpu_torch.integrate.erk import make_default_step_err

    kw, build, method, h = _case("ap_noflux_scar", dtype="float64")
    p = build_problem(SimConfig(**kw), "cpu", **build)
    y = torch.tensor(_state(tuple(p.y0.shape), kw["model"]))
    tstep, init = make_default_step_err(TABLEAUS[method], p.rhs, kw["rtol"],
                                        kw["atol"])
    for t_val, seg_end, _ in SEGMENTS:
        params = {**p.params, "_seg_end": torch.tensor(seg_end,
                                                       dtype=torch.float64)}
        t = torch.tensor(t_val, dtype=torch.float64)
        hh = torch.tensor(h, dtype=torch.float64)
        want_y, want_ss, _ = tstep(t, y, hh, params, init(t, y, params))
        got_y, got_ss = fd.build_fused_divform_step(p, TABLEAUS[method])(
            t, y, hh, params)
        assert float((got_y - want_y).abs().max()) <= 1e-14 * float(
            want_y.abs().max())
        np.testing.assert_allclose(float(got_ss), float(want_ss), rtol=1e-12)


def test_gate():
    kw, build, _, _ = _case("ap_noflux_scar")
    p = build_problem(SimConfig(**kw), "cpu", **build)
    bs32 = TABLEAUS["bs32"]
    assert fd.is_divform_supported(p, bs32, torch.float32)
    assert fd.is_divform_supported(p, TABLEAUS["dopri54"], torch.float32)
    assert not fd.is_divform_supported(p, bs32, torch.float64)
    assert not fd.is_divform_supported(dataclasses.replace(p, forcing=object()),
                                       bs32, torch.float32)
    two_diffusing = dataclasses.replace(p, model=dataclasses.replace(
        p.model, diffusive_vars=(0, 1), diffusion_ratios=(1.0, 1.0)))
    assert not fd.is_divform_supported(two_diffusing, bs32, torch.float32)
    p_jd = build_problem(SimConfig(**{**kw, "just_diffusion": 1}), "cpu",
                         **build)
    assert not fd.is_divform_supported(p_jd, bs32, torch.float32)
    gb = build_problem(SimConfig(**{**kw, "model": "goldbeter",
                                    "beta": 0.4}), "cpu", **build)
    assert fd.is_divform_supported(gb, bs32, torch.float32)
    # closed south faces without their north partners: aS is no longer
    # roll_y(aN), so the kernel cannot read aS from aN
    oE, oW, oN, oS = face_openness(p.cfg.ny, p.cfg.nx, "noflux")
    lopsided = dataclasses.replace(p, face_mask=(oE, oW, np.ones_like(oN),
                                                 oS))
    assert not fd.is_divform_supported(lopsided, bs32, torch.float32)
    with pytest.raises(ValueError, match="roll_y"):
        prepare_divform_constants(lopsided, torch.float32, "cpu")
    # a periodic constant-D problem is K1's
    periodic = build_problem(SimConfig(**{**kw, "boundary": "periodic"}),
                             "cpu")
    assert not fd.is_divform_supported(periodic, bs32, torch.float32)


def test_constants_are_contiguous_fields():
    kw, build, _, _ = _case("fhn_torus_obstacle")
    p = build_problem(SimConfig(**kw), "cpu", **build)
    dc = prepare_divform_constants(p, torch.float32, "cpu")
    assert dc.kind == "divform" and len(dc.coeffs) == 3
    for c in (*dc.coeffs, dc.tissue):
        assert tuple(c.shape) == (p.cfg.ny, p.cfg.nx) and c.is_contiguous()
    assert set(np.unique(dc.tissue.numpy())) == {0.0, 1.0}
    kw, build, _, _ = _case("fhn_flat_xy_field")
    p = build_problem(SimConfig(**kw), "cpu", **build)
    assert prepare_divform_constants(p, torch.float32, "cpu").tissue is None


def test_wrapper_refuses_other_devices():
    kw, build, method, _ = _case("ap_noflux_scar")
    p = build_problem(SimConfig(**kw), "cpu", **build)
    dc = prepare_divform_constants(p, torch.float32, "cpu")
    y = torch.empty(p.y0.shape, device="meta")
    with pytest.raises(ValueError, match="no fused divergence-form"):
        fd.fused_divform_step(y, torch.tensor(0.1), torch.tensor(0.0), dc,
                              TABLEAUS[method], 1e-4, 1e-7)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("method", ["bs32", "dopri54"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernel_matches_plain(name, method, dtype):
    """y_new bitwise equal to the plain version (the same operations in
    the same order, -fmad=false); the per-block error sums to rounding."""
    kw, build, _, h = _case(name, t_boundary=0.4)
    p = build_problem(SimConfig(**kw), "cuda", **build)
    dc = prepare_divform_constants(p, dtype, "cuda")
    y = torch.tensor(_state(tuple(p.y0.shape), kw["model"]), dtype=dtype,
                     device="cuda")
    ht = torch.tensor(h, dtype=dtype, device="cuda")
    for _, _, fz in SEGMENTS:
        fzt = torch.tensor(fz, dtype=dtype, device="cuda")
        args = (y, ht, fzt, dc, TABLEAUS[method], 1e-4, 1e-7)
        before = fd.fused_divform_step.launches
        y_k, ss_k = fd.fused_divform_step(*args)
        y_k2, ss_k2 = fd.fused_divform_step(*args)
        assert fd.fused_divform_step.launches == before + 2
        y_r, ss_r = fd.fused_divform_step_reference(*args)
        torch.cuda.synchronize()
        assert torch.equal(y_k, y_k2) and torch.equal(ss_k, ss_k2)
        assert torch.equal(y_k, y_r)
        rel = abs(float(ss_k.sum()) - float(ss_r.sum())) / float(ss_r.sum())
        assert rel <= (1e-5 if dtype == torch.float32 else 1e-12)
