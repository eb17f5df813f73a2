"""Kernel K5, the fused anisotropic-tensor ERK step
(crdmodel_tpu_torch/ops/fused_aniso.py).

On the CPU: the kernel's plain version against the JAX package's Pallas
kernel (ops/pallas_aniso.py) run in interpret mode, f32, one step from a
numpy-seeded state, on three flat cases: the rotating fibres with
Aliev–Panfilov and a freeze, a constant tensor inside no-flux walls
(dopri54), and random SPD fields with FitzHugh–Nagumo's beta ramp and a
freeze; the plain step against the torch path's, f64 and f32; the
constants.
The plain version of the kernel's partial sums (fused_aniso_tile_sums:
their number, and their total against the plain step's sum), also on a
sheet narrower than a tile's rings and an odd sheet; the dispatch on the
tableau. On a CUDA card (marker `cuda`): the CUDA kernel against the plain
version, y_new and every partial sum bitwise, the launched kernel traced.
The JAX package is imported inside the test that uses it, so that the card
tests run where JAX is not installed:

    python -m pytest tests/test_torch_fused_aniso.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.convert import inputs_from_numpy
from crdmodel_tpu_torch.core.problem import build_problem
from crdmodel_tpu_torch.integrate.erk import TABLEAUS
from crdmodel_tpu_torch.ops import erk_slots
from crdmodel_tpu_torch.ops import fused_aniso as fa
from crdmodel_tpu_torch.ops.kernel_common import prepare_aniso_constants

FLAT = dict(surface="flat", x_mesh=32, surface_width=20.0,
            surface_length=40.0)
NY, NX = 64, 32
COMMON = dict(t_final=2.0, dtype="float32", rtol=1e-4, atol=1e-7,
              wave_length=0.25, wave_width=0.5)


def fiber_tensor(ny, nx, d_par=1.0, d_perp=0.2, angle0=0.0,
                 angle1=np.pi / 3):
    """examples/anisotropic_fibers.py::fiber_tensor on an (ny, nx) grid."""
    th = np.broadcast_to(np.linspace(angle0, angle1, nx)[None, :], (ny, nx))
    c, s = np.cos(th), np.sin(th)
    return (d_par * c * c + d_perp * s * s, d_par * s * s + d_perp * c * c,
            (d_par - d_perp) * c * s)


def _random_spd(ny, nx, seed=12):
    rng = np.random.default_rng(seed)
    dxx = 0.5 + rng.random((ny, nx))
    dyy = 0.3 + rng.random((ny, nx))
    return dxx, dyy, 0.9 * np.sqrt(dxx * dyy) * (2 * rng.random((ny, nx)) - 1)


# name: (config, tensor, method, h)
CASES = {
    "ap_fibres_freeze": (
        dict(FLAT, model="aliev_panfilov", beta=0.05, t_boundary=0.4),
        fiber_tensor(NY, NX), "bs32", 0.05),
    "ap_const_noflux": (
        dict(FLAT, model="aliev_panfilov", beta=0.05, boundary="noflux",
             t_boundary=0.4),
        (1.0, 0.25, 0.15), "dopri54", 0.05),
    "fhn_random_ramp_freeze": (
        dict(FLAT, model="fhn", beta=1.25, vary_beta=1, beta_min=0.7,
             beta_max=1.7, t_boundary=0.4),
        _random_spd(NY, NX), "bs32", 0.02),
}
# the edges of bs32's register-resident scheme, each with a freeze: a sheet
# narrower than a tile's rings (the wrap loops run more than once) and an
# odd sheet, partial tiles on both axes
EDGE_CASES = {
    "ap_fibres_4_columns": (
        dict(FLAT, model="aliev_panfilov", beta=0.05, t_boundary=0.4,
             x_mesh=4),
        fiber_tensor(8, 4), "bs32", 0.05),
    "fhn_random_odd": (
        dict(FLAT, model="fhn", beta=1.25, vary_beta=1, beta_min=0.7,
             beta_max=1.7, t_boundary=0.4, x_mesh=37, y_mesh=75),
        _random_spd(75, 37), "bs32", 0.02),
}
# (t, segment end, fz): frozen and released (segments never straddle
# tBoundary)
SEGMENTS = ((0.1, 0.4, 1.0), (0.5, 1.0, 0.0))


def _state(shape, model, seed=3):
    rng = np.random.default_rng(seed)
    if model == "aliev_panfilov":
        return np.stack([rng.uniform(-0.1, 1.1, shape[1:]),
                         rng.uniform(0.0, 2.0, shape[1:])])
    return rng.uniform(-2.0, 2.0, shape)


def _case(name, **over):
    kw, tensor, method, h = {**CASES, **EDGE_CASES}[name]
    return {**COMMON, **kw, **over}, tensor, method, h


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_step_matches_jax_kernel(name):
    """fused_aniso_step_reference through build_fused_aniso_step against
    the JAX Pallas kernel in interpret mode, f32: y within 2e-5 of the
    state's scale (f32 rounding: JAX on the CPU contracts a*b + c into
    FMAs, the port rounds every operation, as K4 is held), the error sum to
    1e-3 relative, and the frozen edge rows at their start."""
    import jax
    import jax.numpy as jnp

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild_problem
    from crdmodel_tpu.integrate.erk import TABLEAUS as JTABLEAUS
    from crdmodel_tpu.ops import pallas_aniso

    kw, tensor, method, h = _case(name)
    jp = jbuild_problem(JSimConfig(**kw), diffusion_tensor=tensor)
    assert pallas_aniso.is_aniso_supported(jp, JTABLEAUS[method],
                                           jnp.float32)
    fused = pallas_aniso.build_fused_aniso_step(
        jp, JTABLEAUS[method], jnp.float32, interpret=True)
    jstep = jax.jit(lambda yp, hh, seg: fused.step_err(
        0.0, yp, hh, {**jp.params, "_seg_end": seg}))
    tp = build_problem(SimConfig(**kw), "cpu", diffusion_tensor=tensor)
    assert fa.is_aniso_supported(tp, TABLEAUS[method], torch.float32)
    step_err = fa.build_fused_aniso_step(tp, TABLEAUS[method])
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
        if fz:
            np.testing.assert_array_equal(y_new[:, [0, -1]].numpy(),
                                          y_np[:, [0, -1]])


@pytest.mark.parametrize("dtype,limit", [(torch.float64, 1e-13),
                                         (torch.float32, 2e-5)])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_step_is_the_torch_path_step(name, dtype, limit):
    """The plain K5 takes the torch path's step to the rounding of its
    dtype: the same operator, with the mixed weight folded into Dxy and
    the JAX kernel's association (kernel_common.aniso_kernel_laplacian),
    so not bitwise."""
    from crdmodel_tpu_torch.integrate.erk import make_default_step_err

    kw, tensor, method, h = _case(name, dtype=str(dtype).split(".")[1])
    p = build_problem(SimConfig(**kw), "cpu", diffusion_tensor=tensor)
    y = torch.tensor(_state(tuple(p.y0.shape), kw["model"]), dtype=dtype)
    tstep, init = make_default_step_err(TABLEAUS[method], p.rhs, kw["rtol"],
                                        kw["atol"])
    step_err = fa.build_fused_aniso_step(p, TABLEAUS[method])
    for t_val, seg_end, _ in SEGMENTS:
        params = {**p.params, "_seg_end": torch.tensor(seg_end, dtype=dtype)}
        t = torch.tensor(t_val, dtype=dtype)
        hh = torch.tensor(h, dtype=dtype)
        want_y, want_ss, _ = tstep(t, y, hh, params, init(t, y, params))
        got_y, got_ss = step_err(t, y, hh, params)
        assert float((got_y - want_y).abs().max()) <= limit * float(
            want_y.abs().max())
        np.testing.assert_allclose(float(got_ss), float(want_ss),
                                   rtol=1e3 * limit)


def test_constants_are_contiguous_fields():
    kw, tensor, _, _ = _case("ap_const_noflux")
    p = build_problem(SimConfig(**kw), "cpu", diffusion_tensor=tensor)
    ac = prepare_aniso_constants(p, torch.float64, "cpu")
    assert ac.kind == "aniso" and len(ac.coeffs) == 3
    for c in ac.coeffs:
        assert tuple(c.shape) == (NY, NX) and c.is_contiguous()
    (aE, aW, aN, aS), dxy, inv4 = p.geometry.tensor_coeffs64(
        *tensor, boundary="noflux")
    # the kernel recovers aW and aS by a wrapped shift of what it gets
    np.testing.assert_array_equal(np.roll(ac.coeffs[0].numpy(), 1, 1), aW)
    np.testing.assert_array_equal(np.roll(ac.coeffs[1].numpy(), 1, 0), aS)
    np.testing.assert_array_equal(ac.coeffs[2].numpy(), dxy * inv4)
    assert not ac.coeffs[2][:, [0, -1]].any()      # the Dxy wall layers


def test_wrapper_refuses_other_devices_and_the_torus():
    kw, tensor, method, _ = _case("ap_fibres_freeze")
    p = build_problem(SimConfig(**kw), "cpu", diffusion_tensor=tensor)
    ac = prepare_aniso_constants(p, torch.float32, "cpu")
    y = torch.empty(p.y0.shape, device="meta")
    with pytest.raises(ValueError, match="no fused anisotropic"):
        fa.fused_aniso_step(y, torch.tensor(0.1), torch.tensor(0.0), ac,
                            TABLEAUS[method], 1e-4, 1e-7)
    torus = build_problem(SimConfig(**{**kw, "surface": "torus",
                                       "x_mesh": 16}), "cpu",
                          diffusion_tensor=(1.0, 0.25, 0.1))
    with pytest.raises(ValueError, match="flat"):
        prepare_aniso_constants(torus, torch.float32, "cpu")


@pytest.mark.parametrize("method", sorted(TABLEAUS))
def test_dispatch_names_a_kernel_for_each_tableau(method):
    """Every tableau the gate takes has a kernel: bs32 the
    register-resident scheme, the others erk_tile.cuh's."""
    kw, tensor, _, _ = _case("ap_fibres_freeze")
    p = build_problem(SimConfig(**kw), "cpu", diffusion_tensor=tensor)
    tab = TABLEAUS[method]
    assert fa.is_aniso_supported(p, tab, torch.float32)
    assert erk_slots.kernel_name(tab) == (
        erk_slots.SLOTS_KERNEL if method == "bs32" else
        erk_slots.TILE_KERNEL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(CASES) + sorted(EDGE_CASES))
def test_tile_sums_add_to_the_plain_total(name, dtype):
    """The plain partial sums, one a tile of K1's plan (32x32 for bs32,
    32x16 for dopri54) in the kernel's order, add up to the plain
    version's total to rounding, for each tableau and freeze."""
    from crdmodel_tpu_torch.ops.fused_step import tile_plan

    kw, tensor, _, h = _case(name)
    p = build_problem(SimConfig(**kw), "cpu", diffusion_tensor=tensor)
    ac = prepare_aniso_constants(p, dtype, "cpu")
    y = torch.tensor(_state(tuple(p.y0.shape), kw["model"]), dtype=dtype)
    _, ny, nx = y.shape
    for method in sorted(TABLEAUS):
        for _, _, fz in SEGMENTS:
            args = (y, torch.tensor(h, dtype=dtype),
                    torch.tensor(fz, dtype=dtype), ac, TABLEAUS[method],
                    1e-4, 1e-7)
            sums = fa.fused_aniso_tile_sums(*args)
            _, total = fa.fused_aniso_step_reference(*args)
            tile_y = tile_plan(TABLEAUS[method].stages, y.element_size())[1]
            assert sums.shape == (-(-nx // 32) * -(-ny // tile_y),)
            rel = 1e-5 if dtype == torch.float32 else 1e-12
            np.testing.assert_allclose(float(sums.sum()), float(total),
                                       rtol=rel)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("method", ["bs32", "dopri54"])
@pytest.mark.parametrize("name", sorted(CASES) + sorted(EDGE_CASES))
def test_cuda_kernel_matches_plain(name, method, dtype):
    """y_new bitwise equal to the plain version (the same operations in
    the same order, -fmad=false), two launches equal, one partial sum a
    tile, each bitwise the plain version's in the kernel's order
    (fused_aniso_tile_sums); the launch runs the kernel the dispatch
    names (erk_slots.kernel_name), and the register-resident kernel's
    shared bytes are slots_plan's with the dxyw plane."""
    from crdmodel_tpu_torch.ops import trace

    kw, tensor, _, h = _case(name)
    p = build_problem(SimConfig(**kw), "cuda", diffusion_tensor=tensor)
    ac = prepare_aniso_constants(p, dtype, "cuda")
    y = torch.tensor(_state(tuple(p.y0.shape), kw["model"]), dtype=dtype,
                     device="cuda")
    ht = torch.tensor(h, dtype=dtype, device="cuda")
    tab = TABLEAUS[method]
    for _, _, fz in SEGMENTS:
        fzt = torch.tensor(fz, dtype=dtype, device="cuda")
        args = (y, ht, fzt, ac, tab, 1e-4, 1e-7)
        # a trace can miss kernels, or hold none: pooled traces
        names = trace.kernel_names(lambda: fa.fused_aniso_step(*args))
        assert any(erk_slots.kernel_name(tab) in n for n in names), names
        before = fa.fused_aniso_step.launches
        y_k, ss_k = fa.fused_aniso_step(*args)
        y_k2, ss_k2 = fa.fused_aniso_step(*args)
        assert fa.fused_aniso_step.launches == before + 2
        y_r, _ = fa.fused_aniso_step_reference(*args)
        sums = fa.fused_aniso_tile_sums(*args)
        torch.cuda.synchronize()
        assert torch.equal(y_k, y_k2) and torch.equal(ss_k, ss_k2)
        assert torch.equal(y_k, y_r)
        assert ss_k.shape == sums.shape and torch.equal(ss_k, sums)
    if erk_slots.uses_slots(tab):
        info = erk_slots.kernel_info("crd_fused_aniso_info", dtype,
                                     ac.kinetics_id)
        smem = erk_slots.slots_plan(y.element_size(), op_planes=1)[3]
        assert info["shared_bytes"] == smem
        assert info["blocks_per_sm"] >= (2 if dtype == torch.float32 else 1)
