"""Kernel K6, the fused ERK step on the 3-D box (ops/fused_box3d.py), on
the CPU: its gate against the JAX gate (crdmodel_tpu/ops/pallas_box3d.py::
is_box3d_supported) on the same problems, declines included; its plain
version against one step of the JAX Pallas kernel in interpret mode in
each operator mode (profile, tissue, field, tensor) and with FitzHugh–
Nagumo's beta ramp and freeze, within f32 rounding (2e-6 of the state's
scale; the step's WRMS error norm to 5e-5 plus 1e-4 of itself, the
rounding of the stage sums over rtol |y|, where the controller accepts at
1); and whole runs through the plain version (use_pallas=True on the CPU)
against JAX interpret-mode runs: the same steps, trajectories within the
JAX box suite's 5e-6 (tests/test_box3d_kernel.py).
On a CUDA card (marker `cuda`): the CUDA kernel against the plain version,
y_new bitwise, and two launches bitwise equal. The JAX package is imported
inside the tests that use it, so that the card tests run where JAX is not
installed:

    python -m pytest tests/test_torch_fused_box3d.py -m cuda --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.core.problem import build_problem
from crdmodel_tpu_torch.integrate.erk import TABLEAUS, Tableau
from crdmodel_tpu_torch.ops import fused_box3d as fb
from crdmodel_tpu_torch.ops.kernel_common import (box_mode, freeze_scalar,
                                                  prepare_box_constants)
from crdmodel_tpu_torch.sim import simulate

NZ, NY, NX = 6, 24, 24


def box_kw(**kw):
    """The JAX box suites' slab (tests/test_box3d_kernel.py::box_cfg)."""
    base = dict(model="aliev_panfilov", surface="box", x_mesh=NX,
                surface_width=10.0, surface_length=10.0, surface_depth=3.0,
                z_mesh=NZ, t_final=2.0, output_timestep=2, beta=0.0,
                dtype="float32", method="bs32", rtol=1e-4, atol=1e-7,
                boundary="noflux", use_pallas=True)
    base.update(kw)
    return base


def wrms(ss, y):
    """The WRMS error norm of a step from its sum of squares."""
    return float(np.sqrt(float(ss) / y.numel()))


def scar_column():
    jj, ii = np.mgrid[0:NY, 0:NX]
    scar = (jj - 12) ** 2 + (ii - 11) ** 2 <= 9
    return np.broadcast_to(~scar, (NZ, NY, NX)).copy()


def transmural_tensor(z_layers_closed=True):
    """The transmural fibre rotation (tests/test_anisotropic3d.py::
    _transmural_tensor) with z couplings inside the wall, or reaching the
    top and bottom layers when z_layers_closed is False."""
    z = np.linspace(0, 1, NZ)[:, None, None] * np.ones((NZ, NY, NX))
    th = (z - 0.5) * np.pi / 3
    dpar, dperp, dtrans = 0.3, 0.08, 0.02
    c, s = np.cos(th), np.sin(th)
    inner = (z > 0.2) & (z < 0.8) if z_layers_closed else z >= 0.0
    return (dpar * c * c + dperp * s * s, dpar * s * s + dperp * c * c,
            np.full_like(c, dtrans), (dpar - dperp) * c * s,
            np.where(inner, 0.01, 0.0), np.where(inner, -0.008, 0.0))


# name -> (config, build arguments, h of the one-step checks)
CASES = {
    "profile": (box_kw(), {}, 2e-3),
    "profile_noflux_z": (box_kw(boundary="noflux_z"), {}, 2e-3),
    "tissue": (box_kw(), dict(obstacle_mask=scar_column()), 2e-3),
    "field": (box_kw(), dict(diffusion_field=0.8 + 0.4 * np.random.
                             default_rng(0).random((NZ, NY, NX))), 2e-3),
    "tensor": (box_kw(boundary="noflux_z", beta=0.05),
               dict(diffusion_tensor=transmural_tensor()), 2e-3),
    "fhn_ramp_freeze": (box_kw(model="fhn", beta=1.25, t_final=1.0,
                               t_boundary=0.4, vary_beta=1, beta_min=0.7,
                               beta_max=1.7, boundary="noflux_z"), {}, 2e-3),
}
# the mode each case takes
MODE_OF = {"profile": "box_profile", "profile_noflux_z": "box_profile",
           "tissue": "box_tissue", "field": "box_field",
           "tensor": "box_tensor", "fhn_ramp_freeze": "box_profile"}


def state(shape, model, seed=7):
    rng = np.random.default_rng(seed)
    if model == "fhn":
        return rng.uniform(-2.0, 2.0, shape)
    return np.stack([rng.uniform(-0.1, 1.1, shape[1:]),
                     rng.uniform(0.0, 2.0, shape[1:])])


def nine_stages(tab_cls):
    """A 9-stage tableau (one over the kernels' MAX_STAGES)."""
    z9 = np.zeros(9)
    return tab_cls(name="nine", order=1, err_order=2,
                   a=np.zeros((9, 9)), b=z9, bhat=z9, c=z9)


# (name, config changes, build arguments, method): the gate's cases
GATE_CASES = [
    ("noflux", {}, {}, "bs32"),
    ("noflux_z", dict(boundary="noflux_z"), {}, "dopri54"),
    ("zonneveld43", {}, {}, "zonneveld43"),
    ("periodic_z", dict(boundary="periodic"), {}, "bs32"),
    ("noflux_x", dict(boundary="noflux_x"), {}, "bs32"),
    ("scar", {}, dict(obstacle_mask=scar_column()), "bs32"),
    ("field", {}, dict(diffusion_field=0.8 + 0.4 * np.random.default_rng(
        1).random((NZ, NY, NX))), "bs32"),
    ("field_periodic_z", dict(boundary="noflux_x"),
     dict(diffusion_field=np.ones((NZ, NY, NX))), "bs32"),
    ("tensor", dict(boundary="noflux_z"),
     dict(diffusion_tensor=transmural_tensor()), "bs32"),
    ("tensor_open_z_layers", dict(boundary="noflux_x"),
     dict(diffusion_tensor=transmural_tensor(False)), "bs32"),
    ("f64", dict(dtype="float64"), {}, "bs32"),
    ("nine_stages", {}, {}, "nine"),
]


@pytest.mark.parametrize("name,cfg_kw,build,method", GATE_CASES,
                         ids=[c[0] for c in GATE_CASES])
def test_gate_agrees_with_jax(name, cfg_kw, build, method):
    import jax.numpy as jnp

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild
    from crdmodel_tpu.integrate import erk as jerk
    from crdmodel_tpu.ops import pallas_box3d

    kw = box_kw(**cfg_kw)
    jp = jbuild(JSimConfig(**kw), **build)
    tp = build_problem(SimConfig(**kw), "cpu", **build)
    if method == "nine":
        jtab = nine_stages(jerk.Tableau)
        ttab = nine_stages(Tableau)
    else:
        jtab, ttab = jerk.TABLEAUS[method], TABLEAUS[method]
    dt = getattr(torch, kw["dtype"])
    want = pallas_box3d.is_box3d_supported(jp, jtab, jnp.dtype(kw["dtype"]))
    assert fb.is_box3d_supported(tp, ttab, dt) == want
    jmode = pallas_box3d._box_mode(jp)[0]
    assert box_mode(tp)[0] == jmode


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_step_matches_jax_interpret_kernel(name):
    import jax.numpy as jnp

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild
    from crdmodel_tpu.integrate import erk as jerk
    from crdmodel_tpu.ops import pallas_box3d

    kw, build, h = CASES[name]
    jp = jbuild(JSimConfig(**kw), **build)
    tp = build_problem(SimConfig(**kw), "cpu", **build)
    bc = prepare_box_constants(tp, torch.float32, "cpu")
    assert bc.kind == MODE_OF[name]
    y_np = state(tuple(tp.y0.shape), kw["model"]).astype(np.float32)
    y = torch.tensor(y_np)
    scale = float(np.abs(y_np).max())
    for method in ("bs32", "dopri54"):
        fs = pallas_box3d.build_fused_box3d_step(
            jp, jerk.TABLEAUS[method], jnp.float32, interpret=True)
        for seg_end in (0.2, 1.5):
            jpar = {**jp.params, "_seg_end": jnp.float32(seg_end)}
            yp, jss = fs.step_err(jnp.float32(0.0),
                                  fs.pad(jnp.asarray(y_np)),
                                  jnp.float32(h), jpar)
            want = np.asarray(fs.unpad(yp))
            tpar = {**tp.params, "_seg_end": torch.tensor(seg_end)}
            fz = freeze_scalar(tpar, bc.has_freeze, float(kw.get(
                "t_boundary", 0.0)), torch.float32)
            got, ss = fb.fused_box3d_step(y, torch.tensor(h), fz, bc,
                                          TABLEAUS[method], kw["rtol"],
                                          kw["atol"])
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=2e-6 * scale)
            want_norm = wrms(jss, y)
            assert (abs(wrms(ss.sum(), y) - want_norm)
                    <= 5e-5 + 1e-4 * want_norm)


def test_tissue_mode_holds_inert_cells_bitwise():
    kw, build, h = CASES["tissue"]
    tp = build_problem(SimConfig(**kw), "cpu", **build)
    bc = prepare_box_constants(tp, torch.float32, "cpu")
    y = torch.tensor(state(tuple(tp.y0.shape), kw["model"]),
                     dtype=torch.float32)
    got, _ = fb.fused_box3d_step(y, torch.tensor(h), torch.tensor(0.0), bc,
                                 TABLEAUS["dopri54"], 1e-4, 1e-7)
    inert = torch.tensor(~build["obstacle_mask"])
    assert torch.equal(got[:, inert], y[:, inert])


# (name, config changes, build arguments): the whole-run cases
RUN_CASES = {
    "noflux": ({}, {}),
    "noflux_z": (dict(boundary="noflux_z"), {}),
    "scar": ({}, dict(obstacle_mask=scar_column())),
    # the JAX suite's field (tests/test_box3d_kernel.py::field_3d)
    "field": ({}, dict(diffusion_field=0.08 + 0.04 * np.random.default_rng(
        0).random((NZ, NY, NX)))),
    "tensor": (dict(boundary="noflux_z", beta=0.05, t_final=0.5),
               dict(diffusion_tensor=transmural_tensor())),
    "fhn_ramp_freeze": (dict(model="fhn", beta=1.25, t_final=1.0,
                             t_boundary=0.4, vary_beta=1, beta_min=0.7,
                             beta_max=1.7, boundary="noflux_z"), {}),
}


@pytest.mark.parametrize("name", sorted(RUN_CASES))
def test_plain_runs_take_jax_interpret_steps(name):
    import jax

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild
    from crdmodel_tpu.sim import make_run_fn

    cfg_kw, build = RUN_CASES[name]
    kw = box_kw(**cfg_kw)
    jp = jbuild(JSimConfig(**kw), **build)
    traj, stats = jax.jit(make_run_fn(jp, interpret=True)[0])(jp.y0,
                                                              jp.params)
    cfg = SimConfig(**kw)
    before = fb.fused_box3d_step.launches
    got = simulate(cfg, "cpu", problem=build_problem(cfg, "cpu", **build))
    assert got.fused and got.ok
    assert fb.fused_box3d_step.launches == before   # no kernel on the CPU
    for field in ("steps", "accepted", "rejected"):
        np.testing.assert_array_equal(getattr(got.stats, field).numpy(),
                                      np.asarray(getattr(stats, field)),
                                      err_msg=field)
    np.testing.assert_allclose(got.trajectory[1:].numpy(), np.asarray(traj),
                               rtol=0, atol=5e-6)
    if name == "scar":
        inert = torch.tensor(~build["obstacle_mask"])
        held = got.trajectory[:, :, inert]
        assert torch.equal(held, held[:1].expand_as(held))


def test_wrapper_refuses_other_constants():
    kw, build, h = CASES["profile"]
    tp = build_problem(SimConfig(**kw), "cpu", **build)
    bc = prepare_box_constants(tp, torch.float32, "cpu")
    y = tp.y0.clone()
    with pytest.raises(ValueError, match="device"):
        fb.launch_box3d("crd_fused_box3d_step", y, torch.tensor(h),
                        torch.tensor(0.0), bc, 5, (), 1e-4, 1e-7)
    flat = build_problem(SimConfig(**{**kw, "surface": "flat",
                                      "z_mesh": 0, "surface_depth": 0.0}),
                         "cpu")
    with pytest.raises(ValueError, match="box_mode is None"):
        prepare_box_constants(flat, torch.float32, "cpu")
    with pytest.raises(ValueError, match="box_mode is None"):
        prepare_box_constants(build_problem(SimConfig(**{
            **kw, "boundary": "periodic"}), "cpu"), torch.float32, "cpu")
    assert dataclasses.replace(bc).kind == "box_profile"


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("method", ["bs32", "dopri54"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernel_matches_plain(name, method, dtype):
    """y_new bitwise equal to the plain version (the same operations in
    the same order, -fmad=false); the per-block error sums to rounding."""
    kw, build, h = CASES[name]
    p = build_problem(SimConfig(**kw), "cuda", **build)
    bc = prepare_box_constants(p, dtype, "cuda")
    y = torch.tensor(state(tuple(p.y0.shape), kw["model"]), dtype=dtype,
                     device="cuda")
    ht = torch.tensor(h, dtype=dtype, device="cuda")
    for fz in (0.0, 1.0):
        fzt = torch.tensor(fz, dtype=dtype, device="cuda")
        args = (y, ht, fzt, bc, TABLEAUS[method], 1e-4, 1e-7)
        before = fb.fused_box3d_step.launches
        y_k, ss_k = fb.fused_box3d_step(*args)
        y_k2, ss_k2 = fb.fused_box3d_step(*args)
        assert fb.fused_box3d_step.launches == before + 2
        y_r, ss_r = fb.fused_box3d_step_reference(*args)
        torch.cuda.synchronize()
        assert torch.equal(y_k, y_k2) and torch.equal(ss_k, ss_k2)
        assert torch.equal(y_k, y_r)
        rel = abs(float(ss_k.sum()) - float(ss_r.sum())) / float(ss_r.sum())
        assert rel <= (1e-5 if dtype == torch.float32 else 1e-12)
