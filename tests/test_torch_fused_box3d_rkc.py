"""Kernel K7, the fused RKC2 step on the 3-D box (ops/fused_box3d_rkc.py),
on the CPU: its gate against the JAX gate (crdmodel_tpu/ops/
pallas_box3d_rkc.py::is_box3d_rkc_supported), declines included; its plain
version against one step of the JAX Pallas kernel in interpret mode in
each operator mode at s = 2, 5 and 7 (the JAX step's stage choice pinned),
y_new within f32 rounding (4e-6 of the state's scale, the Chebyshev
combination's few roundings) and the WRMS error norm to 2e-3 plus 1e-4
of itself (the estimate's .8(y0 - y_new) carries y_new's rounding over
rtol |y0|: some 6e-4 at rtol 1e-4); whole runs through the plain version
(use_pallas=True on the CPU) against JAX interpret-mode runs: the same
steps, trajectories within the JAX suite's 1e-5
(tests/test_box3d_rkc_kernel.py); and the stage cap's contract: where the
accuracy-limited step needs more than C_RKC = 7 stages, the capped run
takes more steps to the same solution.
On a CUDA card (marker `cuda`): the CUDA kernel against the plain version,
y_new bitwise, and two launches bitwise equal:

    python -m pytest tests/test_torch_fused_box3d_rkc.py -m cuda --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.core.problem import build_problem, make_rho_bound
from crdmodel_tpu_torch.integrate import rkc
from crdmodel_tpu_torch.ops import fused_box3d_rkc as fk
from crdmodel_tpu_torch.ops.fused_rkc import static_stage_tables
from crdmodel_tpu_torch.ops.kernel_common import (freeze_scalar,
                                                  prepare_box_constants)
from crdmodel_tpu_torch.sim import simulate

NZ, NY, NX = 6, 24, 24


def box_kw(**kw):
    """The JAX box RKC suite's slab (tests/test_box3d_rkc_kernel.py::
    box_cfg)."""
    base = dict(model="aliev_panfilov", surface="box", x_mesh=NX,
                surface_width=10.0, surface_length=10.0, surface_depth=3.0,
                z_mesh=NZ, t_final=2.0, output_timestep=2, beta=0.0,
                dtype="float32", method="rkc2", rtol=1e-4, atol=1e-7,
                boundary="noflux", use_pallas=True)
    base.update(kw)
    return base


def scar_column():
    jj, ii = np.mgrid[0:NY, 0:NX]
    scar = (jj - 12) ** 2 + (ii - 11) ** 2 <= 9
    return np.broadcast_to(~scar, (NZ, NY, NX)).copy()


def field_3d(seed=0):
    """The JAX box suites' diffusion field (tests/test_box3d_kernel.py)."""
    return 0.08 + 0.04 * np.random.default_rng(seed).random((NZ, NY, NX))


def transmural_tensor(z_layers_closed=True):
    """tests/test_anisotropic3d.py::_transmural_tensor, its z couplings
    inside the wall or reaching the top and bottom layers."""
    z = np.linspace(0, 1, NZ)[:, None, None] * np.ones((NZ, NY, NX))
    th = (z - 0.5) * np.pi / 3
    dpar, dperp, dtrans = 0.3, 0.08, 0.02
    c, s = np.cos(th), np.sin(th)
    inner = (z > 0.2) & (z < 0.8) if z_layers_closed else z >= 0.0
    return (dpar * c * c + dperp * s * s, dpar * s * s + dperp * c * c,
            np.full_like(c, dtrans), (dpar - dperp) * c * s,
            np.where(inner, 0.01, 0.0), np.where(inner, -0.008, 0.0))


# name -> (config changes, build arguments): one box of each mode
CASES = {
    "noflux": ({}, {}),
    "noflux_z": (dict(boundary="noflux_z"), {}),
    "scar": ({}, dict(obstacle_mask=scar_column())),
    "field": ({}, dict(diffusion_field=field_3d())),
    "tensor": (dict(boundary="noflux_z", beta=0.05, t_final=0.5),
               dict(diffusion_tensor=transmural_tensor())),
    "fhn_ramp_freeze": (dict(model="fhn", beta=1.25, t_final=1.0,
                             t_boundary=0.4, vary_beta=1, beta_min=0.7,
                             beta_max=1.7, boundary="noflux_z"), {}),
}

GATE_CASES = [
    ("noflux", {}, {}),
    ("periodic_z", dict(boundary="periodic"), {}),
    ("noflux_x", dict(boundary="noflux_x"), {}),
    ("scar", {}, dict(obstacle_mask=scar_column())),
    ("field", {}, dict(diffusion_field=field_3d())),
    ("field_open_z", dict(boundary="noflux_y"),
     dict(diffusion_field=field_3d())),
    ("tensor", dict(boundary="noflux_z"),
     dict(diffusion_tensor=transmural_tensor())),
    ("tensor_open_z_layers", dict(boundary="noflux_x"),
     dict(diffusion_tensor=transmural_tensor(False))),
    ("f64", dict(dtype="float64"), {}),
]


def state(shape, model, seed=9):
    rng = np.random.default_rng(seed)
    if model == "fhn":
        return rng.uniform(-2.0, 2.0, shape)
    return np.stack([rng.uniform(-0.1, 1.1, shape[1:]),
                     rng.uniform(0.0, 2.0, shape[1:])])


def wrms(ss, y):
    return float(np.sqrt(float(ss) / y.numel()))


@pytest.mark.parametrize("name,cfg_kw,build", GATE_CASES,
                         ids=[c[0] for c in GATE_CASES])
def test_gate_agrees_with_jax(name, cfg_kw, build):
    import jax.numpy as jnp

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild
    from crdmodel_tpu.ops import pallas_box3d_rkc

    kw = box_kw(**cfg_kw)
    jp = jbuild(JSimConfig(**kw), **build)
    tp = build_problem(SimConfig(**kw), "cpu", **build)
    want = pallas_box3d_rkc.is_box3d_rkc_supported(jp, jnp.dtype(kw["dtype"]))
    assert fk.is_box3d_rkc_supported(tp, getattr(torch, kw["dtype"])) == want


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_step_matches_jax_interpret_kernel(name, monkeypatch):
    import jax.numpy as jnp

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild
    from crdmodel_tpu.integrate import rkc as jrkc
    from crdmodel_tpu.ops import pallas_box3d_rkc

    cfg_kw, build = CASES[name]
    kw = box_kw(**cfg_kw)
    jp = jbuild(JSimConfig(**kw), **build)
    tp = build_problem(SimConfig(**kw), "cpu", **build)
    bc = prepare_box_constants(tp, torch.float32, "cpu")
    y_np = state(tuple(tp.y0.shape), kw["model"]).astype(np.float32)
    y = torch.tensor(y_np)
    scale = float(np.abs(y_np).max())
    rho = float(make_rho_bound(tp.cfg, tp.model, tp.geometry, torch.float32,
                               diffusion_field=tp.diffusion_field,
                               diffusion_tensor=tp.diffusion_tensor,
                               face_mask=tp.face_mask)(0.0, y, tp.params))
    mu1, ctab = static_stage_tables(fk.C_RKC, torch.float32)
    frkc = pallas_box3d_rkc.build_fused_box3d_rkc_step(jp, jnp.float32,
                                                       interpret=True)
    for s in (2, 5, 7):
        # the JAX step picks s itself: pin its choice
        monkeypatch.setattr(jrkc, "choose_stages",
                            lambda h, r, s=s: jnp.int32(s))
        h = min(0.65 * (s - 1) ** 2 / rho, 1e-2) if s > 2 else 1e-3
        for seg_end in (0.2, 1.5):
            jpar = {**jp.params, "_seg_end": jnp.float32(seg_end)}
            yp, jss, _ = frkc.step_err(jnp.float32(0.0),
                                       frkc.pad(jnp.asarray(y_np)),
                                       jnp.float32(h), jpar)
            want = np.asarray(frkc.unpad(yp))
            tpar = {**tp.params, "_seg_end": torch.tensor(seg_end)}
            fz = freeze_scalar(tpar, bc.has_freeze, float(kw.get(
                "t_boundary", 0.0)), torch.float32)
            got, ss = fk.fused_box3d_rkc_step(
                y, torch.tensor(h), fz, torch.tensor(s, dtype=torch.int32),
                mu1, ctab, bc, kw["rtol"], kw["atol"])
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=4e-6 * scale)
            want_norm = wrms(jss, y)
            assert (abs(wrms(ss.sum(), y) - want_norm)
                    <= 2e-3 + 1e-4 * want_norm)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_runs_take_jax_interpret_steps(name):
    import jax

    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.core.problem import build_problem as jbuild
    from crdmodel_tpu.sim import make_run_fn

    cfg_kw, build = CASES[name]
    kw = box_kw(**cfg_kw)
    jp = jbuild(JSimConfig(**kw), **build)
    traj, stats = jax.jit(make_run_fn(jp, interpret=True)[0])(jp.y0,
                                                              jp.params)
    cfg = SimConfig(**kw)
    got = simulate(cfg, "cpu", problem=build_problem(cfg, "cpu", **build))
    assert got.fused and got.ok
    for field in ("steps", "accepted", "rejected"):
        np.testing.assert_array_equal(getattr(got.stats, field).numpy(),
                                      np.asarray(getattr(stats, field)),
                                      err_msg=field)
    np.testing.assert_allclose(got.trajectory[1:].numpy(), np.asarray(traj),
                               rtol=0, atol=1e-5)


def test_stage_cap_takes_more_steps_same_solution():
    """tests/test_box3d_rkc_kernel.py::test_stage_cap_takes_more_steps_
    same_solution with Aliev–Panfilov kinetics (the port's kernels take
    reaction on): strong diffusion and a loose tolerance push the
    accuracy-limited h above the coverage of 7 stages; the uncapped torch
    path takes s > 7, the kernel's plain version caps h (h_limit) and takes
    more steps to the same solution."""
    cfg = SimConfig(**box_kw(diffusion=16.0, rtol=1e-2, atol=1e-5))
    capped = simulate(cfg, "cpu")
    free = simulate(dataclasses.replace(cfg, use_pallas=False), "cpu")
    assert capped.fused and not free.fused and capped.ok and free.ok
    p = free.problem
    rho = make_rho_bound(cfg, p.model, p.geometry, torch.float32,
                         diffusion_field=p.diffusion_field,
                         face_mask=p.face_mask)(0.0, p.y0, p.params)
    h_mean = cfg.t_final / free.total_steps()
    assert int(rkc.choose_stages(torch.tensor(h_mean), rho)) > fk.C_RKC
    assert capped.total_steps() > free.total_steps()
    np.testing.assert_allclose(capped.trajectory[-1].numpy(),
                               free.trajectory[-1].numpy(), rtol=0,
                               atol=5e-3)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card and nvcc")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("s", [2, 5, 7])
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernel_matches_plain(name, s, dtype):
    """y_new bitwise equal to the plain version (the same operations in
    the same order, -fmad=false); the per-block error sums to rounding."""
    cfg_kw, build = CASES[name]
    kw = box_kw(**cfg_kw)
    p = build_problem(SimConfig(**kw), "cuda", **build)
    bc = prepare_box_constants(p, dtype, "cuda")
    y = torch.tensor(state(tuple(p.y0.shape), kw["model"]), dtype=dtype,
                     device="cuda")
    mu1, ctab = static_stage_tables(fk.C_RKC, dtype, "cuda")
    ht = torch.tensor(2e-3, dtype=dtype, device="cuda")
    st = torch.tensor(s, dtype=torch.int32, device="cuda")
    for fz in (0.0, 1.0):
        fzt = torch.tensor(fz, dtype=dtype, device="cuda")
        args = (y, ht, fzt, st, mu1, ctab, bc, 1e-4, 1e-7)
        before = fk.fused_box3d_rkc_step.launches
        y_k, ss_k = fk.fused_box3d_rkc_step(*args)
        y_k2, ss_k2 = fk.fused_box3d_rkc_step(*args)
        assert fk.fused_box3d_rkc_step.launches == before + 2
        y_r, ss_r = fk.fused_box3d_rkc_step_reference(*args)
        torch.cuda.synchronize()
        assert torch.equal(y_k, y_k2) and torch.equal(ss_k, ss_k2)
        assert torch.equal(y_k, y_r)
        rel = abs(float(ss_k.sum()) - float(ss_r.sum())) / float(ss_r.sum())
        assert rel <= (1e-4 if dtype == torch.float32 else 1e-12)
