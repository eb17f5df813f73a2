"""coupling="curvature" in the port (crdmodel_tpu_torch/core/problem.py::
diffusion_field_from_cfg, viz/curvature.py) against the JAX package's, on
the CPU: the cases of tests/test_coupling.py that the one-device slice and
the mesh's torch path cover. The D(theta) field, its mean and its profile;
the validation; the torch path at f64 taking JAX f64's step sequences
exactly (fields within 1e-10) with bs32, rkc2 and ark324; a coupled run
differing from constant D; the ark324 split; the profile kernels' plain
versions through the theta-only remap (ops/kernel_common.py::
kernel_stencil_coeffs) against JAX's XLA path; and a 2x2 CPU mesh against
one device.
"""

import dataclasses

import numpy as np
import pytest
import torch

from crdmodel_tpu import simulate as jsimulate
from crdmodel_tpu.config import SimConfig as JSimConfig
from crdmodel_tpu.core import problem as jproblem
from crdmodel_tpu.core.grid import make_geometry as jmake_geometry
from crdmodel_tpu.viz import curvature as jcurvature
from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.core.grid import make_geometry
from crdmodel_tpu_torch.core.problem import (build_problem,
                                             diffusion_field_from_cfg,
                                             make_rhs)
from crdmodel_tpu_torch.ops.stencil import (divergence_laplacian,
                                            torus_laplacian)
from crdmodel_tpu_torch.parallel.mesh import make_mesh
from crdmodel_tpu_torch.parallel.sharded import simulate_sharded
from crdmodel_tpu_torch.sim import simulate
from crdmodel_tpu_torch.viz import curvature as tcurvature


def torus_kw(**kw):
    """tests/test_coupling.py::torus_cfg, smaller."""
    base = dict(model="fhn", surface="torus", x_mesh=16, surface_width=20.0,
                surface_length=80.0, t_final=0.5, output_timestep=2,
                beta=1.25, dtype="float64", coupling="curvature")
    base.update(kw)
    return base


class TestCurvatureCouplingField:
    @pytest.mark.parametrize("x_mesh,length", [(16, 80.0), (48, 80.0),
                                               (40, 40.0)])
    def test_field_matches_jax(self, x_mesh, length):
        """The field equals the JAX package's to 1e-15, its mean is
        cfg.diffusion, and it is positive."""
        kw = torus_kw(x_mesh=x_mesh, surface_length=length)
        cfg, jcfg = SimConfig(**kw), JSimConfig(**kw)
        D = diffusion_field_from_cfg(cfg, make_geometry(cfg))
        want = jproblem.diffusion_field_from_cfg(jcfg, jmake_geometry(jcfg))
        assert D.shape == (cfg.nx,) and D.dtype == np.float64
        np.testing.assert_allclose(D, want, rtol=0, atol=1e-15)
        assert abs(np.mean(D) - cfg.diffusion) < 1e-14
        assert np.all(D > 0)
        assert build_problem(cfg, "cpu").diffusion_field is not None

    def test_profile_matches_viz_formula(self):
        """The dynamics use exactly the coupling-strength profile of
        viz/curvature.py, whose functions equal the JAX package's."""
        cfg = SimConfig(**torus_kw(x_mesh=48))
        geom = make_geometry(cfg)
        D = diffusion_field_from_cfg(cfg, geom)
        g = geom.grid
        th = g.xmin + np.arange(g.nx, dtype=np.float64) * g.dx
        C = tcurvature.coupling_strength(th, geom.r, geom.R)
        np.testing.assert_allclose(D / D.mean(), C / C.mean(), rtol=1e-12)
        thetas = np.linspace(0.0, 2 * np.pi, 97)
        for r, R in ((20 / (2 * np.pi), 80 / (2 * np.pi)), (1.0, 3.0)):
            np.testing.assert_array_equal(
                tcurvature.coupling_strength(thetas, r, R),
                jcurvature.coupling_strength(thetas, r, R))
            np.testing.assert_array_equal(
                tcurvature.gaussian_curvature(thetas, r, R),
                jcurvature.gaussian_curvature(thetas, r, R))

    def test_validation(self):
        with pytest.raises(ValueError, match="coupling"):
            SimConfig(**torus_kw(coupling="nope")).validate()
        with pytest.raises(ValueError, match="torus"):
            SimConfig(**torus_kw(surface="flat")).validate()
        plain = SimConfig(**torus_kw(coupling="none"))
        with pytest.raises(ValueError, match="non-negative"):
            build_problem(plain, "cpu", diffusion_field=np.array([-0.1, 0.2]))
        with pytest.raises(ValueError, match="broadcast"):
            build_problem(plain, "cpu", diffusion_field=np.full(7, 0.1))
        with pytest.raises(ValueError, match="mutually exclusive"):
            build_problem(SimConfig(**torus_kw()), "cpu",
                          diffusion_tensor=(1.0, 1.0, 0.0))

    def test_none_coupling_keeps_reference_operator(self):
        prob = build_problem(SimConfig(**torus_kw(coupling="none")), "cpu")
        assert prob.diffusion_field is None


@pytest.mark.parametrize("method", ["bs32", "rkc2", "ark324"])
def test_torch_path_f64_takes_jax_steps(method):
    """The coupled torus on the torch path in f64: JAX f64's step sequence
    exactly, fields within 1e-10 (ark324's run shorter: its torch path
    steps slowly on the CPU)."""
    kw = torus_kw(method=method, rtol=1e-6, atol=1e-9, t_boundary=0.1,
                  **({"t_final": 0.25} if method == "ark324" else {}))
    jcfg = JSimConfig(**kw)
    jres = jsimulate(jcfg)
    tres = simulate(SimConfig(**kw), device="cpu")
    assert tres.ok and not tres.fused
    np.testing.assert_array_equal(tres.stats.steps.numpy(),
                                  np.asarray(jres.stats.steps))
    np.testing.assert_allclose(tres.trajectory.numpy(),
                               np.asarray(jres.trajectory), rtol=0,
                               atol=1e-10)


class TestEndToEnd:
    def test_fhn_curvature_run_ok_and_differs_from_constant(self):
        cfg = SimConfig(**torus_kw(coupling="none", x_mesh=24, t_final=1.0))
        r_const = simulate(cfg, device="cpu")
        r_curv = simulate(dataclasses.replace(cfg, coupling="curvature"),
                          device="cpu")
        assert r_const.ok and r_curv.ok
        assert float((r_const.trajectory[-1]
                      - r_curv.trajectory[-1]).abs().max()) > 1e-3

    def test_rkc2_with_coupling(self):
        cfg = SimConfig(**torus_kw(x_mesh=24, method="rkc2"))
        res = simulate(cfg, device="cpu")
        ref = simulate(dataclasses.replace(cfg, method="bs32"), device="cpu")
        assert res.ok and ref.ok
        assert float((res.trajectory[-1]
                      - ref.trajectory[-1]).abs().max()) < 5e-4

    def test_ark324_split_matches_composed_rhs(self):
        cfg = SimConfig(**torus_kw(t_boundary=0.2))
        prob = build_problem(cfg, "cpu")
        rhs_ex, rhs_im = make_rhs(cfg, prob.model, prob.geometry,
                                  torch.float64, "cpu", split=True,
                                  diffusion_field=prob.diffusion_field)
        y = prob.y0 + 0.01 * torch.tensor(
            np.random.default_rng(9).standard_normal(tuple(prob.y0.shape)))
        for t in (0.1, 0.3):
            tt = torch.tensor(t, dtype=torch.float64)
            assert torch.equal(prob.rhs(tt, y, prob.params),
                               rhs_ex(tt, y, prob.params)
                               + rhs_im(tt, y, prob.params))

    def test_remap_identity_f64(self):
        """The remapped profiles reproduce the divergence operator of the
        coupled field to rounding on a random field."""
        from crdmodel_tpu_torch.ops.kernel_common import kernel_stencil_coeffs
        prob = build_problem(SimConfig(**torus_kw(x_mesh=32)), "cpu")
        coeffs = kernel_stencil_coeffs(prob, torch.float64, "cpu")
        u = torch.tensor(np.random.default_rng(12).standard_normal(
            tuple(prob.y0.shape[1:])))
        flux = divergence_laplacian(u, prob.geometry.divergence_coeffs(
            prob.diffusion_field, torch.float64, "cpu"))
        torch.testing.assert_close(torus_laplacian(u, coeffs), flux, rtol=0,
                                   atol=1e-12 * float(flux.abs().max()))


# the profile kernels with the coupled field, f32 through their plain
# versions (tests/test_coupling.py::TestFusedKernels' configuration)
FUSED = dict(x_mesh=32, surface_length=40.0, t_final=0.2, dtype="float32",
             rtol=1e-4, atol=1e-6, use_pallas=True)


@pytest.mark.parametrize("method", ["bs32", "rkc2", "ark324"])
def test_fused_coupled_matches_xla(method):
    """K1, K2 and K3 take the coupled torus through the theta-only remap:
    their plain versions against JAX's XLA divergence path, f32, the same
    step count and trajectories within 2e-5 (tests/test_coupling.py's
    bar)."""
    kw = torus_kw(**FUSED, method=method)
    jcfg = JSimConfig(**{**kw, "use_pallas": False})
    jres = jsimulate(jcfg)
    tres = simulate(SimConfig(**kw), device="cpu")
    assert tres.ok and tres.fused
    assert tres.total_steps() == int(np.sum(np.asarray(jres.stats.steps)))
    np.testing.assert_allclose(tres.trajectory.numpy(),
                               np.asarray(jres.trajectory), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["torch_path", "plain_k8"])
def test_sharded_2x2_matches_single_device(use_pallas):
    """The coupled torus on a 2x2 CPU mesh against one device: the torch
    path in f64 to 5e-13 with the same steps (tests/test_coupling.py::
    TestSharded), and K8's plain version (make_shard_constants takes the
    remap) against K1's in f32, the same steps, to 2e-5."""
    kw = (torus_kw(x_mesh=24, t_final=0.25) if not use_pallas
          else torus_kw(**FUSED))
    cfg = SimConfig(**kw)
    r1 = simulate(cfg, device="cpu")
    r4 = simulate_sharded(cfg, mesh=make_mesh(shape=(2, 2),
                                              devices=["cpu"] * 4))
    assert r1.ok and r4.ok and r1.fused == use_pallas
    assert torch.equal(r4.stats.steps.cpu(), r1.stats.steps.cpu())
    torch.testing.assert_close(r4.trajectory.cpu(), r1.trajectory, rtol=0,
                               atol=2e-5 if use_pallas else 5e-13)
