"""The port's geometry, ICs and RHS on the torch path (f64, CPU) against the
JAX package's (f64, CPU), on the ICs and on numpy-seeded random states."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdmodel_tpu.config import SimConfig as JSimConfig
from crdmodel_tpu.core import problem as jproblem
from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.convert import inputs_from_numpy
from crdmodel_tpu_torch.core import problem as tproblem

BASE = dict(model="fhn", x_mesh=16, surface_width=20, surface_length=40,
            t_final=1.0, output_timestep=2, wave_length=0.1, wave_width=0.5,
            beta=1.25, beta_min=0.7, beta_max=1.7, t_boundary=0.4,
            dtype="float64")
CASES = [dict(surface=s, vary_beta=vb, wave_inside=wi)
         for s in ("torus", "flat") for vb in (0, 1) for wi in (0, 1)
         if not (s == "flat" and wi == 1)]
IDS = [f"{c['surface']}-vb{c['vary_beta']}-wi{c['wave_inside']}"
       for c in CASES]
# (t, segment end): before tBoundary in the frozen segment, at tBoundary as
# the frozen segment's last stage and as the released segment's first, after
TIMES = [(0.1, 0.4), (0.4, 0.4), (0.4, 0.5), (0.7, 1.0)]


def _problems(kw):
    cfg = dict(BASE, **kw)
    return (jproblem.build_problem(JSimConfig(**cfg)),
            tproblem.build_problem(SimConfig(**cfg), device="cpu"))


def _assert_close(got, want, scale):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    err = np.max(np.abs(got - np.asarray(want)))
    assert err <= 1e-13 * max(1.0, scale), err


@pytest.mark.parametrize("kw", CASES, ids=IDS)
def test_setup_matches_jax(kw):
    jp, tp = _problems(kw)
    for got, want in zip(tp.geometry.stencil_coeffs(torch.float64, "cpu"),
                         jp.geometry.stencil_coeffs(jnp.float64)):
        assert tuple(got.shape) == tuple(np.shape(want))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tp.params["b"].numpy(),
                                  np.asarray(jp.params["b"]))
    np.testing.assert_array_equal(tp.y0.numpy(), np.asarray(jp.y0))
    assert tp.steady_state == jp.steady_state


@pytest.mark.parametrize("kw", CASES, ids=IDS)
@pytest.mark.parametrize("state", ["ic", "random"])
def test_rhs_matches_jax(kw, state):
    jp, tp = _problems(kw)
    y_np = np.asarray(jp.y0)
    if state == "random":
        rng = np.random.default_rng(7)
        y_np = rng.uniform(-2.0, 2.0, size=y_np.shape)
    y_t, p_t = inputs_from_numpy(
        y_np, {k: np.asarray(v) for k, v in jp.params.items()},
        device="cpu", dtype=torch.float64)
    for t, seg_end in TIMES:
        want = np.asarray(jp.rhs(jnp.float64(t), jnp.asarray(y_np),
                                 {**jp.params, "_seg_end": jnp.float64(seg_end)}))
        got = tp.rhs(torch.tensor(t, dtype=torch.float64), y_t,
                     {**p_t, "_seg_end": torch.tensor(seg_end,
                                                      dtype=torch.float64)})
        _assert_close(got, want, np.max(np.abs(want)))
    # the frozen rows hold still before tBoundary
    frozen = tp.rhs(torch.tensor(0.1, dtype=torch.float64), y_t,
                    {**p_t, "_seg_end": torch.tensor(0.4, dtype=torch.float64)})
    assert torch.all(frozen[:, [0, -1]] == 0)


def test_just_diffusion_rhs_matches_jax():
    jp, tp = _problems(dict(surface="torus", vary_beta=0, just_diffusion=1))
    y_np = np.random.default_rng(3).uniform(-1.0, 1.0, np.shape(jp.y0))
    want = np.asarray(jp.rhs(0.0, jnp.asarray(y_np), jp.params))
    got = tp.rhs(torch.tensor(0.0, dtype=torch.float64),
                 torch.tensor(y_np), tp.params)
    _assert_close(got, want, np.max(np.abs(want)))


@pytest.mark.parametrize("cfg_kw,item", [
    (dict(surface="sphere"), "item 12"), (dict(model="goldbeter"), "item 5"),
    (dict(coupling="curvature", surface="torus"), "item 10")])
def test_unported_inputs_raise(cfg_kw, item):
    cfg = SimConfig(**{**BASE, "surface": "torus", **cfg_kw})
    with pytest.raises(NotImplementedError, match=item):
        tproblem.build_problem(cfg, device="cpu")
