"""The ark324 IMEX integrator on the port's torch path
(crdmodel_tpu_torch/integrate/imex.py, make_rhs(split=True), the models'
closed-form Jacobians) against the JAX package on the CPU, in float64: the
tableau, the pointwise solve, the Jacobians, one step, and whole runs of
the FitzHugh–Nagumo and Goldbeter cases of tests/test_golden.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdmodel_tpu.config import SimConfig as JSimConfig
from crdmodel_tpu.core import problem as jproblem
from crdmodel_tpu.integrate import imex as jimex
from crdmodel_tpu.sim import simulate as jsimulate
from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.convert import inputs_from_numpy
from crdmodel_tpu_torch.core import problem as tproblem
from crdmodel_tpu_torch.integrate import erk, imex
from crdmodel_tpu_torch.models import get_model
from crdmodel_tpu_torch.sim import simulate

# tests/test_golden.py CASES and BASE for the FHN and Goldbeter cases
CASES = {
    "fhn_flat": dict(model="fhn", surface="flat", beta=1.25, t_boundary=0.4),
    "fhn_torus": dict(model="fhn", surface="torus", beta=1.25, vary_beta=1,
                      beta_min=0.7, beta_max=1.7, t_boundary=0.4),
    "goldbeter_flat": dict(model="goldbeter", surface="flat", beta=0.85),
    "goldbeter_torus": dict(model="goldbeter", surface="torus", beta=0.4,
                            wave_inside=1),
}
BASE = dict(x_mesh=16, surface_width=20, surface_length=40,
            t_final=1.0, output_timestep=2, wave_length=0.1, wave_width=0.5,
            dtype="float64", rtol=1e-7, atol=1e-11, method="ark324")
# (t, segment end): in the frozen piece, and after the release
TIMES = ((0.1, 0.4), (0.7, 1.0))


def _rel_close(got, want, rel):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = max(1.0, float(np.max(np.abs(want))))
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * scale, err


def _state(case, jp, seed):
    """A numpy-seeded state near the IC (Goldbeter's stays positive)."""
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal(np.shape(jp.y0))
    if case.startswith("goldbeter"):
        return np.asarray(jp.y0) * np.exp(0.05 * noise)
    return np.asarray(jp.y0) + 0.05 * noise


def test_tableau_matches_jax():
    for got, want in zip(imex.tableau_arrays(), jimex.tableau_arrays()):
        np.testing.assert_array_equal(got, want)
    assert (imex.GAMMA, imex.C, imex.AE, imex.AI, imex.B, imex.D) == (
        jimex.GAMMA, jimex.C, jimex.AE, jimex.AI, jimex.B, jimex.D)
    assert (imex.STAGES, imex.ERR_ORDER, imex.NEWTON_ITERS,
            imex.NEWTON_TOL) == (jimex.STAGES, jimex.ERR_ORDER,
                                 jimex.NEWTON_ITERS, jimex.NEWTON_TOL)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_solve_pointwise_matches_jax(n):
    rng = np.random.default_rng(n)
    m = rng.standard_normal((n, n, 5, 7)) + 3.0 * np.eye(n)[:, :, None, None]
    r = rng.standard_normal((n, 5, 7))
    got = imex.solve_pointwise(torch.tensor(m), torch.tensor(r)).numpy()
    want = np.asarray(jimex.solve_pointwise(jnp.asarray(m), jnp.asarray(r)))
    if n <= 3:
        np.testing.assert_array_equal(got, want)    # the same Cramer ops
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.einsum("ab...,b...->a...", m, got), r,
                               rtol=1e-10, atol=1e-10)


def _split_pair(case, **over):
    kw = {**BASE, **CASES[case], **over}
    jp = jproblem.build_problem(JSimConfig(**kw))
    tp = tproblem.build_problem(SimConfig(**kw), "cpu")
    jsplit = jproblem.make_rhs(jp.cfg, jp.model, jp.geometry, jnp.float64,
                               split=True)
    tsplit = tproblem.make_rhs(tp.cfg, tp.model, tp.geometry, torch.float64,
                               "cpu", split=True)
    return jp, tp, jsplit, tsplit


@pytest.mark.parametrize("case", sorted(CASES))
def test_jacobians_match(case):
    """The closed-form Jacobian (models' jacobian) against torch.func.jacfwd
    of the kinetics and against the JAX package's AD Jacobian; the port's
    AD Jacobian (pointwise_jacobian, freeze included) against JAX's."""
    jp, tp, jsplit, tsplit = _split_pair(case)
    y_np = _state(case, jp, 3)
    params = {k: np.asarray(v) for k, v in jp.params.items()}
    y_t, p_t = inputs_from_numpy(y_np, params, device="cpu",
                                 dtype=torch.float64)
    model = get_model(CASES[case]["model"])
    closed = model.jacobian(y_t, p_t["b"])
    assert tuple(closed.shape) == (2, 2) + tuple(y_t.shape[1:])

    # jacfwd of the whole field is block diagonal in space: take the blocks
    full = torch.func.jacfwd(lambda s: model.kinetics(s, p_t["b"]))(y_t)
    ny, nx = y_t.shape[1:]
    idx = torch.arange(ny * nx)
    blocks = full.reshape(2, ny * nx, 2, ny * nx)[:, idx, :, idx]
    _rel_close(closed, blocks.permute(1, 2, 0).reshape(2, 2, ny, nx), 1e-13)

    for t, seg_end in TIMES:
        jpar = {**jp.params, "_seg_end": jnp.float64(seg_end)}
        tpar = {**p_t, "_seg_end": torch.tensor(seg_end, dtype=torch.float64)}
        tt = torch.tensor(t, dtype=torch.float64)
        want = np.asarray(jimex.pointwise_jacobian(
            jsplit[1], jnp.float64(t), jnp.asarray(y_np), jpar))
        got = imex.pointwise_jacobian(tsplit[1], tt, y_t, tpar)
        _rel_close(got, want, 1e-13)
        if t >= tp.cfg.t_boundary:        # no freeze: the bare kinetics
            _rel_close(closed, want, 1e-13)


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_matches_jax(case):
    """One step at the same (t, y, h): y_new within 1e-13; the WRMS error
    norm sqrt(err_ss/N), which the accept test compares with 1, within
    1e-12 relative plus 1e-11. The absolute part is rounding: the stage
    slopes kI = (Y - rhs_known)/(h gamma) turn a one-ulp difference of the
    Newton iterates (the two AD Jacobians round differently) into about
    1e-13 of WRMS-scaled error at rtol 1e-7, which is many times err_ss's
    own size where the error is small (up to 4e-9 relative at a norm of
    3e-4 on fhn_torus)."""
    jp, tp, jsplit, tsplit = _split_pair(case)
    jstep, jinit = jimex.make_imex_step_err(*jsplit, BASE["rtol"],
                                            BASE["atol"])
    tstep, tinit = imex.make_imex_step_err(*tsplit, BASE["rtol"],
                                           BASE["atol"])
    y_np = _state(case, jp, 5)
    y_t, p_t = inputs_from_numpy(
        y_np, {k: np.asarray(v) for k, v in jp.params.items()},
        device="cpu", dtype=torch.float64)
    n = y_np.size
    for t, seg_end in TIMES:
        for h in (1e-3, 1e-2):
            jpar = {**jp.params, "_seg_end": jnp.float64(seg_end)}
            tpar = {**p_t, "_seg_end": torch.tensor(seg_end,
                                                    dtype=torch.float64)}
            jy, jss, _ = jax.jit(jstep)(jnp.float64(t), jnp.asarray(y_np),
                                        jnp.float64(h), jpar, ())
            tt = torch.tensor(t, dtype=torch.float64)
            assert tinit(tt, y_t, tpar) == ()
            ty, tss, carry = tstep(tt, y_t, torch.tensor(h, dtype=torch.float64),
                                   tpar, ())
            assert carry == ()
            _rel_close(ty, jy, 1e-13)
            tnorm, jnorm = np.sqrt(float(tss) / n), np.sqrt(float(jss) / n)
            assert abs(tnorm - jnorm) <= 1e-12 * jnorm + 1e-11


@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_path_matches_jax(case):
    kw = {**BASE, **CASES[case]}
    got = simulate(SimConfig(**kw), device="cpu")
    want = jsimulate(JSimConfig(**kw))
    assert got.ok and want.ok and not got.fused
    for name in ("steps", "accepted", "rejected", "status"):
        np.testing.assert_array_equal(
            getattr(got.stats, name).numpy(),
            np.asarray(getattr(want.stats, name)), err_msg=name)
    np.testing.assert_allclose(got.trajectory.numpy(),
                               np.asarray(want.trajectory), rtol=0, atol=1e-10)


def test_stepper_needs_the_split():
    with pytest.raises(ValueError, match="rhs_split"):
        erk.make_stepper("ark324", None, 1e-5, 1e-8)
