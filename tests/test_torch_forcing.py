"""Structured forcing in the port (crdmodel_tpu_torch/core/forcing.py, the
forcing term of core/problem.py, the in-kernel forcing of K1, K2, K3 and
K4) against the JAX package's (crdmodel_tpu/core/forcing.py), on the CPU.

The cases are those of tests/test_forcing.py that the one-device slice
covers: the stage-time quadrature oracles, composition, pacing and
breakpoints, the gates, the freeze masking the forcing, and the fused runs
(through the kernels' plain versions, f32) against the JAX package's XLA
path with the JAX package's own fused-vs-XLA limits (a step gap of at most
1 an interval and 2 in all, trajectories within 1e-3; K2's 1e-4). The
torch path at f64 takes JAX f64's step sequences exactly, fields within
1e-10, with a pulse train and with a smooth waveform under bs32, rkc2 and
ark324. One step of each kernel's plain version with a forcing is held
against the JAX Pallas kernel in interpret mode. Pulse trains come across
as data (convert.forcing_from_numpy); smooth waveforms have torch twins
written here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdmodel_tpu import simulate as jsimulate
from crdmodel_tpu.config import SimConfig as JSimConfig
from crdmodel_tpu.core import forcing as jforcing
from crdmodel_tpu.core import problem as jproblem
from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.convert import forcing_from_numpy
from crdmodel_tpu_torch.core import forcing as tforcing
from crdmodel_tpu_torch.core.problem import (build_problem, make_rhs,
                                             solver_breakpoints)
from crdmodel_tpu_torch.sim import fused_eligible, select_stepper, simulate

OMEGA = 3.0


def flat_kw(**kw):
    """tests/test_forcing.py::flat_cfg, smaller."""
    base = dict(model="fhn", surface="flat", x_mesh=16, surface_width=10.0,
                surface_length=20.0, beta=1.25, t_final=2.0,
                output_timestep=4, dtype="float64", rtol=1e-8, atol=1e-12)
    base.update(kw)
    return base


def fused_kw(**kw):
    """tests/test_forcing.py::_fused_cfg, smaller: f32 through the kernels'
    plain versions, fine output intervals."""
    base = dict(model="fhn", surface="flat", x_mesh=32, surface_width=20.0,
                surface_length=20.0, beta=1.25, t_final=1.0,
                output_timestep=10, dtype="float32", rtol=1e-4, atol=1e-6,
                use_pallas=True)
    base.update(kw)
    return base


def cos_forcing(t, state, params):
    """A spatially uniform 0.7 cos(w t) drive on variable 0 (free-form)."""
    f0 = 0.7 * torch.cos(OMEGA * t) * torch.ones_like(state[0])
    return torch.stack([f0] + [torch.zeros_like(state[0])
                               for _ in range(state.shape[0] - 1)])


# the stimuli of tests/test_forcing.py::_protocol and _protocol_smooth as
# plain data: (kind, var, row or None, col or None, parameters); a pulse
# train's parameters are its starts, duration and amplitude, a smooth
# waveform's its name in WAVES
def protocol(ny, nx, smooth=False):
    band = jforcing.rect_profile(ny, 0, ny // 4)
    gauss = jforcing.gaussian_profile(nx, nx / 2, nx / 8)
    first = (("wave", 0, band, None, "bump") if smooth
             else ("pulses", 0, band, None, ([0.05, 0.45], 0.15, 1.5)))
    return (first, ("wave", 1, None, gauss, "cos"))


# each smooth waveform in JAX and its torch twin, the same operations
WAVES = {
    "bump": (lambda t: 1.5 * jnp.exp(-((t - 0.3) / 0.1) ** 2),
             lambda t, seg_end=None: 1.5 * torch.exp(-((t - 0.3) / 0.1) ** 2)),
    "cos": (lambda t: 0.4 * jnp.cos(3.0 * t),
            lambda t, seg_end=None: 0.4 * torch.cos(3.0 * t)),
    "cos5": (lambda t: 0.2 * jnp.cos(5.0 * t),
             lambda t, seg_end=None: 0.2 * torch.cos(5.0 * t)),
}


def jax_forcing(stimuli):
    out = []
    for kind, var, row, col, par in stimuli:
        wave = (jforcing.pulse_train(*par) if kind == "pulses"
                else WAVES[par][0])
        out.append(jforcing.Stimulus(waveform=wave, var=var, row=row,
                                     col=col))
    return jforcing.SeparableForcing(*out)


def torch_forcing(stimuli):
    """The port's twin through convert.forcing_from_numpy: pulse trains as
    data, smooth waveforms as their torch twins."""
    return forcing_from_numpy([
        dict(var=var, row=row, col=col,
             **({"pulses": par} if kind == "pulses"
                else {"waveform": WAVES[par][1]}))
        for kind, var, row, col, par in stimuli])


def both(kw, stimuli, build=None):
    """(JAX problem, the port's CPU problem) of config `kw` with the
    stimuli; build: extra numpy build arguments for both."""
    build = build or {}
    jp = jproblem.build_problem(JSimConfig(**kw), forcing=jax_forcing(
        stimuli), **build)
    tp = build_problem(SimConfig(**kw), "cpu", forcing=torch_forcing(stimuli),
                       **build)
    return jp, tp


def run_both(kw, stimuli, build=None, jax_kw=None):
    """(JAX run on its XLA path, the port's run) of `kw` with the stimuli;
    jax_kw overrides the JAX config (use_pallas=False)."""
    jkw = {**kw, **(jax_kw or {})}
    build = build or {}
    jcfg = JSimConfig(**jkw)
    jres = jsimulate(jcfg, problem=jproblem.build_problem(
        jcfg, forcing=jax_forcing(stimuli), **build))
    cfg = SimConfig(**kw)
    tres = simulate(cfg, device="cpu", problem=build_problem(
        cfg, "cpu", forcing=torch_forcing(stimuli), **build))
    return jres, tres


def assert_fused_limits(jres, tres, atol):
    """tests/test_forcing.py's fused-vs-XLA limits."""
    assert tres.ok and bool(np.all(np.asarray(jres.stats.status) == 0))
    gap = np.abs(tres.stats.steps.numpy() - np.asarray(jres.stats.steps))
    assert gap.max() <= 1 and gap.sum() <= 2, gap
    np.testing.assert_allclose(tres.trajectory.numpy(),
                               np.asarray(jres.trajectory), rtol=0,
                               atol=atol)


class TestStageTimeQuadrature:
    def test_pure_forcing_integrates_cos_exactly(self):
        """diffusion 0, justDiffusion: u' = 0.7 cos(w t), so u(t) = u0 +
        0.7 sin(w t)/w: the torch path evaluates the forcing at the true
        stage times."""
        cfg = SimConfig(**flat_kw(model="goldbeter", just_diffusion=1,
                                  diffusion=0.0))
        prob = build_problem(cfg, "cpu", forcing=cos_forcing)
        res = simulate(cfg, device="cpu", problem=prob)
        assert res.ok
        u0 = prob.y0[0].numpy()
        for k, t in enumerate(res.touts):
            np.testing.assert_allclose(res.trajectory[k, 0].numpy(),
                                       u0 + 0.7 * np.sin(OMEGA * t) / OMEGA,
                                       rtol=0, atol=1e-7)

    def test_forced_heat_mean_mode(self):
        """With diffusion the spatial mean is untouched by the operator, so
        it still follows the forced mode's exact solution."""
        cfg = SimConfig(**flat_kw(model="goldbeter", just_diffusion=1,
                                  diffusion=0.12))
        prob = build_problem(cfg, "cpu", forcing=cos_forcing)
        res = simulate(cfg, device="cpu", problem=prob)
        assert res.ok
        m0 = float(prob.y0[0].mean())
        for k, t in enumerate(res.touts):
            want = m0 + 0.7 * np.sin(OMEGA * t) / OMEGA
            assert abs(float(res.trajectory[k, 0].mean()) - want) < 1e-7


class TestComposition:
    def test_rhs_is_unforced_plus_forcing_and_jax(self):
        """The forced RHS is (diffusion + forcing) + kinetics, and equals
        the JAX package's on a random state, with a structured forcing
        too."""
        cfg = SimConfig(**flat_kw())
        pf = build_problem(cfg, "cpu", forcing=cos_forcing)
        pu = build_problem(cfg, "cpu")
        y = pf.y0 + 0.1
        for t in (0.0, 0.37):
            tt = torch.tensor(t, dtype=torch.float64)
            torch.testing.assert_close(
                pf.rhs(tt, y, pf.params),
                pu.rhs(tt, y, pu.params) + cos_forcing(tt, y, pu.params),
                rtol=0, atol=1e-14)
        jp, tp = both(flat_kw(t_boundary=0.5), protocol(cfg.ny, cfg.nx))
        y_np = np.random.default_rng(2).uniform(-1.0, 1.0, np.shape(jp.y0))
        for t, seg in ((0.1, 0.2), (0.5, 0.5), (1.0, 1.5)):
            want = np.asarray(jp.rhs(jnp.float64(t), jnp.asarray(y_np),
                                     {**jp.params, "_seg_end": seg}))
            got = tp.rhs(torch.tensor(t, dtype=torch.float64),
                         torch.tensor(y_np),
                         {**tp.params,
                          "_seg_end": torch.tensor(seg, dtype=torch.float64)})
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-13 * np.abs(want).max())

    def test_imex_split_keeps_forcing_explicit(self):
        cfg = SimConfig(**flat_kw(method="ark324", t_boundary=0.5))
        prob = build_problem(cfg, "cpu", forcing=cos_forcing)
        rhs_ex, rhs_im = make_rhs(cfg, prob.model, prob.geometry,
                                  torch.float64, "cpu", split=True,
                                  forcing=cos_forcing)
        y = prob.y0 + 0.05
        for t in (0.2, 0.8):
            tt = torch.tensor(t, dtype=torch.float64)
            torch.testing.assert_close(
                prob.rhs(tt, y, prob.params),
                rhs_ex(tt, y, prob.params) + rhs_im(tt, y, prob.params),
                rtol=0, atol=1e-14)
        # the implicit part is autonomous: two times on one side of the
        # freeze
        assert torch.equal(
            rhs_im(torch.tensor(0.2, dtype=torch.float64), y, prob.params),
            rhs_im(torch.tensor(0.3, dtype=torch.float64), y, prob.params))

    def test_ark324_forced_matches_bs32(self):
        cfg = SimConfig(**flat_kw(t_final=1.0))
        r1 = simulate(cfg, device="cpu", problem=build_problem(
            cfg, "cpu", forcing=cos_forcing))
        cfg2 = dataclasses.replace(cfg, method="ark324")
        r2 = simulate(cfg2, device="cpu", problem=build_problem(
            cfg2, "cpu", forcing=cos_forcing))
        assert r1.ok and r2.ok
        torch.testing.assert_close(r1.trajectory[-1], r2.trajectory[-1],
                                   rtol=0, atol=1e-6)

    def test_freeze_masks_forcing(self):
        """The absorbing-boundary freeze zeroes the forced RHS on the edge
        rows (src/FHNmodel_torus.cpp:643-653)."""
        cfg = SimConfig(**flat_kw(t_boundary=1.0))
        prob = build_problem(cfg, "cpu", forcing=cos_forcing)
        ydot = prob.rhs(torch.tensor(0.1, dtype=torch.float64), prob.y0,
                        prob.params)
        assert torch.all(ydot[:, 0, :] == 0) and torch.all(ydot[:, -1, :] == 0)


class TestPacing:
    def test_pulse_train_matches_jax_on_the_device_elementwise(self):
        """pulse_train's values on 0-d and 1-d tensors, with and without
        the segment gate, equal the JAX package's (crdmodel_tpu/core/
        forcing.py:170-179); its edges are its breakpoints; it never reads
        a tensor to the host (it runs on meta tensors, which have no
        values)."""
        starts, dur, amp = [0.1, 0.7], 0.2, 1.5
        jw = jforcing.pulse_train(starts, dur, amp)
        tw = tforcing.pulse_train(starts, dur, amp)
        assert tw.breakpoints == jw.breakpoints and tw.segment_gated
        ts = np.array([0.0, 0.1, 0.15, 0.3, 0.31, 0.7, 0.89, 0.9, 1.0])
        for dtype, jdt in ((torch.float32, jnp.float32),
                           (torch.float64, jnp.float64)):
            times = torch.tensor(ts, dtype=dtype)
            got = tw(times)
            assert got.shape == times.shape and got.dtype == dtype
            for i, t in enumerate(ts):
                want = float(jw(jnp.asarray(t, jdt)))
                assert float(tw(times[i])) == want == float(got[i])
                for seg in (0.1, 0.2, 0.3, 0.31, 0.8, 0.9):
                    want = float(jw(jnp.asarray(t, jdt),
                                    seg_end=jnp.asarray(seg, jdt)))
                    seg_t = torch.tensor(seg, dtype=dtype)
                    assert float(tw(times[i], seg_end=seg_t)) == want
                    gated = tw(times, seg_end=seg_t)
                    assert gated.shape == times.shape
                    assert float(gated[i]) == want
        meta = torch.zeros(3, device="meta")
        assert tw(meta).shape == (3,)
        assert tw(meta, seg_end=torch.zeros((), device="meta")).shape == (3,)

    def test_breakpoints_and_s1s2_protocol_match_jax(self):
        kw = flat_kw(t_boundary=0.5, t_final=3.0)
        cfg, jcfg = SimConfig(**kw), JSimConfig(**kw)
        jf = jforcing.s1s2_protocol(jcfg, amplitude=2.0, s1_times=[0.1, 1.2],
                                    s2_time=2.0, duration=0.3)
        tf = tforcing.s1s2_protocol(cfg, amplitude=2.0, s1_times=[0.1, 1.2],
                                    s2_time=2.0, duration=0.3)
        assert tf.breakpoints == jf.breakpoints
        assert (solver_breakpoints(cfg, tf)
                == jproblem.solver_breakpoints(jcfg, jf))
        assert solver_breakpoints(cfg) == (0.5,)
        assert solver_breakpoints(cfg, cos_forcing) == (0.5,)
        for a, b in zip(tf.stimuli, jf.stimuli):
            assert a.var == b.var
            for name in ("row", "col"):
                x, y = getattr(a, name), getattr(b, name)
                assert (x is None) == (y is None)
                if x is not None:
                    np.testing.assert_array_equal(x, y)

    def test_periodic_stimulus_retriggers_fhn(self):
        """A localised periodic stimulus (free-form, on the torus path)
        keeps re-exciting the medium from rest."""
        cfg = SimConfig(**flat_kw(x_mesh=24, beta=1.3, t_final=12.0,
                                  output_timestep=12, rtol=1e-6, atol=1e-9))
        prob0 = build_problem(cfg, "cpu")
        us, vs = prob0.steady_state
        bump = torch.zeros((cfg.ny, cfg.nx), dtype=torch.float64)
        j, i = cfg.ny // 2, cfg.nx // 2
        bump[j - 2:j + 2, i - 2:i + 2] = 4.0

        def pacing(t, state, params):
            on = (torch.remainder(t, 4.0) < 0.8).to(state.dtype)
            return torch.stack([on * bump, torch.zeros_like(state[0])])

        y0 = torch.tensor([us, vs], dtype=torch.float64)[:, None, None].expand(
            prob0.y0.shape).contiguous()
        prob = dataclasses.replace(build_problem(cfg, "cpu", forcing=pacing),
                                   y0=y0)
        res = simulate(cfg, device="cpu", problem=prob)
        assert res.ok
        u = res.field(0)
        assert np.max(u[0]) <= us + 1e-9
        assert np.max(u[-4:]) > us + 1.0

    def test_s1s2_protocol_elicits_response(self):
        cfg = SimConfig(**fused_kw(use_pallas=False, t_final=2.0))
        frc = tforcing.s1s2_protocol(cfg, amplitude=2.0, s1_times=[0.1],
                                     s2_time=1.0, duration=0.3)
        res = simulate(cfg, device="cpu",
                       problem=build_problem(cfg, "cpu", forcing=frc))
        res0 = simulate(cfg, device="cpu")
        assert res.ok
        assert float((res.trajectory[-1, 0] - res0.trajectory[-1, 0])
                     .abs().max()) > 1e-2


class TestGates:
    def test_separable_accepted_full_2d_and_free_form_declined(self):
        """K1, K2, K3 and K4 take a SeparableForcing of rank-1 stimuli (the
        JAX package's allow_forcing=True gates); a full 2-D `spatial` and
        a free-form callable decline to the torch path; K5 and the box
        kernels decline any forcing (their slices come later), and so does
        K14: a speculative run with a forcing takes K1 per step."""
        from crdmodel_tpu_torch.integrate.erk import TABLEAUS
        from crdmodel_tpu_torch.ops import (fused_aniso, fused_divform,
                                            fused_imex, fused_kstep,
                                            fused_rkc, fused_step)
        from crdmodel_tpu_torch.ops.kernel_common import fused_forcing
        f32, bs32 = torch.float32, TABLEAUS["bs32"]
        cfg = SimConfig(**fused_kw())
        sep = torch_forcing(protocol(cfg.ny, cfg.nx))
        full = tforcing.SeparableForcing(tforcing.Stimulus(
            waveform=tforcing.pulse_train([0.1], 0.2, 2.0),
            spatial=np.random.default_rng(5).random((cfg.ny, cfg.nx))))
        kernels = {
            "bs32": lambda p: fused_step.is_supported(p, bs32, f32),
            "noflux": lambda p: fused_divform.is_divform_supported(p, bs32,
                                                                   f32),
            "rkc2": lambda p: fused_rkc.is_rkc_supported(p, f32),
            "ark324": lambda p: fused_imex.is_imex_supported(p, f32)}
        for name, gate in kernels.items():
            c = dataclasses.replace(
                cfg, **({"boundary": "noflux"} if name == "noflux"
                        else {"method": name} if name != "bs32" else {}))
            p = build_problem(c, "cpu", forcing=sep)
            assert fused_forcing(p) is sep and gate(p) and fused_eligible(p)
            for other in (full, cos_forcing):
                q = build_problem(c, "cpu", forcing=other)
                assert fused_forcing(q) is False
                assert not gate(q) and not fused_eligible(q)
        p = build_problem(dataclasses.replace(cfg, speculative_k=5), "cpu",
                          forcing=sep)
        assert not fused_kstep.is_kstep_supported(p, bs32, f32, 5)
        kw, fused = select_stepper(p)
        assert fused and kw["spec_k"] == 0 and "kstep_call" not in kw
        aniso = build_problem(cfg, "cpu", forcing=sep,
                              diffusion_tensor=(1.0, 0.5, 0.1))
        assert not fused_aniso.is_aniso_supported(aniso, bs32, f32)

    def test_box_kernels_decline_and_zprof_off_the_box_refused(self):
        from crdmodel_tpu_torch.integrate.erk import TABLEAUS
        from crdmodel_tpu_torch.ops import fused_box3d, fused_box3d_rkc
        box = SimConfig(model="aliev_panfilov", surface="box", x_mesh=16,
                        surface_width=8.0, surface_length=16.0, y_mesh=32,
                        surface_depth=2.0, z_mesh=4, t_final=0.2,
                        output_timestep=1, beta=0.1, dtype="float32",
                        rtol=1e-4, atol=1e-6, boundary="noflux",
                        use_pallas=True)
        frc = tforcing.SeparableForcing(tforcing.Stimulus(
            waveform=tforcing.pulse_train([0.05], 0.1),
            row=tforcing.rect_profile(box.ny, 0, 8),
            zprof=tforcing.gaussian_profile(box.nz, 0.0, 1.5)))
        p = build_problem(box, "cpu", forcing=frc)
        # K6 and K7 take a rank-1 forcing with a depth profile (the name
        # is the one this test had while they declined it)
        assert fused_box3d.is_box3d_supported(p, TABLEAUS["bs32"],
                                              torch.float32)
        assert fused_box3d_rkc.is_box3d_rkc_supported(p, torch.float32)
        # on the box the plain K6 evaluates the depth profile, as the torch
        # path does
        res = simulate(box, device="cpu", problem=p)
        assert res.ok and res.fused
        torch_path = simulate(dataclasses.replace(box, use_pallas=False),
                              device="cpu", problem=dataclasses.replace(
                                  p, cfg=dataclasses.replace(
                                      box, use_pallas=False)))
        assert torch_path.ok and not torch_path.fused
        np.testing.assert_allclose(res.trajectory.numpy(),
                                   torch_path.trajectory.numpy(), rtol=0,
                                   atol=1e-5)
        flat = SimConfig(**flat_kw())
        with pytest.raises(ValueError, match="zprof"):
            build_problem(flat, "cpu", forcing=tforcing.SeparableForcing(
                tforcing.Stimulus(
                    waveform=tforcing.pulse_train([0.1], 0.1),
                    row=tforcing.rect_profile(flat.ny, 0, 4),
                    zprof=tforcing.gaussian_profile(4, 0.0, 1.0))))

    def test_stimulus_count_and_variables_match_jax_gate(self):
        """The gates follow the JAX package's fused_forcing alone: twelve
        rank-1 stimuli are taken; past the kernels' var1 mask (31 bits)
        or on a third variable, building the kernel's inputs raises rather
        than declining to the torch path."""
        from crdmodel_tpu.ops import kernel_common as jkc
        from crdmodel_tpu_torch.integrate.erk import TABLEAUS
        from crdmodel_tpu_torch.ops import fused_step
        from crdmodel_tpu_torch.ops import kernel_common as tkc
        cfg = SimConfig(**fused_kw())
        row = tforcing.rect_profile(cfg.ny, 0, 4)

        def stims(n, var=0):
            return [("pulses", var if j == 0 else j % 2, row, None,
                     ([0.1 + 0.01 * j], 0.1, 1.0)) for j in range(n)]

        jp = jproblem.build_problem(JSimConfig(**fused_kw()),
                                    forcing=jax_forcing(stims(12)))
        tp = build_problem(cfg, "cpu", forcing=torch_forcing(stims(12)))
        assert jkc.fused_forcing(jp) is jp.forcing
        assert tkc.fused_forcing(tp) is tp.forcing
        assert fused_step.is_supported(tp, TABLEAUS["bs32"], torch.float32)
        sc = tkc.prepare_stim_constants(tp, torch.float32, "cpu")
        assert sc.n_stim == 12 and sc.var1_mask == sum(
            1 << j for j in range(1, 12, 2))
        for n, var, match in ((32, 0, "at most 31"), (2, 2, "two variables")):
            q = build_problem(cfg, "cpu", forcing=torch_forcing(stims(n, var)))
            assert fused_step.is_supported(q, TABLEAUS["bs32"], torch.float32)
            with pytest.raises(ValueError, match=match):
                tkc.prepare_stim_constants(q, torch.float32, "cpu")

    def test_forcing_from_numpy_takes_one_waveform(self):
        with pytest.raises(ValueError, match="one of"):
            forcing_from_numpy([dict(var=0)])
        with pytest.raises(ValueError, match="one of"):
            forcing_from_numpy([dict(var=0, pulses=([0.1], 0.1, 1.0),
                                     waveform=WAVES["cos"][1])])


class TestStageAmplitudes:
    @pytest.mark.parametrize("smooth", [False, True])
    def test_stage_amplitudes_match_jax(self, smooth):
        """kernel_common.stage_amplitudes at bs32's and the ARK's c nodes
        against the JAX package's, f32, gated and smooth; on meta tensors
        too (no host read)."""
        from crdmodel_tpu.integrate import imex as jimex
        from crdmodel_tpu.integrate.erk import TABLEAUS as JT
        from crdmodel_tpu.ops import kernel_common as jkc
        from crdmodel_tpu_torch.ops import kernel_common as tkc
        stimuli = protocol(8, 8, smooth)
        jf, tf = jax_forcing(stimuli), torch_forcing(stimuli)
        for c_nodes in (tuple(float(c) for c in JT["bs32"].c), jimex.C):
            for t, h, seg in ((0.0, 0.05, 0.05), (0.04, 0.01, 0.05),
                              (0.45, 0.1, 0.55), (0.3, 0.2, 0.5)):
                want = np.asarray(jkc.stage_amplitudes(
                    jf, jnp.float32(t), jnp.float32(h), c_nodes,
                    {"_seg_end": jnp.float32(seg)}, jnp.float32))
                got = tkc.stage_amplitudes(
                    tf, torch.tensor(t), torch.tensor(h),
                    torch.tensor(c_nodes, dtype=torch.float32),
                    {"_seg_end": torch.tensor(seg)}, torch.float32)
                assert got.shape == want.shape and got.is_contiguous()
                np.testing.assert_allclose(got.numpy(), want, rtol=2e-7,
                                           atol=1e-7)
        meta = torch.zeros((), device="meta")
        gated = torch_forcing(protocol(8, 8))
        assert tkc.stage_amplitudes(gated, meta, meta,
                                    torch.zeros(3, device="meta"),
                                    {"_seg_end": meta},
                                    torch.float32).shape == (2, 3)

    def test_pulse_trains_in_one_pass(self):
        """SeparableForcing.amplitudes evaluates all pulse trains in one
        pass: bitwise each stimulus's own waveform, a smooth one between
        them, with and without the segment gate, in f32 and f64, and the
        JAX waveforms' values; its operations do not grow with the
        number of pulses (PulseWindows)."""
        from torch.utils._python_dispatch import TorchDispatchMode

        class Count(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.n = 0

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                self.n += 1
                return func(*args, **(kwargs or {}))

        def train(n_pulses, amp):
            return ([0.05 + 0.1 * j for j in range(n_pulses)], 0.05, amp)

        def stimuli(n_pulses):
            return (("pulses", 0, None, None, train(n_pulses, 1.5)),
                    ("wave", 1, None, None, "cos"),
                    ("pulses", 1, None, None, train(1, -0.7)),
                    ("pulses", 0, None, None, ([], 0.1, 2.0)))

        many = torch_forcing(stimuli(40))
        jmany = jax_forcing(stimuli(40))
        for dtype in (torch.float32, torch.float64):
            for base in (0.0, 0.05, 0.1, 1.23, 3.95, 4.0, 4.1):
                times = (torch.tensor(base, dtype=dtype)
                         + torch.tensor([0.0, 0.5, 1.0], dtype=dtype) * 0.05)
                for seg in (None, times[-1]):
                    got = many.amplitudes(times, seg, dtype)
                    assert got.shape == (4, 3) and got.is_contiguous()
                    for j, st in enumerate(many.stimuli):
                        gated = seg is not None and j != 1
                        want = (st.waveform(times, seg_end=seg) if gated
                                else st.waveform(times))
                        assert torch.equal(got[j], want.to(dtype).expand(3))
                        jst = jmany.stimuli[j].waveform
                        jt = np.asarray(times.numpy())
                        jwant = np.array([
                            jst(x, seg_end=seg.numpy()) if gated
                            else jst(x) for x in jt], np.float64)
                        np.testing.assert_allclose(
                            got[j].numpy(), jwant, rtol=1e-6, atol=1e-7)
        counts = []
        for n_pulses in (1, 40):
            frc = torch_forcing(stimuli(n_pulses))
            times = torch.tensor([0.1, 0.2, 0.3])
            frc.amplitudes(times, times[-1], torch.float32)
            with Count() as c:
                frc.amplitudes(times, times[-1], torch.float32)
            counts.append(c.n)
        assert counts[0] == counts[1], counts

    def test_rkc_stage_times_match_jax(self):
        """static_stage_tables(with_times=True) equals the JAX package's
        table; the amplitude columns of a step's evaluations (amp_column)
        are its stage times' indices."""
        from crdmodel_tpu.ops import pallas_rkc
        from crdmodel_tpu_torch.ops import fused_rkc as fr
        want = pallas_rkc.static_stage_tables(fr.S_MAX_KERNEL, jnp.float64,
                                              with_times=True)
        got = fr.static_stage_tables(fr.S_MAX_KERNEL, torch.float64,
                                     with_times=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert [fr.amp_column(e, fr.S_MAX_KERNEL + 2) for e in range(5)] \
            == [0, 2, 3, 4, 5]
        assert {fr.amp_column(e, 1) for e in range(5)} == {0}


# ---------------------------------------------------------------------------
# The torch path at f64 against JAX f64: the same step sequences exactly


# each method's program; ark324's torch path steps slowly on the CPU (its
# pointwise Newton), so its run is the shortest that still crosses the
# first pulse's two edges and the freeze release
PARITY = {"bs32": dict(model="fhn", surface="flat"),
          "rkc2": dict(model="fhn", surface="torus", surface_length=40.0),
          "ark324": dict(model="goldbeter", surface="torus", beta=0.4,
                         surface_length=40.0, t_final=0.4, output_timestep=2,
                         rtol=1e-5)}


@pytest.mark.parametrize("smooth", [False, True], ids=["pulse", "smooth"])
@pytest.mark.parametrize("method", sorted(PARITY))
def test_torch_path_f64_takes_jax_steps(method, smooth):
    kw = flat_kw(**{**dict(t_final=1.0, output_timestep=4, rtol=1e-6),
                    **PARITY[method]},
                 method=method, atol=1e-9, t_boundary=0.2)
    cfg = SimConfig(**kw)
    jres, tres = run_both(kw, protocol(cfg.ny, cfg.nx, smooth))
    assert tres.ok and not tres.fused
    np.testing.assert_array_equal(tres.stats.steps.numpy(),
                                  np.asarray(jres.stats.steps))
    np.testing.assert_array_equal(tres.stats.rejected.numpy(),
                                  np.asarray(jres.stats.rejected))
    np.testing.assert_allclose(tres.trajectory.numpy(),
                               np.asarray(jres.trajectory), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["torch_path", "plain_k1"])
def test_streaming_takes_simulate_steps(use_pallas):
    """simulate_streaming takes a forced problem's breakpoints and kernel
    as simulate() does: the same steps and rows, bitwise."""
    from crdmodel_tpu_torch.sim import simulate_streaming
    kw = fused_kw(use_pallas=use_pallas, t_final=0.6, output_timestep=3)
    cfg = SimConfig(**kw)
    stimuli = protocol(cfg.ny, cfg.nx)
    res = simulate(cfg, device="cpu", problem=build_problem(
        cfg, "cpu", forcing=torch_forcing(stimuli)))
    stream = simulate_streaming(cfg, device="cpu", problem=build_problem(
        cfg, "cpu", forcing=torch_forcing(stimuli)))
    assert res.fused == stream.fused == use_pallas
    assert torch.equal(stream.stats.steps, res.stats.steps)
    assert torch.equal(stream.trajectory, res.trajectory)


# ---------------------------------------------------------------------------
# The fused runs through the kernels' plain versions against JAX's XLA path


class TestFusedForcing:
    def test_single_device_fused_matches_xla(self):
        kw = fused_kw()
        cfg = SimConfig(**kw)
        stimuli = protocol(cfg.ny, cfg.nx)
        jres, tres = run_both(kw, stimuli, jax_kw=dict(use_pallas=False))
        assert tres.fused
        assert_fused_limits(jres, tres, 1e-3)
        # the forcing did something
        res0 = simulate(cfg, device="cpu")
        assert float((tres.trajectory - res0.trajectory).abs().max()) > 1e-3

    def test_freeze_masks_forcing_in_kernel(self):
        kw = fused_kw(t_boundary=0.3)
        cfg = SimConfig(**kw)
        jres, tres = run_both(kw, protocol(cfg.ny, cfg.nx),
                              jax_kw=dict(use_pallas=False))
        assert tres.fused
        assert_fused_limits(jres, tres, 1e-3)

    def test_dopri54_fused_matches_xla(self):
        kw = fused_kw(method="dopri54")
        cfg = SimConfig(**kw)
        jres, tres = run_both(kw, protocol(cfg.ny, cfg.nx),
                              jax_kw=dict(use_pallas=False))
        assert tres.fused
        assert_fused_limits(jres, tres, 1e-3)


class TestFusedDivformForcing:
    def test_single_device_noflux_matches_xla(self):
        kw = fused_kw(boundary="noflux")
        cfg = SimConfig(**kw)
        jres, tres = run_both(kw, protocol(cfg.ny, cfg.nx),
                              jax_kw=dict(use_pallas=False))
        assert tres.fused
        assert_fused_limits(jres, tres, 1e-3)

    def test_obstacle_with_s1s2(self):
        """s1s2_protocol on a scarred no-flux sheet: the scar holds its IC
        exactly under the stimulus (the tissue mask after the forcing)."""
        kw = fused_kw(model="aliev_panfilov", beta=0.1, boundary="noflux",
                      wave_length=0.25, wave_width=0.5)
        cfg = SimConfig(**kw)
        mask = np.ones((cfg.ny, cfg.nx), bool)
        mask[4:12, 4:12] = False
        frc = tforcing.s1s2_protocol(cfg, 2.0, [0.1], 0.5, 0.2)
        jfrc = jforcing.s1s2_protocol(JSimConfig(**kw), 2.0, [0.1], 0.5, 0.2)
        tres = simulate(cfg, device="cpu", problem=build_problem(
            cfg, "cpu", forcing=frc, obstacle_mask=mask))
        jcfg = JSimConfig(**{**kw, "use_pallas": False})
        jres = jsimulate(jcfg, problem=jproblem.build_problem(
            jcfg, forcing=jfrc, obstacle_mask=mask))
        assert tres.fused
        assert_fused_limits(jres, tres, 1e-3)
        scar = torch.tensor(~mask)
        assert torch.equal(tres.trajectory[-1][:, scar],
                           tres.trajectory[0][:, scar])


RKC_CASES = {"profile": dict(surface="torus", x_mesh=32, surface_width=20.0,
                             surface_length=40.0),
             "divform": dict(boundary="noflux")}


@pytest.mark.parametrize("smooth", [False, True], ids=["gated", "smooth"])
@pytest.mark.parametrize("branch", sorted(RKC_CASES))
def test_fused_rkc2_matches_xla(branch, smooth):
    """K2's plain version, profile and divergence branches, gated pulse
    trains (one amplitude column) and smooth waveforms (one a stage
    time), against the JAX XLA rkc2: a step gap of at most 1 an interval,
    trajectories within 1e-4 (tests/test_forcing.py's K2 limits)."""
    kw = fused_kw(method="rkc2", t_final=0.6, **RKC_CASES[branch])
    cfg = SimConfig(**kw)
    stimuli = (protocol(cfg.ny, cfg.nx, True) if smooth else (
        ("pulses", 0, jforcing.rect_profile(cfg.ny, 0, cfg.ny // 4), None,
         ([0.1, 0.4], 0.1, 1.5)),))
    jres, tres = run_both(kw, stimuli, jax_kw=dict(use_pallas=False))
    assert tres.fused
    assert tres.ok
    gap = np.abs(tres.stats.steps.numpy() - np.asarray(jres.stats.steps))
    assert gap.max() <= 1, gap
    np.testing.assert_allclose(tres.trajectory.numpy(),
                               np.asarray(jres.trajectory), rtol=0,
                               atol=1e-4)


def test_fused_imex_matches_xla():
    """K3's plain version: the forcing on the explicit stages at the ARK c
    nodes (tests/test_forcing.py::TestFusedImexForcing)."""
    kw = fused_kw(model="goldbeter", surface="torus", x_mesh=32,
                  surface_length=40.0, beta=0.4, atol=1e-7,
                  method="ark324", output_timestep=2)
    cfg = SimConfig(**kw)
    band = jforcing.rect_profile(cfg.ny, 0, cfg.ny // 4)
    gauss = jforcing.gaussian_profile(cfg.nx, cfg.nx / 2, cfg.nx / 8)
    stimuli = (("pulses", 0, band, None, ([0.1, 0.5], 0.1, 0.5)),
               ("wave", 0, None, gauss, "cos5"))
    jres, tres = run_both(kw, stimuli, jax_kw=dict(use_pallas=False))
    assert tres.fused and tres.ok
    gap = np.abs(tres.stats.steps.numpy() - np.asarray(jres.stats.steps))
    assert gap.max() <= 1, gap
    np.testing.assert_allclose(tres.trajectory.numpy(),
                               np.asarray(jres.trajectory), rtol=0,
                               atol=1e-3)


# ---------------------------------------------------------------------------
# One step of each kernel's plain version against the JAX Pallas kernel


STEP_CASES = {
    "K1": (dict(surface="torus", vary_beta=1, surface_length=40.0,
                t_boundary=0.4), "bs32"),
    "K4": (dict(boundary="noflux", t_boundary=0.4), "bs32"),
    "K3": (dict(model="goldbeter", surface="torus", beta=0.4,
                surface_length=40.0, wave_inside=1, wave_length=0.2),
           "ark324")}


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_plain_step_matches_jax_kernel(name):
    """One step with the paced protocol (a pulse train and a smooth
    waveform on variable 1) of K1's, K4's and K3's plain versions through
    their build_fused_* step_err against the JAX kernels in interpret mode,
    f32: y within 2e-5 of the state's scale, the error sum within 1e-3,
    in a pulse and out of it."""
    from crdmodel_tpu.integrate.erk import TABLEAUS as JT
    from crdmodel_tpu.ops import pallas_divform, pallas_imex, pallas_step
    from crdmodel_tpu_torch.integrate.erk import TABLEAUS
    from crdmodel_tpu_torch.ops import fused_divform, fused_imex, fused_step
    change, method = STEP_CASES[name]
    kw = fused_kw(x_mesh=16, **change, method=method)
    jp, tp = both(kw, protocol(SimConfig(**kw).ny, SimConfig(**kw).nx))
    if name == "K1":
        jf = pallas_step.build_fused_step(jp, JT[method], jnp.float32,
                                          interpret=True)
        tf = fused_step.build_fused_step(tp, TABLEAUS[method])
    elif name == "K4":
        jf = pallas_divform.build_fused_divform_step(
            jp, JT[method], jnp.float32, interpret=True)
        tf = fused_divform.build_fused_divform_step(tp, TABLEAUS[method])
    else:
        jf = pallas_imex.build_fused_imex_step(jp, jnp.float32,
                                               interpret=True)
        tf = fused_imex.build_fused_imex_step(tp)
    # FitzHugh-Nagumo on a random state with a step whose error stands
    # well above f32 rounding (tests/test_torch_fused_step.py's H);
    # Goldbeter near its positive ICs with a step its stiff kinetics take
    rng = np.random.default_rng(4)
    if name == "K3":
        h = 0.01
        y_np = np.asarray(jp.y0) + rng.uniform(-0.1, 0.1, np.shape(jp.y0))
    else:
        h = 0.1
        y_np = rng.uniform(-2.0, 2.0, np.shape(jp.y0))
    y_np = y_np.astype(np.float32)
    jstep = jax.jit(lambda t, yp, seg: jf.step_err(
        t, yp, jnp.float32(h), {**jp.params, "_seg_end": seg}))
    for t, seg in ((0.05, 0.1), (0.3, 0.35), (0.46, 0.5)):
        yp, ss_j = jstep(jnp.float32(t), jf.pad(jnp.asarray(y_np)),
                         jnp.float32(seg))
        y_new, ss = tf(torch.tensor(t, dtype=torch.float32),
                       torch.tensor(y_np), torch.tensor(h),
                       {**tp.params, "_seg_end": torch.tensor(seg)})
        want = np.asarray(jf.unpad(yp))
        scale = max(1.0, float(np.abs(y_np).max()))
        assert np.abs(y_new.numpy() - want).max() <= 2e-5 * scale
        assert abs(float(ss) - float(ss_j)) <= 1e-3 * float(ss_j)
