"""The port's streaming drivers (crdmodel_tpu_torch/sim.py::
simulate_streaming, parallel/sharded.py::simulate_sharded_streaming)
against the JAX package's simulate_streaming in float64 on the CPU (the
same per-interval steps, accepted and rejected steps and status, and
trajectories within 1e-10, the limits of tests/test_torch_erk.py), and
against the port's own batch drivers, bitwise: a streaming run makes the
same StopLoop calls as simulate() and simulate_sharded()."""

import dataclasses

import numpy as np
import pytest
import torch

from crdmodel_tpu_torch.config import SimConfig
from crdmodel_tpu_torch.core.problem import build_problem
from crdmodel_tpu_torch.parallel.mesh import make_mesh
from crdmodel_tpu_torch.parallel.sharded import (simulate_sharded,
                                                 simulate_sharded_streaming)
from crdmodel_tpu_torch.sim import (fused_eligible, select_stepper,
                                    simulate, simulate_streaming)

# the FHN torus of tests/test_torch_erk.py with a beta ramp and a
# tBoundary breakpoint inside the run; the Goldbeter torus with its wave
BASE = dict(x_mesh=16, surface_width=20, surface_length=40, t_final=1.5,
            output_timestep=4, wave_length=0.1, wave_width=0.5,
            dtype="float64", rtol=1e-7, atol=1e-11)
FHN = dict(BASE, model="fhn", surface="torus", beta=1.25, vary_beta=1,
           beta_min=0.7, beta_max=1.7, t_boundary=0.7)
CASES = {
    "fhn_torus": FHN,
    "goldbeter_torus": dict(BASE, model="goldbeter", surface="torus",
                            beta=0.4, wave_inside=1, t_boundary=0.7),
    "fhn_rkc2": dict(FHN, method="rkc2"),
    "fhn_ark324": dict(FHN, method="ark324", t_final=1.0),
    "fhn_normal": dict(FHN, step_mode="normal"),
}
STAT_FIELDS = ("steps", "accepted", "rejected", "status")


def _jax_streaming(kw):
    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.sim import simulate_streaming as jstream
    return jstream(JSimConfig(**kw))


def _same_stats(a, b):
    return all(torch.equal(getattr(a.stats, f), getattr(b.stats, f))
               for f in STAT_FIELDS)


@pytest.mark.parametrize("case", sorted(CASES))
def test_streaming_matches_jax_streaming(case):
    kw = CASES[case]
    got = simulate_streaming(SimConfig(**kw), device="cpu")
    want = _jax_streaming(kw)
    assert got.ok and want.ok and not got.fused
    for name in STAT_FIELDS:
        np.testing.assert_array_equal(
            getattr(got.stats, name).numpy(),
            np.asarray(getattr(want.stats, name)), err_msg=name)
    np.testing.assert_array_equal(got.touts, want.touts)
    np.testing.assert_allclose(got.trajectory.numpy(),
                               np.asarray(want.trajectory), rtol=0,
                               atol=1e-10)


def test_sticky_failure_stops_after_the_same_row_as_jax():
    """max_steps=3: the first interval fails, writes no row and ends the
    run in both packages; later intervals stay untouched."""
    kw = dict(FHN, max_steps=3)
    got = simulate_streaming(SimConfig(**kw), device="cpu")
    want = _jax_streaming(kw)
    assert not got.ok and not want.ok
    assert got.trajectory.shape[0] == np.asarray(want.trajectory).shape[0]
    assert got.trajectory.shape[0] == 1
    for name in STAT_FIELDS:
        np.testing.assert_array_equal(
            getattr(got.stats, name).numpy(),
            np.asarray(getattr(want.stats, name)), err_msg=name)
    np.testing.assert_array_equal(got.touts, want.touts)


# tstop with speculative_k 0, where simulate() and the streaming driver
# select the same stepper: the torch path, and use_pallas=True, which runs
# the kernels' plain versions on the CPU (K1, K2, K3)
BITWISE = {
    "fhn_torch": dict(FHN, dtype="float32", rtol=1e-5, atol=1e-8),
    "fhn_k1": dict(FHN, dtype="float32", rtol=1e-5, atol=1e-8,
                   use_pallas=True),
    "fhn_rkc2_k2": dict(FHN, dtype="float32", rtol=1e-5, atol=1e-8,
                        method="rkc2", use_pallas=True),
    "goldbeter_ark324_k3": dict(CASES["goldbeter_torus"], dtype="float32",
                                rtol=1e-5, atol=1e-8, method="ark324",
                                use_pallas=True, t_final=1.0),
    "fhn_rkc2_torch": dict(FHN, method="rkc2"),
    "fhn_normal_torch": dict(FHN, step_mode="normal"),
}


@pytest.mark.parametrize("case", sorted(BITWISE))
def test_streaming_is_simulate_bitwise(case):
    cfg = SimConfig(**BITWISE[case])
    batch = simulate(cfg, device="cpu")
    got = simulate_streaming(cfg, device="cpu")
    assert got.ok and got.fused == batch.fused
    assert got.fused == bool(cfg.use_pallas)
    assert torch.equal(got.trajectory, batch.trajectory)
    assert _same_stats(got, batch)
    np.testing.assert_array_equal(got.touts, batch.touts)


@pytest.mark.parametrize("use_pallas", [None, True])
def test_sharded_streaming_is_simulate_sharded_bitwise(use_pallas):
    """On a 2x2 mesh of CPU shards: the torch path and the plain K8."""
    cfg = SimConfig(**dict(FHN, dtype="float32", rtol=1e-5, atol=1e-8,
                           use_pallas=use_pallas))
    mesh = make_mesh(shape=(2, 2), devices=["cpu"] * 4)
    batch = simulate_sharded(cfg, mesh=mesh)
    got = simulate_sharded_streaming(cfg, mesh=mesh)
    assert got.ok and got.fused == batch.fused == bool(use_pallas)
    assert torch.equal(got.trajectory, batch.trajectory)
    assert _same_stats(got, batch)


def test_sharded_streaming_on_cpu_device_default_mesh():
    cfg = SimConfig(**FHN)
    got = simulate_sharded_streaming(cfg, n_devices=4, device="cpu",
                                     snapshot_mode="host")
    batch = simulate_sharded(cfg, n_devices=4, device="cpu")
    assert torch.equal(got.trajectory, batch.trajectory)
    assert _same_stats(got, batch)


def test_snapshot_modes():
    """"host" records the same rows (on the host), "none" only the final
    state and its time; the writer gets each row as a numpy array."""
    cfg = SimConfig(**FHN)
    dev = simulate_streaming(cfg, device="cpu")
    rows = []
    host = simulate_streaming(cfg, device="cpu", host_offload=True,
                              on_snapshot=lambda k, y: rows.append((k, y)))
    assert host.trajectory.device.type == "cpu"
    assert torch.equal(host.trajectory, dev.trajectory)
    assert [k for k, _ in rows] == list(range(cfg.output_timestep + 1))
    assert all(isinstance(y, np.ndarray) for _, y in rows)
    np.testing.assert_array_equal(np.stack([y for _, y in rows]),
                                  dev.trajectory.numpy())
    none = simulate_streaming(cfg, device="cpu", snapshot_mode="none")
    assert none.trajectory.shape[0] == 1
    assert torch.equal(none.trajectory[0], dev.trajectory[-1])
    np.testing.assert_array_equal(none.touts, [cfg.t_final])
    assert _same_stats(none, dev)


@pytest.mark.parametrize("kw", [
    dict(snapshot_mode="disk"),
    dict(snapshot_mode="none", on_snapshot=lambda k, y: None),
    dict(snapshot_mode="none", checkpoint_every=1),
])
def test_snapshot_mode_errors_match_jax(kw):
    from crdmodel_tpu.config import SimConfig as JSimConfig
    from crdmodel_tpu.sim import simulate_streaming as jstream
    small = dict(FHN, t_final=0.1, output_timestep=1)
    with pytest.raises(ValueError) as ours:
        simulate_streaming(SimConfig(**small), device="cpu", **kw)
    with pytest.raises(ValueError) as theirs:
        jstream(JSimConfig(**small), **kw)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("kw", [dict(checkpoint_every=1,
                                     checkpoint_path="ck.npz"),
                                dict(_resume={"k_out": 1})])
def test_checkpoints_raise_item_14(kw):
    with pytest.raises(NotImplementedError, match="item 14"):
        simulate_streaming(SimConfig(**FHN), device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="item 14"):
        simulate_sharded_streaming(SimConfig(**FHN), n_devices=4,
                                   device="cpu", checkpoint_every=1,
                                   checkpoint_dir="ck")


def test_stream_selection_mirrors_jax_streaming_gates():
    """The streaming driver's gates (crdmodel_tpu/sim.py:463-567), as
    select_stepper(streaming=True) applies them: no quiescence check for
    rkc2, no kernel for a tensor with rkc2 or ark324, a tensor on the ERK
    tableaus offered to K5's gate alone, which declines the box, and
    speculative_k ignored; simulate()'s selection differs only on the box
    with a tensor (K6's and K7's tensor modes) and in speculation."""
    quiet = SimConfig(model="fhn", surface="torus", x_mesh=16,
                      surface_width=20, surface_length=40, method="rkc2",
                      vary_beta=0, wave_inside=0, ic_type=0, beta=1.25,
                      t_final=1.0, output_timestep=2, use_pallas=None)
    flat = dict(model="aliev_panfilov", surface="flat", x_mesh=16,
                surface_width=20, surface_length=40, t_final=1.0,
                output_timestep=2, use_pallas=True, beta=0.15)
    tensor = dict(diffusion_tensor=(1.0, 0.5, 0.1))
    box = SimConfig(model="aliev_panfilov", surface="box", x_mesh=12,
                    z_mesh=4, surface_width=10.0, surface_length=10.0,
                    surface_depth=3.0, t_final=1.0, output_timestep=2,
                    boundary="noflux", use_pallas=True, beta=0.15)
    box_tensor = dict(diffusion_tensor=(1.0, 1.0, 0.5, 0.1, 0.0, 0.0))
    rows = [
        # (cfg, build kw, streaming fused, batch fused)
        (SimConfig(**flat), tensor, True, True),
        (SimConfig(**dict(flat, method="rkc2")), tensor, False, False),
        (SimConfig(**dict(flat, method="ark324")), tensor, False, False),
        (box, box_tensor, False, True),
        (dataclasses.replace(box, method="rkc2"), box_tensor, False, True),
        (dataclasses.replace(box, method="rkc2"), {}, True, True),
    ]
    for cfg, build_kw, stream_fused, batch_fused in rows:
        problem = build_problem(cfg, "cpu", **build_kw)
        assert select_stepper(problem, streaming=True)[1] == stream_fused, cfg
        assert fused_eligible(problem, streaming=True) == stream_fused, cfg
        assert select_stepper(problem)[1] == batch_fused, cfg
        assert fused_eligible(problem) == batch_fused, cfg
    # auto selection on the CPU takes no kernel in either driver
    problem = build_problem(quiet, "cpu")
    assert not select_stepper(problem, streaming=True)[1]
    assert not fused_eligible(problem)
    # with the quiescent rest state forced onto the kernels, rkc2 streams
    # through K2 where the batch driver's auto selection would decline
    problem = build_problem(dataclasses.replace(quiet, use_pallas=True),
                            "cpu")
    assert select_stepper(problem, streaming=True)[1]
    # speculative_k: K14 and batching in simulate(), neither when streaming
    problem = build_problem(SimConfig(**dict(
        flat, model="fhn", surface="torus", beta=1.25, speculative_k=4)),
        "cpu")
    batch_kw, batch_fused = select_stepper(problem)
    stream_kw, stream_fused = select_stepper(problem, streaming=True)
    assert batch_fused and stream_fused
    assert batch_kw["spec_k"] == 4 and "kstep_call" in batch_kw
    assert stream_kw["spec_k"] == 0 and "kstep_call" not in stream_kw


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA device")
def test_host_offload_on_card_is_device_mode():
    """On the card, the side-stream copies into pinned memory record the
    device mode's rows bitwise."""
    cfg = SimConfig(**dict(FHN, dtype="float32", rtol=1e-5, atol=1e-8,
                           use_pallas=True))
    dev = simulate_streaming(cfg, device="cuda")
    host = simulate_streaming(cfg, device="cuda", snapshot_mode="host")
    assert host.trajectory.device.type == "cpu"
    assert host.trajectory.is_pinned()
    assert torch.equal(host.trajectory, dev.trajectory.cpu())
