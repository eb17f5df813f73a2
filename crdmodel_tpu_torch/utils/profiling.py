"""Run records and traces (counterpart of crdmodel_tpu/utils/profiling.py).

  - throughput(result): grid points x attempted steps / second of a
    SimResult, the JAX package's formula
  - trace(logdir): a torch.profiler trace of the block (the host's ops and,
    on a card, its kernels), written for TensorBoard's profiler plugin
  - RunManifest: a run's config, environment, timings and solver stats as
    JSON, beside the reference's stdout banner

The JAX package's device_sync has no counterpart: the port's drivers
synchronise the card themselves before they read the clock.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import platform
from typing import Optional

import torch


def throughput(result) -> float:
    """grid-points x internal steps / second for a completed SimResult."""
    cfg = result.cfg
    steps = int(result.stats.steps.sum())
    return cfg.nx * cfg.ny * steps / max(result.wall_time, 1e-12)


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """torch.profiler trace of the block into `logdir`
    (<worker>.<time>.pt.trace.json, the format of
    torch.profiler.tensorboard_trace_handler); the card's kernels too when
    CUDA is available. No-op without logdir."""
    if logdir is None:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


def device_name(device: torch.device) -> str:
    """The card's name on a CUDA device, else the host's processor."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return platform.processor() or platform.machine() or "cpu"


@dataclasses.dataclass
class RunManifest:
    config: dict
    backend: str          # "cuda" or "cpu": the device type of the run
    device: str           # the card's name (the host's processor on a CPU)
    torch_version: str
    python_version: str
    wall_time: float
    total_steps: int
    accepted: int
    rejected: int
    status: list
    throughput: float

    @classmethod
    def from_result(cls, result) -> "RunManifest":
        s = result.stats
        device = result.problem.device
        return cls(
            config=dataclasses.asdict(result.cfg),
            backend=device.type,
            device=device_name(device),
            torch_version=torch.__version__,
            python_version=platform.python_version(),
            wall_time=result.wall_time,
            total_steps=int(s.steps.sum()),
            accepted=int(s.accepted.sum()),
            rejected=int(s.rejected.sum()),
            status=[int(v) for v in s.status.tolist()],
            throughput=throughput(result),
        )

    def save(self, path: str) -> str:
        with open(path, "w") as fh:
            json.dump(dataclasses.asdict(self), fh, indent=2)
        return path
