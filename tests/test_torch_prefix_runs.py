"""The prefix runs of chip_smoke.py (`prefix_cfg`): a run cut to its first
outputs, Tf cut with the output interval kept, takes bitwise the first
steps and rows of the whole run. The card's `cli_run_fhn` and
`stream_sharded_fhn` are held bitwise to the first rows of the golden-held
`main_path` and `main_path_sharded_fhn` runs on that ground. Here on the
CPU, at a small size, with the canonical FHN inputs (the tBoundary
breakpoint past the cut Tf): simulate(), simulate_streaming() and, on a
2x2 mesh through the plain K8, simulate_sharded_streaming() against
simulate_sharded().
"""

import dataclasses

import pytest
import torch

from chip_smoke import INI, PREFIX_OUTPUTS, prefix_cfg
from crdmodel_tpu_torch.config import config_from_ini
from crdmodel_tpu_torch.parallel.mesh import make_mesh
from crdmodel_tpu_torch.parallel.sharded import (simulate_sharded,
                                                 simulate_sharded_streaming)
from crdmodel_tpu_torch.sim import simulate, simulate_streaming

STATS = ("steps", "accepted", "rejected", "status")


def _cfg(**over):
    """The canonical FHN torus at 96x24, Tf 10 in 4 outputs, the freeze's
    release past the prefix."""
    cfg = config_from_ini(INI, model="fhn", surface="torus")
    return dataclasses.replace(cfg, x_mesh=24, t_final=10.0,
                               output_timestep=4, t_boundary=7.6, **over)


def _same_prefix(whole, cut):
    n = PREFIX_OUTPUTS
    assert cut.trajectory.shape[0] == n + 1
    assert torch.equal(whole.trajectory[:n + 1].cpu(), cut.trajectory.cpu())
    for key in STATS:
        assert torch.equal(getattr(whole.stats, key)[:n].cpu(),
                           getattr(cut.stats, key).cpu()), key


def test_prefix_cfg_keeps_the_output_times():
    cfg = _cfg()
    cut = prefix_cfg(cfg)
    assert cut.output_timestep == PREFIX_OUTPUTS
    assert cut.t_final / cut.output_timestep == cfg.t_final / 4
    assert cut.t_boundary > cut.t_final


@pytest.mark.parametrize("entry", [simulate, simulate_streaming])
def test_prefix_run_is_the_first_rows(entry):
    cfg = _cfg()
    _same_prefix(simulate(cfg, device="cpu"),
                 entry(prefix_cfg(cfg), device="cpu"))


def test_sharded_prefix_run_is_the_first_rows():
    """Through the plain K8 on a 2x2 mesh of CPU shards."""
    cfg = _cfg(use_pallas=True)
    mesh = make_mesh(shape=(2, 2), devices=["cpu"] * 4)
    whole = simulate_sharded(cfg, mesh=mesh)
    cut = simulate_sharded_streaming(prefix_cfg(cfg), mesh=mesh)
    assert whole.fused and cut.fused
    _same_prefix(whole, cut)
