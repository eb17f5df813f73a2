"""The port's config loader against the JAX package's, on the canonical
inis in data/ (tests/test_config.py pins the same values on the reference's
own files)."""

import dataclasses
import math
import os
import subprocess
import sys

import pytest

from crdmodel_tpu import config as jcfg
from crdmodel_tpu_torch import config as tcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FHN_INI = os.path.join(ROOT, "data", "FHNmodelArgs.ini")
GB_INI = os.path.join(ROOT, "data", "GoldbeterModelArgs.ini")

CASES = [(FHN_INI, "fhn", "torus"), (FHN_INI, "fhn", "flat"),
         (GB_INI, "goldbeter", "torus"), (GB_INI, "goldbeter", "flat")]
DERIVED = ("nx", "ny", "dx", "dy", "xmin", "xmax", "ymin", "ymax",
           "minor_radius", "major_radius", "program_name")


@pytest.mark.parametrize("ini,model,surface", CASES)
def test_config_equals_jax(ini, model, surface):
    got = tcfg.config_from_ini(ini, model=model, surface=surface)
    want = jcfg.config_from_ini(ini, model=model, surface=surface)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for name in DERIVED:
        assert getattr(got, name) == getattr(want, name), name


def test_fhn_ini_values():
    cfg = tcfg.config_from_ini(FHN_INI, model="fhn", surface="torus")
    assert cfg.diffusion == 0.12
    assert cfg.beta == 1.25
    assert cfg.x_mesh == 400
    assert cfg.vary_beta == 1
    assert cfg.beta_min == 0.7 and cfg.beta_max == 1.7
    assert cfg.t_boundary == 38 and cfg.t_final == 50
    assert cfg.output_timestep == 20
    assert cfg.nx == 400 and cfg.ny == 1600
    assert math.isclose(cfg.minor_radius, 20 / (2 * math.pi))
    assert math.isclose(cfg.dx, 2 * math.pi / 399)
    assert math.isclose(cfg.dy, 2 * math.pi / 1599)


def test_goldbeter_ini_values():
    cfg = tcfg.config_from_ini(GB_INI, model="goldbeter", surface="torus")
    assert cfg.x_mesh == 100
    assert cfg.ny == 400
    assert cfg.t_final == 4
    assert cfg.output_timestep == 5
    assert cfg.ic_type == 2
    assert cfg.just_diffusion == 0


def test_validation_matches_jax():
    for kw in (dict(model="nope"), dict(wave_inside=2), dict(method="rk4")):
        with pytest.raises(ValueError):
            tcfg.SimConfig(**kw).validate()
        with pytest.raises(ValueError):
            jcfg.SimConfig(**kw).validate()


def test_port_imports_no_jax():
    """Every module of the port (pkgutil.walk_packages over the package)
    imports without jax or anything of the JAX package."""
    code = ("import importlib, pkgutil, sys, crdmodel_tpu_torch as pkg; "
            "mods = [m.name for m in pkgutil.walk_packages("
            "pkg.__path__, 'crdmodel_tpu_torch.') "
            "if m.name != 'crdmodel_tpu_torch.__main__']; "
            "[importlib.import_module(m) for m in mods]; "
            "bad = sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'crdmodel_tpu.'))); "
            "need = {'crdmodel_tpu_torch.' + m for m in ("
            "'cli', 'io.trajectory', 'native.build', 'utils.profiling', "
            "'viz.plots', 'parallel.sharded', 'ops.fused_step', "
            "'core.forcing', 'viz.curvature')}; "
            "print(len(mods), bad, sorted(need - set(mods))); "
            "sys.exit(1 if bad or need - set(mods) else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
