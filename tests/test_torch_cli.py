"""The port's `run` command (crdmodel_tpu_torch/cli.py) against the JAX
package's (crdmodel_tpu/cli.py) on the same command line, on the CPU: the
same set of files, the subdomain files byte for byte, the values, the
ParaView files and the manifests' step counts; the banner; the module
entry point and its exit codes; the card as the default device. The
`curvature` command against the JAX package's: the same .vtp file name,
mesh and cell arrays, the values to 1e-12."""

import filecmp
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from crdmodel_tpu_torch import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FHN_INI = os.path.join(ROOT, "data", "FHNmodelArgs.ini")
GB_INI = os.path.join(ROOT, "data", "GoldbeterModelArgs.ini")
# the canonical FHN torus cut to x_mesh 16 and Tf 1.5 with 4 outputs, its
# tBoundary breakpoint inside the run, in f64
SMALL = ["--set", "x_mesh=16", "--set", "t_final=1.5", "--set",
         "output_timestep=4", "--set", "t_boundary=0.7", "--dtype",
         "float64"]


def _fhn_args(outdir, *extra):
    return ["run", FHN_INI, "--model", "fhn", "--surface", "torus", *SMALL,
            "--outdir", str(outdir), "--quiet", *extra]


def _files(top):
    return sorted(os.path.relpath(os.path.join(d, f), top)
                  for d, _, fs in os.walk(top) for f in fs)


def test_run_writes_what_jax_run_writes(tmp_path, capsys):
    from crdmodel_tpu import cli as jcli
    from crdmodel_tpu.viz.vtp import read_vtp
    extra = ["--nprocs-files", "4", "--npz", "--map-torus"]
    ours, theirs = tmp_path / "ours", tmp_path / "jax"
    assert cli.main(_fhn_args(ours, *extra, "--device", "cpu")) == 0
    out = capsys.readouterr().out
    assert jcli.main(_fhn_args(theirs, *extra)) == 0
    jout = capsys.readouterr().out
    # the banner and everything before the run's own lines
    assert out.split("FHNmodel_torus: grid")[0] == \
        jout.split("FHNmodel_torus: grid")[0]
    files = _files(ours)
    assert files == _files(theirs)
    prog = "FHNmodel_torus"
    for name in files:
        a, b = str(ours / name), str(theirs / name)
        if "_subdomain." in name:
            assert filecmp.cmp(a, b, shallow=False), name
        elif name.startswith(f"{prog}_u."):
            np.testing.assert_allclose(np.loadtxt(a), np.loadtxt(b), rtol=0,
                                       atol=1e-10, err_msg=name)
        elif name.endswith(".vtp"):
            pa, ta, ca = read_vtp(a)
            pb, tb, cb = read_vtp(b)
            np.testing.assert_array_equal(pa, pb)
            np.testing.assert_array_equal(ta, tb)
            assert sorted(ca) == sorted(cb)
            for key in ca:
                np.testing.assert_allclose(ca[key], cb[key], rtol=0,
                                           atol=1e-10, err_msg=name)
        elif name.endswith(".pvd"):
            assert filecmp.cmp(a, b, shallow=False), name
    for name in (f"{prog}_manifest.json",):
        ma, mb = (json.load(open(p / name)) for p in (ours, theirs))
        for key in ("total_steps", "accepted", "rejected", "status"):
            assert ma[key] == mb[key], key
        assert ma["backend"] == "cpu" and ma["torch_version"]
    za, zb = (np.load(p / f"{prog}.npz") for p in (ours, theirs))
    np.testing.assert_array_equal(za["steps"], zb["steps"])
    np.testing.assert_allclose(za["trajectory"], zb["trajectory"], rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("ini,model,surface,extra", [
    (FHN_INI, "fhn", "torus", {}),
    (GB_INI, "goldbeter", "torus", {}),
    (FHN_INI, "aliev_panfilov", "box",
     dict(x_mesh=12, z_mesh=4, surface_depth=2.0, beta=0.15)),
])
def test_banner_matches_jax(ini, model, surface, extra, capsys):
    from crdmodel_tpu.config import config_from_ini as jconfig
    from crdmodel_tpu.core.problem import build_problem as jbuild
    from crdmodel_tpu.sim import print_banner as jbanner
    from crdmodel_tpu_torch.config import config_from_ini
    from crdmodel_tpu_torch.core.problem import build_problem
    from crdmodel_tpu_torch.sim import print_banner
    cfg = config_from_ini(ini, model=model, surface=surface, **extra)
    print_banner(cfg, build_problem(cfg, "cpu"))
    ours = capsys.readouterr().out
    jcfg = jconfig(ini, model=model, surface=surface, **extra)
    jbanner(jcfg, jbuild(jcfg))
    assert ours == capsys.readouterr().out
    assert f"{model.upper()} model PDE problem on a {surface}" in ours


def test_module_entry_point_and_exit_codes(tmp_path):
    """python -m crdmodel_tpu_torch: exit 0 on an ok run, 1 on a failed
    one (max_steps exhausted: no row after the IC)."""
    env = dict(os.environ, PYTHONPATH=ROOT)

    def run(outdir, *extra):
        return subprocess.run(
            [sys.executable, "-m", "crdmodel_tpu_torch",
             *_fhn_args(outdir, "--device", "cpu", *extra)],
            cwd=ROOT, env=env, capture_output=True, text=True)

    ok = run(tmp_path / "ok")
    assert ok.returncode == 0, ok.stderr
    assert "status=ok" in ok.stdout
    assert os.path.exists(tmp_path / "ok" / "FHNmodel_torus_u.000.txt")
    bad = run(tmp_path / "bad", "--set", "max_steps=3")
    assert bad.returncode == 1, bad.stderr
    assert "FAILED (max-steps-exceeded)" in bad.stdout
    rows = np.loadtxt(tmp_path / "bad" / "FHNmodel_torus_u.000.txt")
    assert rows.ndim == 1        # the IC alone


def test_card_is_the_default_device(tmp_path, monkeypatch, capsys):
    """Without --device cpu a run needs a CUDA device and names it when
    there is none; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        cli.main(_fhn_args(tmp_path))
    assert "no CUDA device" in str(exc.value)
    assert "--device cuda" in str(exc.value)
    assert not os.path.exists(tmp_path / "FHNmodel_torus_u.000.txt")


@pytest.mark.parametrize("extra", [
    ["--checkpoint-every", "1", "--checkpoint", "x"],
    ["--resume", "x"],
    ["--checkpoint-backend", "orbax"],
])
def test_checkpoint_flags_raise_item_14(tmp_path, extra):
    with pytest.raises(NotImplementedError, match="item 14"):
        cli.main(_fhn_args(tmp_path, "--device", "cpu", *extra))


def test_sharded_run_on_cpu_shards(tmp_path):
    """--devices 4 --device cpu: the sharded streaming run on four CPU
    shards writes the files of simulate_sharded's trajectory."""
    from crdmodel_tpu_torch.config import config_from_ini
    from crdmodel_tpu_torch.io.trajectory import read_reference_files
    from crdmodel_tpu_torch.parallel.sharded import simulate_sharded
    assert cli.main(_fhn_args(tmp_path, "--device", "cpu", "--devices",
                              "4", "--npz")) == 0
    cfg = config_from_ini(FHN_INI, model="fhn", surface="torus",
                          x_mesh=16, t_final=1.5, output_timestep=4,
                          t_boundary=0.7, dtype="float64")
    want = simulate_sharded(cfg, n_devices=4, device="cpu")
    got, _ = read_reference_files(str(tmp_path), cfg.program_name, "u")
    np.testing.assert_array_equal(got, want.trajectory[:, 0].numpy())
    z = np.load(tmp_path / f"{cfg.program_name}.npz")
    np.testing.assert_array_equal(z["steps"], want.stats.steps.numpy())


def test_snapshot_mode_none_writes_only_the_manifest(tmp_path):
    assert cli.main(_fhn_args(tmp_path, "--device", "cpu",
                              "--snapshot-mode", "none")) == 0
    assert _files(tmp_path) == ["FHNmodel_torus_manifest.json"]


def test_box_run_writes_npz_and_volumes(tmp_path):
    from crdmodel_tpu_torch.viz import read_vti
    args = ["run", FHN_INI, "--model", "aliev_panfilov", "--surface", "box",
            "--set", "x_mesh=12", "--set", "z_mesh=4", "--set",
            "surface_depth=2", "--set", "beta=0.15", "--set", "t_final=0.5",
            "--set", "output_timestep=2", "--outdir", str(tmp_path),
            "--quiet", "--map-torus", "--device", "cpu"]
    assert cli.main(args) == 0
    files = _files(tmp_path)
    assert "Aliev_panfilovModel_box.npz" in files, files
    z = np.load(tmp_path / "Aliev_panfilovModel_box.npz")
    vtis = [f for f in files if f.endswith(".vti")]
    assert len(vtis) == 3
    fields, _, _ = read_vti(str(tmp_path / vtis[-1]))
    np.testing.assert_array_equal(fields["u"], z["trajectory"][-1, 0])
    assert not any("_subdomain." in f for f in files)


def test_plot_writes_frames(tmp_path):
    """--plot renders a frame per output (matplotlib imported on use)."""
    pytest.importorskip("matplotlib")
    assert cli.main(_fhn_args(tmp_path, "--device", "cpu", "--plot")) == 0
    frames = os.listdir(tmp_path / "png")
    assert len(frames) == 5 and all(f.endswith(".png") for f in frames)


def test_jax_run_command_lines_parse():
    """Every flag of the JAX package's run parses, --set coerced by the
    annotated types (bools, Optionals)."""
    from crdmodel_tpu.cli import _coerce_override as jcoerce
    import typing
    from crdmodel_tpu_torch.config import SimConfig
    hints = typing.get_type_hints(SimConfig)
    for key, val in (("use_pallas", "true"), ("use_pallas", "none"),
                     ("x_mesh", "32"), ("rtol", "1e-6"), ("method", "rkc2"),
                     ("include_all_vars", "1")):
        assert cli._coerce_override(key, hints[key], val) == \
            jcoerce(key, hints[key], val)


@pytest.mark.parametrize("extra", [[], ["--set", "x_mesh=24"]])
def test_curvature_writes_what_jax_curvature_writes(tmp_path, capsys,
                                                    extra):
    """`curvature` writes the JAX package's .vtp (util/
    GenCurvatureCoupling.py's file name): the same points and cells, the
    'Gaussian Curvature' and 'Coupling Strength' cell arrays, their values
    the JAX functions' to 1e-12; it needs no device."""
    from crdmodel_tpu import cli as jcli
    from crdmodel_tpu.viz.vtp import read_vtp
    args = ["curvature", FHN_INI, "--model", "fhn", "--surface", "torus",
            *extra]
    ours, theirs = tmp_path / "ours", tmp_path / "jax"
    assert cli.main([*args, "--outdir", str(ours)]) == 0
    assert "Saving output to file" in capsys.readouterr().out
    assert jcli.main([*args, "--outdir", str(theirs)]) == 0
    names = os.listdir(ours)
    assert names == os.listdir(theirs) and len(names) == 1
    assert names[0].startswith("CurvatureCoupling_torus_R")
    points, tris, cells = read_vtp(str(ours / names[0]))
    jpoints, jtris, jcells = read_vtp(str(theirs / names[0]))
    np.testing.assert_array_equal(points, jpoints)
    np.testing.assert_array_equal(tris, jtris)
    assert sorted(cells) == sorted(jcells) == [
        "Coupling Strength", "Gaussian Curvature"]
    for name, values in jcells.items():
        np.testing.assert_allclose(cells[name], values, rtol=0, atol=1e-12)

