"""Field movies: PNG frames + optional MP4 (P1-P4 equivalents, Python 3;
counterpart of crdmodel_tpu/viz/plots.py). matplotlib and Pillow are
imported where a frame or a GIF is made, never at import.

One generic renderer replaces the four near-identical reference scripts
(util/FHNmodel/plot_FHNmodel_{flat,torus}.py, util/GoldbeterModel/...):
imshow frames of the reassembled (nt, ny, nx) field with Hopf-bifurcation
overlay lines when varyBeta, then ffmpeg to MP4 when available.

Reference conventions reproduced:
  - FHN torus pads the colour range to [0.9*min, 1.1*max]
    (plot_FHNmodel_torus.py:90-91); the other three use the raw extrema.
  - Hopf line position: y with beta(y) == beta_c, i.e.
    y = (beta_c - betaMin) * (ymax - ymin) / (betaMax - betaMin)
    (plot_FHNmodel_flat.py:93-95 and plot_FHNmodel_torus.py:93-95).
    FHN: beta_c = 1; Goldbeter: beta_c in {0.289, 0.774} — NB the reference's
    Goldbeter torus script hardcodes 0.289*2pi/0.774*2pi, assuming
    betaMin=0/betaMax=1 (plot_GoldbeterModel_torus.py:91-94); we use the
    general formula (identical for those defaults).
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional, Sequence

import numpy as np

HOPF_BETAS = {"fhn": (1.0,), "goldbeter": (0.289, 0.774)}


def hopf_positions(cfg) -> list:
    if not cfg.vary_beta or cfg.beta_max == cfg.beta_min:
        return []
    span = cfg.ymax - cfg.ymin
    out = []
    for bc in HOPF_BETAS.get(cfg.model, ()):
        y = (bc - cfg.beta_min) * span / (cfg.beta_max - cfg.beta_min)
        if cfg.ymin <= y <= cfg.ymax:
            out.append(y)
    return out


def default_frame_prefix(cfg) -> str:
    """Reference frame-name convention (plot_FHNmodel_torus.py:118-124)."""
    if cfg.vary_beta:
        return f"{cfg.program_name}_Z.varyBeta_linear"
    return f"{cfg.program_name}_Z.beta{cfg.beta:g}."


def render_frames(field: np.ndarray, cfg, outdir: str,
                  var_label: Optional[str] = None,
                  frame_prefix: Optional[str] = None) -> list:
    """field: (nt, ny, nx). Writes outdir/png/<prefix>NNN.png, returns paths."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    nt = field.shape[0]
    pngdir = os.path.join(outdir, "png")
    os.makedirs(pngdir, exist_ok=True)

    pad = cfg.model == "fhn" and cfg.surface == "torus"
    vmax = 1.1 * field.max() if pad else field.max()
    vmin = 0.9 * field.min() if pad else field.min()

    if frame_prefix is None:
        frame_prefix = default_frame_prefix(cfg)
    var_label = var_label or ("u" if cfg.model == "fhn" else "Z")
    xlabel, ylabel = (("theta", "phi") if cfg.surface == "torus"
                      else ("v", "phi") if cfg.surface != "flat"
                      else ("x", "y"))
    hopfs = hopf_positions(cfg)

    paths = []
    for k in range(nt):
        fig, ax = plt.subplots(figsize=(6.4, 4.8))
        img = ax.imshow(field[k],
                        extent=[cfg.xmin, cfg.xmax, cfg.ymin, cfg.ymax],
                        cmap="jet", aspect="auto", vmin=vmin, vmax=vmax,
                        origin="lower")
        ax.set_xlabel(xlabel)
        ax.set_ylabel(ylabel)
        fig.colorbar(img)
        for y in hopfs:
            ax.axhline(y=y, color="r", linewidth=1, linestyle="dashed")
        time = (k / nt) * cfg.t_final
        ax.set_title(f"{cfg.surface}: {var_label}({xlabel}, {ylabel}) at "
                     f"t = {time:.1f}, mesh = {cfg.nx}x{cfg.ny}")
        path = os.path.join(pngdir, f"{frame_prefix}{k:03d}.png")
        fig.savefig(path, dpi=150)
        plt.close(fig)
        paths.append(path)
    return paths


def frames_to_mp4(frame_pattern: str, out_path: str, fps: int = 6) -> bool:
    """PNG sequence -> MP4 via ffmpeg (reference uses `ffmpeg -r 6 -i ...`,
    plot_FHNmodel_torus.py:134-139). Returns False when ffmpeg is absent."""
    if shutil.which("ffmpeg") is None:
        return False
    cmd = ["ffmpeg", "-y", "-r", str(fps), "-i", frame_pattern, out_path]
    return subprocess.run(cmd, capture_output=True).returncode == 0


def frames_to_gif(frame_paths: Sequence[str], out_path: str,
                  fps: int = 6) -> bool:
    """PNG sequence -> animated GIF via Pillow — the ffmpeg-free fallback
    so the reference pipeline's movie leg (plot_FHNmodel_torus.py:134-144)
    always ends in a playable artifact. Returns False when Pillow is
    absent or no frames exist."""
    if not frame_paths:
        return False
    try:
        from PIL import Image
    except ImportError:
        return False
    frames = [Image.open(p).convert("P", palette=Image.ADAPTIVE)
              for p in frame_paths]
    frames[0].save(out_path, save_all=True, append_images=frames[1:],
                   duration=max(1, round(1000 / fps)), loop=0)
    return True


def frames_to_movie(frame_pattern: str, frame_paths: Sequence[str],
                    out_base: str, fps: int = 6):
    """Encode the movie leg: MP4 when ffmpeg exists, else animated GIF.
    Returns the artifact path or None."""
    mp4 = out_base + ".mp4"
    if frames_to_mp4(frame_pattern, mp4, fps):
        return mp4
    gif = out_base + ".gif"
    if frames_to_gif(frame_paths, gif, fps):
        return gif
    return None


def plot_movie(source, cfg, outdir: str = ".", var: int = 0) -> dict:
    """End-to-end P1-P4 equivalent.

    source: a SimResult, an (nt, ny, nx) array, or a directory containing
    reference-format text files (ours or the original binaries').
    """
    if isinstance(source, np.ndarray):
        field = source
    elif isinstance(source, str):
        from crdmodel_tpu_torch.io.trajectory import read_reference_files
        from crdmodel_tpu_torch.models import get_model
        name = get_model(cfg.model).var_names[var]
        field, _ = read_reference_files(source, cfg.program_name, name)
    else:
        field = source.field(var)
    prefix = default_frame_prefix(cfg)
    frames = render_frames(field, cfg, outdir, frame_prefix=prefix)
    movie = frames_to_movie(os.path.join(outdir, "png", prefix + "%03d.png"),
                            frames, os.path.join(outdir, prefix.rstrip(".")))
    return {"frames": frames, "movie": movie,
            "mp4": movie if (movie or "").endswith(".mp4") else None}
