"""Gaussian curvature and the coupling-strength profile of the torus
(counterpart of crdmodel_tpu/viz/curvature.py; the reference's
util/GenCurvatureCoupling.py and util/PlotGaussianAndCoupling.py).

Per cell of the torus mesh:

  K(theta) = cos(theta) / (r (R + r cos theta))          (Gaussian curvature)
  C(theta) = 10 (cosh(eta) - cos(theta_i))^2 / a^2       (coupling strength,
                                                          Kneer et al. 2014)

in the alternate toroidal coordinates a = sqrt(R^2 - r^2), eta = atanh(a/R),
theta_i = +/- acos(R/r - a^2/(r (R + r cos theta)))
(util/GenCurvatureCoupling.py:29-43, 87-90). Plain numpy: C(theta) is also
the profile of coupling="curvature" (core/problem.py::
diffusion_field_from_cfg).
"""

from __future__ import annotations

import os

import numpy as np

from crdmodel_tpu_torch.viz.torus_mesh import torus_mesh
from crdmodel_tpu_torch.viz.vtp import write_vtp


def gaussian_curvature(theta, r: float, R: float):
    theta = np.asarray(theta, dtype=np.float64)
    return np.cos(theta) / (r * (R + r * np.cos(theta)))


def coupling_strength(theta, r: float, R: float):
    """C(theta); theta in [0, 2pi)."""
    theta = np.asarray(theta, dtype=np.float64)
    a = np.sqrt(R * R - r * r)
    eta = np.arctanh(a / R)
    arg = np.clip(R / r - a * a / (r * (R + r * np.cos(theta))), -1.0, 1.0)
    theta_i = np.where((theta % (2 * np.pi)) <= np.pi,
                       np.arccos(arg), -np.arccos(arg))
    return 10.0 * (np.cosh(eta) - np.cos(theta_i)) ** 2 / (a * a)


def generate_curvature_coupling_vtp(cfg, outdir: str = ".") -> str:
    """The torus mesh with 'Gaussian Curvature' and 'Coupling Strength'
    cell arrays, under the reference's file name
    (util/GenCurvatureCoupling.py:100)."""
    R, r = cfg.major_radius, cfg.minor_radius
    nx, ny = cfg.nx, cfg.ny
    pts, tris, cell_rc = torus_mesh(R, r, nx, ny)
    th_cells = 2 * np.pi * (cell_rc[:, 1] + 0.5) / nx
    name = (f"CurvatureCoupling_torus_R{cfg.surface_length:g}"
            f"_r{cfg.surface_width:g}_mesh{cfg.nx}.vtp")
    os.makedirs(outdir, exist_ok=True)
    return write_vtp(
        os.path.join(outdir, name), pts, tris,
        cell_data={"Gaussian Curvature": gaussian_curvature(th_cells, r, R),
                   "Coupling Strength": coupling_strength(th_cells, r, R)})


def plot_curvature_profiles(out_path: str,
                            tori=((20.0, 1e9), (20.0, 80.0), (20.0, 40.0)),
                            labels=("flat", "weak curvature (L=80)",
                                    "strong curvature (L=40)")) -> str:
    """K(theta) and C(theta) of a flat, a weakly and a strongly curved
    torus, (W, L) each (util/PlotGaussianAndCoupling.py). Needs
    matplotlib, imported here."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    th = np.linspace(0, 2 * np.pi, 400)
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(7, 8), sharex=True)
    for (W, L), label in zip(tori, labels):
        r = W / (2 * np.pi)
        R = L / (2 * np.pi)
        ax1.plot(th, gaussian_curvature(th, r, R), label=label)
        if np.isfinite(R) and R > r:
            ax2.plot(th, coupling_strength(th, r, R), label=label)
    ax1.set_ylabel("Gaussian curvature K")
    ax2.set_ylabel("Coupling strength C")
    ax2.set_xlabel("theta")
    ax1.legend()
    ax2.legend()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path
