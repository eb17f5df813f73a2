"""The port's output pipeline after a run: movies, the torus mapping, the
box's volumes and the torus's curvature and coupling profiles
(crdmodel_tpu/viz/'s plots, torus_mesh, map_output, vtp, volume and
curvature). The JAX package's other analysis modules (maps, filaments,
tips) are plain numpy over its outputs and are not copied."""

from crdmodel_tpu_torch.viz.curvature import (
    coupling_strength, gaussian_curvature, generate_curvature_coupling_vtp,
    plot_curvature_profiles)
from crdmodel_tpu_torch.viz.map_output import (map_output_to_surface,
                                               map_output_to_torus)
from crdmodel_tpu_torch.viz.plots import (hopf_positions, plot_movie,
                                          render_frames)
from crdmodel_tpu_torch.viz.torus_mesh import generate_torus_vtp, torus_mesh
from crdmodel_tpu_torch.viz.volume import (read_vti, save_volume_series,
                                           volume_slice, write_vti)
from crdmodel_tpu_torch.viz.vtp import read_vtp, write_pvd, write_vtp

__all__ = [
    "plot_movie", "render_frames", "hopf_positions",
    "generate_torus_vtp", "torus_mesh", "map_output_to_torus",
    "map_output_to_surface", "write_vtp", "read_vtp", "write_pvd",
    "write_vti", "read_vti", "save_volume_series", "volume_slice",
    "gaussian_curvature", "coupling_strength",
    "generate_curvature_coupling_vtp", "plot_curvature_profiles",
]
