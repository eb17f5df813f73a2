"""crdmodel_tpu_torch — the PyTorch/CUDA port of crdmodel_tpu.

The same layout and names as the JAX package (crdmodel_tpu/), which stays
the reference. Plain tensor code is PyTorch; every Pallas TPU kernel on a
ported path is a CUDA C++ kernel for Hopper (csrc/), built with nvcc at
first use. The package imports torch and numpy, never jax.
"""

__version__ = "0.1.0"

from crdmodel_tpu_torch.config import SimConfig, config_from_ini, load_ini
from crdmodel_tpu_torch.core.grid import FlatGeometry, Grid, TorusGeometry
from crdmodel_tpu_torch.core.problem import Problem, build_problem
from crdmodel_tpu_torch.parallel.mesh import make_mesh
from crdmodel_tpu_torch.parallel.sharded import (simulate_sharded,
                                                 simulate_sharded_streaming)
from crdmodel_tpu_torch.sim import SimResult, simulate, simulate_streaming

__all__ = [
    "SimConfig",
    "load_ini",
    "config_from_ini",
    "Grid",
    "FlatGeometry",
    "TorusGeometry",
    "Problem",
    "build_problem",
    "simulate",
    "simulate_streaming",
    "simulate_sharded",
    "simulate_sharded_streaming",
    "make_mesh",
    "SimResult",
    "__version__",
]
