"""Device mesh for 2-D spatial domain decomposition (counterpart of
crdmodel_tpu/parallel/mesh.py).

The JAX package builds a `jax.sharding.Mesh` with axes ('py', 'px') over
its devices, and one controlling process drives every shard through
`shard_map`. The port keeps that design: one process holds the shards as
tensors, each on its mesh position's device, and moves halos between them
with device copies (parallel/halo.py). A Mesh here is the (py, px) array
of those devices. Periodicity comes from the exchange, not from the mesh.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

AXIS_Y = "py"
AXIS_X = "px"


def balanced_dims(n: int, ny: int, nx: int) -> tuple:
    """Pick (py, px) with py*px == n — the analogue of MPI_Dims_create's
    auto-factorisation (src/FHNmodel_torus.cpp:724). Accepts ANY (devices,
    grid) pair, like the reference's SetupDecomp uneven block partition
    (src/FHNmodel_torus.cpp:750-755): a grid that doesn't divide the mesh is
    padded-and-masked (parallel/padding.py). Preference order: exactly
    dividing factorisations first (no padding), then the most balanced
    split, then least padded waste."""
    best = None
    for py in range(1, n + 1):
        if n % py:
            continue
        px = n // py
        if py > ny or px > nx:
            continue
        exact = 0 if (ny % py == 0 and nx % px == 0) else 1
        balance = abs(np.log(py / px))
        waste = (-(-ny // py) * py) * (-(-nx // px) * px) - ny * nx
        key = (exact, balance, waste)
        if best is None or key < best[0]:
            best = (key, py, px)
    if best is None:
        raise ValueError(
            f"no (py, px) factorisation of {n} devices fits grid {ny}x{nx} "
            "(need py <= ny and px <= nx)")
    return best[1], best[2]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (py, px) array of torch devices; shard (iy, ix) lives on
    devices[iy, ix]. Shards are listed in row-major mesh order everywhere
    (index iy*px + ix), and devices[0, 0] holds the run's control state."""
    devices: np.ndarray

    @property
    def shape(self) -> tuple:
        return tuple(self.devices.shape)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_list(self) -> list:
        """The shards' devices in row-major mesh order."""
        return list(self.devices.reshape(-1))

    @property
    def control(self) -> torch.device:
        """The device of shard (0, 0), which holds the control state."""
        return self.devices[0, 0]


def make_mesh(n_devices: int | None = None, shape: tuple | None = None,
              grid_shape: tuple | None = None, devices=None) -> Mesh:
    """Build a ('py', 'px') mesh over the first n devices.

    Either pass an explicit mesh `shape` (py, px), or `grid_shape`=(ny, nx)
    to auto-factorise n_devices over it. By default the devices are the
    visible CUDA cards, one shard on each, and too few raise as in the JAX
    package. An explicit `devices` list may repeat a device, for example
    ["cuda:0"] * 4 (a 2x2 mesh of shards on one card) or ["cpu"] * 8: the
    port's counterpart of the virtual CPU devices the JAX tests run on."""
    if devices is None:
        devs = [torch.device(f"cuda:{i}")
                for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(d) for d in devices]
    if shape is None:
        n = n_devices if n_devices is not None else len(devs)
        if grid_shape is None:
            raise ValueError("need shape or grid_shape")
        shape = balanced_dims(n, *grid_shape)
    n = shape[0] * shape[1]
    if n > len(devs):
        raise ValueError(f"mesh {shape} needs {n} devices, have {len(devs)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs[:n]
    return Mesh(arr.reshape(shape))
