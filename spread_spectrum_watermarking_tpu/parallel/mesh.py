"""Device mesh construction and sharding policy.

The reference is strictly single-threaded (SURVEY.md section 2.1); here
scaling is expressed with ``jax.sharding.Mesh`` +
``NamedSharding``/``shard_map`` and XLA collectives (NCCL on GPUs). The
mesh follows the algorithm: the cards of one host are joined all to all, so
devices are placed in ``jax.devices()`` order.

- axis ``data``: the image batch (DP) -- the primary axis for the 1024x1080p
  corpus configs.
- axis ``spatial``: tiles of a single large image (TP) -- used by the sharded
  DCT's row->column reshard (an Ulysses-style all-to-all) and the
  distributed top-k.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a (data, spatial) mesh over the available devices.

    ``shape=None`` puts every device on the data axis -- the right default
    for batch workloads. Pass e.g. ``(1, 8)`` to dedicate all chips to one
    huge image, or ``(2, 4)`` to combine both.
    """
    devices = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (len(devices), 1)
    if shape[0] * shape[1] != len(devices):
        raise ValueError(f"mesh shape {shape} != {len(devices)} devices")
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, (DATA_AXIS, SPATIAL_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch) axis over the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def multihost_initialize(**kwargs) -> None:
    """Initialize multi-process JAX -- thin alias for discoverability.

    Call this once per process before building meshes, with the
    coordinator address, process count and process id given explicitly.
    """
    jax.distributed.initialize(**kwargs)
