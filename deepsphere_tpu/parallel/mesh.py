"""Device mesh and sharding helpers.

The reference is single-device (SURVEY.md §2.3: no tf.distribute anywhere);
scale-out here is a ``jax.sharding.Mesh`` with a ``data`` axis
(batch / data parallelism — gradient psums inserted by the XLA SPMD
partitioner) and a ``pixel`` axis (sharding the HEALPix pixel dimension M —
the sequence-parallel analog for spherical maps, see ``halo.py``).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "batch_sharding", "replicated", "P", "Mesh", "NamedSharding"]


def make_mesh(shape=None, axis_names=("data", "pixel"), devices=None):
    """Create a mesh over the available devices.

    :param shape: tuple matching ``axis_names``; defaults to all devices on
        the first axis.
    :param devices: explicit device list (defaults to ``jax.devices()``)
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not match {n} devices")
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, axis_names)


def batch_sharding(mesh, data_axis="data"):
    """Sharding for (B, M, F) batches: batch split over the data axis."""
    return NamedSharding(mesh, P(data_axis))


def replicated(mesh):
    return NamedSharding(mesh, P())
