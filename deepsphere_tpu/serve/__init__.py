"""Serving / deployment: ahead-of-time exported inference artifacts.

The reference framework has no serving story beyond pickled Keras weights
(`/root/reference/src/deepsphere/healpy_networks.py` + HDF5 checkpoints,
which require the full framework — healpy, pygsp, TF — at load time).
Here inference is exported through ``jax.export`` to a **self-contained
StableHLO artifact**: weights and graph tables are baked in as constants,
so the consumer needs only ``jax`` (no deepsphere_tpu, no graph rebuild,
no HEALPix precompute) and the call is jittable/shardable like any JAX
function.
"""

from .export import (ExportedModel, export_inference, load_exported,
                     read_exported, save_exported, write_exported)

__all__ = [
    "ExportedModel",
    "export_inference",
    "save_exported",
    "load_exported",
    "write_exported",
    "read_exported",
]
