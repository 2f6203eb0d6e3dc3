"""shard_map graph convolutions: DP x pixel-sharded polynomial conv.

The scale-out of the hot loop (SURVEY.md §3.2): batch rides the
``data`` mesh axis, the pixel axis M rides the ``pixel`` mesh axis, and every
Laplacian application performs one boundary-halo all_gather
(:mod:`.halo`) instead of materializing the full activation anywhere.
Gradients flow through ``shard_map`` + collectives natively (all_gather
transposes to a scatter-reduce in the VJP).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from .. import config
from .halo import ShardedEllpack

__all__ = ["ShardConfig", "sharded_poly_conv"]


@dataclass(frozen=True)
class ShardConfig:
    """Mesh + axis names for DP x pixel sharding (hashable; lives on
    modules as a static attribute)."""

    mesh: Mesh
    data_axis: str = "data"
    pixel_axis: str = "pixel"

    @property
    def n_pixel_shards(self):
        return self.mesh.shape[self.pixel_axis]


def _basis_stack(kind, spmv, x2d, n_terms):
    """Polynomial basis recursions on the local (m, C) block; each L
    application does one halo exchange."""
    from ..ops.spmv import bernstein_terms, chebyshev_terms, monomial_terms

    if kind == "cheby":
        return list(chebyshev_terms(spmv, x2d, n_terms))
    if kind == "mono":
        return list(monomial_terms(spmv, x2d, n_terms))
    if kind in ("bern", "bern_ref"):
        return list(bernstein_terms(spmv, x2d, n_terms,
                                    quirk=kind == "bern_ref"))
    raise ValueError(f"unknown basis kind {kind}")


def sharded_poly_conv(kind, op: ShardedEllpack, x, kernel, n_terms,
                      cfg: ShardConfig, tables=None):
    """Pixel-sharded polynomial graph conv: x (B, M, Fin) -> (B, M, Fout).

    ``op`` is the precomputed :class:`~.halo.ShardedEllpack`; ``tables``
    its arrays (``op.tables()``), passed separately so they enter the
    computation as runtime arguments, not HLO constants.
    """
    if tables is None:
        tables = op.tables()

    da, pa = cfg.data_axis, cfg.pixel_axis
    Fout = kernel.shape[-1]
    table_specs = {"local_idx": P(pa), "val": P(pa), "boundary": P(pa)}

    @partial(
        shard_map,
        mesh=cfg.mesh,
        in_specs=(P(da, pa, None), P(), table_specs),
        out_specs=P(da, pa, None),
        check_vma=False,
    )
    def conv(x_local, kernel_rep, tbl):
        tbl = {k: v[0] for k, v in tbl.items()}  # drop the shard axis
        B, m, Fin = x_local.shape
        x2d = jnp.transpose(x_local, (1, 0, 2)).reshape(m, B * Fin)
        spmv = lambda t: ShardedEllpack.spmv(t, pa, tbl)
        stack = _basis_stack(kind, spmv, x2d, n_terms)
        tx = jnp.stack(stack, axis=0).reshape(n_terms, m, B, Fin)
        tx = jnp.transpose(tx, (2, 1, 3, 0)).reshape(B * m, Fin * n_terms)
        y = jnp.dot(
            tx, kernel_rep.astype(tx.dtype),
            preferred_element_type=jnp.float32, precision=config.precision(),
        )
        return y.reshape(B, m, Fout).astype(x_local.dtype)

    tables = {k: jnp.asarray(v) for k, v in tables.items()}
    return conv(x, kernel, tables)
