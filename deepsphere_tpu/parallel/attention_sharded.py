"""Pixel-sharded edge-sparse attention (shard_map + segment reductions).

Scale-out of the reference's full-resolution graph transformer
(``/root/reference/src/deepsphere/gnn_transformers.py:54-106``; SURVEY.md
§2.3 "edge-partitioned sparse attention with segment-sum reduction").

Design — destination-partitioned edges:

* The edge list is sorted by destination pixel (``SphereGraph.edge_idx``),
  so slicing the PIXEL axis into contiguous shards induces a clean edge
  partition: every edge belongs to exactly the shard that owns its
  destination.  All softmax segment reductions are over destinations, so
  with this partition there are NO cut segments — each shard's
  ``segment_max`` / ``segment_sum`` is exact locally and no psum of
  partial numerators/denominators is needed.
* The E-sized per-edge arrays (logits, exp weights, weighted values —
  the memory bottleneck of sparse attention at full resolution, roughly
  ``k``x the node arrays) are sharded S ways.  Only k/v are all_gathered
  over the pixel axis (one collective per attention layer) because a
  destination shard's sources reach into neighboring shards; q, the
  per-edge arrays, and the output stay sharded.
* Per-shard edge counts differ by O(1) on the near-uniform-degree sphere
  graph, so chunks are padded to the max count with masked edges
  (mask rides the exp weights: padded edges contribute exactly 0 to both
  numerator and denominator).

Gradients flow natively through shard_map: the all_gather of k/v
transposes to a reduce_scatter in the VJP, everything else is local.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

__all__ = ["partition_edges_by_dst", "sharded_edge_attention"]


def partition_edges_by_dst(edge_idx, num_nodes, n_shards):
    """Split a dst-sorted (E, 2) edge list into per-pixel-shard chunks.

    :param edge_idx: (E, 2) int array of (dst, src), sorted by dst
    :param num_nodes: total pixel count M (must divide ``n_shards``)
    :param n_shards: number of pixel shards
    :return: (parts (n_shards, Emax, 2) int32 with LOCAL dst / GLOBAL src,
        mask (n_shards, Emax, 1) float32 — 1 for real edges, 0 for padding)
    """
    edge_idx = np.asarray(edge_idx)
    if num_nodes % n_shards:
        raise ValueError(
            f"num_nodes={num_nodes} not divisible by n_shards={n_shards}"
        )
    m = num_nodes // n_shards
    dst = edge_idx[:, 0]
    if len(dst) > 1 and np.any(np.diff(dst) < 0):
        raise ValueError("edge_idx must be sorted by destination")
    bounds = np.searchsorted(dst, np.arange(0, num_nodes + 1, m))
    counts = np.diff(bounds)
    e_max = max(int(counts.max()) if counts.size else 0, 1)
    parts = np.zeros((n_shards, e_max, 2), np.int32)
    mask = np.zeros((n_shards, e_max, 1), np.float32)
    for s in range(n_shards):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        c = hi - lo
        parts[s, :c, 0] = dst[lo:hi] - s * m  # local dst
        parts[s, :c, 1] = edge_idx[lo:hi, 1]  # global src
        mask[s, :c, 0] = 1.0
    return parts, mask


def _local_edge_attention(q_l, k_full, v_full, e, mk, m, stabilized):
    """Edge attention on one destination shard (mirrors
    ``ops.attention.edge_sparse_attention`` with local segments)."""
    dk = jnp.asarray(k_full.shape[-1], dtype=jnp.float32)
    dst = e[:, 0]
    src = e[:, 1]
    mk = mk.reshape(-1, 1, 1, 1)  # (E, 1, 1, 1) against (E, B, H, 1)

    q_e = jnp.take(jnp.transpose(q_l, (2, 0, 1, 3)), dst, axis=0)  # (E,B,H,D)
    k_e = jnp.take(jnp.transpose(k_full, (2, 0, 1, 3)), src, axis=0)
    logits = jnp.sum(q_e * k_e, axis=-1, keepdims=True) / jnp.sqrt(dk)
    # padded edges: force a tiny finite logit so they can never win the
    # per-destination max (their contribution is zeroed by the mask below)
    logits = jnp.where(mk > 0, logits, -1e30)

    if stabilized:
        seg_max = jax.ops.segment_max(
            logits, dst, num_segments=m, indices_are_sorted=True
        )
        seg_max = jnp.where(
            jnp.isfinite(seg_max) & (seg_max > -1e29), seg_max, 0.0
        )
        logits = logits - jnp.take(seg_max, dst, axis=0)

    unnorm = jnp.exp(logits) * mk  # mask: padding contributes exactly 0
    v_e = jnp.take(jnp.transpose(v_full, (2, 0, 1, 3)), src, axis=0)
    weighted = v_e * unnorm

    denom = jax.ops.segment_sum(
        unnorm, dst, num_segments=m, indices_are_sorted=True
    )
    numer = jax.ops.segment_sum(
        weighted, dst, num_segments=m, indices_are_sorted=True
    )
    out = numer / jnp.where(denom == 0.0, 1.0, denom)  # (m, B, H, D)
    return jnp.transpose(out, (1, 2, 0, 3))


def sharded_edge_attention(q, k, v, parts, mask, cfg, stabilized=True):
    """Pixel-sharded edge-sparse attention.

    :param q, k, v: (B, H, M, D) — M sharded over ``cfg.pixel_axis``,
        B over ``cfg.data_axis``
    :param parts: (n_shards, Emax, 2) from :func:`partition_edges_by_dst`
        (sharded over the pixel axis on its leading dim)
    :param mask: (n_shards, Emax, 1) edge-validity mask
    :param cfg: :class:`~.sharded_ops.ShardConfig`
    :return: (B, H, M, D), M sharded like q
    """
    da, pa = cfg.data_axis, cfg.pixel_axis
    m = q.shape[2] // cfg.n_pixel_shards

    @partial(
        shard_map,
        mesh=cfg.mesh,
        in_specs=(
            P(da, None, pa), P(da, None, pa), P(da, None, pa), P(pa), P(pa)
        ),
        out_specs=P(da, None, pa),
        check_vma=False,
    )
    def attn(q_l, k_l, v_l, e_l, mk_l):
        # one collective per layer: sources of a destination shard
        # reach into neighboring pixel shards
        k_full = jax.lax.all_gather(k_l, pa, axis=2, tiled=True)
        v_full = jax.lax.all_gather(v_l, pa, axis=2, tiled=True)
        return _local_edge_attention(
            q_l, k_full, v_full, e_l[0], mk_l[0], m, stabilized
        )

    return attn(q, k, v, parts, mask)
