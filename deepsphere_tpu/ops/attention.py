"""Dense and edge-sparse attention kernels.

Re-implementation of the attention math in
``/root/reference/src/deepsphere/gnn_transformers.py:14-106``:

* ``scaled_dot_product_attention`` — standard SDPA with additive -1e9 masking
  (parity with ``gnn_transformers.py:35-49``).
* ``edge_sparse_attention`` — attention restricted to graph edges, computed
  as edgewise dot products + segment-sum softmax over destination pixels
  (parity with ``gnn_transformers.py:79-103``).  Unlike the reference, the
  softmax is numerically stabilized by default with a per-destination
  ``segment_max`` subtraction (the reference exponentiates raw logits,
  ``gnn_transformers.py:95``); pass ``stabilized=False`` for bit-level
  behavioral parity.

The segment reductions lower to scatter-add patterns sized by the edge
count, which suits the <1% edge densities this is designed for
(``gnn_transformers.py:161-162``).  The edge list must be sorted by
destination (row) — guaranteed by ``SphereGraph.edge_idx``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import config

__all__ = ["scaled_dot_product_attention", "edge_sparse_attention"]


def scaled_dot_product_attention(q, k, v, mask=None):
    """SDPA over the last two axes; mask is additive 0/1 with 1 = masked.

    :param q: (..., Sq, D), k: (..., Sk, D), v: (..., Sk, Dv)
    :param mask: broadcastable to (..., Sq, Sk); 1 entries get -1e9
    :return: (output (..., Sq, Dv), attention_weights (..., Sq, Sk))
    """
    dk = jnp.asarray(k.shape[-1], dtype=q.dtype)
    logits = jnp.einsum(
        "...qd,...kd->...qk", q, k,
        preferred_element_type=jnp.float32, precision=config.precision(),
    )
    logits = logits / jnp.sqrt(dk)
    if mask is not None:
        logits = logits + mask * -1e9
    weights = jax.nn.softmax(logits, axis=-1).astype(q.dtype)
    out = jnp.einsum(
        "...qk,...kv->...qv", weights, v,
        preferred_element_type=jnp.float32, precision=config.precision(),
    )
    return out.astype(q.dtype), weights


def edge_sparse_attention(q, k, v, edge_idx, num_nodes, stabilized=True):
    """Graph-edge-masked attention via gather + segment reductions.

    :param q, k, v: (B, H, M, D) — batch, heads, nodes, head dim
    :param edge_idx: (E, 2) int array of (dst, src) edges, sorted by dst
    :param num_nodes: static M (segment count)
    :param stabilized: subtract per-destination max before exp
    :return: (B, H, M, D)
    """
    dk = jnp.asarray(k.shape[-1], dtype=jnp.float32)
    dst = edge_idx[:, 0]
    src = edge_idx[:, 1]

    # (E, B, H) edgewise scaled dot products; node axis first for the gather
    q_e = jnp.take(jnp.transpose(q, (2, 0, 1, 3)), dst, axis=0)  # (E, B, H, D)
    k_e = jnp.take(jnp.transpose(k, (2, 0, 1, 3)), src, axis=0)
    logits = jnp.sum(q_e * k_e, axis=-1, keepdims=True) / jnp.sqrt(dk)  # (E,B,H,1)

    if stabilized:
        seg_max = jax.ops.segment_max(
            logits, dst, num_segments=num_nodes, indices_are_sorted=True
        )
        # isolated nodes have -inf max; they contribute no edges anyway
        seg_max = jnp.where(jnp.isfinite(seg_max), seg_max, 0.0)
        logits = logits - jnp.take(seg_max, dst, axis=0)

    unnorm = jnp.exp(logits)
    v_e = jnp.take(jnp.transpose(v, (2, 0, 1, 3)), src, axis=0)  # (E, B, H, D)
    weighted = v_e * unnorm

    denom = jax.ops.segment_sum(
        unnorm, dst, num_segments=num_nodes, indices_are_sorted=True
    )
    numer = jax.ops.segment_sum(
        weighted, dst, num_segments=num_nodes, indices_are_sorted=True
    )
    out = numer / jnp.where(denom == 0.0, 1.0, denom)  # (M, B, H, D)
    return jnp.transpose(out, (1, 2, 0, 3))
