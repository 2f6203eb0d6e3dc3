"""Input pipeline for sharded training: host-local numpy -> global arrays.

The reference trains from in-memory numpy on one device (quick_start cell
16; there is no input pipeline to port — SURVEY.md §2.3).  At multi-host
scale the input side changes shape: every host holds only its slice of the
batch, and the training step consumes ONE logically-global array laid out
over the mesh.  ``jax.make_array_from_process_local_data`` is the
bridge; these helpers wrap it with the framework's mesh
conventions so a user writes

    it = data_iterator(mesh, x, y, batch_size=64)
    for xb, yb in it:          # xb is global, sharded over the data axis
        state, logs = train_step(state, xb, yb)

single-process (one host owning the whole mesh) and multi-process
(``jax.process_count() > 1``, each host passing its local slice) look
identical to the step function.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

__all__ = ["global_batch", "data_iterator"]


def global_batch(mesh, local, data_axis="data", spec=None):
    """Assemble a logically-global, mesh-sharded array (or pytree) from
    process-local data.

    :param mesh: ``jax.sharding.Mesh``
    :param local: numpy/jax array (or pytree of them) holding THIS host's
        rows; across hosts the leading axis concatenates in process order
    :param data_axis: mesh axis the leading (batch) dim shards over
    :param spec: optional full ``PartitionSpec`` override (default: shard
        the leading axis over ``data_axis``, replicate the rest)
    :return: global ``jax.Array`` (pytree), addressable-shard-backed
    """
    sh = NamedSharding(mesh, P(data_axis) if spec is None else spec)

    def one(a):
        return jax.make_array_from_process_local_data(sh, np.asarray(a))

    return jax.tree_util.tree_map(one, local)


def data_iterator(mesh, x, y=None, batch_size=16, *, shuffle=True, seed=0,
                  drop_remainder=True, data_axis="data", epochs=1):
    """Yield mesh-sharded global batches from host-local arrays.

    Batches whose size does not divide the ``data_axis`` extent cannot be
    laid out evenly; with ``drop_remainder=False`` the trailing batch is
    padded by repeating its last row and yielded with a boolean ``mask``
    (shape (B,)) so losses/metrics can ignore the padding.

    :param x, y: host-local arrays with matching leading dim (y optional)
    :param epochs: number of passes (reshuffled per pass)
    :yield: ``(xb, yb)`` — or ``(xb, yb, mask)`` when a padded trailing
        batch is possible (mask all-True for full batches)
    """
    x = np.asarray(x)
    if y is not None:
        y = np.asarray(y)
    n = x.shape[0]
    # ``batch_size`` is the PER-PROCESS batch: it must lay out evenly over
    # this process's share of the data axis (multi-host: each host feeds
    # its local slice; make_array_from_process_local_data assembles the
    # global batch of batch_size * process_count rows)
    ndev = max(1, int(mesh.shape[data_axis]) // jax.process_count())
    if batch_size % ndev:
        raise ValueError(
            f"batch_size {batch_size} must divide over this process's "
            f"{ndev} devices on the '{data_axis}' mesh axis"
        )
    rng = np.random.RandomState(seed)
    emit_mask = (not drop_remainder) and (n % batch_size != 0)

    for _ in range(int(epochs)):
        order = rng.permutation(n) if shuffle else np.arange(n)
        stop = (n // batch_size) * batch_size if drop_remainder else n
        for start in range(0, stop, batch_size):
            sel = order[start:start + batch_size]
            mask = np.ones(batch_size, bool)
            if sel.shape[0] < batch_size:  # trailing partial batch
                pad = batch_size - sel.shape[0]
                mask[sel.shape[0]:] = False
                sel = np.concatenate([sel, np.repeat(sel[-1:], pad)])
            xb = global_batch(mesh, x[sel], data_axis)
            out = (xb,)
            if y is not None:
                out += (global_batch(mesh, y[sel], data_axis),)
            if emit_mask:
                out += (global_batch(mesh, mask, data_axis),)
            yield out if len(out) > 1 else out[0]
