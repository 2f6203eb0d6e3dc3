"""Multi-chip training: DP x pixel sharding over a device mesh.

The reference is single-device (SURVEY.md §2.3 — no tf.distribute); this
is the scale-out workflow end to end:

1. a ``Mesh`` with a ``data`` axis (batch parallelism) and a ``pixel``
   axis (the HEALPix pixel dimension sharded over chips — the
   sequence-parallel analog for spherical maps),
2. ``HealpyGCNN(shard_cfg=...)``: convs run the halo-sharded ELLPACK
   SpMV (one boundary-row all_gather per Laplacian application;
   gradients psum over ``data`` via the XLA SPMD partitioner),
3. ``data_iterator``: host-local numpy -> mesh-sharded global batches,
4. a jitted functional train step (params replicated, batch sharded).

Runs anywhere: on CPU set ``XLA_FLAGS=--xla_force_host_platform_device_count=8``
to simulate an 8-device mesh (that is what the test harness does); on a
multi-GPU host the same code shards over the GPUs.

Run:  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/multichip_train.py   [NSIDE=8 STEPS=6 PIXEL=4]
"""

import os

import numpy as np

NSIDE = int(os.environ.get("NSIDE", 8))
STEPS = int(os.environ.get("STEPS", 6))
PIXEL = int(os.environ.get("PIXEL", 4))  # pixel-axis mesh extent


def main():
    import jax
    import jax.numpy as jnp
    import optax

    import deepsphere_tpu as ds
    from deepsphere_tpu.nn import healpy_layers as hp_nn
    from deepsphere_tpu.parallel import (
        NamedSharding, P, ShardConfig, data_iterator, make_mesh,
    )
    from deepsphere_tpu.sphere import healpix as hp

    ndev = len(jax.devices())
    data = ndev // PIXEL
    mesh = make_mesh(shape=(data, PIXEL), axis_names=("data", "pixel"))
    cfg = ShardConfig(mesh=mesh, data_axis="data", pixel_axis="pixel")
    print(f"mesh: data={data} x pixel={PIXEL} over {ndev} devices")

    npix = hp.nside2npix(NSIDE)
    model = ds.HealpyGCNN(
        nside=NSIDE, indices=np.arange(npix),
        layers=[
            hp_nn.HealpyChebyshev(K=3, Fout=4, activation="relu",
                                  use_bn=True),
            hp_nn.HealpyPool(p=1),
            hp_nn.Flatten(),
            hp_nn.Dense(2),
        ],
        shard_cfg=cfg,
    )

    # synthetic 2-class task (bump at the north pole)
    rng = np.random.RandomState(0)
    n = 8 * data * STEPS
    labels = rng.randint(0, 2, size=n).astype(np.int32)
    x = rng.normal(size=(n, npix, 1)).astype(np.float32)
    v = hp.pix2vec(NSIDE, np.arange(npix), nest=True)
    bump = np.exp(-((v - np.array([0.0, 0.0, 1.0])) ** 2).sum(1))
    x[labels == 1, :, 0] += 0.7 * bump

    variables = model.init(0, jnp.asarray(x[: 2 * data]))
    params = variables["params"]
    batch_stats = variables.get("batch_stats", {})
    graph_tables = variables.get("graph_tables", {})  # jit args, never consts
    tx = optax.adam(1e-3)  # 1e-2 diverges on this toy task (saturated CE)
    opt_state = tx.init(params)

    def loss_fn(params, batch_stats, graph_tables, xb, yb):
        out, upd = model.module.apply(
            {"params": params, "batch_stats": batch_stats,
             "graph_tables": graph_tables},
            xb, training=True, mutable=["batch_stats"],
        )
        logp = jax.nn.log_softmax(out, axis=-1)
        loss = -jnp.mean(jnp.take_along_axis(logp, yb[:, None], axis=-1))
        return loss, upd["batch_stats"]

    @jax.jit
    def train_step(params, batch_stats, graph_tables, opt_state, xb, yb):
        (loss, new_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(params, batch_stats, graph_tables, xb, yb)
        updates, new_opt = tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), new_stats, new_opt,
                loss)

    rep = NamedSharding(mesh, P())
    params = jax.device_put(params, rep)
    batch_stats = jax.device_put(batch_stats, rep)
    opt_state = jax.device_put(opt_state, rep)
    graph_tables = jax.device_put(graph_tables, rep)

    losses = []
    for xb, yb in data_iterator(mesh, x, labels, batch_size=8 * data,
                                seed=1):
        params, batch_stats, opt_state, loss = train_step(
            params, batch_stats, graph_tables, opt_state, xb, yb
        )
        losses.append(float(loss))
        print(f"step {len(losses)}: loss {losses[-1]:.4f}")
    assert np.isfinite(losses).all()
    print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f} over {len(losses)} steps")


if __name__ == "__main__":
    from deepsphere_tpu.utils import enable_compile_cache

    enable_compile_cache()
    main()
