"""Masked partial-sky classifier with a custom jitted training loop.

Re-creation of ``/root/reference/examples/advanced_tutorial.ipynb``: maps are
observed only inside a disc mask; the index set is padded with
``extend_indices`` so it stays reducible through the pooling hierarchy, and
training runs through an explicit jax.jit train_step (the JAX analogue of the
notebook's @tf.function GradientTape loop, cell 28).

Run:  python examples/advanced_masked.py  [NSIDE=16 EPOCHS=10]
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax

import deepsphere_tpu as ds
from deepsphere_tpu.nn import healpy_layers as hp_nn
from deepsphere_tpu.sphere import healpix as hp
from deepsphere_tpu.sphere.indexing import extend_indices
from deepsphere_tpu.train.losses import resolve_loss

NSIDE = int(os.environ.get("NSIDE", 16))
EPOCHS = int(os.environ.get("EPOCHS", 10))
N_CLASSES = 2
REDUCTION_P = 2  # two pooling layers of p=1


def disc_indices(nside, center=(1.0, 0.0, 0.0), radius=0.6):
    """NEST ids of pixels within an angular radius of a center direction."""
    npix = hp.nside2npix(nside)
    vec = hp.pix2vec(nside, np.arange(npix), nest=True)
    return np.flatnonzero(vec @ np.asarray(center) > np.cos(radius))


def make_dataset(nside, indices, n_maps, seed=0):
    rng = np.random.RandomState(seed)
    npix_local = len(indices)
    vec = hp.pix2vec(nside, indices, nest=True)
    labels = rng.randint(0, N_CLASSES, size=n_maps)
    x = rng.normal(scale=0.5, size=(n_maps, npix_local, 1)).astype(np.float32)
    for i, lab in enumerate(labels):
        width = 0.2 + 0.3 * lab
        centers = vec[rng.randint(npix_local, size=6)]
        bump = np.exp(-((1.0 - vec @ centers.T) / width**2)).sum(axis=1)
        x[i, :, 0] += (bump - bump.mean()) / (bump.std() + 1e-8)
    return x, labels


def main():
    # build the mask and extend it so pooling by 4^2 stays aligned
    # (the advanced_tutorial's extend_indices workflow)
    raw = disc_indices(NSIDE, radius=0.7)
    indices = extend_indices(raw, nside_in=NSIDE, nside_out=NSIDE // 2**REDUCTION_P)
    print(f"mask: {len(raw)} pixels -> {len(indices)} after extend_indices")

    x_train, y_train = make_dataset(NSIDE, indices, 160, seed=0)
    x_test, y_test = make_dataset(NSIDE, indices, 40, seed=1)

    layers = [
        hp_nn.HealpyChebyshev(K=5, Fout=8, activation="relu", use_bn=True),
        hp_nn.HealpyPool(p=1),
        hp_nn.Healpy_ResidualLayer("CHEBY", {"K": 5}, activation="relu", use_bn=True),
        hp_nn.HealpyPool(p=1),
        hp_nn.HealpyMonomial(K=3, Fout=16, activation="relu"),
        hp_nn.Flatten(),
        hp_nn.Dense(N_CLASSES),
    ]
    model = ds.HealpyGCNN(nside=NSIDE, indices=indices, layers=layers)

    batch = 16
    variables = model.build((batch, len(indices), 1))
    model.summary()

    # --- custom loop (jitted train_step; advanced_tutorial cell 28) ---
    loss_fn = resolve_loss("sparse_categorical_crossentropy_from_logits")
    tx = optax.adam(1e-3)
    params = variables["params"]
    batch_stats = variables.get("batch_stats", {})
    # static graph arrays: always thread them through jit as arguments
    graph_tables = variables.get("graph_tables", {})
    opt_state = tx.init(params)

    @jax.jit
    def train_step(params, batch_stats, graph_tables, opt_state, xb, yb):
        def loss_of(p):
            out, updates = model.module.apply(
                {"params": p, "batch_stats": batch_stats,
                 "graph_tables": graph_tables},
                xb, training=True, mutable=["batch_stats"],
            )
            return loss_fn(yb, out), updates["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(loss_of, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, new_stats, opt_state, loss

    @jax.jit
    def eval_step(params, batch_stats, graph_tables, xb, yb):
        out = model.module.apply(
            {"params": params, "batch_stats": batch_stats,
             "graph_tables": graph_tables},
            xb, training=False,
        )
        return jnp.mean(jnp.argmax(out, -1) == yb)

    rng = np.random.RandomState(0)
    n = x_train.shape[0]
    for epoch in range(EPOCHS):
        order = rng.permutation(n)
        losses = []
        for s in range(0, n - batch + 1, batch):
            sel = order[s : s + batch]
            params, batch_stats, opt_state, loss = train_step(
                params, batch_stats, graph_tables, opt_state,
                jnp.asarray(x_train[sel]), jnp.asarray(y_train[sel]),
            )
            losses.append(float(loss))
        accs = [
            float(eval_step(params, batch_stats, graph_tables,
                            jnp.asarray(x_test[s : s + batch]),
                            jnp.asarray(y_test[s : s + batch])))
            for s in range(0, x_test.shape[0], batch)
        ]
        print(f"epoch {epoch + 1}/{EPOCHS}: loss={np.mean(losses):.4f} "
              f"val_acc={np.mean(accs):.3f}")


if __name__ == "__main__":
    from deepsphere_tpu.utils import enable_compile_cache

    enable_compile_cache()
    main()
