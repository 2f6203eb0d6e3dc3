"""Train -> export -> serve: the deployment workflow.

The reference's deployment story is HDF5 weights plus re-building the
model in Python with the full framework (healpy, pygsp, TF) installed.
Here the trained model is lowered once to a **self-contained StableHLO
artifact** (weights + graph tables baked in, polymorphic batch axis) and
the "serving side" below replays it as a plain ``jax.export.Exported``
(rebuilt by ``serve.read_exported`` from the StableHLO bytecode and a
JSON header) — no graph rebuild, no model code.

Run:  python examples/serving.py   [NSIDE=8 for a fast run]
"""

import os

import numpy as np

NSIDE = int(os.environ.get("NSIDE", 8))
ARTIFACT = os.environ.get("ARTIFACT", "/tmp/deepsphere_classifier.dsx")


def train_and_export():
    import deepsphere_tpu as ds
    from deepsphere_tpu.nn import healpy_layers as hp_nn
    from deepsphere_tpu.sphere import healpix as hp

    npix = hp.nside2npix(NSIDE)
    rng = np.random.RandomState(3)
    n = 96
    labels = rng.randint(0, 2, size=n)
    x = rng.normal(size=(n, npix, 1)).astype(np.float32)
    v = hp.pix2vec(NSIDE, np.arange(npix), nest=True)
    bump = np.exp(-((v - np.array([0.0, 0.0, 1.0])) ** 2).sum(1))
    x[labels == 1, :, 0] += 0.7 * bump

    model = ds.HealpyGCNN(
        nside=NSIDE, indices=np.arange(npix),
        layers=[
            hp_nn.HealpyChebyshev(K=5, Fout=8, activation="relu", use_bn=True),
            hp_nn.HealpyPool(p=1),
            hp_nn.Flatten(),
            hp_nn.Dense(2, activation="softmax"),
        ],
    )
    model.build((16, npix, 1))
    model.compile(optimizer=1e-3, loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    hist = model.fit(x, labels, batch_size=16, epochs=8, verbose=1)
    print(f"final accuracy: {hist['accuracy'][-1]:.3f}")

    nbytes = model.save_exported(ARTIFACT, batch_size=None)
    print(f"exported {ARTIFACT}: {nbytes / 1e6:.2f} MB, any batch size")
    return x, labels


def serve(x, labels):
    """The consumer: a plain jax.export.Exported — no model, no graph
    precompute."""
    import jax.numpy as jnp

    from deepsphere_tpu.serve import read_exported

    fn = read_exported(ARTIFACT)
    print(f"loaded artifact: input {fn.in_avals[0].shape}, "
          f"platforms {fn.platforms}")

    for bs in (4, 16, 7):  # one artifact, any batch size
        probs = np.asarray(fn.call(jnp.asarray(x[:bs])))
        acc = (probs.argmax(1) == labels[:bs]).mean()
        print(f"batch {bs:3d}: accuracy {acc:.3f}")


if __name__ == "__main__":
    from deepsphere_tpu.utils import enable_compile_cache

    enable_compile_cache()
    data = train_and_export()
    serve(*data)
