"""Whole-sphere classifier — the quick_start workload.

Re-creation of ``/root/reference/examples/quick_start.ipynb`` as a runnable
script: a 4-conv Chebyshev classifier on nside=64 maps, trained with the
Keras-style surface.  The bundled cosmology maps are not shipped with the
reference checkout, so we generate a synthetic 4-class dataset with the same
shape contract: classes differ by the angular scale of a smooth random
signal ("power spectrum" classification, the task of the original).

Run:  python examples/quick_start.py  [NSIDE=16 EPOCHS=8 for a fast run]
"""

import os

import numpy as np

import deepsphere_tpu as ds
from deepsphere_tpu.nn import healpy_layers as hp_nn
from deepsphere_tpu.sphere import healpix as hp

NSIDE = int(os.environ.get("NSIDE", 16))
EPOCHS = int(os.environ.get("EPOCHS", 8))
N_CLASSES = 4
N_TRAIN, N_TEST = 160, 40


def make_dataset(nside, n_maps, seed=0):
    """Synthetic classes: smooth bumps at class-dependent angular scale."""
    rng = np.random.RandomState(seed)
    npix = hp.nside2npix(nside)
    vec = hp.pix2vec(nside, np.arange(npix), nest=True)  # (npix, 3)
    labels = rng.randint(0, N_CLASSES, size=n_maps)
    x = rng.normal(scale=0.5, size=(n_maps, npix, 1)).astype(np.float32)
    for i, lab in enumerate(labels):
        width = 0.15 + 0.35 * lab / (N_CLASSES - 1)
        centers = vec[rng.randint(npix, size=12)]
        bump = np.exp(
            -((1.0 - vec @ centers.T) / width**2)
        ).sum(axis=1)
        x[i, :, 0] += (bump - bump.mean()) / (bump.std() + 1e-8)
    return x, labels


def main():
    npix = hp.nside2npix(NSIDE)
    x_train, y_train = make_dataset(NSIDE, N_TRAIN, seed=0)
    x_test, y_test = make_dataset(NSIDE, N_TEST, seed=1)

    # the quick_start architecture: Chebyshev(K=10) + pool, x4, dense head
    layers = [
        hp_nn.HealpyChebyshev(K=10, Fout=8, activation="relu", use_bn=True),
        hp_nn.HealpyPool(p=1),
        hp_nn.HealpyChebyshev(K=10, Fout=16, activation="relu", use_bn=True),
        hp_nn.HealpyPool(p=1),
        hp_nn.HealpyChebyshev(K=10, Fout=32, activation="relu", use_bn=True),
        hp_nn.HealpyPool(p=1),
        hp_nn.HealpyChebyshev(K=10, Fout=32, activation="relu"),
        hp_nn.Flatten(),
        hp_nn.Dense(N_CLASSES),
    ]
    model = ds.HealpyGCNN(nside=NSIDE, indices=np.arange(npix), layers=layers)
    model.build((16, npix, 1))
    model.summary()

    model.compile(
        optimizer=1e-3,
        loss="sparse_categorical_crossentropy_from_logits",
        metrics=["accuracy"],
    )
    history = model.fit(
        x_train, y_train, batch_size=16, epochs=EPOCHS,
        validation_data=(x_test, y_test),
    )
    print(f"final val accuracy: {history['val_accuracy'][-1]:.3f}")


if __name__ == "__main__":
    from deepsphere_tpu.utils import enable_compile_cache

    enable_compile_cache()
    main()
