"""Spherical auto-encoder: learnable down/up-sampling through the NEST
hierarchy.

Re-creation of ``/root/reference/examples/generative_models.ipynb``: an
encoder HealpyGCNN (pseudo-convs down to a bottleneck nside) and a decoder
(transpose pseudo-convs back up), trained to reconstruct masked maps with an
MAE loss.

Run:  python examples/autoencoder.py  [NSIDE=16 EPOCHS=10]
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax

import deepsphere_tpu as ds
from deepsphere_tpu.nn import healpy_layers as hp_nn
from deepsphere_tpu.sphere import healpix as hp

NSIDE = int(os.environ.get("NSIDE", 16))
BOTTLENECK_NSIDE = NSIDE // 4
EPOCHS = int(os.environ.get("EPOCHS", 10))


def make_maps(nside, n_maps, seed=0):
    """Smooth random maps (superposition of wide bumps)."""
    rng = np.random.RandomState(seed)
    npix = hp.nside2npix(nside)
    vec = hp.pix2vec(nside, np.arange(npix), nest=True)
    x = np.zeros((n_maps, npix, 1), np.float32)
    for i in range(n_maps):
        centers = vec[rng.randint(npix, size=8)]
        amps = rng.normal(size=8)
        bump = (np.exp(-((1.0 - vec @ centers.T) / 0.3**2)) * amps).sum(axis=1)
        x[i, :, 0] = (bump - bump.mean()) / (bump.std() + 1e-8)
    return x


class AutoEncoder:
    """Encoder + decoder pair of HealpyGCNNs (generative_models.ipynb cell 8)."""

    def __init__(self, nside, bottleneck_nside):
        npix = hp.nside2npix(nside)
        steps = int(np.log2(nside // bottleneck_nside))
        enc_layers = []
        for i in range(steps):
            enc_layers += [
                hp_nn.HealpyChebyshev(K=5, Fout=8 * 2**i, activation="relu"),
                hp_nn.HealpyPseudoConv(p=1, Fout=8 * 2**i),
            ]
        self.encoder = ds.HealpyGCNN(
            nside=nside, indices=np.arange(npix), layers=enc_layers
        )
        dec_layers = []
        for i in reversed(range(steps)):
            dec_layers += [
                hp_nn.HealpyPseudoConv_Transpose(p=1, Fout=8 * 2**i),
                hp_nn.HealpyChebyshev(K=5, Fout=8 * 2**i, activation="relu"),
            ]
        dec_layers.append(hp_nn.HealpyChebyshev(K=5, Fout=1))
        self.decoder = ds.HealpyGCNN(
            nside=bottleneck_nside,
            indices=np.arange(hp.nside2npix(bottleneck_nside)),
            layers=dec_layers,
        )

    def init(self, rng, x):
        ve = self.encoder.init(rng, x)
        z = self.encoder.module.apply(ve, x, training=False)
        vd = self.decoder.init(rng, z)
        # split trainables from the static graph arrays
        params = {"enc": ve["params"], "dec": vd["params"]}
        static = {
            "enc": {k: v for k, v in ve.items() if k != "params"},
            "dec": {k: v for k, v in vd.items() if k != "params"},
        }
        return params, static

    def apply(self, params, static, x, training=False):
        z = self.encoder.module.apply(
            {**static["enc"], "params": params["enc"]}, x, training=training
        )
        return self.decoder.module.apply(
            {**static["dec"], "params": params["dec"]}, z, training=training
        )


def main():
    npix = hp.nside2npix(NSIDE)
    x_train = make_maps(NSIDE, 120, seed=0)
    x_test = make_maps(NSIDE, 24, seed=1)

    ae = AutoEncoder(NSIDE, BOTTLENECK_NSIDE)
    batch = 8
    params, static = ae.init(0, jnp.zeros((batch, npix, 1), jnp.float32))

    tx = optax.adam(1e-3)
    opt_state = tx.init(params)

    @jax.jit
    def train_step(params, static, opt_state, xb):
        def loss_of(p):
            rec = ae.apply(p, static, xb, training=False)
            return jnp.mean(jnp.abs(rec - xb))

        loss, grads = jax.value_and_grad(loss_of)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    @jax.jit
    def eval_mae(params, static, xb):
        return jnp.mean(jnp.abs(ae.apply(params, static, xb) - xb))

    n = x_train.shape[0]
    rng = np.random.RandomState(0)
    for epoch in range(EPOCHS):
        order = rng.permutation(n)
        losses = []
        for s in range(0, n - batch + 1, batch):
            sel = order[s : s + batch]
            params, opt_state, loss = train_step(
                params, static, opt_state, jnp.asarray(x_train[sel])
            )
            losses.append(float(loss))
        val = float(eval_mae(params, static, jnp.asarray(x_test)))
        print(f"epoch {epoch + 1}/{EPOCHS}: train_mae={np.mean(losses):.4f} "
              f"val_mae={val:.4f}")


if __name__ == "__main__":
    from deepsphere_tpu.utils import enable_compile_cache

    enable_compile_cache()
    main()
