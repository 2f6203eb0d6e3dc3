"""The main path needs only jax, numpy, scipy, optax, chex and einops:
the quick-start drive runs with flax, orbax, msgpack, scikit-learn,
matplotlib, flatbuffers and Pallas made unimportable."""

import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_DRIVE = r"""
import sys
for name in ("flax", "orbax", "orbax.checkpoint", "msgpack", "sklearn",
             "matplotlib", "flatbuffers", "jax.experimental.pallas"):
    sys.modules[name] = None
import numpy as np, tempfile, os
import deepsphere_tpu as ds
from deepsphere_tpu import serve
from deepsphere_tpu.nn import healpy_layers as hp_nn
nside = 8; npix = ds.sphere.healpix.nside2npix(nside)
rng = np.random.RandomState(3); n = 96
labels = rng.randint(0, 2, size=n)
x = rng.normal(size=(n, npix, 1)).astype(np.float32)
v = ds.sphere.healpix.pix2vec(nside, np.arange(npix), nest=True)
x[labels == 1, :, 0] += 0.7 * np.exp(-((v - np.array([0, 0, 1.])) ** 2).sum(1))
model = ds.HealpyGCNN(nside=nside, indices=np.arange(npix), layers=[
    hp_nn.HealpyChebyshev(K=5, Fout=8, activation="relu", use_bn=True),
    hp_nn.HealpyPool(p=1), hp_nn.Flatten(),
    hp_nn.Dense(2, activation="softmax")])
model.build((16, npix, 1))
model.compile(optimizer=1e-3, loss="sparse_categorical_crossentropy",
              metrics=["accuracy"])
h = model.fit(x[:80], labels[:80], batch_size=16, epochs=10,
              validation_data=(x[80:], labels[80:]), verbose=0)
assert h["loss"][-1] < h["loss"][0] and h["val_accuracy"][-1] >= 0.8, h
with tempfile.TemporaryDirectory() as tmp:
    model.save_weights(os.path.join(tmp, "w.npz"))
    model.load_weights(os.path.join(tmp, "w.npz"))
    model.save_exported(os.path.join(tmp, "m.dsx"))
    serve.load_exported(os.path.join(tmp, "m.dsx"))(x[:4])
    from deepsphere_tpu.train import restore_checkpoint, save_checkpoint
    save_checkpoint(os.path.join(tmp, "ck"), model._trainer.state)
    restore_checkpoint(os.path.join(tmp, "ck"), model._trainer.state)
op = hp_nn.SmoothingOperator(nside=nside, indices=np.arange(npix),
                             sigma=300.0, method="ellpack")
banned = ("flax", "orbax", "msgpack", "sklearn", "matplotlib", "flatbuffers")
loaded = [m for m in sys.modules if m.split(".")[0] in banned
          and sys.modules[m] is not None]
assert not loaded, loaded
print("OK", h["val_accuracy"][-1])
"""


def test_main_path_runs_without_optional_packages():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=_REPO)
    proc = subprocess.run([sys.executable, "-c", _DRIVE], cwd=_REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1].startswith("OK")
