"""Serving export: self-contained StableHLO inference artifacts.

The reference's deployment unit is HDF5 weights + re-assembling the model
in Python (reference ``healpy_networks.py:169-189``,
``tests/test_healpy_networks.py:133-152``); the replacement here is
``jax.export`` artifacts with weights and graph tables baked in
(``deepsphere_tpu/serve/export.py``).  These tests pin:

* roundtrip equality vs the live model (serialize -> deserialize -> call),
* polymorphic-batch artifacts serving multiple batch sizes,
* cross-platform lowering metadata,
* the build-first error contract.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import deepsphere_tpu as ds
from deepsphere_tpu import serve
from deepsphere_tpu.nn import healpy_layers as hp_nn


@pytest.fixture(scope="module")
def tiny_model():
    nside = 8
    npix = ds.sphere.healpix.nside2npix(nside)
    model = ds.HealpyGCNN(
        nside=nside,
        indices=np.arange(npix),
        layers=[
            hp_nn.HealpyChebyshev(K=5, Fout=8, activation="relu", use_bn=True),
            hp_nn.HealpyPool(p=1),
            hp_nn.Flatten(),
            hp_nn.Dense(2, activation="softmax"),
        ],
    )
    model.build((16, npix, 1))
    x = np.random.RandomState(0).normal(size=(5, npix, 1)).astype(np.float32)
    y = np.asarray(model(jnp.asarray(x)))
    return model, x, y


def test_roundtrip_polymorphic_batch(tiny_model, tmp_path):
    model, x, y = tiny_model
    path = tmp_path / "model.dsx"
    nbytes = model.save_exported(path, batch_size=None)
    assert nbytes > 0 and path.stat().st_size == nbytes

    em = serve.load_exported(path)
    # symbolic leading axis
    assert str(em.input_shape[0]) == "b"
    assert em.input_shape[1:] == (x.shape[1], 1)

    np.testing.assert_allclose(np.asarray(em(x)), y, atol=1e-5)
    # same artifact, different batch size
    np.testing.assert_allclose(np.asarray(em(x[:3])), y[:3], atol=1e-5)
    # chunked predict
    yp = em.predict(np.tile(x, (2, 1, 1)), batch_size=4)
    np.testing.assert_allclose(yp, np.tile(y, (2, 1)), atol=1e-5)


def test_fixed_batch_artifact(tiny_model, tmp_path):
    model, x, y = tiny_model
    path = tmp_path / "model5.dsx"
    model.save_exported(path, batch_size=5)
    em = serve.load_exported(path)
    assert em.input_shape == (5, x.shape[1], 1)
    np.testing.assert_allclose(np.asarray(em(x)), y, atol=1e-5)


def test_cross_platform_lowering(tiny_model, tmp_path):
    model, x, y = tiny_model
    exported = model.export_inference(batch_size=None, platforms=["cpu", "cuda"])
    assert set(exported.platforms) == {"cpu", "cuda"}
    path = tmp_path / "model_xp.dsx"
    serve.write_exported(path, exported)
    em = serve.load_exported(path)
    assert set(em.platforms) == {"cpu", "cuda"}
    np.testing.assert_allclose(np.asarray(em(x)), y, atol=1e-5)


def test_artifact_is_framework_free(tiny_model, tmp_path):
    """The blob must replay without graph_tables/precompute: the file holds
    only StableHLO bytecode and a JSON header, and what it rebuilds is a
    plain jax.export.Exported (no deepsphere_tpu objects) that jax runs."""
    import zipfile

    from jax import export as jexport

    model, x, y = tiny_model
    path = tmp_path / "model.dsx"
    model.save_exported(path, batch_size=None)
    with zipfile.ZipFile(path) as z:
        assert sorted(z.namelist()) == ["exported.json", "module.mlirbc"]
    raw = serve.read_exported(path)
    assert type(raw) is jexport.Exported
    out = raw.call(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(out), y, atol=1e-5)


def test_export_requires_build():
    nside = 8
    npix = ds.sphere.healpix.nside2npix(nside)
    model = ds.HealpyGCNN(
        nside=nside, indices=np.arange(npix),
        layers=[hp_nn.Flatten(), hp_nn.Dense(2)],
    )
    with pytest.raises(ValueError, match="build"):
        model.export_inference()
