"""Checkpoints as ``.npz`` files keyed by variable path: the tree format,
the model weights and the train-state step directories."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepsphere_tpu.train.checkpoint import (load_tree, restore_checkpoint,
                                             save_checkpoint, save_tree)


def test_tree_roundtrip_keeps_path_and_structure(tmp_path, rng):
    tree = {"params": {"a": {"kernel": rng.normal(size=(3, 2))},
                       "b": np.arange(4, dtype=np.int32)},
            "batch_stats": {"a": {"mean": np.zeros(2, np.float32)}}}
    path = str(tmp_path / "w.weights")  # any name: written exactly there
    save_tree(path, tree)
    assert os.listdir(tmp_path) == ["w.weights"]
    with np.load(path) as z:
        assert sorted(z.files) == ["batch_stats/a/mean", "params/a/kernel",
                                   "params/b"]
    back = load_tree(path, tree)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    free = load_tree(path)
    np.testing.assert_array_equal(free["params"]["b"], tree["params"]["b"])

    with pytest.raises(ValueError, match="shape"):
        load_tree(path, {**tree, "params": {**tree["params"],
                                            "b": np.zeros(5)}})
    with pytest.raises(ValueError, match="missing"):
        load_tree(path, {**tree, "extra": {"x": np.zeros(1)}})


def test_train_checkpoint_steps_keep_and_restore(tmp_path):
    import optax

    from deepsphere_tpu.train import TrainState

    params = {"w": jnp.arange(6.0).reshape(2, 3)}
    tx = optax.adam(1e-3)
    path = str(tmp_path / "ckpt")
    for step in range(1, 5):
        state = TrainState(params=jax.tree_util.tree_map(lambda p: p * step,
                                                         params),
                           batch_stats={}, opt_state=tx.init(params),
                           step=step)
        save_checkpoint(path, state, keep=2)
    assert sorted(os.listdir(path)) == ["3", "4"]

    target = TrainState(params=params, batch_stats={},
                        opt_state=tx.init(params), step=0)
    got = restore_checkpoint(path, target)
    assert got["step"] == 4 and isinstance(got["step"], int)
    np.testing.assert_array_equal(np.asarray(got["params"]["w"]),
                                  4 * np.arange(6.0).reshape(2, 3))
    assert jax.tree_util.tree_structure(got["opt_state"]) == \
        jax.tree_util.tree_structure(target.opt_state)
    older = restore_checkpoint(path, target, step=3)
    np.testing.assert_array_equal(np.asarray(older["params"]["w"]),
                                  3 * np.arange(6.0).reshape(2, 3))
    free = restore_checkpoint(path)
    np.testing.assert_array_equal(free["params"]["w"],
                                  4 * np.arange(6.0).reshape(2, 3))
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "nothing"))


def test_model_weights_npz_roundtrip(tmp_path, rng):
    """save_weights writes one .npz without graph tables; load_weights
    restores it into a model built with another seed."""
    import deepsphere_tpu as ds
    from deepsphere_tpu.nn import healpy_layers as hp_nn

    npix = 12 * 4 * 4

    def make():
        return ds.HealpyGCNN(nside=4, indices=np.arange(npix), layers=[
            hp_nn.HealpyChebyshev(K=3, Fout=2, use_bn=True),
            hp_nn.Flatten(), hp_nn.Dense(2)])

    m1, m2 = make(), make()
    m1.build((2, npix, 1), rng=0)
    m2.build((2, npix, 1), rng=5)
    path = str(tmp_path / "weights.npz")
    m1.save_weights(path)
    with np.load(path) as z:
        assert all(not f.startswith("graph_tables") for f in z.files)
        assert "batch_stats/layers_layer_0/bn/mean" in z.files
    m2.load_weights(path)
    x = jnp.asarray(rng.normal(size=(2, npix, 1)), jnp.float32)
    np.testing.assert_array_equal(np.asarray(m1(x)), np.asarray(m2(x)))
