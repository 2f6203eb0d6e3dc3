"""The in-repo module system (``deepsphere_tpu.nn.core``): Dense, LayerNorm,
BatchNorm and remat against closed-form numpy, and the variable-tree
contract (collections, names, mutability) the layers and checkpoints rely
on."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepsphere_tpu.nn import core


class _Stack(core.Module):
    """Dense -> BatchNorm -> LayerNorm, optionally under remat."""

    remat: bool = False

    @core.compact
    def __call__(self, x, training=False):
        def block(mdl, x):
            return mdl(x, training=training)

        inner = _Block(name="block")
        if self.remat:
            return core.remat(block)(inner, x)
        return block(inner, x)


class _Block(core.Module):
    @core.compact
    def __call__(self, x, training=False):
        y = core.Dense(3, name="dense")(x)
        y = core.BatchNorm(use_running_average=not training, momentum=0.9,
                           name="bn")(y)
        return jnp.tanh(core.LayerNorm(name="ln")(y))


def test_dense_matches_numpy(rng):
    x = rng.normal(size=(4, 5)).astype(np.float32)
    layer = core.Dense(3)
    v = layer.init(0, jnp.asarray(x))
    assert set(v) == {"params"}
    assert v["params"]["kernel"].shape == (5, 3)
    assert v["params"]["bias"].shape == (3,)
    w = rng.normal(size=(5, 3)).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    y = layer.apply({"params": {"kernel": w, "bias": b}}, jnp.asarray(x))
    want = x.astype(np.float64) @ w + b
    np.testing.assert_allclose(np.asarray(y), want, rtol=1e-6, atol=1e-6)
    nobias = core.Dense(3, use_bias=False)
    assert set(nobias.init(0, jnp.asarray(x))["params"]) == {"kernel"}


@pytest.mark.parametrize("axes", [-1, 1])
def test_layernorm_matches_numpy(rng, axes):
    x = rng.normal(loc=2.0, size=(2, 3, 4)).astype(np.float32)
    layer = core.LayerNorm(epsilon=1e-3, reduction_axes=axes,
                           feature_axes=axes)
    v = layer.init(0, jnp.asarray(x))
    F = x.shape[axes]
    assert v["params"]["scale"].shape == (F,)
    scale = rng.normal(size=(F,)).astype(np.float32)
    bias = rng.normal(size=(F,)).astype(np.float32)
    y = layer.apply({"params": {"scale": scale, "bias": bias}},
                    jnp.asarray(x))
    xd = x.astype(np.float64)
    mean = xd.mean(axis=axes, keepdims=True)
    var = xd.var(axis=axes, keepdims=True)
    shape = [1, 1, 1]
    shape[axes] = F
    want = ((xd - mean) / np.sqrt(var + 1e-3) * scale.reshape(shape)
            + bias.reshape(shape))
    np.testing.assert_allclose(np.asarray(y), want, rtol=1e-5, atol=1e-5)


def test_batchnorm_stats_and_running_average(rng):
    x = rng.normal(loc=1.0, scale=2.0, size=(6, 5, 3)).astype(np.float32)
    layer = core.BatchNorm(momentum=0.9, epsilon=1e-5)
    v = layer.init(0, jnp.asarray(x))
    # init does not update the running statistics
    np.testing.assert_array_equal(np.asarray(v["batch_stats"]["mean"]), 0.0)
    np.testing.assert_array_equal(np.asarray(v["batch_stats"]["var"]), 1.0)

    y, upd = layer.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    xd = x.astype(np.float64)
    mean, var = xd.mean(axis=(0, 1)), xd.var(axis=(0, 1))
    np.testing.assert_allclose(np.asarray(y), (xd - mean) / np.sqrt(var + 1e-5),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(upd["batch_stats"]["mean"]),
                               0.1 * mean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(upd["batch_stats"]["var"]),
                               0.9 + 0.1 * var, rtol=1e-5, atol=1e-6)

    infer = core.BatchNorm(use_running_average=True, epsilon=1e-5)
    y_inf = infer.apply({**v, "batch_stats": upd["batch_stats"]},
                        jnp.asarray(x))
    rm, rv = 0.1 * mean, 0.9 + 0.1 * var
    np.testing.assert_allclose(np.asarray(y_inf), (xd - rm) / np.sqrt(rv + 1e-5),
                               rtol=1e-4, atol=1e-5)
    # batch statistics outside a mutable collection are an error
    with pytest.raises(ValueError, match="mutable"):
        layer.apply(v, jnp.asarray(x))


def test_remat_matches_plain(rng):
    """remat recomputes instead of storing: same outputs, gradients and
    batch-stat updates as the plain stack, same variable tree."""
    x = jnp.asarray(rng.normal(size=(4, 5)), jnp.float32)
    plain, rem = _Stack(), _Stack(remat=True)
    v = plain.init(0, x)
    assert jax.tree_util.tree_structure(rem.init(0, x)) == \
        jax.tree_util.tree_structure(v)
    assert set(v["params"]["block"]) == {"dense", "bn", "ln"}

    def loss(model, params):
        y, upd = model.apply({**v, "params": params}, x, training=True,
                             mutable=["batch_stats"])
        return jnp.sum(y ** 2), upd

    (l1, u1), g1 = jax.value_and_grad(lambda p: loss(plain, p),
                                      has_aux=True)(v["params"])
    (l2, u2), g2 = jax.jit(jax.value_and_grad(lambda p: loss(rem, p),
                                              has_aux=True))(v["params"])
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves((g1, u1)),
                    jax.tree_util.tree_leaves((g2, u2))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)


def test_missing_param_and_unbound_module_raise(rng):
    x = jnp.asarray(rng.normal(size=(2, 5)), jnp.float32)
    with pytest.raises(KeyError, match="kernel"):
        core.Dense(3).apply({"params": {}}, x)
    with pytest.raises(RuntimeError, match="init/apply"):
        core.Dense(3)(x)


def test_model_variable_tree_names():
    """Checkpoint trees name user layers ``layers_layer_<i>`` whatever the
    internal layout plan, with the conv's kernel and BN state under it."""
    import deepsphere_tpu as ds
    from deepsphere_tpu.nn import healpy_layers as hp_nn

    npix = 12 * 8 * 8
    model = ds.HealpyGCNN(nside=8, indices=np.arange(npix), layers=[
        hp_nn.HealpyChebyshev(K=3, Fout=4, use_bn=True, activation="relu"),
        hp_nn.HealpyPool(p=1),
        hp_nn.Flatten(),
        hp_nn.Dense(2),
    ])
    v = model.build((2, npix, 1))
    assert len(model.module.layers) > len(model.layers_use)  # converters
    assert set(v["params"]) == {"layers_layer_0", "layers_layer_3"}
    assert set(v["params"]["layers_layer_0"]) == {"kernel"}
    assert set(v["batch_stats"]["layers_layer_0"]["bn"]) == {"mean", "var"}
    assert set(v["params"]["layers_layer_3"]["dense"]) == {"kernel", "bias"}
    assert "stencil" in v["graph_tables"]["layers_layer_0"]
