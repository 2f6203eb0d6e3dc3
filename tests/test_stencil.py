"""Face layout + stencil graph conv: parity against the ELLPACK gather path.

The stencil path is the structured fast path; its ground truth is the gather path,
whose own ground truth is scipy (tests/test_ops.py) — matching the reference
test strategy of layering golden checks (SURVEY.md §4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepsphere_tpu.graph import build_sphere_graph
from deepsphere_tpu.ops import spmv
from deepsphere_tpu.ops.stencil import (
    stencil_basis_stack,
    stencil_graph_conv,
    stencil_matvec,
    stencil_tables,
)
from deepsphere_tpu.sphere import faces, healpix as hp


# ---------------------------------------------------------------------------
# face layout
# ---------------------------------------------------------------------------

def test_nest2face_roundtrip(rng):
    nside = 8
    m = rng.rand(3, hp.nside2npix(nside))
    f = faces.nest2face(m, nside, axis=1)
    assert f.shape == (3, 12, nside, nside)
    back = faces.face2nest(f, nside, axis=1)
    assert np.array_equal(back, m)


def test_halo_map_interior_matches_neighbors():
    nside = 8
    h = 2
    hm = faces.halo_map(nside, h)
    assert hm.shape == (12, nside + 2 * h, nside + 2 * h)
    # interior equals the plain face index map
    assert np.array_equal(
        hm[:, h : h + nside, h : h + nside], faces.nest2face_index(nside)
    )
    # direction-exact: map neighbor == neighbors_nest for interior positions
    nb = hp.neighbors_nest(nside, np.arange(hp.nside2npix(nside)))
    n2f = faces.nest2face_index(nside).reshape(-1)
    for d, (dx, dy) in enumerate(zip(hp._NB_XOFFSET, hp._NB_YOFFSET)):
        mapped = hm[:, h + dx : h + dx + nside, h + dy : h + dy + nside].reshape(-1)
        assert np.array_equal(mapped, nb[:, d][n2f])


def test_halo_map_rejects_deep_halo():
    with pytest.raises(ValueError):
        faces.halo_map(4, 4)


# ---------------------------------------------------------------------------
# stencil extraction + matvec
# ---------------------------------------------------------------------------

def test_stencil_matvec_matches_scipy(rng):
    nside = 8
    g = build_sphere_graph(nside, k=8, method="grid")
    st = g.face_stencil(0.75)
    assert st is not None
    L = g.rescaled(0.75)
    x = rng.normal(size=(g.n_pixels, 3)).astype(np.float32)
    y_ref = L @ x

    from deepsphere_tpu.ops.stencil import stencil_tables

    tables = {k: jnp.asarray(v) for k, v in stencil_tables(st).items()}
    xf = jnp.asarray(x)[tables["n2f"]].reshape(12, nside, nside, 3)
    yf = stencil_matvec(st, tables, xf)
    y = np.asarray(yf.reshape(-1, 3))[st.f2n]
    np.testing.assert_allclose(y, y_ref, atol=1e-5)


def test_knn_graph_extracts_wide_stencil(rng):
    """kNN graphs now ride the stencil path via the radius-2 capture
    window (tests/test_knn_stencil.py has the deep/fused coverage)."""
    g = build_sphere_graph(8, k=8, method="knn")
    st = g.face_stencil(0.75)
    assert st is not None and st.radius == 2

    from deepsphere_tpu.ops.stencil import stencil_tables

    L = g.rescaled(0.75)
    x = rng.normal(size=(g.n_pixels, 3)).astype(np.float32)
    tables = {k: jnp.asarray(v) for k, v in stencil_tables(st).items()}
    xf = jnp.asarray(x)[tables["n2f"]].reshape(12, 8, 8, 3)
    y = np.asarray(stencil_matvec(st, tables, xf).reshape(-1, 3))[st.f2n]
    np.testing.assert_allclose(y, L @ x, atol=1e-5)


def test_partial_sky_knn_stencil_exact(rng):
    """kNN masked graphs rewire boundary pixels to 2nd-ring neighbors;
    the capture window holds them, escapes get the per-row exact fix."""
    from deepsphere_tpu.ops.stencil import stencil_tables
    from deepsphere_tpu.sphere import healpix as hp

    ind = np.arange(200)
    g = build_sphere_graph(8, indices=ind, k=8, method="knn")
    st = g.face_stencil(0.75)
    assert st is not None

    npix = hp.nside2npix(8)
    x = rng.normal(size=(len(ind), 3)).astype(np.float32)
    y_ref = g.rescaled(0.75) @ x
    xfull = np.zeros((npix, 3), np.float32)
    xfull[ind] = x
    tables = {k: jnp.asarray(v) for k, v in stencil_tables(st).items()}
    xf = jnp.asarray(xfull)[tables["n2f"]].reshape(12, 8, 8, 3)
    y = np.asarray(stencil_matvec(st, tables, xf).reshape(-1, 3))
    y = y[np.asarray(st.f2n)][ind]
    np.testing.assert_allclose(y, y_ref, atol=1e-5)


def test_masked_grid_stencil_matches_ellpack(rng):
    """Masked-sky grid graphs extract an EXACT stencil (zero rows outside
    the mask): the embedded stencil matvec equals the local L~ @ x."""
    from deepsphere_tpu.ops.stencil import stencil_matvec, stencil_tables
    from deepsphere_tpu.sphere import healpix as hp
    from deepsphere_tpu.sphere.indexing import extend_indices

    nside = 8
    npix = hp.nside2npix(nside)
    vec = hp.pix2vec(nside, np.arange(npix), nest=True)
    raw = np.flatnonzero(vec @ np.array([0.0, 0.0, 1.0]) > 0.35)  # polar cap
    ind = extend_indices(raw, nside_in=nside, nside_out=nside // 2)
    g = build_sphere_graph(nside, indices=ind, k=8, method="grid")
    st = g.face_stencil(0.75)
    assert st is not None

    x = rng.normal(size=(len(ind), 3)).astype(np.float32)
    y_ref = g.rescaled(0.75) @ x

    xfull = np.zeros((npix, 3), np.float32)
    xfull[ind] = x
    tables = {k: jnp.asarray(v) for k, v in stencil_tables(st).items()}
    xf = jnp.asarray(xfull)[tables["n2f"]].reshape(12, nside, nside, 3)
    yf = stencil_matvec(st, tables, xf)
    y = np.asarray(yf.reshape(-1, 3))[np.asarray(st.f2n)][ind]
    np.testing.assert_allclose(y, y_ref, atol=1e-5)


def test_masked_conv_layer_uses_stencil_and_matches_ellpack(rng):
    """A ChebyshevConv on a masked grid graph routes through the stencil
    path (embed -> conv -> slice) and matches the ELLPACK gather path."""
    import deepsphere_tpu.nn.layers as L
    from deepsphere_tpu.sphere import healpix as hp
    from deepsphere_tpu.sphere.indexing import extend_indices

    nside = 8
    npix = hp.nside2npix(nside)
    vec = hp.pix2vec(nside, np.arange(npix), nest=True)
    raw = np.flatnonzero(vec @ np.array([1.0, 0.0, 0.0]) > 0.5)
    ind = extend_indices(raw, nside_in=nside, nside_out=nside // 2)
    g = build_sphere_graph(nside, indices=ind, k=8, method="grid")
    assert g.face_stencil(0.75, n_steps=3) is not None

    import jax

    x = jnp.asarray(rng.normal(size=(2, len(ind), 2)), jnp.float32)
    conv_st = L.ChebyshevConv(graph=g, K=4, Fout=3, conv_method="stencil")
    conv_el = L.ChebyshevConv(graph=g, K=4, Fout=3, conv_method="ellpack")
    v = conv_st.init(jax.random.key(0), x)
    v_el = conv_el.init(jax.random.key(0), x)
    v_el = {**v_el, "params": v["params"]}
    y_st = np.asarray(conv_st.apply(v, x))
    y_el = np.asarray(conv_el.apply(v_el, x))
    np.testing.assert_allclose(y_st, y_el, atol=1e-4)


@pytest.mark.parametrize(
    "kind,scale,n_terms",
    [("cheby", 0.75, 5), ("mono", 1.0, 4), ("bern", 0.75, 4)],
)
def test_stencil_basis_matches_ellpack(rng, kind, scale, n_terms):
    nside = 8
    g = build_sphere_graph(nside, k=8, method="grid")
    st = g.face_stencil(scale)
    idx, val = g.ellpack(scale)
    x2d = jnp.asarray(rng.normal(size=(g.n_pixels, 6)), jnp.float32)
    basis = {
        "cheby": spmv.chebyshev_basis,
        "mono": spmv.monomial_basis,
        "bern": spmv.bernstein_basis,
    }[kind]
    ref = basis(jnp.asarray(idx), jnp.asarray(val), x2d, n_terms)
    got = stencil_basis_stack(st, kind, x2d, n_terms)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize(
    "kind,scale,n_terms",
    [("cheby", 0.75, 5), ("mono", 1.0, 3), ("bern", 0.75, 4)],
)
def test_stencil_conv_matches_ellpack_conv(rng, kind, scale, n_terms):
    nside = 4
    g = build_sphere_graph(nside, k=8, method="grid")
    st = g.face_stencil(scale)
    B, Fin, Fout = 3, 2, 5
    x = jnp.asarray(rng.normal(size=(B, g.n_pixels, Fin)), jnp.float32)
    kern = jnp.asarray(rng.normal(size=(Fin * n_terms, Fout)), jnp.float32)
    idx, val = jnp.asarray(g.ellpack(scale)[0]), jnp.asarray(g.ellpack(scale)[1])
    basis = {
        "cheby": spmv.chebyshev_basis,
        "mono": spmv.monomial_basis,
        "bern": spmv.bernstein_basis,
    }[kind]
    y_ref = spmv.graph_conv(lambda x2d, nt: basis(idx, val, x2d, nt), x, kern, n_terms)
    y = stencil_graph_conv(st, x, kern, n_terms, kind)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref), atol=1e-4)


def test_stencil_conv_gradients_match(rng):
    """Autodiff through the stencil path agrees with the gather path."""
    nside = 4
    g = build_sphere_graph(nside, k=8, method="grid")
    st = g.face_stencil(0.75)
    idx, val = g.ellpack(0.75)
    idx, val = jnp.asarray(idx), jnp.asarray(val)
    B, Fin, Fout, K = 2, 2, 3, 4
    x = jnp.asarray(rng.normal(size=(B, g.n_pixels, Fin)), jnp.float32)
    kern = jnp.asarray(rng.normal(size=(Fin * K, Fout)), jnp.float32)

    def loss_st(x, kern):
        return jnp.sum(stencil_graph_conv(st, x, kern, K, "cheby") ** 2)

    def loss_el(x, kern):
        return jnp.sum(
            spmv.graph_conv(
                lambda x2d, nt: spmv.chebyshev_basis(idx, val, x2d, nt), x, kern, K
            )
            ** 2
        )

    gx_st, gk_st = jax.grad(loss_st, argnums=(0, 1))(x, kern)
    gx_el, gk_el = jax.grad(loss_el, argnums=(0, 1))(x, kern)
    np.testing.assert_allclose(np.asarray(gx_st), np.asarray(gx_el), rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(gk_st), np.asarray(gk_el), rtol=2e-3, atol=1e-3)


def test_conv_layer_uses_stencil_path(rng):
    """ChebyshevConv auto-selects the stencil path on grid graphs and the
    result matches conv_method='ellpack'."""
    from deepsphere_tpu.nn.layers import ChebyshevConv

    nside = 4
    g = build_sphere_graph(nside, k=8, method="grid")
    x = jnp.asarray(rng.normal(size=(2, g.n_pixels, 3)), jnp.float32)
    layer_a = ChebyshevConv(graph=g, K=4, Fout=5, conv_method="auto")
    layer_e = ChebyshevConv(graph=g, K=4, Fout=5, conv_method="ellpack")
    va = layer_a.init(jax.random.key(0), x)
    ve = layer_e.init(jax.random.key(0), x)
    assert "stencil" in va["graph_tables"]  # auto picked the stencil path
    assert "ellpack" in ve["graph_tables"]
    ve = {**ve, "params": va["params"]}  # same weights through both paths
    ya = layer_a.apply(va, x)
    ye = layer_e.apply(ve, x)
    np.testing.assert_allclose(np.asarray(ya), np.asarray(ye), atol=1e-4)
    assert g.face_stencil(0.75) is not None


def test_conv_layer_stencil_method_works_on_knn():
    """conv_method='stencil' on a kNN graph no longer raises — the capture
    window extracts an exact wide stencil (parity in test_knn_stencil.py)."""
    from deepsphere_tpu.nn.layers import ChebyshevConv

    g = build_sphere_graph(8, k=8, method="knn")
    x = jnp.zeros((1, g.n_pixels, 2), jnp.float32)
    layer = ChebyshevConv(graph=g, K=3, Fout=2, conv_method="stencil")
    vs = layer.init(jax.random.key(0), x)
    assert "stencil" in vs["graph_tables"]


# ---------------------------------------------------------------------------
# face-layout internal mode
# ---------------------------------------------------------------------------

def test_layout_roundtrip(rng):
    from deepsphere_tpu.ops.layout import face_to_nest, nest_to_face
    from deepsphere_tpu.sphere.faces import nest2face_index

    nside = 8
    M = 12 * nside * nside
    x = jnp.asarray(rng.normal(size=(3, M, 2)), jnp.float32)
    f = nest_to_face(x)
    # must equal the index-based permutation
    idx = nest2face_index(nside).reshape(-1)
    np.testing.assert_array_equal(np.asarray(f), np.asarray(x)[:, idx, :])
    np.testing.assert_array_equal(np.asarray(face_to_nest(f)), np.asarray(x))


@pytest.mark.parametrize("mode", ["pool_max", "pool_avg", "pseudo", "pseudo_t"])
def test_face_layer_parity(rng, mode):
    """Face-layout pool/pseudo-conv layers with the SAME params equal their
    NEST versions exactly (taps are reordered internally)."""
    from deepsphere_tpu.nn.layers import (
        HealpyPool,
        HealpyPseudoConv,
        HealpyPseudoConv_Transpose,
    )
    from deepsphere_tpu.ops.layout import face_to_nest, nest_to_face

    nside, p = 8, 2
    M = 12 * nside * nside
    x = jnp.asarray(rng.normal(size=(2, M, 3)), jnp.float32)
    if mode == "pool_max":
        mk = lambda lo: HealpyPool(p=p, pool_type="MAX", layout=lo)
    elif mode == "pool_avg":
        mk = lambda lo: HealpyPool(p=p, pool_type="AVG", layout=lo)
    elif mode == "pseudo":
        mk = lambda lo: HealpyPseudoConv(p=p, Fout=5, layout=lo)
    else:
        mk = lambda lo: HealpyPseudoConv_Transpose(p=p, Fout=5, layout=lo)

    nest_layer, face_layer = mk("nest"), mk("face")
    v = nest_layer.init(jax.random.key(0), x)
    y_nest = nest_layer.apply(v, x)
    y_face = face_layer.apply(v, nest_to_face(x))
    np.testing.assert_allclose(
        np.asarray(face_to_nest(y_face)), np.asarray(y_nest), atol=1e-5
    )


def test_model_face_mode_matches_nest_mode(rng):
    """internal_layout='auto' (face hot path) == internal_layout='nest'."""
    import deepsphere_tpu as ds
    from deepsphere_tpu.nn import healpy_layers as hp_nn

    nside = 8
    npix = 12 * nside * nside
    layers = lambda: [
        hp_nn.HealpyChebyshev(K=4, Fout=6, activation="relu", use_bn=True),
        hp_nn.HealpyPool(p=1),
        hp_nn.Healpy_ResidualLayer("CHEBY", {"K": 3}, activation="relu"),
        hp_nn.HealpyPseudoConv(p=1, Fout=8),
        hp_nn.HealpyPseudoConv_Transpose(p=1, Fout=4),
        hp_nn.HealpyMonomial(K=3, Fout=4, activation="elu"),
        hp_nn.Flatten(),
        hp_nn.Dense(3),
    ]
    m_auto = ds.HealpyGCNN(nside=nside, indices=np.arange(npix), layers=layers())
    m_nest = ds.HealpyGCNN(nside=nside, indices=np.arange(npix),
                           layers=layers(), internal_layout="nest")
    # face mode engaged: module has more layers than the user list
    assert len(m_auto.module.layers) > len(m_auto.layers_use)
    assert len(m_nest.module.layers) == len(m_nest.layers_use)

    x = jnp.asarray(rng.normal(size=(2, npix, 1)), jnp.float32)
    va = m_auto.init(0, x)
    vn = m_nest.init(0, x)
    # same param tree up to the module-index renaming
    ya = m_auto.apply(va, x)
    # rename params from auto-module indices to nest-module indices
    pa = {f"layers_{i}": va["params"][m_auto.param_key(i)]
          for i in range(len(m_auto.layers_use)) if m_auto.param_key(i) in va["params"]}
    vn2 = dict(vn)
    vn2["params"] = {**vn["params"], **pa}
    yn = m_nest.apply(vn2, x)
    np.testing.assert_allclose(np.asarray(ya), np.asarray(yn), atol=2e-4)


def test_face_mode_checkpoint_roundtrip(tmp_path, rng):
    """save/load across a fresh model instance in face mode."""
    import deepsphere_tpu as ds
    from deepsphere_tpu.nn import healpy_layers as hp_nn

    nside = 8
    npix = 12 * nside * nside

    def mk():
        return ds.HealpyGCNN(nside=nside, indices=np.arange(npix), layers=[
            hp_nn.HealpyChebyshev(K=3, Fout=4, activation="relu"),
            hp_nn.HealpyPool(p=1),
            hp_nn.Flatten(),
            hp_nn.Dense(2),
        ])

    x = rng.normal(size=(4, npix, 1)).astype(np.float32)
    m1 = mk(); m1.build((4, npix, 1), rng=0)
    m2 = mk(); m2.build((4, npix, 1), rng=7)
    path = str(tmp_path / "w.npz")
    m1.save_weights(path)
    m2.load_weights(path)
    np.testing.assert_allclose(
        np.asarray(m1(jnp.asarray(x))), np.asarray(m2(jnp.asarray(x))), atol=1e-6
    )


@pytest.mark.parametrize("nside,K,C", [(8, 2, 3), (8, 5, 3), (16, 2, 1),
                                       (16, 5, 8), (32, 3, 4)])
def test_edge_strips_match_gather_tables(rng, nside, K, C):
    """Structured edge copies == the halo_map gather strips (all regions)
    at the halo depth h = K - 1 of a K-term conv."""
    from deepsphere_tpu.ops.stencil import edge_strips

    n, h = nside, K - 1
    npix = 12 * n * n
    x2d = rng.normal(size=(npix, C)).astype(np.float32)
    x3 = jnp.asarray(x2d.T.reshape(C, 12, n, n))
    flat = x2d  # face-flat (M, C)

    g = build_sphere_graph(n, k=8, method="grid")
    st = g.face_stencil(0.75, n_steps=h)
    tables = stencil_tables(st)

    def gather(name):
        src = tables[f"{name}_src"]
        mask = tables[f"{name}_mask"]
        out = flat[src.reshape(-1)].reshape(src.shape + (C,)) * mask[..., None]
        return np.transpose(out, (3, 0, 1, 2))  # (C, 12, rows, cols)

    west, east, south, north = edge_strips(n, h, x3)
    np.testing.assert_array_equal(np.asarray(west), gather("west"))
    np.testing.assert_array_equal(np.asarray(east), gather("east"))
    np.testing.assert_array_equal(np.asarray(south), gather("south"))
    np.testing.assert_array_equal(np.asarray(north), gather("north"))


class TestRingStencil:
    """k in {20, 40, 60}: ring-template ("grid") graphs extract radius-r
    stencils, so the conv path stays structured instead of falling to the
    ELLPACK gather path (the reference treats these k as first-class,
    healpy_networks.py:39-42)."""

    @pytest.mark.parametrize("k,r", [(20, 2), (40, 3)])
    def test_ring_graph_builds_and_extracts(self, k, r):
        g = build_sphere_graph(16, k=k, method="grid")
        assert g.stencil_radius == r
        st = g.face_stencil(0.75)
        assert st is not None and st.radius == r and st.n_steps == r
        # symmetric Laplacian, rows have <= k entries
        g._materialize()
        L = g.rescaled(0.75)
        assert abs(L - L.T).max() < 1e-12

    def test_ring_stencil_matvec_matches_ellpack(self, rng):
        from deepsphere_tpu.ops.stencil import stencil_matvec, stencil_tables

        nside, k = 16, 20
        g = build_sphere_graph(nside, k=k, method="grid")
        st = g.face_stencil(0.75)
        x = rng.normal(size=(g.n_pixels, 3)).astype(np.float32)
        y_ref = g.rescaled(0.75) @ x
        tables = {kk: jnp.asarray(v) for kk, v in stencil_tables(st).items()}
        xf = jnp.asarray(x)[tables["n2f"]].reshape(12, nside, nside, 3)
        yf = stencil_matvec(st, tables, xf)
        y = np.asarray(yf.reshape(-1, 3))[np.asarray(st.f2n)]
        np.testing.assert_allclose(y, y_ref, atol=1e-5)

    def test_ring_deep_stencil_conv_matches_ellpack(self, rng):
        """Fused-geometry (deep) radius-2 stencil conv vs the gather path,
        corrections active at the polar corners."""
        import jax

        import deepsphere_tpu.nn.layers as L

        nside, k, K = 16, 20, 3
        g = build_sphere_graph(nside, k=k, method="grid")
        st = g.deep_stencil(0.75, K)
        assert st is not None and st.n_steps == 4 and st.radius == 2
        assert st.corr_src.shape[0] > 0  # polar corners under r=2

        x = jnp.asarray(rng.normal(size=(2, g.n_pixels, 2)), jnp.float32)
        conv_st = L.ChebyshevConv(graph=g, K=K, Fout=3, conv_method="stencil")
        conv_el = L.ChebyshevConv(graph=g, K=K, Fout=3, conv_method="ellpack")
        v = conv_st.init(jax.random.key(0), x)
        v_el = conv_el.init(jax.random.key(0), x)
        v_el = {**v_el, "params": v["params"]}
        y_st = np.asarray(conv_st.apply(v, x))
        y_el = np.asarray(conv_el.apply(v_el, x))
        np.testing.assert_allclose(y_st, y_el, atol=1e-4)

    def test_deep_stencil_halo_is_radius_times_steps(self):
        """deep_stencil builds exactly the halo a K-term conv consumes,
        h = radius * (K - 1), and the cface plan accepts a stencil whose
        halo covers the conv — never one that falls short."""
        from deepsphere_tpu.ops.stencil import cfp_structural_available

        g3 = build_sphere_graph(32, k=40, method="grid")
        st3 = g3.deep_stencil(0.75, 5)
        assert st3 is not None and st3.radius == 3 and st3.n_steps == 12
        g2 = build_sphere_graph(32, k=20, method="grid")
        st2 = g2.deep_stencil(0.75, 5)
        assert st2 is not None and st2.radius == 2 and st2.n_steps == 8
        g1 = build_sphere_graph(32, k=8, method="grid")
        st10 = g1.deep_stencil(0.75, 10)
        assert st10 is not None and st10.n_steps == 9
        st9 = g1.deep_stencil(0.75, 9)
        assert st9 is not None and st9.n_steps == 8

        assert cfp_structural_available(st3, "cheby", 5)
        assert cfp_structural_available(st10, "cheby", 10)
        # a deeper stencil serves SHALLOWER convs of the same radius ...
        assert cfp_structural_available(st10, "cheby", 5)
        # ... but never a conv needing MORE halo than it has
        assert not cfp_structural_available(st9, "cheby", 10)
        assert not cfp_structural_available(st10, "bern", 5)
        # a halo as deep as the face itself has no stencil
        assert build_sphere_graph(8, k=8, method="grid").deep_stencil(
            0.75, 10) is None
