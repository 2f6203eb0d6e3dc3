"""Sphere-graph construction tests: kNN adjacency, normalized Laplacian
spectrum, ELLPACK round-trip, caching."""

import numpy as np
import pytest
from scipy import sparse

from deepsphere_tpu.graph import (
    build_sphere_graph,
    graph_from_laplacian,
    lmax_bound,
    rescale_laplacian,
)
from deepsphere_tpu.sphere import healpix as hp


def test_full_sphere_graph_structure():
    g = build_sphere_graph(4, k=8)
    n = hp.nside2npix(4)
    assert g.n_pixels == n
    A = g.A
    # symmetric, zero diagonal, positive weights
    assert (A != A.T).nnz == 0
    assert np.allclose(A.diagonal(), 0.0)
    assert A.data.min() > 0
    # each node has >= 8 neighbors after symmetrization
    deg = np.diff(A.indptr)
    assert deg.min() >= 8
    # normalized Laplacian: symmetric PSD with spectrum <= 2
    L = g.L
    assert (abs(L - L.T) > 1e-10).nnz == 0
    evals = np.linalg.eigvalsh(L.toarray())
    assert evals.min() > -1e-8
    assert evals.max() <= 2.0 + 1e-8
    assert g.lmax >= evals.max()


def test_rescale_laplacian_spectrum():
    g = build_sphere_graph(2, k=8)
    # L <- (2 scale / lmax) L - I maps [0, lmax] to [-1, 2 scale - 1]
    Lr = g.rescaled(scale=0.75)
    evals = np.linalg.eigvalsh(Lr.toarray())
    assert evals.min() >= -1 - 1e-9
    assert evals.max() <= 2 * 0.75 - 1 + 1e-9


def test_ellpack_roundtrip():
    g = build_sphere_graph(2, k=8)
    idx, val = g.ellpack(scale=0.75)
    M = g.n_pixels
    dense = np.zeros((M, M))
    for i in range(M):
        for j, v in zip(idx[i], val[i]):
            dense[i, j] += v
    assert np.allclose(dense, g.rescaled(0.75).toarray(), atol=1e-6)


def test_partial_sky_graph():
    indices = np.arange(48)  # one quarter of nside=4... first 48 NEST pixels
    g = build_sphere_graph(4, indices=indices, k=8)
    assert g.n_pixels == 48
    assert g.L.shape == (48, 48)


def test_graph_cache(tmp_path):
    g1 = build_sphere_graph(2, k=8, cache_dir=str(tmp_path))
    g2 = build_sphere_graph(2, k=8, cache_dir=str(tmp_path))
    assert np.allclose(g1.L.toarray(), g2.L.toarray())
    assert g1.lmax == g2.lmax
    assert g1 == g2  # content-key equality


def test_edge_idx_sorted_row_major():
    g = build_sphere_graph(2, k=8)
    e = g.edge_idx
    order = np.lexsort((e[:, 1], e[:, 0]))
    assert np.all(order == np.arange(len(e)))
    assert e.shape[1] == 2


def test_graph_from_laplacian(rng):
    R = rng.normal(size=(5, 5))
    L = R @ R.T
    g = graph_from_laplacian(L)
    assert np.allclose(g.L.toarray(), L)
    assert g.lmax == pytest.approx(1.02 * np.abs(np.linalg.eigvalsh(L)).max(), rel=1e-4)


def test_lmax_bound_matches_dense(rng):
    R = rng.normal(size=(20, 20))
    L = sparse.csr_matrix(R @ R.T)
    lm = lmax_bound(L)
    assert lm == pytest.approx(1.02 * np.abs(np.linalg.eigvalsh(L.toarray())).max(), rel=1e-5)


def test_rescale_matches_reference_formula(rng):
    R = rng.normal(size=(6, 6))
    L = sparse.csr_matrix(R @ R.T)
    lmax, scale = 3.0, 0.75
    got = rescale_laplacian(L, lmax, scale).toarray()
    want = L.toarray() * (2 * scale / lmax) - np.eye(6)
    assert np.allclose(got, want)


def test_harmonic_width_default():
    """Default kernel_width follows the harmonic width table (re-derivation
    of the pygsp fork's tuned per-(nside, k) widths, setup.cfg:20 /
    arXiv:2012.15000 §3): width = ratio * mean neighbor distance, and the
    Laplacian spectrum aligns with the spherical-harmonic multiplets
    strictly better than with the legacy mean-distance width."""
    from deepsphere_tpu.graph.laplacian import harmonic_width_ratio

    nside = 8
    g_harm = build_sphere_graph(nside, k=8, method="grid")
    g_mean = build_sphere_graph(nside, k=8, method="grid",
                                kernel_width="mean")
    ratio = harmonic_width_ratio(8, nside)
    assert ratio == pytest.approx(0.5166)
    assert g_harm.kernel_width == pytest.approx(ratio * g_mean.kernel_width,
                                                rel=1e-12)
    # table lookup: above-table nsides reuse the largest tabulated ratio
    assert harmonic_width_ratio(8, 1024) == pytest.approx(0.5029)
    assert harmonic_width_ratio(7, 64) is None

    def multiplet_dispersion(L, lmax_fit=10):
        lam = np.linalg.eigvalsh(L.toarray())
        err, pos = 0.0, 1
        for l in range(1, lmax_fit + 1):
            grp = lam[pos : pos + 2 * l + 1]
            pos += 2 * l + 1
            err += grp.std() / grp.mean()
        return err / lmax_fit

    g_harm._materialize()
    g_mean._materialize()
    assert multiplet_dispersion(g_harm.L) < 0.6 * multiplet_dispersion(g_mean.L)


def test_harmonic_width_native_and_numpy_agree():
    """The native (C++) ratio-mode build must produce the same width as the
    numpy path (negative-kernel_width ABI convention)."""
    from deepsphere_tpu import native

    if not native.available():
        pytest.skip("native core unavailable")
    res = native.grid_laplacian(8, -0.5166)
    g = build_sphere_graph(8, k=8, method="grid")
    assert res["kernel_width"] == pytest.approx(g.kernel_width, rel=1e-12)


def _same_up_to_ties(i_a, d_a, i_b, d_b):
    """Neighbor lists agree: identical sorted distances per row, and the
    same neighbor set on every row whose last distance is not tied with a
    dropped candidate (equidistant k-th neighbors may be chosen either
    way)."""
    np.testing.assert_allclose(np.sort(d_a, 1), np.sort(d_b, 1),
                               rtol=0, atol=1e-12)
    sa, sb = np.sort(i_a, 1), np.sort(i_b, 1)
    differ = (sa != sb).any(axis=1)
    # a differing row must hold a tie: a neighbor of one list at the last
    # distance that the other list dropped
    last = np.max(d_a, axis=1)
    for r in np.flatnonzero(differ):
        only = np.setdiff1d(sa[r], sb[r])
        assert np.allclose(d_a[r][np.isin(i_a[r], only)], last[r],
                           rtol=0, atol=1e-12), r
    return differ.sum()


@pytest.mark.parametrize("nside,k", [(4, 8), (8, 20), (8, 40)])
def test_knn_neighbors_match_sklearn(nside, k):
    """The kNN graph (scipy cKDTree) selects the neighbors sklearn's
    NearestNeighbors selected, up to the choice among equidistant k-th
    neighbors, and builds the same adjacency on every untied row."""
    neighbors = pytest.importorskip("sklearn.neighbors")
    from scipy.spatial import cKDTree

    from deepsphere_tpu.graph.laplacian import _knn_adjacency

    npix = hp.nside2npix(nside)
    coords = hp.pix2vec(nside, np.arange(npix), nest=True)
    d_s, i_s = neighbors.NearestNeighbors(n_neighbors=k + 1).fit(
        coords).kneighbors(coords)
    d_c, i_c = cKDTree(coords).query(coords, k=k + 1)
    assert (i_c[:, 0] == np.arange(npix)).all()  # self first, then dropped
    n_tied = _same_up_to_ties(i_c[:, 1:], d_c[:, 1:], i_s[:, 1:], d_s[:, 1:])
    assert n_tied < 0.05 * npix

    W, width = _knn_adjacency(coords, k)
    assert width == pytest.approx(float(np.mean(d_s[:, 1:])), rel=1e-12)
    rows = np.flatnonzero(
        (np.sort(i_c[:, 1:], 1) == np.sort(i_s[:, 1:], 1)).all(axis=1))
    w = np.exp(-(d_s[:, 1:] ** 2) / (2.0 * width ** 2))
    D = sparse.csr_matrix((w.reshape(-1), (np.repeat(np.arange(npix), k),
                                           i_s[:, 1:].reshape(-1))),
                          shape=(npix, npix))
    W_ref = (D + D.T) / 2.0
    tied = np.setdiff1d(np.arange(npix), rows)
    # rows whose W entries involve a tied row's choice in either graph
    touched = np.unique(np.concatenate([tied, i_s[tied].ravel(),
                                        i_c[tied].ravel()]))
    untied = np.setdiff1d(np.arange(npix), touched)
    assert untied.size > 0.5 * npix
    diff = (W - W_ref).tocsr()[untied]
    assert abs(diff).max() < 1e-12


@pytest.mark.parametrize("nside,sigma_arcmin", [(8, 600.0), (16, 240.0)])
def test_smoothing_neighbors_match_balltree(nside, sigma_arcmin):
    """The smoothing kernel's great-circle neighbors (cKDTree on unit
    vectors) equal sklearn's haversine BallTree query: same support size,
    same angular distances, same neighbor sets up to equidistant ties."""
    neighbors = pytest.importorskip("sklearn.neighbors")
    from deepsphere_tpu.nn.smoothing import _great_circle_neighbors

    npix = hp.nside2npix(nside)
    radius = 3 * np.radians(sigma_arcmin / 60.0)
    lon, lat = hp.pix2ang(nside, np.arange(npix), nest=True, lonlat=True)
    theta = np.stack([np.radians(lat), np.radians(lon)], axis=1)
    tree = neighbors.BallTree(theta, metric="haversine")
    kq = int(np.max(tree.query_radius(theta, r=radius, count_only=True)))
    d_b, i_b = tree.query(theta, k=kq, sort_results=True)

    d_c, i_c = _great_circle_neighbors(nside, np.arange(npix), True, radius)
    assert i_c.shape == i_b.shape
    np.testing.assert_allclose(d_c, d_b, rtol=0, atol=1e-9)
    d_c = d_b  # identical up to the formula's rounding
    assert _same_up_to_ties(i_c, d_c, i_b, d_b) < 0.1 * npix
