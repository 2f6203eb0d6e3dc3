"""The per-step stencil conv on deep stencils (halo = radius * (K - 1),
the stencil the cface plan builds) against the ELLPACK gather path:
forward, gradients, the rows at the 8 polar 3-way corners, a radius-3
(k=40) graph and the cface entry point."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepsphere_tpu.graph import build_sphere_graph
from deepsphere_tpu.ops import spmv
from deepsphere_tpu.ops.stencil import (cface_embed, cface_extract,
                                        cfp_geometry, stencil_graph_conv,
                                        stencil_graph_conv_cface,
                                        stencil_tables)


@pytest.fixture(scope="module")
def graph():
    return build_sphere_graph(8, k=8, method="grid")


def _ref_conv(g, kind, x, kern, K, scale):
    idx, val = g.ellpack(scale)
    basis = {"cheby": spmv.chebyshev_basis, "mono": spmv.monomial_basis}[kind]
    return spmv.graph_conv(
        lambda z, nt: basis(jnp.asarray(idx), jnp.asarray(val), z, nt),
        x, kern, K,
    )


def _tables(st):
    return {k: jnp.asarray(v) for k, v in stencil_tables(st).items()}


@pytest.mark.parametrize("kind,K,scale", [("cheby", 5, 0.75), ("mono", 3, 1.0)])
def test_deep_stencil_conv_matches_gather(rng, graph, kind, K, scale):
    st = graph.deep_stencil(scale, K)
    assert st.n_steps == K - 1
    B, Fin, Fout = 3, 2, 4
    x = jnp.asarray(rng.normal(size=(B, graph.n_pixels, Fin)), jnp.float32)
    kern = jnp.asarray(rng.normal(size=(Fin * K, Fout)), jnp.float32)
    y = stencil_graph_conv(st, x, kern, K, kind, tables=_tables(st))
    y_ref = _ref_conv(graph, kind, x, kern, K, scale)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref), atol=2e-5)


def test_deep_stencil_gradients_match(rng, graph):
    K, B, Fin, Fout = 4, 2, 2, 3
    st = graph.deep_stencil(0.75, K)
    tables = _tables(st)
    x = jnp.asarray(rng.normal(size=(B, graph.n_pixels, Fin)), jnp.float32)
    kern = jnp.asarray(rng.normal(size=(Fin * K, Fout)), jnp.float32)

    def loss_st(x, k):
        return jnp.sum(stencil_graph_conv(st, x, k, K, "cheby",
                                          tables=tables) ** 2)

    def loss_ref(x, k):
        return jnp.sum(_ref_conv(graph, "cheby", x, k, K, 0.75) ** 2)

    gx1, gk1 = jax.grad(loss_st, argnums=(0, 1))(x, kern)
    gx2, gk2 = jax.grad(loss_ref, argnums=(0, 1))(x, kern)
    np.testing.assert_allclose(np.asarray(gx1), np.asarray(gx2),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(gk1), np.asarray(gk2),
                               rtol=2e-4, atol=2e-3)


def test_polar_corner_rows_are_exact(rng, graph):
    """The rows whose neighborhoods a rectangular face extension cannot
    represent (the 8 polar 3-way corners) come out exact, because the
    per-step path refills the halo before every application."""
    K = 5
    st = graph.deep_stencil(0.75, K)
    rows = np.asarray(st.corrupt_rows)
    assert rows.size > 0
    x = jnp.asarray(rng.normal(size=(1, graph.n_pixels, 1)), jnp.float32)
    kern = jnp.asarray(rng.normal(size=(K, 1)), jnp.float32)
    y = np.asarray(stencil_graph_conv(st, x, kern, K, "cheby",
                                      tables=_tables(st)))
    y_ref = np.asarray(_ref_conv(graph, "cheby", x, kern, K, 0.75))
    np.testing.assert_allclose(y[:, rows], y_ref[:, rows], atol=2e-5)


def test_deep_radius_k40_conv_matches_gather(rng):
    """k=40 (radius 3) runs per step on the shallow stencil."""
    K, B, Fin, Fout = 4, 2, 2, 3
    g = build_sphere_graph(16, k=40, method="grid")
    st = g.face_stencil(0.75)
    assert st is not None and st.radius == 3 and st.n_steps == 3
    x = jnp.asarray(rng.normal(size=(B, g.n_pixels, Fin)), jnp.float32)
    kern = jnp.asarray(rng.normal(scale=0.1, size=(Fin * K, Fout)),
                       jnp.float32)
    y = stencil_graph_conv(st, x, kern, K, "cheby", tables=_tables(st))
    y_ref = _ref_conv(g, "cheby", x, kern, K, 0.75)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref), atol=2e-5)


def test_cface_conv_matches_gather(rng, graph):
    """The model assembler's cface entry: padded channels-first in and
    out, zero lanes outside the interior, geometry checked."""
    K, B, Fin, Fout = 5, 2, 3, 2
    st = graph.deep_stencil(0.75, K)
    n, h = st.nside, st.n_steps
    x = jnp.asarray(rng.normal(size=(B, graph.n_pixels, Fin)), jnp.float32)
    kern = jnp.asarray(rng.normal(size=(Fin * K, Fout)), jnp.float32)
    xf = jnp.take(x, jnp.asarray(st.n2f), axis=1)  # NEST -> face-flat
    x5 = cface_embed(xf, n, h)
    assert x5.shape == (B, Fin, 12, n, cfp_geometry(n, h))
    y5 = stencil_graph_conv_cface(st, x5, kern, K, "cheby",
                                  tables=_tables(st))
    assert y5.shape == (B, Fout, 12, n, cfp_geometry(n, h))
    lanes = np.asarray(y5)
    assert not lanes[..., :h].any() and not lanes[..., h + n:].any()
    y = jnp.take(cface_extract(y5, h), jnp.asarray(st.f2n), axis=1)
    y_ref = _ref_conv(graph, "cheby", x, kern, K, 0.75)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref), atol=2e-5)
    with pytest.raises(ValueError, match="geometry"):
        stencil_graph_conv_cface(st, x5[..., :-1], kern, K, "cheby")
