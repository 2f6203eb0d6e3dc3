"""ELLPACK sparse matvec and graph-polynomial bases (jnp reference path).

The hot loop of the framework (see the reference call stack,
``/root/reference/src/deepsphere/gnn_layers.py:106-161``): K applications of
the rescaled graph Laplacian against a dense (M, C) activation matrix,
interleaved per the Chebyshev / Monomial / Bernstein recurrences, followed by
one dense (B*M, Fin*K) x (Fin*K, Fout) matmul.

Layout: the Laplacian is a padded ELLPACK pair ``(idx, val)`` of shape
(M, W) — the kNN sphere graph has fixed bounded degree — so the SpMV is a
fixed-width gather plus a W-term weighted sum, and the final contraction is
a single large matmul.  This is the original design of the reference (K
sparse-dense matmuls per conv), the plain reference the stencil path
(:mod:`.stencil`) is tested against, and the path for graphs that have no
stencil form.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from scipy.special import comb

from .. import config

__all__ = [
    "ellpack_spmv",
    "chebyshev_basis",
    "chebyshev_terms",
    "monomial_basis",
    "monomial_terms",
    "bernstein_basis",
    "bernstein_basis_ref",
    "bernstein_terms",
    "graph_conv",
]


def ellpack_spmv(idx, val, x):
    """y = L @ x with L in padded ELLPACK form.

    Unrolled over the (small, static) row width W: W gathers of (M, C) with
    fused multiply-accumulate.  This keeps peak memory at O(M*C) instead of
    the O(M*W*C) a materialized (M, W, C) gather would need — the deciding
    factor at nside=1024 where M*C is already hundreds of MB.

    :param idx: (M, W) int32 column indices (padded entries self-point)
    :param val: (M, W) values (padded entries are 0)
    :param x: (M, C) dense activations
    :return: (M, C)
    """
    W = idx.shape[1]
    y = val[:, 0:1] * jnp.take(x, idx[:, 0], axis=0)
    for w in range(1, W):
        y = y + val[:, w : w + 1] * jnp.take(x, idx[:, w], axis=0)
    return y


def chebyshev_terms(matvec, x0, K):
    """Yield [T_0(L)x, ..., T_{K-1}(L)x] over an abstract ``matvec``.

    Recurrence x_k = 2 L x_{k-1} - x_{k-2} (``gnn_layers.py:137-143``).
    K is static; the loop unrolls into the jaxpr.  Shared by the ELLPACK,
    halo-sharded, and stencil conv paths.
    """
    yield x0
    if K > 1:
        x1 = matvec(x0)
        yield x1
        for _ in range(2, K):
            x0, x1 = x1, 2.0 * matvec(x1) - x0
            yield x1


def monomial_terms(matvec, x0, K):
    """Yield [x, Lx, L^2 x, ...] over an abstract ``matvec``
    (``gnn_layers.py:287-290``)."""
    yield x0
    for _ in range(1, K):
        x0 = matvec(x0)
        yield x0


def chebyshev_basis(idx, val, x, K):
    """Chebyshev basis stack, shape (K, M, C) — see
    :func:`chebyshev_terms`."""
    mv = lambda y: ellpack_spmv(idx, val, y)
    return jnp.stack(list(chebyshev_terms(mv, x, K)), axis=0)


def monomial_basis(idx, val, x, K):
    """Monomial basis stack, shape (K, M, C) — see
    :func:`monomial_terms`."""
    mv = lambda y: ellpack_spmv(idx, val, y)
    return jnp.stack(list(monomial_terms(mv, x, K)), axis=0)


def bernstein_terms(matvec, x0, n_terms, quirk=False):
    """Yield the Bernstein basis terms over an abstract ``matvec`` — the
    ONE implementation shared by the ELLPACK, halo-sharded, and stencil
    conv paths (the recursion is numerically delicate; keeping three
    copies in sync caused real divergence risk).

    Term i: comb(K, i)/2^K * (2I - L)^(K-i) L^i x (``gnn_layers.py:
    542-554``; arXiv:2106.10994).  ``quirk=True`` reproduces the
    reference's stale-buffer i = K term (it re-emits term K-1 divided by
    2^K, ``gnn_layers.py:549-553``) — and skips the L^K power that the
    correct term would need.
    """
    K = n_terms - 1
    if quirk and K < 1:
        raise ValueError(
            "ref_quirks Bernstein needs K >= 1 (the reference crashes at "
            "K=0: gnn_layers.py:542-554 never assigns its output buffer)"
        )
    power = x0
    prev = None
    for i in range(K + 1):
        theta = float(comb(K, i)) / (2.0**K)
        if i == K and quirk:
            yield prev / (2.0**K)
            return
        y = power
        for _ in range(K - i):
            y = 2.0 * y - matvec(y)
        prev = theta * y
        yield prev
        if i < K:
            power = matvec(power)


def bernstein_basis(idx, val, x, n_terms):
    """Bernstein basis stack, shape (n_terms = K+1, M, C) — see
    :func:`bernstein_terms`.  We implement the mathematically correct
    i = K term (the quirk variant is :func:`bernstein_basis_ref`)."""
    mv = lambda y: ellpack_spmv(idx, val, y)
    return jnp.stack(list(bernstein_terms(mv, x, n_terms)), axis=0)


def bernstein_basis_ref(idx, val, x, n_terms):
    """Bernstein basis with BIT-EXACT reference-quirk parity.

    The reference's i = K loop iteration never recomputes ``x3``
    (``gnn_layers.py:542-554``): with the k-loop skipped, ``x3 = theta * x3``
    rebinds the PREVIOUS term (theta_{K-1} applied included), so the last
    basis term is ``stack[K-1] / 2^K`` instead of the correct
    ``L^K x / 2^K``.  A reference-trained Bernstein checkpoint only
    reproduces under this quirk — enable it via ``BernsteinConv(
    ref_quirks=True)``.  K = 0 raises, as the reference does (NameError on
    the never-assigned ``x3``).
    """
    mv = lambda y: ellpack_spmv(idx, val, y)
    return jnp.stack(list(bernstein_terms(mv, x, n_terms, quirk=True)),
                     axis=0)


def graph_conv(basis, x, kernel, n_terms):
    """Apply a graph polynomial conv given a basis function.

    :param basis: callable (x2d (M, C), n_terms) -> (n_terms, M, C)
    :param x: input activations (B, M, Fin)
    :param kernel: (Fin * n_terms, Fout) — Fin-major, term-minor row layout,
        identical to the reference kernel layout (``gnn_layers.py:144-150``,
        confirmed by the (Fin, K, Fout) reshape at ``healpy_networks.py:199-204``)
    :return: (B, M, Fout)
    """
    B, M, Fin = x.shape
    Fout = kernel.shape[-1]
    x2d = jnp.transpose(x, (1, 0, 2)).reshape(M, B * Fin)
    tx = basis(x2d, n_terms)  # (K, M, B*Fin)
    tx = tx.reshape(n_terms, M, B, Fin)
    tx = jnp.transpose(tx, (2, 1, 3, 0)).reshape(B * M, Fin * n_terms)
    y = jnp.dot(
        tx, kernel.astype(tx.dtype),
        preferred_element_type=jnp.float32, precision=config.precision(),
    )
    return y.reshape(B, M, Fout).astype(x.dtype)
