"""Host float64 references for the device conv paths.

Plain numpy, independent of the JAX code under test: the same ELLPACK
operator and Chebyshev recurrence as :func:`.spmv.graph_conv` +
:func:`.spmv.chebyshev_basis`, evaluated in float64 on the host.  Used by
``chip_smoke.py`` and ``bench.py`` as the correctness gate of every conv
they run on the device.
"""

from __future__ import annotations

import numpy as np

__all__ = ["numpy_ellpack_spmv", "numpy_cheby_conv"]


def numpy_ellpack_spmv(idx, val, x):
    """y = L @ x for an (M, W) ELLPACK ``(idx, val)`` and x (M, C), float64."""
    val = np.asarray(val, np.float64)
    y = val[:, 0:1] * x[idx[:, 0]]
    for w in range(1, idx.shape[1]):
        y += val[:, w : w + 1] * x[idx[:, w]]
    return y


def numpy_cheby_conv(idx, val, x, kernel, K):
    """K-term Chebyshev graph conv, float64 throughout.

    :param x: (B, M, Fin); :param kernel: (Fin * K, Fout), Fin-major /
        term-minor rows (``gnn_layers.py:144-150``)
    :return: (B, M, Fout) float64
    """
    B, M, Fin = x.shape
    Fout = kernel.shape[-1]
    wk = np.asarray(kernel, np.float64).reshape(Fin, K, Fout)
    t0 = np.transpose(x, (1, 0, 2)).reshape(M, B * Fin).astype(np.float64)
    y = np.zeros((M, B, Fout), np.float64)

    def add(t, k):
        y[...] += np.einsum("mbf,fo->mbo", t.reshape(M, B, Fin), wk[:, k])

    add(t0, 0)
    if K > 1:
        t1 = numpy_ellpack_spmv(idx, val, t0)
        add(t1, 1)
        for k in range(2, K):
            t0, t1 = t1, 2.0 * numpy_ellpack_spmv(idx, val, t1) - t0
            add(t1, k)
    return np.transpose(y, (1, 0, 2))
