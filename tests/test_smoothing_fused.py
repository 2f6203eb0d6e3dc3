"""Smoothing as a chain of monomial powers.

``HealpySmoothing`` decomposes a wide Gaussian into ``m`` repetitions of a
narrow radius-<=4 template (``healpy_layers.py:592-621`` semantics).  Since
S^j x is the j-th monomial recursion term, the chain runs as
ceil(m_total / apps) graph-conv passes with a one-hot contraction picking
each channel's power.  These tests pin the conv-path result against
explicit per-step ``stencil_matvec`` application.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepsphere_tpu.nn.smoothing import HealpySmoothing, SmoothingOperator
from deepsphere_tpu.ops.stencil import stencil_matvec, stencil_tables


@pytest.fixture
def rng():
    return np.random.RandomState(3)


def _per_step_reference(op, x, indices=None):
    """Explicit m-repetition per-step application of op's template."""
    st = op.stencil
    n = st.nside
    npix = 12 * n * n
    B, M, C = x.shape
    tables = {k: jnp.asarray(v) for k, v in stencil_tables(st).items()}
    x2d = jnp.transpose(x, (1, 0, 2)).reshape(M, B * C)
    if M != npix:
        full = jnp.zeros((npix, B * C), x2d.dtype)
        x2d = full.at[jnp.asarray(indices)].set(x2d)
    x4 = jnp.take(x2d, tables["n2f"], axis=0).reshape(12, n, n, B, C)
    reps = op.per_channel_repetitions
    chans = []
    for c in range(C):
        fc = x4[..., c]
        total = op.stencil_reps * (int(reps[c]) if reps is not None else 1)
        for _ in range(total):
            fc = stencil_matvec(st, tables, fc)
        chans.append(fc)
    yf = jnp.stack(chans, axis=-1).reshape(npix, B * C)
    y2d = jnp.take(yf, tables["f2n"], axis=0)
    if M != npix:
        y2d = y2d[jnp.asarray(indices)]
    return np.asarray(jnp.transpose(y2d.reshape(M, B, C), (1, 0, 2)))


def _apply(op, x):
    lay = HealpySmoothing(operator=op)
    vs = lay.init(jax.random.PRNGKey(0), x)
    return np.asarray(lay.apply(vs, x))


def test_fused_chunked_uniform(rng):
    """m=8 at nside=32 needs chunking (apps=7 < 8): two conv passes must
    equal eight per-step matvecs."""
    nside = 32
    npix = 12 * nside * nside
    x = jnp.asarray(rng.normal(size=(2, npix, 2)), jnp.float32)
    op = SmoothingOperator(nside=nside, indices=np.arange(npix),
                           sigma=400.0, method="stencil")
    assert op.stencil_reps > op.stencil_apps > 1  # chunked by construction
    y = _apply(op, x)
    y_ref = _per_step_reference(op, x)
    np.testing.assert_allclose(y, y_ref, rtol=3e-6, atol=3e-6)


def test_fused_per_channel_powers(rng):
    """Multi-scale sigmas: each channel rides its own one-hot power."""
    nside = 32
    npix = 12 * nside * nside
    x = jnp.asarray(rng.normal(size=(1, npix, 3)), jnp.float32)
    op = SmoothingOperator(nside=nside, indices=np.arange(npix),
                           sigma=[400.0, 560.0, 700.0], method="stencil")
    assert op.per_channel_repetitions is not None
    y = _apply(op, x)
    y_ref = _per_step_reference(op, x)
    np.testing.assert_allclose(y, y_ref, rtol=3e-6, atol=3e-6)


def test_fused_masked_sky(rng):
    """Partial-sky smoothing through the conv path (zero rows outside the
    mask; output restricted to the mask)."""
    nside = 32
    npix = 12 * nside * nside
    ind = np.arange(npix)[npix // 4: 3 * npix // 4]
    x = jnp.asarray(rng.normal(size=(2, ind.shape[0], 2)), jnp.float32)
    op = SmoothingOperator(nside=nside, indices=ind, sigma=400.0,
                           method="stencil")
    y = _apply(op, x)
    y_ref = _per_step_reference(op, x, indices=ind)
    np.testing.assert_allclose(y, y_ref, rtol=3e-6, atol=3e-6)


def test_smoothing_gradient_is_transpose(rng):
    """The smoothing operator S is row-normalized (NOT symmetric): the
    backward pass must apply S^T, not S.  The gradient of sum(sin(S x))
    must equal S^T cos(S x) with S assembled densely from the explicit
    per-step reference (a symmetric-VJP regression shows up at ~1e-2)."""
    from deepsphere_tpu.sphere import healpix as hp

    nside = 8
    npix = hp.nside2npix(nside)
    op = SmoothingOperator(nside=nside, indices=np.arange(npix),
                           sigma=400.0, method="stencil")
    lay = HealpySmoothing(operator=op)
    x = jnp.asarray(rng.normal(size=(2, npix, 1)), jnp.float32)
    v = lay.init(jax.random.PRNGKey(0), x)

    # column j of S is S e_j: the per-step reference on the identity basis
    eye = jnp.eye(npix, dtype=jnp.float32)[:, :, None]
    S = _per_step_reference(op, eye)[:, :, 0].T.astype(np.float64)
    assert np.abs(S - S.T).max() > 1e-3 * np.abs(S).max()  # not symmetric

    def loss(x):
        return jnp.sum(jnp.sin(lay.apply(v, x)))

    g = np.asarray(jax.jit(jax.grad(loss))(x))[:, :, 0]
    xs = np.asarray(x)[:, :, 0].astype(np.float64)
    want = np.cos(xs @ S.T) @ S  # row b: S^T cos(S x_b)
    rel = np.abs(g - want).max() / np.abs(want).max()
    assert rel < 1e-5, rel


def test_stencil_error_bound_and_estimator(rng):
    """The stencil decomposition's deviation from the BallTree kernel is
    bounded (<5% rel L2 for sigma up to 4 pixel scales) and the numpy
    proxy estimator predicts the ACTUAL deviation to within 2x — the
    basis of the stencil_rel_tol gate (VERDICT r2 #7)."""
    from deepsphere_tpu.nn.smoothing import estimate_stencil_error
    from deepsphere_tpu.sphere import healpix as hp

    nside = 16
    npix = hp.nside2npix(nside)
    res_am = np.degrees(hp.nside2resol(nside)) * 60
    x = jnp.asarray(rng.normal(size=(1, npix, 1)), jnp.float32)
    for mult in (2.0, 4.0):
        sig = res_am * mult
        ys = {}
        for meth in ("stencil", "ellpack"):
            op = SmoothingOperator(nside=nside, indices=np.arange(npix),
                                   sigma=sig, method=meth)
            lay = HealpySmoothing(operator=op)
            v = lay.init(jax.random.PRNGKey(0), x)
            ys[meth] = np.asarray(lay.apply(v, x))[0, :, 0]
        d = ys["stencil"] - ys["ellpack"]
        rel = np.linalg.norm(d) / np.linalg.norm(ys["ellpack"])
        assert rel < 0.05, (mult, rel)
        # the proxy estimator runs at nside_proxy=16 == nside here, and at
        # a DIFFERENT proxy for a scaled-up target with the same ratio —
        # both must land within 2x of the measured value
        sig_rad = np.radians(sig / 60.0)
        est_same = estimate_stencil_error(sig_rad, nside, nside_proxy=16)
        est_scaled = estimate_stencil_error(
            sig_rad * hp.nside2resol(64) / hp.nside2resol(nside), 64,
            nside_proxy=16,
        )
        for est in (est_same, est_scaled):
            assert 0.5 * rel < est < 2.0 * rel, (mult, rel, est)


def test_stencil_error_bound_masked(rng):
    """Masked (partial-sky) stencil decomposition vs the masked BallTree
    kernel: the full-sky estimator under-predicts near the mask boundary
    (m template applications touch the edge m times), so the measured
    masked deviation must stay within a documented slack factor of the
    full-sky estimate (ADVICE r3: quantify the full-sky assumption)."""
    from deepsphere_tpu.nn.smoothing import estimate_stencil_error
    from deepsphere_tpu.sphere import healpix as hp

    nside = 16
    npix = hp.nside2npix(nside)
    res_am = np.degrees(hp.nside2resol(nside)) * 60
    # a contiguous cap of ~5 faces: real boundary, not scattered pixels
    vec = np.stack(hp.pix2vec(nside, np.arange(npix), nest=True), axis=-1)
    indices = np.where(vec[:, 2] > -0.2)[0]
    x = jnp.asarray(rng.normal(size=(1, len(indices), 1)), jnp.float32)
    sig = res_am * 2.0
    ys = {}
    for meth in ("stencil", "ellpack"):
        op = SmoothingOperator(nside=nside, indices=indices,
                               sigma=sig, method=meth)
        lay = HealpySmoothing(operator=op)
        v = lay.init(jax.random.PRNGKey(0), x)
        ys[meth] = np.asarray(lay.apply(v, x))[0, :, 0]
    d = ys["stencil"] - ys["ellpack"]
    rel = np.linalg.norm(d) / np.linalg.norm(ys["ellpack"])
    est = estimate_stencil_error(np.radians(sig / 60.0), nside,
                                 nside_proxy=16)
    # boundary accumulation: allow 3x the full-sky estimate, and an
    # absolute ceiling consistent with the full-sky <5% bound
    assert rel < max(3.0 * est, 0.08), (rel, est)


def test_stencil_rel_tol_gate(rng):
    """stencil_rel_tol drives the auto path selection: a tolerance below
    the predicted error keeps the exact ELLPACK kernel; a loose one keeps
    the stencil decomposition."""
    from deepsphere_tpu.sphere import healpix as hp

    nside = 16
    npix = hp.nside2npix(nside)
    res_am = np.degrees(hp.nside2resol(nside)) * 60
    sig = res_am * 2.0

    op_exact = SmoothingOperator(nside=nside, indices=np.arange(npix),
                                 sigma=sig, method="auto",
                                 stencil_rel_tol=1e-3)
    assert op_exact.stencil is None
    assert op_exact.stencil_rel_err_est > 1e-3

    op_fast = SmoothingOperator(nside=nside, indices=np.arange(npix),
                                sigma=sig, method="auto",
                                stencil_rel_tol=0.2)
    assert op_fast.stencil is not None
    assert op_fast.stencil_rel_err_est <= 0.2
