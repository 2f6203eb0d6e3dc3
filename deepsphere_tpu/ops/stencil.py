"""Gather-free graph convolution: 3x3 stencil on the 12-face HEALPix layout.

The hot loop of the framework — the K-term polynomial graph convolution
that the reference implements as K sparse matvecs
(``deepsphere/gnn_layers.py:137-150`` of the reference).  With the
Laplacian in stencil form (:func:`~deepsphere_tpu.graph.stencil.face_stencil`)
each Laplacian application is nine shifted multiply-adds on dense face
images (no gathers), the face-border halo is refilled between applications
from a precomputed scatter map, and the [K*Fin, Fout] contraction is folded
into the recursion one term at a time so the K-term basis stack is never
materialized.

The only gathers left are the NEST <-> face layout permutations at the conv
boundary (one each way), and the O(sqrt(M)) halo border fill per step.

The static graph arrays are passed around as a ``tables`` dict (see
:func:`stencil_tables`) so callers can route them through jit as **runtime
arguments** — at nside=1024 the weight planes alone are ~0.5 GB, which must
never be baked into the HLO as constants (it bloats compile time and the
serialized executable).

Everything here is plain jnp, so autodiff falls out for free.
"""

from __future__ import annotations

import jax.numpy as jnp

from .. import config
from ..graph.stencil import FaceStencil

__all__ = [
    "stencil_tables",
    "pad_faces",
    "edge_strips",
    "stencil_matvec",
    "stencil_graph_conv",
    "stencil_graph_conv_cface",
    "cfp_geometry",
    "cfp_structural_available",
    "cface_embed",
    "cface_extract",
    "stencil_basis_stack",
]


def _extract_bands(x3, n, h):
    """The four face-edge bands of (C, 12, n, n) face images, cut to depth
    h: first/last rows (C, 12, h, n) and first/last columns (C, 12, n, h)."""
    return (
        x3[:, :, :h, :],
        x3[:, :, n - h :, :],
        x3[:, :, :, :h],
        x3[:, :, :, n - h :],
    )


def _src_block(bands, n, h, ax, ay):
    """Slice the (ax, ay) source rectangle of face ``nbf`` out of the
    prefetched edge bands.  A halo-region rectangle always has at least
    one thin (h-wide) axis pinned to a face edge, so it lives inside one
    of the four bands."""
    fr, lr, fc, lc = bands  # (C,12,h,n) first/last rows, (C,12,n,h) cols
    (a0, a1), (b0, b1) = ax, ay
    if a1 - a0 == h and (a0 == 0 or a0 == n - h):
        band = fr if a0 == 0 else lr
        return band if (b1 - b0) == n else band[..., b0:b1]
    band = fc if b0 == 0 else lc
    return band if (a1 - a0) == n else band[:, :, a0:a1, :]


def _edge_block(bands, n, h, f, xs, ys):
    """Halo block for region (xs, ys) of face ``f`` as a structured copy.

    Returns (C, lx, ly) with lx = h if xs else n (same for y), raster-
    ordered by the region's local (xw, yw).  Pure slices + flips + one
    transpose on the h-thin bands of :func:`_extract_bands` — no gather.
    """
    from ..sphere.faces import edge_descriptor

    d = edge_descriptor(f, xs, ys)
    lx = h if xs else n
    ly = h if ys else n
    if d is None:  # polar 3-way corner: no pixels
        return jnp.zeros((bands[0].shape[0], lx, ly), bands[0].dtype)
    nbf, fx, fy, swap = d
    xw0 = n - h if xs < 0 else 0
    yw0 = n - h if ys < 0 else 0

    def rng(w0, l, flip):
        return (n - w0 - l, n - w0) if flip else (w0, w0 + l)

    ax = rng(xw0, lx, fx)
    ay = rng(yw0, ly, fy)
    if swap:
        blk = jnp.transpose(_src_block(bands, n, h, ay, ax)[:, nbf], (0, 2, 1))
    else:
        blk = _src_block(bands, n, h, ax, ay)[:, nbf]
    if fx:
        blk = jnp.flip(blk, axis=1)
    if fy:
        blk = jnp.flip(blk, axis=2)
    return blk


def edge_strips(n, h, x3):
    """The four halo strips of every face, as structured edge copies.

    x3: (C, 12, n, n) channels-first faces.  Returns ``(west, east, south,
    north)`` with west/east (C, 12, h, n+2h) spanning the full padded width
    (corners included) and south/north (C, 12, n, h) covering interior
    rows — the same coverage as the gather tables built in
    :mod:`..graph.stencil`, from slices, flips and transposes of the four
    face-edge bands alone.
    """
    bands = _extract_bands(x3, n, h)
    faces = range(12)

    def row_strip(xs):
        return jnp.stack(
            [
                jnp.concatenate(
                    [
                        _edge_block(bands, n, h, f, xs, -1),
                        _edge_block(bands, n, h, f, xs, 0),
                        _edge_block(bands, n, h, f, xs, 1),
                    ],
                    axis=2,
                )
                for f in faces
            ],
            axis=1,
        )

    def col_strip(ys):
        return jnp.stack(
            [_edge_block(bands, n, h, f, 0, ys) for f in faces], axis=1
        )

    return row_strip(-1), row_strip(1), col_strip(-1), col_strip(1)


def stencil_tables(st: FaceStencil):
    """The device-side arrays of a stencil, as a pytree dict (host numpy;
    convert/donate at the jit boundary)."""
    return {
        "weights": st.weights,
        "west_src": st.west_src,
        "west_mask": st.west_mask,
        "east_src": st.east_src,
        "east_mask": st.east_mask,
        "south_src": st.south_src,
        "south_mask": st.south_mask,
        "north_src": st.north_src,
        "north_mask": st.north_mask,
        "n2f": st.n2f,
        "f2n": st.f2n,
        # exact-kNN per-application fix rows (empty for grid/ring graphs)
        "fix_src": st.fix_src,
        "fix_idx": st.fix_idx,
        "fix_val": st.fix_val,
    }


def _as_device(tables, st):
    if tables is None:
        tables = stencil_tables(st)
    return {k: jnp.asarray(v) for k, v in tables.items()}


def pad_faces(st: FaceStencil, xf, tables):
    """(12, n, n, C) -> (12, P, P, C) with the cross-face halo filled.

    The halo lands via four static-slice updates; only the thin strips
    themselves are gathered (O(nside) rows), and no index scatter is used.
    """
    n, s = st.nside, st.n_steps
    P = n + 2 * s
    C = xf.shape[-1]
    flat = xf.reshape(12 * n * n, C)

    def strip(name):
        src = tables[f"{name}_src"]
        mask = tables[f"{name}_mask"].astype(xf.dtype)
        return flat[src.reshape(-1)].reshape(src.shape + (C,)) * mask[..., None]

    xpad = jnp.pad(xf, ((0, 0), (s, s), (s, s), (0, 0)))
    xpad = xpad.at[:, :s, :, :].set(strip("west"))
    xpad = xpad.at[:, s + n :, :, :].set(strip("east"))
    xpad = xpad.at[:, s : s + n, :s, :].set(strip("south"))
    xpad = xpad.at[:, s : s + n, s + n :, :].set(strip("north"))
    return xpad


def stencil_matvec(st: FaceStencil, tables, xf):
    """One application of the rescaled Laplacian: y = L~ xf.

    Exact for ``st.n_steps == st.radius`` stencils (one application).

    :param xf: (12, n, n, C) face-layout activations
    :return: (12, n, n, C)
    """
    n, s = st.nside, st.n_steps
    offs = st.offsets
    nc = len(offs) - 1  # center plane index (center is last)
    # weight planes: wrapped-extended layout — interior face rows at [0, n),
    # face col y at lane y + s
    w = tables["weights"][:, :, 0:n, s : s + n].astype(xf.dtype)
    xpad = pad_faces(st, xf, tables)
    y = w[nc][..., None] * xf
    for d, (dx, dy) in enumerate(offs[:-1]):
        sl = xpad[:, s + dx : s + dx + n, s + dy : s + dy + n, :]
        y = y + w[d][..., None] * sl
    fs = tables.get("fix_src")
    if fs is not None and fs.shape[0]:
        # exact-kNN graphs: rows whose edges escape/alias the capture
        # window get the exact ELLPACK matvec (small row set; see
        # graph.stencil.face_stencil)
        C = xf.shape[-1]
        flat = xf.reshape(12 * n * n, C)
        vals = jnp.einsum(
            "rw,rwc->rc",
            tables["fix_val"].astype(xf.dtype),
            flat[tables["fix_idx"]],
            preferred_element_type=jnp.float32,
            precision=config.precision(),
        ).astype(xf.dtype)
        y = y.reshape(12 * n * n, C).at[fs].set(vals).reshape(y.shape)
    return y


def _term_stream(kind, matvec, x0, n_terms):
    """Yield the polynomial basis terms one at a time (never stacked) —
    the shared recursions from :mod:`.spmv`, with the per-step stencil
    matvec as the L application."""
    from .spmv import bernstein_terms, chebyshev_terms, monomial_terms

    if kind == "cheby":
        yield from chebyshev_terms(matvec, x0, n_terms)
    elif kind == "mono":
        yield from monomial_terms(matvec, x0, n_terms)
    elif kind in ("bern", "bern_ref"):
        yield from bernstein_terms(matvec, x0, n_terms,
                                   quirk=kind == "bern_ref")
    else:  # pragma: no cover
        raise ValueError(f"unknown basis kind: {kind}")


def stencil_graph_conv(st: FaceStencil, x, kernel, n_terms, kind, tables=None,
                       layout="nest"):
    """Polynomial graph conv on the face layout.

    Drop-in equivalent of ``spmv.graph_conv`` (same kernel layout,
    ``gnn_layers.py:144-150``), keeping the reference's
    (batch, pixel, channel) contract.

    :param x: (B, M, Fin)
    :param kernel: (Fin * n_terms, Fout), Fin-major / term-minor rows
    :param tables: device arrays from :func:`stencil_tables`; pass them
        through the jit boundary as arguments.  ``None`` converts on the
        spot (fine outside jit / in tests only).
    :param layout: ordering of the pixel axis — "nest" (reference contract;
        converted at entry/exit via dense Morton transposes) or "face"
        (face-flat [f, x, y]; zero-permutation hot path — the native mode
        the model assembler uses internally)
    :return: (B, M, Fout)
    """
    B, M, Fin = x.shape
    n = st.nside
    if M != 12 * n * n:
        raise ValueError(f"stencil conv needs the full sphere ({12*n*n} pixels), got {M}")
    Fout = kernel.shape[-1]
    tables = _as_device(tables, st)

    x2d = jnp.transpose(x, (1, 0, 2)).reshape(M, B * Fin)
    if layout == "nest":
        from .layout import nest_to_face

        x2d = nest_to_face(x2d)
    elif layout != "face":
        raise ValueError(f"unknown layout: {layout}")

    xf = x2d.reshape(12, n, n, B * Fin)
    matvec = lambda t: stencil_matvec(st, tables, t)
    wk = kernel.reshape(Fin, n_terms, Fout)
    y = jnp.zeros((M, B, Fout), dtype=jnp.float32)
    for k, t in enumerate(_term_stream(kind, matvec, xf, n_terms)):
        tk = t.reshape(M, B, Fin)
        y = y + jnp.einsum(
            "mbf,fo->mbo", tk, wk[:, k, :].astype(t.dtype),
            preferred_element_type=jnp.float32, precision=config.precision(),
        )
    if layout == "nest":
        from .layout import face_to_nest

        y = face_to_nest(y.reshape(M, B * Fout)).reshape(M, B, Fout)
    return jnp.transpose(y, (1, 0, 2)).astype(x.dtype)


def cfp_geometry(n, h):
    """Padded lane width ``P_l = roundup(n + 2h, 128)`` of the channels-first
    padded (cface) layout (B, F, 12, n, P_l), face col y at lane y + h."""
    return -(-(n + 2 * h) // 128) * 128


def cfp_structural_available(st: FaceStencil, kind, n_terms):
    """Whether a conv can run in the cface layout: a Chebyshev or monomial
    recurrence on a stencil whose halo covers all ``n_terms - 1``
    applications.  Depends on the graph only, so a model planned on one
    platform applies unchanged on another."""
    if st is None or kind not in ("cheby", "mono") or n_terms < 2:
        return False
    return st.n_steps >= getattr(st, "radius", 1) * (n_terms - 1)


def stencil_graph_conv_cface(st: FaceStencil, x5, kernel, n_terms, kind,
                             tables=None):
    """Polynomial graph conv in the channels-first padded (cface) layout.

    Input and output are (B, F, 12, n, P_l) with face col y at lane
    ``y + h`` (see :func:`cfp_geometry`); the interior runs the per-step
    face path of :func:`stencil_graph_conv` and is re-embedded.

    :param x5: (B, Fin, 12, n, P_l); only interior lanes are read
    :return: (B, Fout, 12, n, P_l); non-interior lanes are zero
    """
    n, P_l = x5.shape[3], x5.shape[4]
    h = st.n_steps
    if n != st.nside or P_l != cfp_geometry(n, h):
        raise ValueError(
            f"cface input geometry {(n, P_l)} does not match the stencil "
            f"({st.nside}, {cfp_geometry(st.nside, h)})"
        )
    yf = stencil_graph_conv(st, cface_extract(x5, h), kernel, n_terms, kind,
                            tables=tables, layout="face")
    return cface_embed(yf, n, h)


def cface_embed(x, n, h):
    """(B, M, F) face-flat -> (B, F, 12, n, P_l) channels-first padded."""
    B, M, F = x.shape
    P_l = cfp_geometry(n, h)
    xi = jnp.transpose(x, (0, 2, 1)).reshape(B, F, 12, n, n)
    return jnp.concatenate(
        [
            jnp.zeros((B, F, 12, n, h), x.dtype),
            xi,
            jnp.zeros((B, F, 12, n, P_l - n - h), x.dtype),
        ],
        axis=4,
    )


def cface_extract(x5, h):
    """(B, F, 12, n, P_l) channels-first padded -> (B, M, F) face-flat."""
    B, F, _, n, _ = x5.shape
    xi = x5[:, :, :, :, h : h + n].reshape(B, F, 12 * n * n)
    return jnp.transpose(xi, (0, 2, 1))


def stencil_basis_stack(st: FaceStencil, kind, x2d, n_terms, tables=None):
    """Basis stack in NEST order, shape (n_terms, M, C) — the stencil-path
    analogue of ``spmv.chebyshev_basis`` & co., for tests and parity checks."""
    from .layout import face_to_nest, nest_to_face

    n = st.nside
    M, C = x2d.shape
    tables = _as_device(tables, st)
    xf = nest_to_face(x2d).reshape(12, n, n, C)
    matvec = lambda t: stencil_matvec(st, tables, t)
    terms = [
        face_to_nest(t.reshape(M, C))
        for t in _term_stream(kind, matvec, xf, n_terms)
    ]
    return jnp.stack(terms, axis=0)
