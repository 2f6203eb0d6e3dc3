"""Layer zoo: graph convolutions, residual blocks and HEALPix pooling.

Re-design of the reference layer zoo
(``/root/reference/src/deepsphere/gnn_layers.py`` and the concrete layers in
``healpy_layers.py``):

* ``ChebyshevConv`` / ``MonomialConv`` / ``BernsteinConv`` — graph polynomial
  convolutions over a precomputed :class:`~deepsphere_tpu.graph.SphereGraph`
  (ELLPACK Laplacian), with initializer / batch-norm / bias / activation
  semantics matching ``gnn_layers.py:12-161,164-309,416-572``.
* ``ResidualLayer`` — two conv sublayers with optional norms and the
  ``act(out + alpha * in)`` coupling of ``gnn_layers.py:386-413``.
* ``HealpyPool`` — NEST-hierarchy max/avg pooling (``healpy_layers.py:20-84``)
  as a reshape-reduce (Keras Pool1D with kernel == stride is exactly that).
* ``HealpyPseudoConv`` / ``HealpyPseudoConv_Transpose`` — learnable 4^p
  down/up-sampling (``healpy_layers.py:87-216``); a Conv1D with kernel ==
  stride is a blocked matmul.

All layers keep the reference's ``(batch, nodes, channels)`` tensor contract.
Cross-replica batch-norm for data-parallel training is supported via
``bn_axis_name`` (maps to ``core.BatchNorm(axis_name=...)``, i.e. pmean
batch stats over the mesh axis).
"""

from __future__ import annotations

from typing import Any, Callable, ClassVar, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from .. import config
from . import core as nn
from ..graph import SphereGraph
from ..ops import spmv
from ..ops.layout import face_to_nest, nest_to_face, nside_of_axis
from ..sphere.healpix import _spread_bits
from ..utils import resolve_activation

__all__ = [
    "ChebyshevConv",
    "MonomialConv",
    "BernsteinConv",
    "ResidualLayer",
    "HealpyPool",
    "HealpyPseudoConv",
    "HealpyPseudoConv_Transpose",
    "Flatten",
    "Dense",
    "NestToFace",
    "FaceToNest",
    "NestToCface",
    "CfaceToNest",
    "CfaceReEmbed",
]

Dtype = Any


def _raster_to_morton_taps(p):
    """Tap permutation between the two block orderings of a 2^p x 2^p NEST
    parent block: entry j (raster dx*2^p + dy) gives the NEST child index
    (Morton interleave).  Reordering kernel taps with this makes face-layout
    pooling convs numerically identical to their NEST-layout form, so
    checkpoints are layout-independent."""
    sp = 2**p
    j = np.arange(sp * sp, dtype=np.int64)
    dx, dy = j // sp, j % sp
    return np.asarray(_spread_bits(dx) | (_spread_bits(dy) << 1), dtype=np.int64)


class NestToFace(nn.Module):
    """Reorder the pixel axis from NEST to face-flat [f, x, y] (dense Morton
    transposes, no gather).  Inserted by the model assembler at the NEST ->
    face-layout boundary."""

    @nn.compact
    def __call__(self, x, training=False):
        return nest_to_face(x)


class FaceToNest(nn.Module):
    """Inverse of :class:`NestToFace`."""

    @nn.compact
    def __call__(self, x, training=False):
        return face_to_nest(x)


class NestToCface(nn.Module):
    """NEST (B, M, F) -> the conv's native channels-first padded layout
    (B, F, 12, n, P_l) with face col y at lane ``y + off``.  Inserted once
    per cface segment by the model assembler; inside the segment no layer
    performs any layout change at all."""

    off: int

    @nn.compact
    def __call__(self, x, training=False):
        from ..ops.stencil import cface_embed

        n = nside_of_axis(x.shape[1])
        return cface_embed(nest_to_face(x), n, self.off)


class CfaceToNest(nn.Module):
    """Inverse of :class:`NestToCface`."""

    off: int

    @nn.compact
    def __call__(self, x, training=False):
        from ..ops.stencil import cface_extract

        return face_to_nest(cface_extract(x, self.off))


class CfaceReEmbed(nn.Module):
    """Shift the lane embedding between two cface geometries (needed only
    between consecutive convs of different polynomial order)."""

    off_in: int
    off_out: int

    @nn.compact
    def __call__(self, x, training=False):
        from ..ops.stencil import cfp_geometry

        if self.off_in == self.off_out:
            return x
        B, F, _, n, _ = x.shape
        P_out = cfp_geometry(n, self.off_out)
        xi = x[:, :, :, :, self.off_in : self.off_in + n]
        return jnp.concatenate(
            [
                jnp.zeros((B, F, 12, n, self.off_out), x.dtype),
                xi,
                jnp.zeros((B, F, 12, n, P_out - n - self.off_out), x.dtype),
            ],
            axis=4,
        )


class _CfaceBatchNorm(nn.Module):
    """BatchNorm over the cface layout with interior-only statistics.

    Mirrors :class:`.core.BatchNorm` semantics and state layout (so
    checkpoints are layout-independent), but computes batch statistics over
    the interior lanes only — the layout's halo/pad lanes hold garbage that
    must not pollute the stats.  The full array is normalized with those
    stats (garbage stays garbage; downstream consumers only read the
    interior).
    """

    off: int
    use_running_average: bool = False
    momentum: float = 0.9
    epsilon: float = 1e-5
    use_bias: bool = False
    use_scale: bool = False
    axis_name: Optional[str] = None

    @nn.compact
    def __call__(self, x):
        B, F, _, n, _ = x.shape
        ra_mean = self.variable(
            "batch_stats", "mean", lambda s: jnp.zeros(s, jnp.float32), (F,)
        )
        ra_var = self.variable(
            "batch_stats", "var", lambda s: jnp.ones(s, jnp.float32), (F,)
        )
        if self.use_running_average:
            mean, var = ra_mean.value, ra_var.value
        else:
            xi = x[:, :, :, :, self.off : self.off + n].astype(jnp.float32)
            mean = jnp.mean(xi, axis=(0, 2, 3, 4))
            mean2 = jnp.mean(jnp.square(xi), axis=(0, 2, 3, 4))
            if self.axis_name is not None:
                mean = jax.lax.pmean(mean, self.axis_name)
                mean2 = jax.lax.pmean(mean2, self.axis_name)
            var = mean2 - jnp.square(mean)
            if not self.is_initializing():
                m = self.momentum
                ra_mean.value = m * ra_mean.value + (1 - m) * mean
                ra_var.value = m * ra_var.value + (1 - m) * var
        shape = (1, F, 1, 1, 1)
        y = (x - mean.reshape(shape).astype(x.dtype)) * jax.lax.rsqrt(
            var.reshape(shape).astype(x.dtype) + self.epsilon
        )
        if self.use_scale:
            scale = self.param("scale", nn.initializers.ones, (F,), jnp.float32)
            y = y * scale.reshape(shape).astype(x.dtype)
        if self.use_bias:
            bias = self.param("bias", nn.initializers.zeros, (F,), jnp.float32)
            y = y + bias.reshape(shape).astype(x.dtype)
        return y


def _batch_norm(training, axis_name, name=None):
    """The reference conv-layer BN config: momentum 0.9, eps 1e-5, no affine
    (``gnn_layers.py:52-53``)."""
    return nn.BatchNorm(
        use_running_average=not training,
        momentum=0.9,
        epsilon=1e-5,
        use_bias=False,
        use_scale=False,
        axis_name=axis_name,
        name=name,
    )


class _GraphPolyConv(nn.Module):
    """Shared skeleton of the three polynomial graph convolutions."""

    graph: SphereGraph
    K: int
    Fout: Optional[int] = None
    initializer: Optional[Callable] = None
    activation: Optional[Union[str, Callable]] = None
    use_bias: bool = False
    use_bn: bool = False
    bn_axis_name: Optional[str] = None
    shard_cfg: Optional[Any] = None  # parallel.ShardConfig -> halo-sharded SpMV
    conv_method: str = "auto"  # "auto" | "stencil" | "ellpack"
    layout: str = "nest"  # pixel-axis ordering of inputs/outputs; "face"
    # requires the stencil path and skips all boundary permutations
    ref_quirks: bool = False  # Bernstein only: reproduce the reference's
    # stale-buffer i=K term bit-exactly (see spmv.bernstein_basis_ref)

    # subclass configuration (not dataclass fields)
    _scale: ClassVar[float] = 1.0
    _basis: ClassVar = None  # staticmethod set by subclass
    _basis_kind: ClassVar[str] = ""
    _n_terms_offset: ClassVar[int] = 0  # Bernstein uses K+1 terms

    def _default_std(self, Fin, Fout):
        raise NotImplementedError

    @property
    def basis_kind(self):
        if self.ref_quirks and self._basis_kind == "bern":
            return "bern_ref"
        return self._basis_kind

    def _basis_fn(self):
        if self.basis_kind == "bern_ref":
            return spmv.bernstein_basis_ref
        return type(self)._basis

    @nn.compact
    def __call__(self, x, training=False):
        if self.layout == "cface":
            return self._call_cface(x, training)
        B, M, Fin = x.shape
        if M != self.graph.n_pixels:
            raise ValueError(
                f"Input has {M} nodes but the graph has {self.graph.n_pixels}"
            )
        Fout = Fin if self.Fout is None else self.Fout
        n_terms = self.K + self._n_terms_offset

        if self.initializer is None:
            init = nn.initializers.truncated_normal(
                stddev=self._default_std(Fin, Fout), lower=-2.0, upper=2.0
            )
        else:
            init = self.initializer
        kernel = self.param("kernel", init, (Fin * n_terms, Fout), jnp.float32)

        # The static graph arrays are 100s of MB at large nside: they must
        # reach the computation as runtime arguments, NOT as jit constants
        # (constants are baked into the HLO module).  They live in the
        # "graph_tables" variable collection, which apply threads through
        # ``variables`` into every apply call.
        if self.shard_cfg is not None:
            from ..parallel.halo import shard_ellpack_cached
            from ..parallel.sharded_ops import sharded_poly_conv

            op = shard_ellpack_cached(
                self.graph, self.shard_cfg.n_pixel_shards, self._scale
            )
            tables = self.variable("graph_tables", "sharded", op.tables).value
            y = sharded_poly_conv(
                self.basis_kind, op, x, kernel, n_terms, self.shard_cfg,
                tables=tables,
            )
        else:
            st = None
            if self.conv_method in ("auto", "stencil"):
                # the deep (n_steps = K-1) stencil is the one the cface
                # plan builds, so both layouts share one extraction
                if self._basis_kind in ("cheby", "mono") and n_terms >= 2:
                    r = self.graph.stencil_radius
                    if r is not None and r >= 3 and n_terms > 2:
                        # deep-radius graphs (k=40/60): a halo of r*(K-1)
                        # rows outgrows small faces, and one application
                        # needs only r — build the shallow stencil
                        st = self.graph.face_stencil(self._scale)
                    else:
                        st = self.graph.deep_stencil(self._scale, n_terms)
                if st is None:
                    st = self.graph.face_stencil(self._scale)
                if st is None and self.conv_method == "stencil":
                    raise ValueError(
                        "conv_method='stencil' requires a stencil-capturable "
                        "full-sphere graph (grid/ring construction, or a kNN "
                        "graph whose edges fit the capture window)"
                    )
            if st is None and self.layout == "face":
                raise ValueError(
                    "layout='face' requires the stencil path (full-sphere "
                    "grid graph)"
                )
            if st is not None:
                from ..ops.stencil import stencil_graph_conv, stencil_tables

                tables = self.variable(
                    "graph_tables", "stencil", stencil_tables, st
                ).value
                npix_full = 12 * st.nside * st.nside
                if M != npix_full:
                    # masked sky on the stencil path: embed the masked rows
                    # into the full sphere (zeros outside — exact, see
                    # graph.stencil.face_stencil), convolve, slice back.
                    # Both directions are gathers (take), not scatters.
                    def _embed_maps():
                        ind = np.asarray(self.graph.indices, dtype=np.int64)
                        inv = np.full(npix_full, M, dtype=np.int32)
                        inv[ind] = np.arange(M, dtype=np.int32)
                        return {"ind": ind.astype(np.int32), "inv": inv}

                    emb = self.variable(
                        "graph_tables", "mask_embed", _embed_maps
                    ).value
                    xpad = jnp.concatenate(
                        [x, jnp.zeros((B, 1, Fin), x.dtype)], axis=1
                    )
                    xf = jnp.take(xpad, emb["inv"], axis=1)
                    yf = stencil_graph_conv(
                        st, xf, kernel, n_terms, self.basis_kind,
                        tables=tables, layout="nest",
                    )
                    y = jnp.take(yf, emb["ind"], axis=1)
                else:
                    y = stencil_graph_conv(
                        st, x, kernel, n_terms, self.basis_kind,
                        tables=tables, layout=self.layout,
                    )
            else:
                idx_np, val_np = self.graph.ellpack(self._scale)
                tables = self.variable(
                    "graph_tables", "ellpack",
                    lambda: {"idx": idx_np, "val": val_np},
                ).value
                idx = tables["idx"]
                val = tables["val"].astype(x.dtype)
                basis_impl = self._basis_fn()
                basis = lambda x2d, nt: basis_impl(idx, val, x2d, nt)
                y = spmv.graph_conv(basis, x, kernel, n_terms)

        if self.use_bn:
            y = _batch_norm(training, self.bn_axis_name, name="bn")(y)
        if self.use_bias:
            bias = self.param("bias", nn.initializers.zeros, (1, 1, Fout), jnp.float32)
            y = y + bias
        act = resolve_activation(self.activation)
        if act is not None:
            y = act(y)
        return y

    def _call_cface(self, x, training):
        """The conv in its native channels-first padded layout — see
        :func:`..ops.stencil.stencil_graph_conv_cface`."""
        from ..ops.stencil import stencil_graph_conv_cface, stencil_tables

        B, Fin, _, n, P_l = x.shape
        Fout = Fin if self.Fout is None else self.Fout
        n_terms = self.K + self._n_terms_offset
        st = self.graph.deep_stencil(self._scale, n_terms)
        if st is None:
            raise ValueError("layout='cface' requires the deep stencil path")

        if self.initializer is None:
            init = nn.initializers.truncated_normal(
                stddev=self._default_std(Fin, Fout), lower=-2.0, upper=2.0
            )
        else:
            init = self.initializer
        kernel = self.param("kernel", init, (Fin * n_terms, Fout), jnp.float32)
        tables = self.variable(
            "graph_tables", "stencil", stencil_tables, st
        ).value
        y = stencil_graph_conv_cface(
            st, x, kernel, n_terms, self.basis_kind, tables=tables
        )
        if self.use_bn:
            y = _CfaceBatchNorm(
                off=st.n_steps,
                use_running_average=not training,
                axis_name=self.bn_axis_name,
                name="bn",
            )(y)
        if self.use_bias:
            bias = self.param("bias", nn.initializers.zeros, (1, 1, Fout), jnp.float32)
            y = y + bias.reshape(1, Fout, 1, 1, 1)
        act = resolve_activation(self.activation)
        if act is not None:
            y = act(y)
        return y


class ChebyshevConv(_GraphPolyConv):
    """Chebyshev graph conv; spectrum rescale 0.75, recurrence and kernel
    layout per ``gnn_layers.py:64-72,131-150``."""

    _scale: ClassVar[float] = 0.75
    _basis: ClassVar = staticmethod(spmv.chebyshev_basis)
    _basis_kind: ClassVar[str] = "cheby"

    def _default_std(self, Fin, Fout):
        # gnn_layers.py:92-93
        return 1.0 / np.sqrt(Fin * (self.K + 0.5) / 2.0)


class MonomialConv(_GraphPolyConv):
    """Monomial graph conv; rescale 1.0 (``gnn_layers.py:219`` with the
    utils.rescale_L default), basis ``gnn_layers.py:287-290``."""

    _scale: ClassVar[float] = 1.0
    _basis: ClassVar = staticmethod(spmv.monomial_basis)
    _basis_kind: ClassVar[str] = "mono"

    def _default_std(self, Fin, Fout):
        # gnn_layers.py:243
        return 0.1


class BernsteinConv(_GraphPolyConv):
    """Bernstein graph conv (arXiv:2106.10994); rescale 0.75, K+1 terms,
    kernel shape [(K+1)*Fin, Fout] per ``gnn_layers.py:469-508``."""

    _scale: ClassVar[float] = 0.75
    _basis: ClassVar = staticmethod(spmv.bernstein_basis)
    _basis_kind: ClassVar[str] = "bern"
    _n_terms_offset: ClassVar[int] = 1

    def _default_std(self, Fin, Fout):
        # gnn_layers.py:497
        return np.sqrt(6.0 / (Fin + Fout))


_CONV_TYPES = {"CHEBY": ChebyshevConv, "MONO": MonomialConv}


class ResidualLayer(nn.Module):
    """``out = act(layer2(norm1(layer1(x))) + alpha * x)`` (or the act-before
    variant), two CHEBY or MONO sublayers — parity with ``GCNN_ResidualLayer``
    (``gnn_layers.py:312-413``)."""

    graph: SphereGraph
    layer_type: str
    layer_kwargs: Any  # dict-like of conv kwargs (K, activation, ...)
    activation: Optional[Union[str, Callable]] = None
    act_before: bool = False
    use_bn: bool = False
    norm_type: str = "batch_norm"
    bn_kwargs: Optional[Any] = None
    alpha: float = 1.0
    bn_axis_name: Optional[str] = None
    shard_cfg: Optional[Any] = None
    layout: str = "nest"

    def __post_init__(self):
        super().__post_init__()
        if self.layer_type not in _CONV_TYPES:
            raise IOError(f"Layertype not understood: {self.layer_type}")
        if self.use_bn and self.norm_type not in ("batch_norm", "layer_norm"):
            raise ValueError(f"norm_type <{self.norm_type}> not understood!")
        # validate eagerly like the reference (gnn_layers.py:348-353)
        resolve_activation(self.activation)

    @nn.compact
    def __call__(self, x, training=False):
        kwargs = dict(self.layer_kwargs or {})
        kwargs.pop("L", None)
        kwargs.pop("n_matmul_splits", None)
        conv_cls = _CONV_TYPES[self.layer_type]
        layer1 = conv_cls(graph=self.graph, bn_axis_name=self.bn_axis_name,
                          shard_cfg=self.shard_cfg, layout=self.layout,
                          name="layer1", **kwargs)
        layer2 = conv_cls(graph=self.graph, bn_axis_name=self.bn_axis_name,
                          shard_cfg=self.shard_cfg, layout=self.layout,
                          name="layer2", **kwargs)

        bn_kwargs = dict(self.bn_kwargs or {})
        bn_kwargs.pop("axis", None)  # (B, M, F) -> always normalize features
        # the reference instantiates plain Keras normalization layers here
        # (gnn_layers.py:375-382), whose DEFAULTS differ from core.BatchNorm:
        # epsilon=1e-3 (both kinds), momentum=0.99 + affine (batch norm).
        # Apply those defaults so outputs match the TF2 reference to <1e-5;
        # explicit bn_kwargs still override.
        bn_kwargs.setdefault("epsilon", 1e-3)
        if self.norm_type == "batch_norm":
            bn_kwargs.setdefault("momentum", 0.99)
            bn_kwargs.setdefault("use_bias", True)
            bn_kwargs.setdefault("use_scale", True)

        def norm(name):
            if self.layout == "cface":
                if self.norm_type == "layer_norm":
                    # per-pixel feature norm: axes move to position 1
                    return nn.LayerNorm(
                        name=name, reduction_axes=1, feature_axes=1,
                        **bn_kwargs,
                    )
                conv_cls0 = _CONV_TYPES[self.layer_type]
                n_terms0 = self.layer_kwargs["K"] + conv_cls0._n_terms_offset
                # halo depth of the sublayers' cface geometry
                h = self.graph.stencil_radius * (n_terms0 - 1)
                return _CfaceBatchNorm(
                    off=h,
                    use_running_average=not training,
                    axis_name=self.bn_axis_name,
                    name=name,
                    **{k: v for k, v in bn_kwargs.items()
                       if k in ("momentum", "epsilon", "use_bias", "use_scale")},
                )
            if self.norm_type == "layer_norm":
                return nn.LayerNorm(name=name, **bn_kwargs)
            return nn.BatchNorm(
                use_running_average=not training,
                axis_name=self.bn_axis_name,
                name=name,
                **bn_kwargs,
            )

        y = layer1(x, training=training)
        if self.use_bn:
            y = norm("bn1")(y)
        y = layer2(y, training=training)
        if self.use_bn:
            y = norm("bn2")(y)

        act = resolve_activation(self.activation)
        if act is None:
            return y + x
        if self.act_before:
            return act(y) + self.alpha * x
        return act(y + self.alpha * x)


class HealpyPool(nn.Module):
    """NEST-hierarchy pooling by 4^p: reshape + max/mean over child blocks.
    Parity with ``healpy_layers.py:20-84`` (and numerically with
    ``hp.ud_grade`` for AVG)."""

    p: int
    pool_type: str = "MAX"
    layout: str = "nest"
    cface_off: int = 0  # lane offset of the incoming cface geometry
    cface_off_out: int = 0  # lane offset to emit (the next conv's halo)

    def __post_init__(self):
        super().__post_init__()
        if not self.p >= 1:
            raise IOError("The reduction factors has to be at least 1!")
        if self.pool_type not in ("MAX", "AVG"):
            raise IOError(f"Pooling type not understood: {self.pool_type}")

    @property
    def filter_size(self):
        return int(4**self.p)

    @nn.compact
    def __call__(self, x, training=False):
        if self.layout == "cface":
            # spatial 2^p x 2^p reduce on the interior + re-embed for the
            # next conv's geometry
            from ..ops.stencil import cfp_geometry

            B, F, _, n, _ = x.shape
            sp = 2**self.p
            xi = x[:, :, :, :, self.cface_off : self.cface_off + n]
            blocks = xi.reshape(B, F, 12, n // sp, sp, n // sp, sp)
            reducer = jnp.max if self.pool_type == "MAX" else jnp.mean
            y = reducer(blocks, axis=(4, 6))  # (B, F, 12, n/sp, n/sp)
            n2 = n // sp
            off = self.cface_off_out
            P_out = cfp_geometry(n2, off)
            return jnp.concatenate(
                [
                    jnp.zeros((B, F, 12, n2, off), y.dtype),
                    y,
                    jnp.zeros((B, F, 12, n2, P_out - n2 - off), y.dtype),
                ],
                axis=4,
            )
        B, M, F = x.shape
        fs = self.filter_size
        if M % fs != 0:
            raise IOError(f"Input shape {x.shape} not compatible with the filter size {fs}")
        if self.layout == "face":
            # a NEST parent block is a 2^p x 2^p spatial tile of the face
            n = nside_of_axis(M)
            sp = 2**self.p
            blocks = x.reshape(B, 12, n // sp, sp, n // sp, sp, F)
            reducer = jnp.max if self.pool_type == "MAX" else jnp.mean
            return reducer(blocks, axis=(3, 5)).reshape(B, M // fs, F)
        blocks = x.reshape(B, M // fs, fs, F)
        if self.pool_type == "MAX":
            return jnp.max(blocks, axis=2)
        return jnp.mean(blocks, axis=2)


class HealpyPseudoConv(nn.Module):
    """Learnable 4^p -> 1 downsampling: Conv1D with kernel == stride is a
    blocked matmul ``(B, M/4^p, 4^p * Fin) @ (4^p * Fin, Fout)``.
    Parity with ``healpy_layers.py:87-146`` (Conv1D default glorot-uniform
    kernel + zero bias)."""

    p: int
    Fout: int
    kernel_initializer: Optional[Callable] = None
    use_bias: bool = True
    layout: str = "nest"
    cface_off: int = 0
    cface_off_out: int = 0

    def __post_init__(self):
        super().__post_init__()
        if not self.p >= 1:
            raise IOError("The reduction factors has to be at least 1!")

    @property
    def filter_size(self):
        return int(4**self.p)

    @nn.compact
    def __call__(self, x, training=False):
        if self.layout == "cface":
            return self._call_cface(x)
        B, M, Fin = x.shape
        fs = self.filter_size
        if M % fs != 0:
            raise IOError(f"Input shape {x.shape} not compatible with the filter size {fs}")
        init = self.kernel_initializer or nn.initializers.glorot_uniform()
        # params always stored in NEST tap order -> checkpoints are
        # layout-independent
        kernel = self.param("kernel", init, (fs * Fin, self.Fout), jnp.float32)
        if self.layout == "face":
            n = nside_of_axis(M)
            sp = 2**self.p
            blocks = x.reshape(B, 12, n // sp, sp, n // sp, sp, Fin)
            blocks = jnp.transpose(blocks, (0, 1, 2, 4, 3, 5, 6))
            x3d = blocks.reshape(B, M // fs, fs * Fin)
            perm = _raster_to_morton_taps(self.p)
            k_face = kernel.reshape(fs, Fin, self.Fout)[perm].reshape(
                fs * Fin, self.Fout
            )
            y = jnp.dot(x3d, k_face.astype(x.dtype), precision=config.precision())
        else:
            y = jnp.dot(
                x.reshape(B, M // fs, fs * Fin), kernel.astype(x.dtype),
                precision=config.precision(),
            )
        if self.use_bias:
            bias = self.param("bias", nn.initializers.zeros, (self.Fout,), jnp.float32)
            y = y + bias
        return y

    def _call_cface(self, x):
        """Blocked matmul on the interior of the cface layout + re-embed."""
        from ..ops.stencil import cfp_geometry

        B, Fin, _, n, _ = x.shape
        fs = self.filter_size
        sp = 2**self.p
        init = self.kernel_initializer or nn.initializers.glorot_uniform()
        kernel = self.param("kernel", init, (fs * Fin, self.Fout), jnp.float32)
        perm = _raster_to_morton_taps(self.p)
        # raster-tap order (p, q): matches the face-layout path numerically
        k_face = kernel.reshape(fs, Fin, self.Fout)[perm].reshape(
            sp, sp, Fin, self.Fout
        )
        xi = x[:, :, :, :, self.cface_off : self.cface_off + n]
        blocks = xi.reshape(B, Fin, 12, n // sp, sp, n // sp, sp)
        y = jnp.einsum(
            "bfgxpyq,pqfo->bogxy", blocks, k_face.astype(x.dtype),
            preferred_element_type=jnp.float32, precision=config.precision(),
        ).astype(x.dtype)
        if self.use_bias:
            bias = self.param("bias", nn.initializers.zeros, (self.Fout,), jnp.float32)
            y = y + bias.reshape(1, self.Fout, 1, 1, 1)
        n2 = n // sp
        off = self.cface_off_out
        P_out = cfp_geometry(n2, off)
        return jnp.concatenate(
            [
                jnp.zeros((B, self.Fout, 12, n2, off), y.dtype),
                y,
                jnp.zeros((B, self.Fout, 12, n2, P_out - n2 - off), y.dtype),
            ],
            axis=4,
        )


class HealpyPseudoConv_Transpose(nn.Module):
    """Learnable 1 -> 4^p upsampling (transpose of the pseudo conv): each
    coarse pixel emits a 4^p block, ``y[b, m*4^p + j, o] = sum_f x[b, m, f] *
    W[j, f, o] + b[o]``.  Parity with the Conv2DTranspose formulation at
    ``healpy_layers.py:149-216``."""

    p: int
    Fout: int
    kernel_initializer: Optional[Callable] = None
    use_bias: bool = True
    layout: str = "nest"
    cface_off: int = 0
    cface_off_out: int = 0

    def __post_init__(self):
        super().__post_init__()
        if not self.p >= 1:
            raise IOError("The boost factors has to be at least 1!")

    @property
    def filter_size(self):
        return int(4**self.p)

    @nn.compact
    def __call__(self, x, training=False):
        if self.layout == "cface":
            return self._call_cface(x)
        B, M, Fin = x.shape
        fs = self.filter_size
        init = self.kernel_initializer or nn.initializers.glorot_uniform()
        # params always stored in NEST tap order (layout-independent ckpts)
        kernel = self.param("kernel", init, (fs, Fin, self.Fout), jnp.float32)
        if self.layout == "face":
            n = nside_of_axis(M)
            sp = 2**self.p
            perm = _raster_to_morton_taps(self.p)
            k_face = kernel[perm]  # (fs raster taps, Fin, Fout)
            y = jnp.einsum(
                "bmf,jfo->bmjo", x, k_face.astype(x.dtype),
                preferred_element_type=jnp.float32, precision=config.precision(),
            ).astype(x.dtype)
            # (B, 12, n, n, sp, sp, Fout): emit each coarse pixel's tile
            y = y.reshape(B, 12, n, n, sp, sp, self.Fout)
            y = jnp.transpose(y, (0, 1, 2, 4, 3, 5, 6))
            y = y.reshape(B, M * fs, self.Fout)
        else:
            y = jnp.einsum(
                "bmf,jfo->bmjo", x, kernel.astype(x.dtype),
                preferred_element_type=jnp.float32, precision=config.precision(),
            ).astype(x.dtype)
            y = y.reshape(B, M * fs, self.Fout)
        if self.use_bias:
            bias = self.param("bias", nn.initializers.zeros, (self.Fout,), jnp.float32)
            y = y + bias
        return y

    def _call_cface(self, x):
        """Each coarse interior pixel emits a 2^p x 2^p tile; re-embed."""
        from ..ops.stencil import cfp_geometry

        B, Fin, _, n, _ = x.shape
        fs = self.filter_size
        sp = 2**self.p
        init = self.kernel_initializer or nn.initializers.glorot_uniform()
        kernel = self.param("kernel", init, (fs, Fin, self.Fout), jnp.float32)
        perm = _raster_to_morton_taps(self.p)
        k_face = kernel[perm].reshape(sp, sp, Fin, self.Fout)
        xi = x[:, :, :, :, self.cface_off : self.cface_off + n]
        y = jnp.einsum(
            "bfgxy,pqfo->bogxpyq", xi, k_face.astype(x.dtype),
            preferred_element_type=jnp.float32, precision=config.precision(),
        ).astype(x.dtype)
        n2 = n * sp
        y = y.reshape(B, self.Fout, 12, n2, n2)
        if self.use_bias:
            bias = self.param("bias", nn.initializers.zeros, (self.Fout,), jnp.float32)
            y = y + bias.reshape(1, self.Fout, 1, 1, 1)
        off = self.cface_off_out
        P_out = cfp_geometry(n2, off)
        return jnp.concatenate(
            [
                jnp.zeros((B, self.Fout, 12, n2, off), y.dtype),
                y,
                jnp.zeros((B, self.Fout, 12, n2, P_out - n2 - off), y.dtype),
            ],
            axis=4,
        )


class Flatten(nn.Module):
    """(B, M, F) -> (B, M*F); drop-in for the tf.keras.layers.Flatten used in
    reference model heads (``tests/test_healpy_networks.py:37``)."""

    @nn.compact
    def __call__(self, x, training=False):
        return x.reshape(x.shape[0], -1)


class Dense(nn.Module):
    """Dense head layer with optional activation (tf.keras.layers.Dense
    analogue for model heads)."""

    features: int
    activation: Optional[Union[str, Callable]] = None
    use_bias: bool = True

    @nn.compact
    def __call__(self, x, training=False):
        y = nn.Dense(self.features, use_bias=self.use_bias, name="dense")(x)
        act = resolve_activation(self.activation)
        return act(y) if act is not None else y
