"""HealpyGCNN: the model assembler.

Re-design of the reference assembler
(``/root/reference/src/deepsphere/healpy_networks.py:14-167``): scans the
layer list for resolution changes, validates the pixel-index set against the
NEST hierarchy, builds one :class:`~deepsphere_tpu.graph.SphereGraph` per
resolution level (memoized — the reference rebuilds the graph for every
layer), instantiates the deferred graph layers and wires everything into a
single module (:mod:`deepsphere_tpu.nn.core`).

The wrapper keeps a Keras-like stateful surface (``build`` / ``__call__`` /
``summary`` / ``save_weights`` / ``load_weights`` — parity with the usage in
``/root/reference/tests/test_healpy_networks.py``) on top of the functional
core (``init`` / ``apply``), so both idioms work:

    model = HealpyGCNN(nside, indices, layers)
    variables = model.init(jax.random.key(0), x)        # functional
    y = model.apply(variables, x)

    model.build(input_shape=(B, n_pix, F))               # stateful
    y = model(x)
"""

from __future__ import annotations

import inspect
from typing import Any, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .._logger import logger
from ..graph import build_sphere_graph
from ..nn import core as nn
from ..nn.healpy_layers import (
    Healpy_ViT,
    HealpyPool,
    HealpyPseudoConv,
    HealpyPseudoConv_Transpose,
    _DeferredLayer,
)
from ..nn.transformers import GraphViT
from ..sphere import healpix as hp
from ..sphere.indexing import check_indices_consistent, transform_indices
from ..utils import count_params, format_summary

__all__ = ["HealpyGCNN", "SequentialModel"]


def _accepts_training(layer):
    try:
        sig = inspect.signature(type(layer).__call__)
        return "training" in sig.parameters
    except (TypeError, ValueError):
        return False


class SequentialModel(nn.Module):
    """Sequential container passing ``training`` to layers that accept it.

    ``layers`` maps STABLE names to modules (each runs as the child
    ``layers_<key>``, so parameter/checkpoint trees do not depend on which
    internal layout the assembler chose or how many layout converters it
    inserted); ``order`` fixes the execution order.

    Each layer runs under a ``jax.named_scope`` so per-layer costs show up
    in ``jax.profiler`` traces (the reference has no tracing at all —
    SURVEY.md §5)."""

    layers: Any  # dict name -> module
    order: Tuple[str, ...]
    remat: bool = False  # per-layer jax.checkpoint: recompute activations
    # on the backward pass instead of storing them — trades ~1 extra
    # forward of FLOPs for O(depth) -> O(1) activation memory, the standard
    # move for training deep stacks at nside >= 512

    @nn.compact
    def __call__(self, x, training=False):
        def _run(mdl, xx):
            if _accepts_training(mdl):
                return mdl(xx, training=training)
            return mdl(xx)

        for key in self.order:
            layer = self.layers[key].clone(name=f"layers_{key}")
            with jax.named_scope(f"{type(layer).__name__}_{key}"):
                if self.remat:
                    x = nn.remat(_run)(layer, x)
                else:
                    x = _run(layer, x)
        return x


def _layer_display_name(layer, counters):
    """Keras-style snake-case auto names; the two names the reference test
    suite looks up (``chebyshev``, ``gcnn__residual_layer``) are preserved."""
    cls = type(layer).__name__
    base = {
        "ChebyshevConv": "chebyshev",
        "MonomialConv": "monomial",
        "BernsteinConv": "bernstein",
        "ResidualLayer": "gcnn__residual_layer",
        "HealpyPool": "healpy_pool",
        "HealpyPseudoConv": "healpy_pseudo_conv",
        "HealpyPseudoConv_Transpose": "healpy_pseudo_conv__transpose",
        "GraphViT": "graph_vit",
        "Healpy_ViT": "graph_vit",
        "GraphTransformer": "graph_transformer",
        "HealpySmoothing": "healpy_smoothing",
        "Flatten": "flatten",
        "Dense": "dense",
    }.get(cls, cls.lower())
    n = counters.get(base, 0)
    counters[base] = n + 1
    return base if n == 0 else f"{base}_{n}"


class HealpyGCNN:
    """A graph convolutional network on HEALPix maps.

    :param nside: nside of the input maps
    :param indices: 1d array of NEST pixel ids covered by the input
    :param layers: list of layer specs — deferred graph layers
        (``HealpyChebyshev`` & co.), concrete resolution layers
        (``HealpyPool`` & co.), or any :class:`deepsphere_tpu.nn.core.Module`
    :param n_neighbors: kNN graph degree; 8 (default), 20, 40 or 60
    :param max_batch_size, initial_Fin: accepted for API parity with the
        reference; XLA has no 2^31 SpMM limit so no matmul splitting is
        needed (``healpy_networks.py:125-137``)
    :param graph_cache_dir: optional on-disk cache for built graphs
    :param kernel_width: optional Gaussian kernel width override for the
        graph edge weights
    :param remat: checkpoint every layer (``jax.checkpoint`` via
        ``core.remat``): the backward pass recomputes activations instead of
        storing them — one extra forward of FLOPs for O(1) activation
        memory, the standard trade for training deep stacks at nside >= 512
    """

    def __init__(
        self,
        nside,
        indices,
        layers,
        n_neighbors=8,
        max_batch_size=None,
        initial_Fin=None,
        graph_cache_dir=None,
        kernel_width=None,
        shard_cfg=None,
        graph_method="auto",
        internal_layout="auto",
        remat=False,
    ):
        logger.info(
            "WARNING: This network assumes that everything concerning healpy "
            "is in NEST ordering..."
        )
        if n_neighbors not in [8, 20, 40, 60]:
            raise NotImplementedError(
                f"The requested number of neighbors {n_neighbors} is nor supported. "
                f"Choose either 8, 20, 40 or 60."
            )

        self._remat = bool(remat)
        self.nside_in = nside
        self.indices_in = np.asarray(indices, dtype=np.int64)
        self.layers_in = list(layers)
        self.n_neighbors = n_neighbors
        self.max_batch_size = max_batch_size
        self._graph_cache_dir = graph_cache_dir
        self._kernel_width = kernel_width
        self.shard_cfg = shard_cfg
        if graph_method not in ("auto", "grid", "knn"):
            raise ValueError(f"graph_method must be auto/grid/knn, got {graph_method}")
        self._graph_method = graph_method

        # resolution scan (healpy_networks.py:51-58)
        self.reduction_fac = 1.0
        for layer in self.layers_in:
            if isinstance(layer, (HealpyPool, HealpyPseudoConv, GraphViT)):
                self.reduction_fac *= 2**layer.p
            if isinstance(layer, HealpyPseudoConv_Transpose):
                self.reduction_fac /= 2**layer.p

        self.nside_out = int(self.nside_in // self.reduction_fac)
        if self.nside_out < 1:
            raise ValueError(
                "With the given input, the layers would reduce the nside below zero!"
                "Use less layers that reduce the nside, e.g. HealpyPool or "
                "HealpyPseudoConv..."
            )
        if not hp.isnsideok(self.nside_out, nest=True):
            raise ValueError(
                f"The ouput of the network does not have a valid nside {self.nside_out}..."
            )
        logger.info(
            f"Detected a reduction factor of {self.reduction_fac}, the input with "
            f"nside {self.nside_in} will be transformed to {self.nside_out} during "
            f"a forward pass. Checking for consistency with indices..."
        )

        # index consistency (healpy_networks.py:73-88)
        if not check_indices_consistent(self.indices_in, self.nside_in, self.nside_out):
            raise ValueError(
                "With the given indices it would not be possible to properly reduce "
                "the input maps with the reduction factor determined by the layers. "
                "Use the function <extend_indices> from utils with the determined "
                "minimal nside to make your set of indices compatible..."
            )
        logger.info("indices seem consistent...")

        # per-layer build with graph memoization per resolution level
        self.layers_use = []
        self.layer_names = []
        self.graphs = {}
        counters = {}
        current_nside = self.nside_in
        current_indices = self.indices_in

        for layer in self.layers_in:
            if isinstance(layer, _DeferredLayer) and layer.needs == "res":
                # resolution-only layers (deferred HealpySmoothing): no
                # graph Laplacian build, just the current nside/indices
                actual = layer._get_layer_res(
                    current_nside, current_indices,
                    cache_dir=self._graph_cache_dir,
                )
                self.layers_use.append(actual)
            elif isinstance(layer, _DeferredLayer):
                graph = self._get_graph(current_nside, current_indices)
                extra = {}
                if shard_cfg is not None and layer.needs == "L":
                    extra["shard_cfg"] = shard_cfg
                elif (shard_cfg is not None and layer.needs == "A"
                      and graph.n_pixels % shard_cfg.n_pixel_shards == 0):
                    # transformer: pixel-shard the edge-sparse attention
                    # (dst-partitioned edges + local segment sums; see
                    # parallel.attention_sharded).  Falls back to the
                    # replicated path when the pixel count does not tile.
                    extra["shard_cfg"] = shard_cfg
                actual = layer._get_layer(graph, **extra)
                self.layers_use.append(actual)
            elif isinstance(layer, (HealpyPool, HealpyPseudoConv, GraphViT)):
                new_nside = int(current_nside // 2**layer.p)
                current_indices = transform_indices(current_nside, new_nside, current_indices)
                current_nside = new_nside
                self.layers_use.append(layer)
            elif isinstance(layer, HealpyPseudoConv_Transpose):
                new_nside = int(current_nside * 2**layer.p)
                current_indices = transform_indices(current_nside, new_nside, current_indices)
                current_nside = new_nside
                self.layers_use.append(layer)
            else:
                self.layers_use.append(layer)
            self.layer_names.append(_layer_display_name(self.layers_use[-1], counters))

        self._plan_internal_layout(internal_layout)
        names = []
        counts = {}
        for k, layer in enumerate(self._module_layers):
            if k in self._index_to_module:
                nm = f"layer_{self._index_to_module[k]}"
            else:  # layout converter: parameter-free, positional name ok
                base = type(layer).__name__.lower()
                counts[base] = counts.get(base, 0) + 1
                nm = f"{base}_{counts[base] - 1}"
            names.append(nm)
        self.module = SequentialModel(
            layers=dict(zip(names, self._module_layers)), order=tuple(names),
            remat=bool(getattr(self, "_remat", False)),
        )
        self.variables = None

    def _plan_internal_layout(self, internal_layout):
        """Run as much of the model as possible in the conv's native layout.

        Two internal layouts exist, best first:

        * **cface** — channels-first padded face images (B, F, 12, n, P_l):
          a chain of convs / pools / pseudo-convs runs with no Morton
          permutation between layers (see ``ops.stencil.cfp_geometry``).
          Chosen for every maximal run of unsharded layers whose convs
          support the deep stencil (structural check only, so plans are
          platform-independent).
        * **face** — face-flat pixel axis (B, M, F): still removes the
          Morton permutations but pays per-conv transposes; used for
          stencil-capable convs that cannot run cface (e.g. Bernstein).

        Weight/checkpoint layout is unchanged in all modes (params are
        stored in NEST tap order).
        """
        from ..nn.layers import (
            CfaceReEmbed,
            CfaceToNest,
            FaceToNest,
            NestToCface,
            NestToFace,
            ResidualLayer,
            _GraphPolyConv,
        )
        from ..ops.stencil import cfp_structural_available

        def shardable(layer):
            """Pixel-sharded convs run the halo-sharded ELLPACK path in
            NEST order, so only unsharded convs join a cface segment."""
            return layer.shard_cfg is None

        def full_sphere(layer):
            g = layer.graph
            return g.n_pixels == hp.nside2npix(g.nside)

        def cface_info(layer):
            """("cf", h) for a cface-capable conv/residual, ("sif",) for a
            pass-through geometry layer, else None."""
            if internal_layout == "nest":
                return None
            if isinstance(layer, _GraphPolyConv):
                if not shardable(layer) or layer.conv_method not in (
                    "auto", "stencil",
                ) or not full_sphere(layer):
                    return None
                n_terms = layer.K + layer._n_terms_offset
                if layer._basis_kind not in ("cheby", "mono") or n_terms < 2:
                    return None
                st = layer.graph.deep_stencil(layer._scale, n_terms)
                if st is None or not cfp_structural_available(
                    st, layer._basis_kind, n_terms
                ):
                    return None
                return ("cf", st.n_steps)
            if isinstance(layer, ResidualLayer):
                scales = {"CHEBY": 0.75, "MONO": 1.0}
                if (not shardable(layer) or layer.layer_type not in scales
                        or not full_sphere(layer)):
                    return None
                K = dict(layer.layer_kwargs or {}).get("K", None)
                if K is None or K < 2:
                    return None
                st = layer.graph.deep_stencil(scales[layer.layer_type], K)
                kind = "cheby" if layer.layer_type == "CHEBY" else "mono"
                if st is None or not cfp_structural_available(st, kind, K):
                    return None
                return ("cf", st.n_steps)
            if isinstance(
                layer, (HealpyPool, HealpyPseudoConv, HealpyPseudoConv_Transpose)
            ):
                return ("sif",)
            return None

        def face_version(layer):
            if internal_layout == "nest":
                return None
            if isinstance(layer, _GraphPolyConv):
                if (
                    layer.shard_cfg is None
                    and layer.conv_method in ("auto", "stencil")
                    and full_sphere(layer)
                    and layer.graph.face_stencil(layer._scale) is not None
                ):
                    return layer.clone(layout="face")
                return None
            if isinstance(layer, ResidualLayer):
                conv_cls = {"CHEBY": 0.75, "MONO": 1.0}
                if (
                    layer.shard_cfg is None
                    and layer.layer_type in conv_cls
                    and full_sphere(layer)
                    and layer.graph.face_stencil(conv_cls[layer.layer_type]) is not None
                ):
                    return layer.clone(layout="face")
                return None
            return None  # pool/pseudo handled below (stay-in-face only)

        stay_in_face = (HealpyPool, HealpyPseudoConv, HealpyPseudoConv_Transpose)

        # 1) carve out cface segments: maximal runs of (cf | sif) layers
        #    containing at least one conv
        infos = [cface_info(l) for l in self.layers_use]
        n_layers = len(self.layers_use)
        seg_of = [-1] * n_layers
        segments = []
        i = 0
        while i < n_layers:
            if infos[i] is None:
                i += 1
                continue
            j = i
            while j < n_layers and infos[j] is not None:
                j += 1
            if any(infos[t][0] == "cf" for t in range(i, j)):
                for t in range(i, j):
                    seg_of[t] = len(segments)
                segments.append((i, j))
            i = j

        def next_cf_h(t, j):
            for u in range(t, j):
                if infos[u][0] == "cf":
                    return infos[u][1]
            return 0

        # 2) emit, falling back to the face layout outside cface segments
        self._module_layers = []
        self._module_index = []
        self._index_to_module = {}
        in_face = False
        cur_off = 0
        for i, layer in enumerate(self.layers_use):
            if seg_of[i] >= 0:
                a, j = segments[seg_of[i]]
                if in_face:
                    self._module_layers.append(FaceToNest())
                    in_face = False
                if i == a:  # segment entry
                    cur_off = next_cf_h(a, j)
                    self._module_layers.append(NestToCface(off=cur_off))
                if infos[i][0] == "cf":
                    h = infos[i][1]
                    if cur_off != h:
                        self._module_layers.append(
                            CfaceReEmbed(off_in=cur_off, off_out=h)
                        )
                    actual = layer.clone(layout="cface")
                    cur_off = h
                else:  # sif: pool / pseudo-conv — re-embeds for the next conv
                    off_out = next_cf_h(i + 1, j)
                    actual = layer.clone(
                        layout="cface", cface_off=cur_off,
                        cface_off_out=off_out,
                    )
                    cur_off = off_out
                self._module_layers.append(actual)
                self._module_index.append(len(self._module_layers) - 1)
                self._index_to_module[len(self._module_layers) - 1] = i
                self.layers_use[i] = actual
                if i == j - 1:  # segment exit
                    self._module_layers.append(CfaceToNest(off=cur_off))
                continue

            fc = face_version(layer)
            if fc is not None:
                if not in_face:
                    self._module_layers.append(NestToFace())
                    in_face = True
                actual = fc
            elif in_face and isinstance(layer, stay_in_face):
                actual = layer.clone(layout="face")
            else:
                if in_face:
                    self._module_layers.append(FaceToNest())
                    in_face = False
                actual = layer
            # stable, plan-independent parameter naming: checkpoints must
            # not depend on which internal layout the assembler chose
            self._module_layers.append(actual)
            self._module_index.append(len(self._module_layers) - 1)
            self._index_to_module[len(self._module_layers) - 1] = i
            self.layers_use[i] = actual
        if in_face:
            self._module_layers.append(FaceToNest())

    # ------------------------------------------------------------------
    # graph bookkeeping
    # ------------------------------------------------------------------

    def _get_graph(self, nside, indices):
        key = (nside, hash(np.ascontiguousarray(indices).tobytes()))
        if key not in self.graphs:
            # "auto": the grid/ring construction (stencil-compatible ->
            # structured conv path, O(M) build, exact
            # masked-sky support) whenever a template exists for k — else
            # the kNN graph of the reference's pygsp backend.  Pass
            # graph_method="knn" for strict reference-graph semantics;
            # exact kNN ALSO rides the fast stencil path via capture-window
            # extraction (KNN_CAPTURE_RADIUS + SphereGraph.stencil_radius,
            # pinned by tests/test_knn_stencil.py): rows where the kNN edge set
            # escapes the radius-r template get exact per-row corrections,
            # so only pathological graphs fall back to the gather conv.
            from ..graph.laplacian import GRID_RADIUS

            method = self._graph_method
            if method == "auto":
                method = "grid" if self.n_neighbors in GRID_RADIUS else "knn"
            self.graphs[key] = build_sphere_graph(
                nside,
                indices,
                k=self.n_neighbors,
                lap_type="normalized",
                kernel_width=self._kernel_width,
                cache_dir=self._graph_cache_dir,
                method=method,
            )
        return self.graphs[key]

    # ------------------------------------------------------------------
    # functional API
    # ------------------------------------------------------------------

    def init(self, rng, x, training=False):
        # deliberately NOT jitted: init materializes the "graph_tables"
        # collection (100s of MB at large nside), which under jit would be
        # baked into the init HLO as constants
        if isinstance(rng, int):
            rng = jax.random.key(rng)
        return self.module.init(rng, x, training=False)

    def apply(self, variables, x, training=False, mutable=None, rngs=None):
        if mutable is None:
            mutable = ["batch_stats"] if training else False
        if rngs is None and mutable in (False, ["batch_stats"]):
            # cached jitted fast paths for the two common calls
            if not hasattr(self, "_jit_apply"):
                self._jit_apply = {
                    False: jax.jit(
                        lambda v, xx: self.module.apply(v, xx, training=False)
                    ),
                    True: jax.jit(
                        lambda v, xx: self.module.apply(
                            v, xx, training=True, mutable=["batch_stats"]
                        )
                    ),
                }
            return self._jit_apply[bool(training)](variables, x)
        return self.module.apply(variables, x, training=training, mutable=mutable, rngs=rngs)

    # ------------------------------------------------------------------
    # Keras-like stateful surface
    # ------------------------------------------------------------------

    def build(self, input_shape, rng=0):
        x = jnp.zeros(input_shape, dtype=jnp.float32)
        self.variables = self.init(rng, x)
        self._built_input_shape = tuple(input_shape)
        return self.variables

    def __call__(self, x, training=False):
        if self.variables is None:
            self.build((int(x.shape[0]),) + tuple(x.shape[1:]))
        if training:
            y, updates = self.apply(self.variables, x, training=True, mutable=["batch_stats"])
            self.variables = {**self.variables, **updates}
            return y
        return self.apply(self.variables, x, training=False)

    def get_layer(self, name=None, index=None):
        """Layer instance by display name or position."""
        if index is not None:
            return self.layers_use[index]
        if name is not None:
            if name not in self.layer_names:
                raise ValueError(f"No such layer: {name}. Layers: {self.layer_names}")
            return self.layers_use[self.layer_names.index(name)]
        raise ValueError("Provide a layer name or index.")

    def summary(self, input_shape=None, line_length=None, print_fn=print):
        if input_shape is None:
            if self.variables is None:
                raise ValueError("Call build(input_shape) first or pass input_shape.")
            input_shape = self._built_input_shape
        if self.variables is not None:
            variables = self.variables
        else:
            variables = jax.eval_shape(
                lambda: self.init(0, jnp.zeros(tuple(input_shape), jnp.float32))
            )
        shapes = self._layer_output_shapes(input_shape)
        params = variables.get("params", {})
        rows = []
        for i, (name, layer) in enumerate(zip(self.layer_names, self.layers_use)):
            pkey = self.param_key(i)
            nparams = count_params(params[pkey]) if pkey in params else 0
            rows.append((name, type(layer).__name__, shapes.get(pkey, "?"), nparams))
        total = count_params(
            {k: v for k, v in variables.items() if k != "graph_tables"}
        )
        print_fn(format_summary("HealpyGCNN", rows, total))

    def param_key(self, index):
        """The submodule key for the user layer at ``index`` — stable
        across internal-layout plans (dict-named children)."""
        return f"layers_layer_{index}"

    def _layer_output_shapes(self, input_shape):
        """Map submodule key -> output shape via a shape-only trace."""

        def run():
            x = jnp.zeros(tuple(input_shape), jnp.float32)
            variables = self.module.init(jax.random.key(0), x, training=False)
            _, state = self.module.apply(
                variables,
                x,
                training=False,
                capture_intermediates=True,
                mutable=["intermediates", "batch_stats"],
            )
            return state["intermediates"]

        inter = jax.eval_shape(run)
        shapes = {}
        for key, sub in inter.items():
            if isinstance(sub, dict) and "__call__" in sub:
                out = sub["__call__"][0]
                if hasattr(out, "shape"):
                    shapes[key] = tuple(out.shape)
        return shapes

    # ------------------------------------------------------------------
    # filter extraction + visualization
    # (parity with healpy_networks.py:190-385; pygsp replaced by
    #  viz.SphericalFilterBank over the layer's own graph)
    # ------------------------------------------------------------------

    def _resolve_conv_layer(self, layer):
        """Layer spec (index or display name) -> (index, layer instance)."""
        if isinstance(layer, int):
            idx = layer
        elif isinstance(layer, str):
            if layer not in self.layer_names:
                raise ValueError(f"No such layer: {layer}. Layers: {self.layer_names}")
            idx = self.layer_names.index(layer)
        else:
            raise ValueError("layer should be either string or int.")
        return idx, self.layers_use[idx]

    @staticmethod
    def _coeffs_from_kernel(kernel, K, ind_in=None, ind_out=None):
        """(Fin*K, Fout) kernel -> (K, Fout, Fin) coefficients — the reshape
        and slicing semantics of ``_get_filter_coeffs``
        (healpy_networks.py:190-212)."""
        kernel = np.asarray(kernel)
        Fout = kernel.shape[-1]
        coeffs = kernel.reshape((-1, K, Fout)).transpose([1, 2, 0])
        if ind_in is not None:
            coeffs = coeffs[:, :, np.atleast_1d(ind_in)]
        if ind_out is not None:
            coeffs = coeffs[:, np.atleast_1d(ind_out), :]
        return coeffs

    def get_filters(self, layer, ind_in=None, ind_out=None, return_weights=False):
        """Trained filters of a Chebyshev (or residual-of-Chebyshev) layer as
        :class:`~deepsphere_tpu.viz.SphericalFilterBank` objects (the
        ``get_gsp_filters`` analogue, healpy_networks.py:214-289).

        :param layer: layer index or display name
        :param return_weights: return the raw (K, Fout, Fin) coeff arrays
        :return: list of filter banks (two for a residual layer)
        """
        from ..nn.layers import ChebyshevConv, ResidualLayer
        from ..viz import SphericalFilterBank

        if self.variables is None:
            raise ValueError("Build the model first (model.build(input_shape)).")
        idx, lyr = self._resolve_conv_layer(layer)
        params = self.variables["params"].get(self.param_key(idx), {})

        if isinstance(lyr, ResidualLayer):
            if lyr.layer_type != "CHEBY":
                raise ValueError(
                    f"The requested layer ({layer}) is a residual layer of type "
                    f"{lyr.layer_type}; only CHEBY residual layers are supported..."
                )
            K = dict(lyr.layer_kwargs or {}).get("K")
            kernels = [params["layer1"]["kernel"], params["layer2"]["kernel"]]
            graph = lyr.graph
        elif isinstance(lyr, ChebyshevConv):
            K = lyr.K
            kernels = [params["kernel"]]
            graph = lyr.graph
        else:
            raise ValueError(
                f"The requested layer ({layer}) is of type {type(lyr).__name__}, "
                f"but only ChebyshevConv or ResidualLayer layers (with CHEBY "
                f"sublayers) are supported..."
            )

        weights = [self._coeffs_from_kernel(k, K, ind_in, ind_out) for k in kernels]
        if return_weights:
            return weights
        return [SphericalFilterBank(graph, w, kind="cheby") for w in weights]

    # pygsp-era name kept for drop-in compatibility
    get_gsp_filters = get_filters

    def plot_chebyshev_coeffs(self, layer, ind_in=None, ind_out=None, ax=None,
                              title="Chebyshev coefficients - layer {}"):
        """Scatter the Chebyshev coefficients of a layer
        (healpy_networks.py:291-310)."""
        import matplotlib.pyplot as plt

        weights = self.get_filters(layer, ind_in, ind_out, return_weights=True)
        if ax is None:
            ax = plt.gca()
        for weight in weights:
            K, Fout, Fin = weight.shape
            ax.plot(weight.reshape((K, Fin * Fout)), ".")
            ax.set_title(title.format(layer))
        return ax

    def plot_filters_spectral(self, layer, ind_in=None, ind_out=None, ax=None, **kwargs):
        """Spectral response of a layer's filters
        (healpy_networks.py:312-329)."""
        import matplotlib.pyplot as plt

        banks = self.get_filters(layer, ind_in=ind_in, ind_out=ind_out)
        if ax is None:
            ax = plt.gca()
        for bank in banks:
            x = np.linspace(-bank.scale, bank.scale, 200)
            resp = bank.evaluate(x)  # (Fout, Fin, n_x)
            # plot in the unrescaled eigenvalue domain [0, lmax]
            lam = (x / bank.scale + 1.0) * bank.graph.lmax / 2.0
            for fo in range(resp.shape[0]):
                for fi in range(resp.shape[1]):
                    ax.plot(lam, resp[fo, fi], **kwargs)
            ax.set_xlabel(r"$\lambda$")
            ax.set_ylabel(r"$\hat{g}(\lambda)$")
        return ax

    def plot_filters_section(self, layer, ind_in=None, ind_out=None, **kwargs):
        """Equator cross-sections of a layer's localized filters
        (healpy_networks.py:331-357)."""
        from ..viz import plot_filters_section as _pfs

        banks = self.get_filters(layer, ind_in=ind_in, ind_out=ind_out)
        order = banks[0].K
        return [_pfs(bank, order=order, **kwargs) for bank in banks]

    def plot_filters_gnomonic(self, layer, ind_in=None, ind_out=None, **kwargs):
        """Gnomonic views of a layer's localized filters
        (healpy_networks.py:359-385)."""
        from ..viz import plot_filters_gnomonic as _pfg

        banks = self.get_filters(layer, ind_in=ind_in, ind_out=ind_out)
        order = banks[0].K
        return [_pfg(bank, order=order, **kwargs) for bank in banks]

    # ------------------------------------------------------------------
    # Keras-style training surface (delegates to train.Trainer)
    # ------------------------------------------------------------------

    def compile(self, optimizer=1e-3, loss="sparse_categorical_crossentropy",
                metrics=(), data_sharding=None):
        from ..train import Trainer

        self._trainer = Trainer(
            self, optimizer=optimizer, loss=loss, metrics=metrics,
            data_sharding=data_sharding,
        )
        return self._trainer

    def _require_trainer(self):
        if getattr(self, "_trainer", None) is None:
            raise ValueError("Call compile(...) before fit/evaluate.")
        return self._trainer

    def fit(self, x, y, batch_size=16, epochs=1, validation_data=None,
            shuffle=True, verbose=1, callbacks=None):
        if self.variables is None:
            self.build((batch_size,) + tuple(np.asarray(x).shape[1:]))
        return self._require_trainer().fit(
            x, y, batch_size=batch_size, epochs=epochs,
            validation_data=validation_data, shuffle=shuffle, verbose=verbose,
            callbacks=callbacks,
        )

    def evaluate(self, x, y, batch_size=16, verbose=1):
        return self._require_trainer().evaluate(x, y, batch_size=batch_size, verbose=verbose)

    def predict(self, x, batch_size=16):
        if getattr(self, "_trainer", None) is not None:
            return self._trainer.predict(x, batch_size=batch_size)
        outs = []
        for start in range(0, np.asarray(x).shape[0], batch_size):
            outs.append(np.asarray(self(jnp.asarray(np.asarray(x)[start:start + batch_size]))))
        return np.concatenate(outs, axis=0)

    # ------------------------------------------------------------------
    # checkpointing (numpy .npz keyed by variable path)
    # ------------------------------------------------------------------

    def save_weights(self, path):
        """Write params/batch_stats to ``path`` as an ``.npz`` keyed by
        variable path (:func:`deepsphere_tpu.train.checkpoint.save_tree`).
        The "graph_tables" collection is deterministic precompute —
        excluded from checkpoints (it would add 100s of MB at large nside)."""
        from ..train.checkpoint import save_tree

        if self.variables is None:
            raise ValueError("Model has no variables yet; call build() first.")
        save_tree(path, {k: v for k, v in self.variables.items()
                         if k != "graph_tables"})

    def load_weights(self, path):
        from ..train.checkpoint import load_tree

        if self.variables is None:
            raise ValueError("Build the model before loading weights.")
        target = {k: v for k, v in self.variables.items() if k != "graph_tables"}
        restored = jax.tree_util.tree_map(jnp.asarray, load_tree(path, target))
        if "graph_tables" in self.variables:
            restored["graph_tables"] = self.variables["graph_tables"]
        self.variables = restored
        return self.variables

    def load_weights_from_reference(self, path):
        """Import a checkpoint written by the TF2 reference's
        ``HealpyGCNN.save_weights('*.weights.h5')`` — the reference's
        deployment unit (``tests/test_healpy_networks.py:133-152``) — into
        this (built) model.  See
        :func:`deepsphere_tpu.train.import_keras_h5`."""
        from ..train.import_ref import import_keras_h5

        self.variables = import_keras_h5(path, self)
        return self.variables

    # ------------------------------------------------------------------
    # serving export (self-contained StableHLO artifact)
    # ------------------------------------------------------------------

    def export_inference(self, *, batch_size=None, platforms=None):
        """Lower inference to a ``jax.export.Exported`` with weights and
        graph tables baked in — see :mod:`deepsphere_tpu.serve`."""
        from ..serve import export_inference

        return export_inference(
            self, batch_size=batch_size, platforms=platforms
        )

    def save_exported(self, path, *, batch_size=None, platforms=None):
        """Write a self-contained inference artifact (StableHLO) to
        ``path``; load it anywhere with
        :func:`deepsphere_tpu.serve.load_exported` (needs only jax)."""
        from ..serve import save_exported

        return save_exported(
            path, self, batch_size=batch_size, platforms=platforms
        )
