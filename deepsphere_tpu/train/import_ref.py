"""Import reference (deepsphere-cosmo-tf2) Keras checkpoints.

The reference's deployment unit is Keras ``model.save_weights(...)`` /
``load_weights`` on the ``HealpyGCNN(Sequential)`` model
(``/root/reference/tests/test_healpy_networks.py:133-152``).  Under Keras 3
that artifact is the ``*.weights.h5`` format: an HDF5 tree mirroring the
tracked-object graph, one group per stateful layer under ``/layers``, with
per-container class-name deduplication (first Chebyshev -> ``chebyshev``,
second -> ``chebyshev_1``, ...), nested sublayers stored by attribute name
(``bn``, ``layer1``, ``filter``) or under a ``layers`` list container, and
each layer's variables as ``vars/0..n`` in Keras build order.

This module maps that tree onto our variable tree so a model trained
with the TF2 reference can be served/fine-tuned here directly:

==============================  ============================================
reference layer (H5 group)      our layer / param subtree
==============================  ============================================
``chebyshev``                   ``ChebyshevConv``: ``vars/0`` -> ``kernel``
                                (Fin*K, Fout), ``vars/1`` -> ``bias``
                                (1,1,Fout); ``bn/vars/{0,1}`` -> batch_stats
                                ``bn.{mean,var}`` (the reference's conv BN is
                                ``center=False, scale=False`` —
                                ``gnn_layers.py:53``)
``monomial`` / ``bernstein``    same as ``chebyshev``
``gcnn__residual_layer``        ``ResidualLayer``: ``layer{1,2}/vars/0`` ->
                                ``layer{1,2}.kernel``; ``bn{1,2}/vars`` ->
                                affine BatchNorm (gamma, beta, moving_mean,
                                moving_variance) or LayerNorm (gamma, beta)
                                by the layer's ``norm_type``
``healpy_pseudo_conv``          ``HealpyPseudoConv``: Conv1D kernel
                                (fs, Fin, Fout) -> ``kernel`` (fs*Fin, Fout)
``healpy_pseudo_conv__transpose``  ``HealpyPseudoConv_Transpose``:
                                Conv2DTranspose kernel (1, fs, Fout, Fin) ->
                                ``kernel`` (fs, Fin, Fout)
``healpy__vi_t``                ``GraphViT``: Conv1D embed -> blocked-matmul
                                ``embed_kernel``; ``layers/`` blocks -> MHA
``graph__transformer``          ``GraphTransformer``: Dense ``embed`` +
                                ``layers/`` blocks -> MHA
``dense``                       ``Dense`` head: ``vars`` -> ``dense.{kernel,
                                bias}``
==============================  ============================================

Within a reference MHA block (``gnn_transformers.py:150-245``) the wq/wk/wv
projections live under the block's ``layers`` container as ``dense``,
``dense_1``, ``dense_2`` and the output projection as the block-level
``dense`` group (verified against live TF layer objects).

Stateless layers (``HealpyPool``, ``Flatten``, dropout, ``HealpySmoothing``
— whose kernel is a deterministic precompute, not a weight) have no H5
group and are skipped.
"""

from __future__ import annotations

import numpy as np

__all__ = ["import_keras_h5"]


# our layer class name -> the H5 top-level base group name (the
# snake_case of the REFERENCE class it corresponds to)
_BASE_NAME = {
    "ChebyshevConv": "chebyshev",
    "MonomialConv": "monomial",
    "BernsteinConv": "bernstein",
    "ResidualLayer": "gcnn__residual_layer",
    "HealpyPseudoConv": "healpy_pseudo_conv",
    "HealpyPseudoConv_Transpose": "healpy_pseudo_conv__transpose",
    "GraphViT": "healpy__vi_t",
    "Healpy_ViT": "healpy__vi_t",  # our user-facing subclass of GraphViT
    "GraphTransformer": "graph__transformer",
    "Dense": "dense",
}

# our layer classes that carry no weights in either framework
_STATELESS = {
    "HealpyPool", "Flatten", "Dropout", "HealpySmoothing", "Activation",
    "FaceToNest", "NestToFace", "CfaceReEmbed",
}


def _read_tree(h5group):
    """HDF5 group -> nested dict; ``vars`` groups become LISTS of arrays
    ordered by their integer dataset names (Keras build order)."""
    import h5py

    out = {}
    for key, item in h5group.items():
        if isinstance(item, h5py.Group):
            if key == "vars":
                out["vars"] = [
                    np.asarray(item[str(i)]) for i in range(len(item))
                ]
            else:
                out[key] = _read_tree(item)
        else:  # bare dataset (not observed in practice; keep it readable)
            out[key] = np.asarray(item)
    return out


def _has_weights(subtree):
    """Whether any actual weights live under this H5 subtree.  RNG state
    (``seed_generator`` groups, e.g. under dropout layers) doesn't count."""
    for key, item in subtree.items():
        if key == "seed_generator":
            continue
        if key == "vars":
            if len(item):
                return True
        elif isinstance(item, dict):
            if _has_weights(item):
                return True
    return False


def _conform(src, target, path):
    """Reshape ``src`` to the target leaf's shape (sizes must match)."""
    src = np.asarray(src)
    tgt_shape = tuple(np.shape(target))
    if int(np.prod(src.shape, dtype=np.int64)) != int(
        np.prod(tgt_shape, dtype=np.int64)
    ):
        raise ValueError(
            f"{path}: reference weight has shape {src.shape} "
            f"({src.size} elements) but the model expects {tgt_shape}"
        )
    return src.reshape(tgt_shape).astype(np.asarray(target).dtype)


def _norm_from_vars(vars_, kind, path):
    """Split a reference norm layer's ``vars`` list into (params, stats).

    Keras build order: BatchNormalization -> gamma, beta, moving_mean,
    moving_variance (affine) or moving_mean, moving_variance
    (center=False, scale=False); LayerNormalization -> gamma, beta.
    """
    if kind == "layer_norm":
        if len(vars_) != 2:
            raise ValueError(f"{path}: expected 2 LayerNorm vars, got {len(vars_)}")
        return {"scale": vars_[0], "bias": vars_[1]}, None
    if len(vars_) == 2:  # center=False, scale=False conv BN
        return None, {"mean": vars_[0], "var": vars_[1]}
    if len(vars_) == 4:
        return (
            {"scale": vars_[0], "bias": vars_[1]},
            {"mean": vars_[2], "var": vars_[3]},
        )
    raise ValueError(f"{path}: unexpected BatchNorm var count {len(vars_)}")


def _convert_conv(group, cur_params, layer, path):
    params = {"kernel": group["vars"][0]}
    if "bias" in cur_params:
        if len(group["vars"]) < 2:
            raise ValueError(f"{path}: model expects a bias but the "
                             f"reference layer saved none")
        params["bias"] = group["vars"][1]
    stats = None
    if "bn" in group:
        bn_params, bn_stats = _norm_from_vars(
            group["bn"]["vars"], "batch_norm", path + "/bn")
        if bn_params:  # reference conv BN is non-affine; tolerate affine
            params["bn"] = bn_params
        stats = {"bn": bn_stats}
    return params, stats


def _convert_residual(group, cur_params, layer, path):
    params = {
        "layer1": {"kernel": group["layer1"]["vars"][0]},
        "layer2": {"kernel": group["layer2"]["vars"][0]},
    }
    stats = {}
    norm_type = getattr(layer, "norm_type", "batch_norm")
    for bn in ("bn1", "bn2"):
        if bn in group:
            bn_params, bn_stats = _norm_from_vars(
                group[bn]["vars"], norm_type, f"{path}/{bn}")
            if bn_params:
                params[bn] = bn_params
            if bn_stats:
                stats[bn] = bn_stats
    return params, (stats or None)


def _convert_pseudo_conv(group, cur_params, layer, path):
    vars_ = group["filter"]["vars"]
    k = np.asarray(vars_[0])  # Conv1D kernel (fs, Fin, Fout)
    params = {"kernel": k.reshape(k.shape[0] * k.shape[1], k.shape[2])}
    if "bias" in cur_params:
        params["bias"] = vars_[1]
    return params, None


def _convert_pseudo_conv_t(group, cur_params, layer, path):
    vars_ = group["filter"]["vars"]
    k = np.asarray(vars_[0])  # Conv2DTranspose kernel (1, fs, Fout, Fin)
    params = {"kernel": k[0].transpose(0, 2, 1)}  # (fs, Fin, Fout)
    if "bias" in cur_params:
        params["bias"] = vars_[1]
    return params, None


def _convert_mha_block(block, path):
    """One reference MHA block group -> our MultiHeadAttention params."""
    out = {}
    proj_names = {"wq": "dense", "wk": "dense_1", "wv": "dense_2"}
    for ours, ref in proj_names.items():
        sub = block["layers"][ref]
        out[ours] = {"kernel": sub["vars"][0], "bias": sub["vars"][1]}
    out["dense"] = {
        "kernel": block["dense"]["vars"][0],
        "bias": block["dense"]["vars"][1],
    }
    for ln in ("layer_norm1", "layer_norm2"):
        if ln in block:
            out[ln] = {
                "scale": block[ln]["vars"][0],
                "bias": block[ln]["vars"][1],
            }
    return out


def _convert_attention(group, cur_params, layer, path, vit):
    params = {}
    ev = group["embed"]["vars"]
    if vit:  # Conv1D (fs, Fin, emb) -> blocked matmul (fs*Fin, emb)
        k = np.asarray(ev[0])
        params["embed_kernel"] = k.reshape(k.shape[0] * k.shape[1], k.shape[2])
        params["embed_bias"] = ev[1]
    else:  # Dense embed
        params["embed"] = {"kernel": ev[0], "bias": ev[1]}
    blocks = group.get("layers", {})
    if "add_position_embs" in blocks:
        params["pos_encoder"] = {
            "pos_embedding": blocks["add_position_embs"]["vars"][0]
        }
    i = 0
    while True:
        name = "multi_head_attention" if i == 0 else f"multi_head_attention_{i}"
        if name not in blocks:
            break
        params[f"mha_{i}"] = _convert_mha_block(blocks[name], f"{path}/{name}")
        i += 1
    return params, None


def _convert_dense(group, cur_params, layer, path):
    params = {"dense": {"kernel": group["vars"][0]}}
    if "bias" in cur_params.get("dense", {}):
        params["dense"]["bias"] = group["vars"][1]
    return params, None


_CONVERTERS = {
    "ChebyshevConv": _convert_conv,
    "MonomialConv": _convert_conv,
    "BernsteinConv": _convert_conv,
    "ResidualLayer": _convert_residual,
    "HealpyPseudoConv": _convert_pseudo_conv,
    "HealpyPseudoConv_Transpose": _convert_pseudo_conv_t,
    "GraphViT": lambda g, c, l, p: _convert_attention(g, c, l, p, vit=True),
    "Healpy_ViT": lambda g, c, l, p: _convert_attention(g, c, l, p, vit=True),
    "GraphTransformer": lambda g, c, l, p: _convert_attention(
        g, c, l, p, vit=False),
    "Dense": _convert_dense,
}


def _conform_tree(src, target, path):
    """Recursively conform ``src`` leaves to the target tree's shapes and
    verify every target param is covered."""
    if not isinstance(target, dict):
        return _conform(src, target, path)
    if not isinstance(src, dict):
        raise ValueError(f"{path}: expected a subtree, got a leaf")
    missing = sorted(set(target) - set(src))
    if missing:
        raise ValueError(
            f"{path}: reference checkpoint does not provide {missing} "
            f"(model/reference architecture mismatch)")
    extra = sorted(set(src) - set(target))
    if extra:
        raise ValueError(
            f"{path}: reference checkpoint provides {extra} the model "
            f"does not have (model/reference architecture mismatch)")
    return {k: _conform_tree(src[k], target[k], f"{path}/{k}") for k in target}


def import_keras_h5(path, model, variables=None):
    """Load a reference ``*.weights.h5`` checkpoint into a built model.

    Parameters
    ----------
    path : str
        A Keras-3 weights file written by the reference's
        ``HealpyGCNN.save_weights`` (``healpy_networks.py``; usage in
        ``tests/test_healpy_networks.py:133-152``).
    model : deepsphere_tpu.HealpyGCNN
        A model with the SAME user-layer sequence as the reference model
        that wrote the checkpoint.
    variables : dict, optional
        The variable tree to update; defaults to ``model.variables``
        (the model must be built).

    Returns
    -------
    dict
        A new variable tree with params/batch_stats replaced by the
        checkpoint's weights (graph_tables and anything else untouched).
    """
    import h5py

    if variables is None:
        variables = model.variables
    if variables is None:
        raise ValueError(
            "Build the model first (model.build(input_shape)) so the "
            "importer can conform the checkpoint to the parameter tree.")

    with h5py.File(path, "r") as f:
        if "layers" not in f:
            raise ValueError(
                f"{path} is not a Keras-3 .weights.h5 file (no /layers "
                "group). Legacy TF2 HDF5 checkpoints are not supported — "
                "re-export with a current Keras: model.save_weights("
                "'model.weights.h5').")
        tree = _read_tree(f["layers"])

    params = dict(variables.get("params", {}))
    batch_stats = dict(variables.get("batch_stats", {}))
    seen: dict = {}
    matched = set()

    for i, layer in enumerate(model.layers_use):
        cls = type(layer).__name__
        pkey = model.param_key(i)
        base = _BASE_NAME.get(cls)
        if base is None:
            if cls in _STATELESS or pkey not in params or not params[pkey]:
                continue
            raise NotImplementedError(
                f"layer {i} ({cls}) has parameters but no reference "
                f"checkpoint mapping")
        n = seen.get(base, 0)
        seen[base] = n + 1
        gname = base if n == 0 else f"{base}_{n}"
        if gname not in tree:
            raise ValueError(
                f"layer {i} ({cls}): expected group '{gname}' in the "
                f"checkpoint; available: {sorted(tree)}")
        matched.add(gname)
        cur_params = params.get(pkey, {})
        new_params, new_stats = _CONVERTERS[cls](
            tree[gname], cur_params, layer, gname)
        if pkey in params:
            params[pkey] = _conform_tree(new_params, cur_params, gname)
        elif new_params:
            raise ValueError(
                f"layer {i} ({cls}): checkpoint has weights but the model "
                f"has no parameters at {pkey}")
        if new_stats is not None:
            cur_stats = batch_stats.get(pkey)
            if cur_stats is None:
                raise ValueError(
                    f"layer {i} ({cls}): checkpoint has BatchNorm moving "
                    f"statistics but the model has no batch_stats at {pkey}")
            batch_stats[pkey] = _conform_tree(new_stats, cur_stats, gname)

    # a compiled/fit reference model also writes (empty) groups for
    # stateless layers (flatten, healpy_pool, dropout); only groups that
    # actually carry weights must be consumed
    unmatched = sorted(
        g for g in set(tree) - matched if _has_weights(tree[g])
    )
    if unmatched:
        raise ValueError(
            f"checkpoint groups not consumed by the model: {unmatched} "
            f"(model/reference architecture mismatch)")

    out = dict(variables)
    out["params"] = params
    if batch_stats:
        out["batch_stats"] = batch_stats
    return out
