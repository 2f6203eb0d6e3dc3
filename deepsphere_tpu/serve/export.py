"""Ahead-of-time inference export via ``jax.export`` (StableHLO).

Why this shape:

* **Self-contained artifacts.**  The exported closure bakes the model's
  ``params`` / ``batch_stats`` / ``graph_tables`` in as constants — the
  blob is the whole deployable: no graph build (the nside=1024 stencil
  extraction is minutes of host precompute), no healpy/pygsp analog, no
  framework import on the serving side.  ``ExportedModel`` runs a blob
  with nothing but jax installed.
* **Platform stickiness is explicit.**  An artifact is lowered for the
  current backend (CPU or CUDA) unless ``platforms=`` names others to
  cross-lower for; the artifact records its lowering platforms and
  jax.export enforces them at call time.
* **Polymorphic batch when the model allows it.**  ``batch_size=None``
  exports with a symbolic leading axis ``b`` so one artifact serves any
  batch size.  Models whose head flattens pixels into a static Dense are
  fine (the pixel axis is static); if some layer genuinely needs a
  concrete batch, jax.export raises at trace time — fall back to a fixed
  ``batch_size=N``.

Reference parity anchor: the TF2 reference's deployment unit is
``save_weights``/``load_weights`` (HDF5) + re-assembling the model in
Python (`healpy_networks.py:169-189` semantics); this module is the
replacement for "ship the trained model".
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from .._logger import logger

__all__ = ["export_inference", "save_exported", "load_exported", "ExportedModel"]


def _infer_pixel_shape(model):
    """(npix_in, Fin) for a built HealpyGCNN."""
    shp = getattr(model, "_built_input_shape", None)
    if shp is None:
        raise ValueError(
            "Model has no variables yet; call build(input_shape) or fit() "
            "before exporting."
        )
    return tuple(shp[1:])


def export_inference(model, variables=None, *, batch_size=None, platforms=None):
    """Lower a built model's inference call to a ``jax.export.Exported``.

    :param model: a built :class:`~deepsphere_tpu.models.HealpyGCNN` (or any
        object with ``.module.apply`` and ``.variables``)
    :param variables: optional variable dict to bake (defaults to
        ``model.variables``)
    :param batch_size: ``None`` exports a symbolic batch axis ``b`` (one
        artifact, any batch size); an int pins the leading axis
    :param platforms: optional sequence of lowering platforms (e.g.
        ``["cuda"]``, ``["cpu", "cuda"]``) for cross-platform artifacts;
        default = the current backend
    :return: ``jax.export.Exported`` — call via ``.call(x)``, write via
        :func:`write_exported`
    """
    from jax import export as jexport

    variables = model.variables if variables is None else variables
    if variables is None:
        raise ValueError(
            "Model has no variables yet; call build(input_shape) or fit() "
            "before exporting."
        )
    npix, fin = _infer_pixel_shape(model)
    module = model.module

    # Bake the variables: closure constants serialize into the artifact.
    def infer(x):
        return module.apply(variables, x, training=False)

    if batch_size is None:
        (b,) = jexport.symbolic_shape("b")
        arg = jax.ShapeDtypeStruct((b, npix, fin), jnp.float32)
    else:
        arg = jax.ShapeDtypeStruct((int(batch_size), npix, fin), jnp.float32)

    kwargs = {}
    if platforms is not None:
        kwargs["platforms"] = [str(p) for p in platforms]
    exported = jexport.export(jax.jit(infer), **kwargs)(arg)
    logger.info(
        f"Exported inference: input {arg.shape}, platforms "
        f"{exported.platforms}, {len(exported.mlir_module_serialized)} bytes "
        f"of StableHLO"
    )
    return exported


def write_exported(path, exported):
    """Write a single-input, single-output ``jax.export.Exported`` to
    ``path``: a zip of its StableHLO bytecode (``module.mlirbc``) and a
    JSON header (``exported.json``) with the avals, platforms and calling
    convention.  Needs only jax — not the ``flatbuffers`` package that
    ``Exported.serialize`` needs.  Returns the byte count."""
    import json
    import zipfile

    (ia,), (oa,) = exported.in_avals, exported.out_avals
    single = jax.tree_util.tree_structure(((0,), {}))
    if (exported.in_tree != single
            or exported.out_tree != jax.tree_util.tree_structure(0)
            or exported.ordered_effects or exported.unordered_effects
            or exported.disabled_safety_checks
            or any(s is not None for s in exported.in_shardings_hlo
                   + exported.out_shardings_hlo
                   + exported._in_named_shardings
                   + exported._out_named_shardings)):
        raise ValueError(
            "write_exported handles one unsharded array in and out, "
            "without effects")
    header = {
        "fun_name": exported.fun_name,
        "in_shape": [str(d) for d in ia.shape], "in_dtype": str(ia.dtype),
        "out_shape": [str(d) for d in oa.shape], "out_dtype": str(oa.dtype),
        "has_named_shardings": exported._has_named_shardings,
        "nr_devices": exported.nr_devices,
        "platforms": list(exported.platforms),
        "calling_convention_version": exported.calling_convention_version,
        "module_kept_var_idx": list(exported.module_kept_var_idx),
        "uses_global_constants": exported.uses_global_constants,
    }
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("exported.json", json.dumps(header))
        z.writestr("module.mlirbc", exported.mlir_module_serialized)
    return os.path.getsize(path)


def read_exported(path):
    """Rebuild the ``jax.export.Exported`` written by
    :func:`write_exported`; calling it needs nothing but jax."""
    import json
    import zipfile

    from jax import export as jexport
    from jax._src import core

    with zipfile.ZipFile(path) as z:
        h = json.loads(z.read("exported.json"))
        module = z.read("module.mlirbc")
    scope = jexport.SymbolicScope()

    def aval(dims, dtype):
        shape = jexport.symbolic_shape(", ".join(dims), scope=scope)
        return core.ShapedArray(shape, np.dtype(dtype))

    return jexport.Exported(
        fun_name=h["fun_name"],
        in_tree=jax.tree_util.tree_structure(((0,), {})),
        in_avals=(aval(h["in_shape"], h["in_dtype"]),),
        out_tree=jax.tree_util.tree_structure(0),
        out_avals=(aval(h["out_shape"], h["out_dtype"]),),
        _has_named_shardings=h["has_named_shardings"],
        _in_named_shardings=(None,), _out_named_shardings=(None,),
        in_shardings_hlo=(None,), out_shardings_hlo=(None,),
        nr_devices=h["nr_devices"], platforms=tuple(h["platforms"]),
        ordered_effects=(), unordered_effects=(), disabled_safety_checks=(),
        mlir_module_serialized=module,
        calling_convention_version=h["calling_convention_version"],
        module_kept_var_idx=tuple(h["module_kept_var_idx"]),
        uses_global_constants=h["uses_global_constants"],
        _get_vjp=None,
    )


def save_exported(path, model, variables=None, *, batch_size=None,
                  platforms=None):
    """Export (see :func:`export_inference`) and write the artifact to
    ``path`` (:func:`write_exported`).  Returns the byte count."""
    exported = export_inference(
        model, variables, batch_size=batch_size, platforms=platforms
    )
    return write_exported(path, exported)


class ExportedModel:
    """A deserialized inference artifact.  Framework-free: holds only the
    ``jax.export.Exported`` — calling it jit-compiles the baked StableHLO
    for the local backend (subject to the artifact's lowering platforms).
    """

    def __init__(self, exported):
        self.exported = exported

    @property
    def input_shape(self):
        return tuple(self.exported.in_avals[0].shape)

    @property
    def platforms(self):
        return tuple(self.exported.platforms)

    def __call__(self, x):
        return self.exported.call(jnp.asarray(x, jnp.float32))

    def predict(self, x, batch_size=16):
        """Keras-like convenience: chunked inference -> one numpy array.

        Needs a polymorphic-batch artifact (``batch_size=None`` at export
        time) unless every chunk matches the baked batch dimension."""
        x = np.asarray(x)
        baked = self.input_shape[0]
        if isinstance(baked, int):
            if x.shape[0] % baked:
                raise ValueError(
                    f"fixed-batch artifact (batch={baked}): predict needs "
                    f"len(x) divisible by it, got {x.shape[0]} — export "
                    f"with batch_size=None for arbitrary batches"
                )
            batch_size = baked
        outs = [
            np.asarray(self(x[i:i + batch_size]))
            for i in range(0, x.shape[0], batch_size)
        ]
        return np.concatenate(outs, axis=0)


def load_exported(path):
    """Read an artifact written by :func:`save_exported`."""
    return ExportedModel(read_exported(path))
