"""Minimal module system: dataclass modules, named variable collections and
functional ``init`` / ``apply``.

Covers exactly what the package's layers use:

* :class:`Module` subclasses are dataclasses whose ``__call__`` is decorated
  with :func:`compact`; submodules created or held inside a compact method
  bind to the caller's scope under their ``name`` (or ``ClassName_<i>``).
* ``self.param(name, init_fn, *args)`` lives in the ``params`` collection;
  ``self.variable(col, name, init_fn, *args)`` in any other collection
  (``batch_stats``, ``graph_tables``); ``self.is_initializing()``.
* ``module.init(rng, *args)`` returns every collection the call created;
  ``module.apply(variables, *args, mutable=[...])`` returns the output, and
  with ``mutable`` also the updated collections.
* :class:`Dense`, :class:`LayerNorm`, :class:`BatchNorm`, :func:`remat` and
  :data:`initializers` (``jax.nn.initializers``).

Every matmul issued here uses :func:`deepsphere_tpu.config.precision`.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import zlib
from typing import Any, Optional

import jax
import jax.numpy as jnp

from .. import config

__all__ = [
    "Module",
    "compact",
    "remat",
    "initializers",
    "Dense",
    "LayerNorm",
    "BatchNorm",
]

initializers = jax.nn.initializers

_frames = threading.local()


def _stack():
    if not hasattr(_frames, "stack"):
        _frames.stack = []
    return _frames.stack


def _copy_dicts(tree):
    """Copy the dict structure of a variable tree (leaves shared)."""
    if isinstance(tree, dict):
        return {k: _copy_dicts(v) for k, v in tree.items()}
    return tree


def _get_path(tree, path):
    for key in path:
        if not isinstance(tree, dict) or key not in tree:
            return None
        tree = tree[key]
    return tree


class _State:
    """Variables and policy of one init/apply call."""

    def __init__(self, variables, mutable, rng, initializing, capture):
        self.vars = variables
        self.mutable = mutable  # True (all) or a set of collection names
        self.rng = rng
        self.initializing = initializing
        self.capture = capture

    def is_mutable(self, col):
        return self.mutable is True or col in self.mutable


class _Scope:
    """A module's position in the variable tree."""

    def __init__(self, state, path):
        self.state = state
        self.path = path
        self._names = {}  # id(module) -> child name
        self._counts = {}

    def child_name(self, module):
        if module.name is not None:
            return module.name
        key = id(module)
        if key not in self._names:
            cls = type(module).__name__
            i = self._counts.get(cls, 0)
            self._counts[cls] = i + 1
            self._names[key] = f"{cls}_{i}"
        return self._names[key]

    def get(self, col, name):
        return _get_path(self.state.vars.get(col), self.path + (name,))

    def put(self, col, name, value):
        if not self.state.is_mutable(col):
            raise ValueError(
                f"collection {col!r} is not mutable here; pass "
                f"mutable=[{col!r}] to apply"
            )
        tree = self.state.vars.setdefault(col, {})
        for key in self.path:
            tree = tree.setdefault(key, {})
        tree[name] = value

    def rng(self, name):
        if self.state.rng is None:
            raise ValueError("initializing a variable needs an rng key")
        tag = "/".join(self.path + (name,)).encode()
        return jax.random.fold_in(self.state.rng, zlib.crc32(tag))


class _Frame:
    def __init__(self, module, scope):
        self.module = module
        self.scope = scope


class Variable:
    """Handle to one entry of a variable collection."""

    def __init__(self, scope, col, name):
        self._scope, self._col, self._name = scope, col, name

    @property
    def value(self):
        return self._scope.get(self._col, self._name)

    @value.setter
    def value(self, v):
        self._scope.put(self._col, self._name, v)


def compact(fn):
    """Decorator for a module's ``__call__``: binds the module to a child
    scope of the calling module for the duration of the call."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        stack = _stack()
        if not stack:
            raise RuntimeError(
                f"{type(self).__name__} must be called inside init/apply"
            )
        parent = stack[-1]
        if parent.module is self:  # the root call, or a method re-entering
            return fn(self, *args, **kwargs)
        scope = _Scope(parent.scope.state,
                       parent.scope.path + (parent.scope.child_name(self),))
        stack.append(_Frame(self, scope))
        try:
            out = fn(self, *args, **kwargs)
        finally:
            stack.pop()
        if scope.state.capture:
            inter = scope.state.vars.setdefault("intermediates", {})
            for key in scope.path:
                inter = inter.setdefault(key, {})
            inter["__call__"] = inter.get("__call__", ()) + (out,)
        return out

    return wrapper


def _run(module, state, fn):
    stack = _stack()
    stack.append(_Frame(module, _Scope(state, ())))
    try:
        return fn()
    finally:
        stack.pop()


@dataclasses.dataclass(eq=False, repr=False)
class Module:
    """Base class: subclasses become dataclasses automatically."""

    name: Optional[str] = dataclasses.field(default=None, kw_only=True)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(cls, eq=False, repr=False)

    def __post_init__(self):
        pass

    # -- functional entry points ------------------------------------------

    def init(self, rngs, *args, **kwargs):
        """Run ``__call__`` creating every variable; returns the variables
        as ``{collection: nested dict}``."""
        if isinstance(rngs, dict):
            rngs = rngs["params"]
        if isinstance(rngs, int):
            rngs = jax.random.key(rngs)
        state = _State({}, True, rngs, initializing=True, capture=False)
        _run(self, state, lambda: self(*args, **kwargs))
        return state.vars

    def apply(self, variables, *args, mutable=False, rngs=None,
              capture_intermediates=False, **kwargs):
        """Run ``__call__`` on ``variables``.  With ``mutable`` (a list of
        collection names, or True) returns ``(output, updated collections)``."""
        if isinstance(rngs, dict):
            rngs = rngs.get("params")
        cols = (True if mutable is True
                else set(mutable or ()) | ({"intermediates"}
                                           if capture_intermediates else set()))
        state = _State(_copy_dicts(dict(variables)), cols, rngs,
                       initializing=False, capture=capture_intermediates)
        out = _run(self, state, lambda: self(*args, **kwargs))
        if not mutable and not capture_intermediates:
            return out
        keep = state.vars.keys() if cols is True else cols
        return out, {c: state.vars[c] for c in keep if c in state.vars}

    # -- inside a compact method ------------------------------------------

    def _scope(self):
        stack = _stack()
        if not stack or stack[-1].module is not self:
            raise RuntimeError(
                f"{type(self).__name__} is not bound: variables exist only "
                f"inside its compact __call__ under init/apply"
            )
        return stack[-1].scope

    def is_initializing(self):
        return self._scope().state.initializing

    def param(self, name, init_fn, *init_args):
        scope = self._scope()
        value = scope.get("params", name)
        if value is None:
            if not scope.state.initializing:
                raise KeyError(
                    f"parameter {'/'.join(scope.path + (name,))} missing "
                    f"from the variables passed to apply"
                )
            value = init_fn(scope.rng(name), *init_args)
            scope.put("params", name, value)
        return value

    def variable(self, col, name, init_fn, *init_args):
        scope = self._scope()
        if scope.get(col, name) is None:
            scope.put(col, name, init_fn(*init_args))
        return Variable(scope, col, name)

    def clone(self, **updates):
        return dataclasses.replace(self, **updates)


def remat(fn):
    """``jax.checkpoint`` for ``fn(module, *args)`` called inside a compact
    method: the backward pass recomputes the module's activations instead
    of storing them.  Mutated collections (batch stats) are threaded
    through the checkpointed function explicitly."""

    def wrapped(module, *args):
        parent = _stack()[-1]
        state = parent.scope.state
        if state.initializing or state.capture:
            return fn(module, *args)
        name = parent.scope.child_name(module)
        path = parent.scope.path + (name,)
        sub = {}
        for col, tree in state.vars.items():
            v = _get_path(tree, path)
            if v is not None:
                sub[col] = v
        mutable = {c for c in sub if state.is_mutable(c)}

        def run(sub, *args):
            inner = _State({c: {name: _copy_dicts(t)} for c, t in sub.items()},
                           mutable, None, initializing=False, capture=False)
            holder = _Scope(inner, ())
            holder._names[id(module)] = name
            stack = _stack()
            stack.append(_Frame(None, holder))
            try:
                out = fn(module, *args)
            finally:
                stack.pop()
            return out, {c: inner.vars[c][name] for c in mutable}

        out, updated = jax.checkpoint(run)(sub, *args)
        for col, tree in updated.items():
            dst = state.vars.setdefault(col, {})
            for key in parent.scope.path:
                dst = dst.setdefault(key, {})
            dst[name] = tree
        return out

    return wrapped


class Dense(Module):
    """``y = x @ kernel + bias`` over the last axis (lecun-normal kernel,
    zero bias)."""

    features: int
    use_bias: bool = True
    kernel_init: Any = initializers.lecun_normal()

    @compact
    def __call__(self, x):
        kernel = self.param("kernel", self.kernel_init,
                            (x.shape[-1], self.features), jnp.float32)
        y = jnp.matmul(x, kernel.astype(x.dtype), precision=config.precision())
        if self.use_bias:
            bias = self.param("bias", initializers.zeros, (self.features,),
                              jnp.float32)
            y = y + bias.astype(y.dtype)
        return y


def _normalize_axes(axes, ndim):
    axes = (axes,) if isinstance(axes, int) else tuple(axes)
    return tuple(sorted(a % ndim for a in axes))


class LayerNorm(Module):
    """Normalize over ``reduction_axes``; learned ``scale``/``bias`` over
    ``feature_axes``."""

    epsilon: float = 1e-6
    use_bias: bool = True
    use_scale: bool = True
    reduction_axes: Any = -1
    feature_axes: Any = -1

    @compact
    def __call__(self, x):
        red = _normalize_axes(self.reduction_axes, x.ndim)
        feat = _normalize_axes(self.feature_axes, x.ndim)
        xf = x.astype(jnp.float32)
        mean = jnp.mean(xf, axis=red, keepdims=True)
        mean2 = jnp.mean(jnp.square(xf), axis=red, keepdims=True)
        var = jnp.maximum(0.0, mean2 - jnp.square(mean))
        y = (xf - mean) * jax.lax.rsqrt(var + self.epsilon)
        fshape = tuple(x.shape[a] for a in feat)
        bshape = tuple(x.shape[a] if a in feat else 1 for a in range(x.ndim))
        if self.use_scale:
            scale = self.param("scale", initializers.ones, fshape, jnp.float32)
            y = y * scale.reshape(bshape)
        if self.use_bias:
            bias = self.param("bias", initializers.zeros, fshape, jnp.float32)
            y = y + bias.reshape(bshape)
        return y.astype(x.dtype)


class BatchNorm(Module):
    """Batch normalization over every axis but the last, with running
    statistics in the ``batch_stats`` collection (``mean``, ``var``)
    updated as ``m * running + (1 - m) * batch``.  ``axis_name`` averages
    the batch statistics across that mesh axis."""

    use_running_average: bool = False
    momentum: float = 0.99
    epsilon: float = 1e-5
    use_bias: bool = True
    use_scale: bool = True
    axis_name: Optional[str] = None

    @compact
    def __call__(self, x):
        F = x.shape[-1]
        ra_mean = self.variable("batch_stats", "mean",
                                lambda: jnp.zeros((F,), jnp.float32))
        ra_var = self.variable("batch_stats", "var",
                               lambda: jnp.ones((F,), jnp.float32))
        if self.use_running_average:
            mean, var = ra_mean.value, ra_var.value
        else:
            axes = tuple(range(x.ndim - 1))
            xf = x.astype(jnp.float32)
            mean = jnp.mean(xf, axis=axes)
            mean2 = jnp.mean(jnp.square(xf), axis=axes)
            if self.axis_name is not None:
                mean, mean2 = jax.lax.pmean((mean, mean2), self.axis_name)
            var = jnp.maximum(0.0, mean2 - jnp.square(mean))
            if not self.is_initializing():
                m = self.momentum
                ra_mean.value = m * ra_mean.value + (1 - m) * mean
                ra_var.value = m * ra_var.value + (1 - m) * var
        mul = jax.lax.rsqrt(var + self.epsilon)
        if self.use_scale:
            mul = mul * self.param("scale", initializers.ones, (F,), jnp.float32)
        y = (x - mean.astype(x.dtype)) * mul.astype(x.dtype)
        if self.use_bias:
            y = y + self.param("bias", initializers.zeros, (F,),
                               jnp.float32).astype(x.dtype)
        return y
