"""Jitted training loop over a HealpyGCNN (or any SequentialModel).

Equivalent of the two reference training idioms (SURVEY §3.3):
Keras ``compile``/``fit`` (``quick_start.ipynb`` cells 15-16) and the custom
``tf.function`` GradientTape loop (``advanced_tutorial.ipynb`` cell 28) —
here a single ``jax.jit``-compiled optax train step with mutable batch
stats, optionally data-parallel over a device mesh (gradients ride XLA psum
inserted by the sharding partitioner).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from .._logger import logger
from .losses import resolve_loss, resolve_metric

__all__ = ["Trainer", "TrainState"]


@dataclass
class TrainState:
    params: Any
    batch_stats: Any
    opt_state: Any
    step: int = 0


class Trainer:
    """Compiles and drives the train/eval steps for a model wrapper.

    :param model: a :class:`~deepsphere_tpu.models.HealpyGCNN` (anything with
        ``.module`` being a :class:`~deepsphere_tpu.nn.core.Module` taking
        ``(x, training=...)``)
    :param optimizer: an optax GradientTransformation (or learning-rate float
        -> Adam, mirroring the notebooks' default)
    :param loss: loss name or callable ``loss(y_true, y_pred)``
    :param metrics: list of metric names / callables
    :param data_sharding: optional ``jax.sharding.NamedSharding`` to place
        batches on a mesh (data-parallel scale-out)
    """

    def __init__(self, model, optimizer=1e-3, loss="sparse_categorical_crossentropy",
                 metrics=(), data_sharding=None):
        self.model = model
        self.module = model.module
        if isinstance(optimizer, (int, float)):
            optimizer = optax.adam(optimizer)
        self.optimizer = optimizer
        self.loss_fn = resolve_loss(loss)
        self.metric_fns = {
            (m if isinstance(m, str) else getattr(m, "__name__", f"metric_{i}")): resolve_metric(m)
            for i, m in enumerate(metrics)
        }
        self.data_sharding = data_sharding
        # donate params / batch_stats / opt_state: the step consumes and
        # returns them, so XLA can update in place — at nside>=512 this
        # halves the peak HBM of the optimizer update
        self._train_step = jax.jit(
            self._make_train_step(), donate_argnums=(0, 1, 3)
        )
        self._eval_step = jax.jit(self._make_eval_step())
        self.state: Optional[TrainState] = None

    # ------------------------------------------------------------------

    def _split_variables(self, variables):
        params = variables["params"]
        batch_stats = variables.get("batch_stats", {})
        rest = {k: v for k, v in variables.items() if k not in ("params", "batch_stats")}
        return params, batch_stats, rest

    def init_state(self, variables=None):
        if variables is None:
            if self.model.variables is None:
                raise ValueError("Build the model first (model.build(input_shape)).")
            variables = self.model.variables
        params, batch_stats, rest = self._split_variables(variables)
        # static collections (e.g. "graph_tables": precomputed graph arrays)
        # are not trained but must ride along into every apply call
        self._static_collections = rest
        self.state = TrainState(
            params=params,
            batch_stats=batch_stats,
            opt_state=self.optimizer.init(params),
            step=0,
        )
        return self.state

    def _variables(self, params, batch_stats):
        v = dict(getattr(self, "_static_collections", None) or {})
        v["params"] = params
        if batch_stats:
            v["batch_stats"] = batch_stats
        return v

    def _make_train_step(self):
        module, loss_fn, optimizer = self.module, self.loss_fn, self.optimizer
        metric_fns = self.metric_fns

        def train_step(params, batch_stats, static, opt_state, x, y):
            def compute_loss(p):
                variables = dict(static)
                variables["params"] = p
                if batch_stats:
                    variables["batch_stats"] = batch_stats
                out = module.apply(variables, x, training=True, mutable=["batch_stats"])
                y_pred, updates = out
                return loss_fn(y, y_pred), (y_pred, updates.get("batch_stats", batch_stats))

            (loss, (y_pred, new_stats)), grads = jax.value_and_grad(
                compute_loss, has_aux=True
            )(params)
            updates, new_opt_state = optimizer.update(grads, opt_state, params)
            new_params = optax.apply_updates(params, updates)
            logs = {"loss": loss}
            for name, fn in metric_fns.items():
                logs[name] = fn(y, y_pred)
            return new_params, new_stats, new_opt_state, logs

        return train_step

    def _make_eval_step(self):
        module, loss_fn = self.module, self.loss_fn
        metric_fns = self.metric_fns

        def eval_step(params, batch_stats, static, x, y):
            variables = dict(static)
            variables["params"] = params
            if batch_stats:
                variables["batch_stats"] = batch_stats
            y_pred = module.apply(variables, x, training=False)
            logs = {"loss": loss_fn(y, y_pred)}
            for name, fn in metric_fns.items():
                logs[name] = fn(y, y_pred)
            return logs

        return eval_step

    # ------------------------------------------------------------------

    def _place(self, arr):
        arr = jnp.asarray(arr)
        if self.data_sharding is not None:
            arr = jax.device_put(arr, self.data_sharding)
        return arr

    def train_on_batch(self, x, y):
        if self.state is None:
            self.init_state()
        s = self.state
        params, stats, opt_state, logs = self._train_step(
            s.params, s.batch_stats, self._static_collections, s.opt_state,
            self._place(x), self._place(y)
        )
        self.state = TrainState(params, stats, opt_state, s.step + 1)
        # the step donates its inputs, so any old references (e.g.
        # model.variables from build()) now point at invalidated buffers —
        # refresh the wrapper's view to the live arrays
        self.model.variables = self._variables(params, stats)
        return {k: float(v) for k, v in logs.items()}

    def test_on_batch(self, x, y):
        if self.state is None:
            self.init_state()
        logs = self._eval_step(self.state.params, self.state.batch_stats,
                               self._static_collections,
                               self._place(x), self._place(y))
        return {k: float(v) for k, v in logs.items()}

    def load_state_arrays(self, params, batch_stats):
        """Replace the live params/batch_stats (e.g. restoring an
        EarlyStopping snapshot); optimizer state is kept."""
        import jax.numpy as jnp

        params = jax.tree_util.tree_map(jnp.asarray, params)
        batch_stats = jax.tree_util.tree_map(jnp.asarray, batch_stats)
        s = self.state
        self.state = TrainState(params, batch_stats, s.opt_state, s.step)
        self.model.variables = self._variables(params, batch_stats)

    def fit(self, x, y, batch_size=16, epochs=1, validation_data=None, shuffle=True,
            verbose=1, seed=0, callbacks=None):
        """Mini-batch epoch loop; returns a Keras-like history dict.

        :param callbacks: list of :mod:`~.callbacks` objects — epoch-granular
            hooks only (per-batch hooks would host-sync the hot loop)
        """
        x = np.asarray(x)
        y = np.asarray(y)
        n = x.shape[0]
        rng = np.random.RandomState(seed)
        history = {}
        if self.state is None:
            self.init_state()
        callbacks = list(callbacks or [])
        self.stop_training = False
        for cb in callbacks:
            cb.set_trainer(self)
            cb.on_train_begin()

        # Keras `fit` trains on the trailing partial batch; the remainder
        # shape triggers ONE extra jit specialization.  With a data
        # sharding the remainder must still divide the mesh's data axis —
        # otherwise it is dropped with a warning (Keras semantics are
        # unreachable there without padding).
        n_shards = 1
        if self.data_sharding is not None:
            spec0 = self.data_sharding.spec[0] if self.data_sharding.spec else None
            if spec0 is not None:
                names = (spec0,) if isinstance(spec0, str) else tuple(spec0)
                for nm in names:
                    n_shards *= self.data_sharding.mesh.shape[nm]
        rem = n % batch_size
        drop_rem = rem != 0 and rem % n_shards != 0
        if drop_rem:
            logger.info(
                f"WARNING: dropping the trailing partial batch of {rem} "
                f"samples (not divisible by the {n_shards}-way data sharding)"
            )
        if n == 0 or (drop_rem and n < batch_size):
            raise ValueError(
                f"no trainable batches: {n} samples with batch_size "
                f"{batch_size} under {n_shards}-way data sharding — pad the "
                f"dataset or use parallel.data_iterator (padded+masked "
                f"trailing batches)"
            )

        for epoch in range(epochs):
            order = rng.permutation(n) if shuffle else np.arange(n)
            t0 = time.time()
            epoch_logs = []
            sizes = []
            stop = (n - rem) if drop_rem else n
            for start in range(0, stop, batch_size):
                sel = order[start:start + batch_size]
                epoch_logs.append(self.train_on_batch(x[sel], y[sel]))
                sizes.append(len(sel))
            w = np.asarray(sizes, dtype=np.float64)
            means = {
                k: float(np.average([l[k] for l in epoch_logs], weights=w))
                for k in epoch_logs[0]
            }
            if validation_data is not None:
                vx, vy = validation_data
                val = self.evaluate(vx, vy, batch_size=batch_size, verbose=0)
                means.update({f"val_{k}": v for k, v in val.items()})
            for k, v in means.items():
                history.setdefault(k, []).append(v)
            if verbose:
                msg = " - ".join(f"{k}: {v:.4f}" for k, v in means.items())
                logger.info(f"Epoch {epoch + 1}/{epochs} [{time.time() - t0:.2f}s] {msg}")
            for cb in callbacks:
                cb.on_epoch_end(epoch, means)
            if self.stop_training:
                break

        # sync back into the model wrapper for Keras-style continued use
        self.model.variables = self._variables(self.state.params, self.state.batch_stats)
        for cb in callbacks:
            cb.on_train_end()
        return history

    def evaluate(self, x, y, batch_size=16, verbose=1):
        x = np.asarray(x)
        y = np.asarray(y)
        n = x.shape[0]
        if n == 0:
            raise ValueError("evaluate() needs at least one sample, got 0")
        logs = []
        sizes = []
        for start in range(0, n, batch_size):
            xb = x[start:start + batch_size]
            yb = y[start:start + batch_size]
            logs.append(self.test_on_batch(xb, yb))
            sizes.append(len(xb))
        # per-sample averaging (Keras semantics): a trailing partial batch
        # contributes proportionally to its size, not as a full batch
        w = np.asarray(sizes, dtype=np.float64)
        means = {
            k: float(np.average([l[k] for l in logs], weights=w))
            for k in logs[0]
        }
        if verbose:
            logger.info(" - ".join(f"{k}: {v:.4f}" for k, v in means.items()))
        return means

    def predict(self, x, batch_size=16):
        if self.state is None:
            self.init_state()
        variables = self._variables(self.state.params, self.state.batch_stats)
        x = np.asarray(x)
        outs = []
        apply = jax.jit(lambda v, xb: self.module.apply(v, xb, training=False))
        for start in range(0, x.shape[0], batch_size):
            outs.append(np.asarray(apply(variables, jnp.asarray(x[start:start + batch_size]))))
        return np.concatenate(outs, axis=0)
