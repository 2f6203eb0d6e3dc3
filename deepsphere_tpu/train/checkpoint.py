"""Checkpointing to numpy ``.npz`` files.

A pytree is stored as one ``.npz`` archive whose entry names are the
leaves' key paths joined by ``/`` (``params/layers_layer_0/kernel``).
Bare weights (``HealpyGCNN.save_weights``) are one such file; the full
train state (params, batch stats, optimizer state, step) is one file per
step directory ``<path>/<step>/state.npz``.

The reference only has Keras ``save_weights``/``load_weights`` (HDF5,
``tests/test_healpy_networks.py:133-152``); here we additionally checkpoint
optimizer state and step for true resume.
"""

from __future__ import annotations

import os
import shutil

import jax
import numpy as np

__all__ = ["save_tree", "load_tree", "save_checkpoint", "restore_checkpoint"]


def _key_name(entry):
    for attr in ("key", "idx", "name"):
        if hasattr(entry, attr):
            return str(getattr(entry, attr))
    return str(entry)


def _flatten(tree):
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    names = ["/".join(_key_name(e) for e in path) for path, _ in leaves]
    return names, [leaf for _, leaf in leaves], treedef


def save_tree(path, tree):
    """Write ``tree``'s leaves to ``path`` (exactly that file name) as an
    ``.npz`` keyed by leaf path; the write is atomic."""
    names, leaves, _ = _flatten(tree)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **{n: np.asarray(v) for n, v in zip(names, leaves)})
    os.replace(tmp, path)


def load_tree(path, target=None):
    """Read an ``.npz`` written by :func:`save_tree`.

    With ``target``, the result has ``target``'s structure and every leaf
    must be present with the target leaf's shape; without, nested dicts
    keyed by path component."""
    with np.load(path) as z:
        stored = {n: z[n] for n in z.files}
    if target is None:
        out = {}
        for name, value in stored.items():
            node = out
            *parents, last = name.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[last] = value
        return out
    names, leaves, treedef = _flatten(target)
    if set(names) != set(stored):
        missing = sorted(set(names) - set(stored))
        extra = sorted(set(stored) - set(names))
        raise ValueError(
            f"{path} does not match the target tree (missing {missing[:5]}, "
            f"unexpected {extra[:5]})"
        )
    restored = []
    for name, ref in zip(names, leaves):
        value = stored[name]
        if np.shape(ref) != value.shape:
            raise ValueError(
                f"{path}: {name} has shape {value.shape}, expected "
                f"{np.shape(ref)}"
            )
        restored.append(type(ref)(value) if isinstance(ref, (int, float))
                        else value)
    return jax.tree_util.tree_unflatten(treedef, restored)


def _payload(state):
    if isinstance(state, dict):
        return state
    return {
        "params": state.params,
        "batch_stats": state.batch_stats,
        "opt_state": state.opt_state,
        "step": state.step,
    }


def _steps(path):
    if not os.path.isdir(path):
        return []
    return sorted(int(d) for d in os.listdir(path)
                  if d.isdigit() and os.path.exists(
                      os.path.join(path, d, "state.npz")))


def save_checkpoint(path, state, keep=3):
    """Save a train state (``Trainer.TrainState`` or a dict of its fields)
    under ``path/<step>/state.npz``, keeping the newest ``keep`` steps."""
    path = os.path.abspath(path)
    payload = _payload(state)
    step = int(payload.get("step", 0))
    step_dir = os.path.join(path, str(step))
    os.makedirs(step_dir, exist_ok=True)
    save_tree(os.path.join(step_dir, "state.npz"), payload)
    for old in _steps(path)[:-keep] if keep else []:
        shutil.rmtree(os.path.join(path, str(old)))
    return path


def restore_checkpoint(path, target=None, step=None):
    """Restore the latest (or given) step; ``target`` (a train state or
    dict) gives the pytree structure to restore into."""
    path = os.path.abspath(path)
    if step is None:
        steps = _steps(path)
        if not steps:
            raise FileNotFoundError(f"No checkpoint found under {path}")
        step = steps[-1]
    file = os.path.join(path, str(step), "state.npz")
    if not os.path.exists(file):
        raise FileNotFoundError(f"No checkpoint for step {step} under {path}")
    return load_tree(file, None if target is None else _payload(target))
