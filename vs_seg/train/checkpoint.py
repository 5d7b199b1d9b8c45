"""Full-state checkpointing.

The reference saves weights only (params/VSparams.py:508,526), so a crash loses
the optimizer state and epoch counter. Here a checkpoint is the complete
training state: params, batch_stats, optimizer state, epoch, PRNG key, best
metric — a true resume point.

Format: one numpy `.npz` archive whose entries are the state's leaves, each
named by its key path joined with "/" (e.g. `params/down_0/unit0/conv/kernel`,
`opt_state/inner_state/1/mu`). `load_checkpoint` rebuilds nested dicts from
the names, so params and batch_stats need no template; a structured value
such as an optax state is restored into a template of the same structure
with `restore_into`.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import jax
import numpy as np

_SEP = "/"


def _key_name(entry) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(entry, attr):
            return str(getattr(entry, attr))
    raise TypeError(f"unsupported pytree key {entry!r}")


def _path_name(path) -> str:
    parts = [_key_name(e) for e in path]
    if any(_SEP in p for p in parts):
        raise ValueError(f"checkpoint key {parts!r} contains {_SEP!r}")
    return _SEP.join(parts)


def flatten_state(state) -> Dict[str, np.ndarray]:
    """{"a/b/c": leaf} for every leaf of a pytree, as host numpy arrays."""
    leaves = jax.tree_util.tree_flatten_with_path(jax.device_get(state))[0]
    return {_path_name(path): np.asarray(leaf) for path, leaf in leaves}


def save_checkpoint(path: str, state: Dict[str, Any]) -> None:
    flat = flatten_state(state)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Nested dicts of numpy arrays keyed by the saved entry names; 0-d
    entries come back as 0-d arrays."""
    out: Dict[str, Any] = {}
    with np.load(path, allow_pickle=False) as data:
        for name in data.files:
            node = out
            *parents, leaf = name.split(_SEP)
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[name]
    return out


def restore_into(template, saved: Dict[str, Any]):
    """`template`'s pytree structure with each leaf taken from `saved` (as
    returned by load_checkpoint for that subtree), matched by key path."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    values = []
    for path, leaf in leaves:
        node = saved
        for e in path:
            node = node[_key_name(e)]
        value = np.asarray(node)
        if value.shape != np.shape(leaf):
            raise ValueError(
                f"checkpoint entry {_path_name(path)} has shape {value.shape},"
                f" expected {np.shape(leaf)}")
        values.append(value)
    return jax.tree_util.tree_unflatten(treedef, values)
