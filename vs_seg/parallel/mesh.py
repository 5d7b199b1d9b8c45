"""Device mesh + sharding rules.

The reference is single-GPU (params/VSparams.py:83,112 hardcodes cuda:0 and has no
distributed code at all). Here the mesh is a first-class object: every training
batch and every sliding-window tile batch is sharded over the `data` axis of a
device mesh, gradients are reduced with XLA `psum` inserted by `jit` under sharding
constraints. Works identically on 1 device, N GPUs of a host, or an
`xla_force_host_platform_device_count` virtual CPU mesh.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axes: Tuple[str, ...] = ("data",),
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Build a named device mesh. Default: all devices on one `data` axis."""
    devices = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (len(devices),)
        axes = axes[:1]
    if int(np.prod(shape)) != len(devices):
        raise ValueError(f"mesh shape {shape} != #devices {len(devices)}")
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, axes)


def batch_sharding(mesh: Mesh, ndim: int, batch_axis: int = 0) -> NamedSharding:
    """Shard `batch_axis` over the data-parallel mesh axes ("data", plus
    "dcn" across hosts when present); replicate other dims."""
    spec = [None] * ndim
    names = tuple(n for n in ("dcn", "data") if n in mesh.axis_names)
    spec[batch_axis] = names if len(names) > 1 else names[0]
    return NamedSharding(mesh, P(*spec))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, tree):
    """Device-put a pytree of host arrays with the leading dim sharded on `data`."""
    def put(x):
        return jax.device_put(x, batch_sharding(mesh, np.ndim(x)))
    return jax.tree_util.tree_map(put, tree)


def pad_batch_to_multiple(tree, multiple: int):
    """Pad leading dim so it divides the data-axis size; returns (tree, real_n).

    XLA needs static, evenly divisible shards; surplus rows are masked out by
    callers via `real_n`.
    """
    def pad(x):
        n = x.shape[0]
        rem = (-n) % multiple
        if rem == 0:
            return x
        pad_width = [(0, rem)] + [(0, 0)] * (x.ndim - 1)
        return np.pad(x, pad_width, mode="edge")
    n0 = jax.tree_util.tree_leaves(tree)[0].shape[0]
    return jax.tree_util.tree_map(pad, tree), n0
