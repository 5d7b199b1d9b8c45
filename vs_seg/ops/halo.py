"""Explicit halo-exchange convolution over a spatially sharded volume.

SURVEY §5: the reference's "long context" analog is volume size, scaled by
sliding-window tiling (params/VSparams.py:568-574). Spatial sharding splits
one volume's H across the mesh so a single window can use every device.
Convs then need their receptive-field overlap from the neighboring shards —
exchanged here with `jax.lax.ppermute` inside a `shard_map` region.

This module is the primitive used by the production spatially-sharded
predictor (infer/spatial.py) through its explicit shard_map route. A pure
GSPMD alternative (jit the whole model under input shardings, let XLA insert
the halo collectives) was measured to silently diverge (~7e-3) on this
backend — see the warning in infer/spatial.py:14-18; do not reintroduce it
without an exactness test. Exercised by tests/test_spatial.py on an 8-device
CPU mesh.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vs_seg.nn.layers import conv3d, same_padding


def exchange_halo(x: jnp.ndarray, halo, axis_name: str, spatial_axis: int,
                  n_shards: int) -> jnp.ndarray:
    """Concatenate halo rows from the neighbor shards along `spatial_axis`.

    halo: int (symmetric) or (lo, hi). Boundary shards receive zeros (matching
    dense zero padding). x is the per-shard block inside a shard_map region.
    """
    lo_n, hi_n = (halo, halo) if isinstance(halo, int) else halo
    if lo_n == 0 and hi_n == 0:
        return x
    idx = jax.lax.axis_index(axis_name)

    def take(a, sl):
        slicer = [slice(None)] * a.ndim
        slicer[spatial_axis] = sl
        return a[tuple(slicer)]

    # shard i's top rows flow to shard i+1 (they become its lower halo)
    fwd = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    bwd = [(i, (i - 1) % n_shards) for i in range(n_shards)]
    parts = [x]
    if lo_n:
        lo = jax.lax.ppermute(take(x, slice(-lo_n, None)), axis_name, fwd)
        parts.insert(0, jnp.where(idx == 0, 0.0, lo).astype(x.dtype))
    if hi_n:
        hi = jax.lax.ppermute(take(x, slice(0, hi_n)), axis_name, bwd)
        parts.append(jnp.where(idx == n_shards - 1, 0.0, hi).astype(x.dtype))
    return jnp.concatenate(parts, axis=spatial_axis)


def halo_conv3d(x: jnp.ndarray, w: jnp.ndarray, b: Optional[jnp.ndarray],
                mesh: Mesh, *, axis: str = "data",
                dtype=jnp.bfloat16) -> jnp.ndarray:
    """Stride-1 same-padding conv on (B, D, H, W, C) with H sharded over
    `axis`: each shard convolves its block after a 1-hop halo exchange.

    Kernel `w` is (kh, kw, kd, Cin, Cout) in reference (H, W, D) order, like
    nn.layers.conv3d. Exact vs the dense conv3d (tested). H must divide the
    axis size.
    """
    n = mesh.shape[axis]
    kh = w.shape[0]
    ph, pw, pd = same_padding((w.shape[0], w.shape[1], w.shape[2]))
    halo = ph  # rows of neighbor context needed in H

    def local(xs, w, b):
        xh = exchange_halo(xs, halo, axis, spatial_axis=2, n_shards=n)
        # H already has its halo (valid in H); W/D keep same-padding
        return conv3d(xh, w, b, (1, 1, 1),
                      [(0, 0), (pw, pw), (pd, pd)], dtype=dtype)

    fn = jax.shard_map(partial(local), mesh=mesh,
                       in_specs=(P(None, None, axis), P(), P()),
                       out_specs=P(None, None, axis))
    return fn(x, w, jnp.zeros((w.shape[-1],), jnp.float32) if b is None else b)
