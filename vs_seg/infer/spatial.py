"""Spatially sharded inference: one window's H is split across the mesh.

SURVEY §5: the reference's "long context" analog is volume size (tiling at
params/VSparams.py:568-574). When a volume yields fewer windows than chips,
window data-parallelism (infer/sharded.py) leaves chips idle; here ONE window
runs across every chip: H is sharded over the mesh `data` axis, every conv
exchanges its receptive-field halo rows with `jax.lax.ppermute`
(nn/layers.conv3d under the `spatial_sharding` context), and the deep levels
— whose H no longer divides the mesh and whose compute is negligible — run
replicated after one `all_gather`.

The forward topology below mirrors models/unet2d5_spvpa.py exactly (pinned by
tests/test_spatial.py exact-equality vs model.apply on an 8-device CPU mesh).
A pure-GSPMD route (jit with input shardings, XLA inserts halos) was measured
to silently diverge (~7e-3, identical in float64 — an XLA SPMD partitioner
miscompile for this program, not float reordering), so the explicit shard_map
route is the production one.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vs_seg.nn.blocks import AttentionBlock1, Convolution, ResidualUnit, attention_gate
from vs_seg.nn.layers import spatial_sharding


def _sub(variables, name):
    v = {"params": variables["params"][name]}
    bs = variables.get("batch_stats", {})
    if name in bs:
        v["batch_stats"] = bs[name]
    return v


def spatial_forward(model, variables, x, *, axis: str, n_shards: int,
                    gather_level: int) -> jnp.ndarray:
    """Eval-mode forward of UNet2d5_spvPA on a LOCAL H block (inside
    shard_map). Levels < gather_level run H-sharded with halo-exchange convs;
    deeper levels run replicated (all_gather once), and the decoder re-shards
    when it crosses back. Returns local logits."""
    m = model
    n = len(m.strides)
    common = dict(norm="batch", dropout=m.dropout, dtype=m.dtype)

    def res(name, feats, kernel, subunits, last_conv_only=False):
        def f(h):
            return ResidualUnit(feats, kernel, subunits=subunits,
                                last_conv_only=last_conv_only,
                                **common).apply(_sub(variables, name), h, False)
        return f

    def conv(name, feats, kernel, strides, transposed=False):
        def f(h):
            return Convolution(feats, kernel, strides, is_transposed=transposed,
                               **common).apply(_sub(variables, name), h, False)
        return f

    def att(name, kernel):
        def f(h):
            a, _ = AttentionBlock1(kernel, dtype=m.dtype).apply(
                _sub(variables, name), h, False)
            return a
        return f

    sharded = spatial_sharding(axis, n_shards)

    skips = []
    sharded_now = True
    for i in range(n):
        if i == gather_level and sharded_now:
            x = jax.lax.all_gather(x, axis, axis=2, tiled=True)
            sharded_now = False
        with (sharded if sharded_now else _null_ctx()):
            x = res(f"down_{i}", m.channels[i], m.kernel_sizes[i],
                    m.num_res_units)(x)
            skips.append(x)
            x = conv(f"downsample_{i}", m.channels[i],
                     m.sample_kernel_sizes[i], m.strides[i])(x)

    if gather_level == n and sharded_now:
        x = jax.lax.all_gather(x, axis, axis=2, tiled=True)
        sharded_now = False
    with (sharded if sharded_now else _null_ctx()):
        if m.attention_module:
            a = att("bottom_att", m.kernel_sizes[n])(x)
            x = attention_gate(a, x)
        x = res("bottom", m.channels[n], m.kernel_sizes[n], m.num_res_units)(x)

    for i in reversed(range(n)):
        if not sharded_now and i < gather_level:
            # decoder crosses back above the gather boundary: upsample
            # replicated, then each shard keeps its local H block
            x = conv(f"upsample_{i}", m.channels[i], m.sample_kernel_sizes[i],
                     m.strides[i], transposed=True)(x)
            idx = jax.lax.axis_index(axis)
            local_h = x.shape[2] // n_shards
            x = jax.lax.dynamic_slice_in_dim(x, idx * local_h, local_h, axis=2)
            sharded_now = True
        elif sharded_now:
            with sharded:
                x = conv(f"upsample_{i}", m.channels[i], m.sample_kernel_sizes[i],
                         m.strides[i], transposed=True)(x)
        else:
            x = conv(f"upsample_{i}", m.channels[i], m.sample_kernel_sizes[i],
                     m.strides[i], transposed=True)(x)

        x = (skips[i], x.astype(skips[i].dtype))  # concat held as a pair
        ctx = sharded if sharded_now else _null_ctx()
        with ctx:
            outc = m.out_channels if i == 0 else m.channels[i]
            if m.attention_module:
                a = att(f"upatt_{i}", m.kernel_sizes[i])(x)
                x = attention_gate(a, x)
            x = res(f"up_{i}", outc, m.kernel_sizes[i], 1,
                    last_conv_only=(i == 0))(x)
    return x


class _null_ctx:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def pick_gather_level(model, h: int, n_shards: int) -> int:
    """First level whose LOCAL H block would stop dividing cleanly (shard must
    stay a multiple of the remaining stride product and >= 1 row)."""
    local = h // n_shards
    if h % n_shards:
        return 0
    for i in range(len(model.strides)):
        sh = model.strides[i][0]
        if local % sh or local // sh < 1:
            return i
        local //= sh
    return len(model.strides)


def make_spatial_predictor(model, params, batch_stats, mesh: Mesh, *,
                           axis: str = "data",
                           dtype=jnp.bfloat16) -> Callable:
    """(N, D, H, W, C) -> (N, D, H, W, out) logits with H sharded over `axis`.

    Drop-in replacement for infer/engine.make_predictor (use sw_batch_size=1:
    the mesh is already busy on spatial shards).
    """
    variables = {"params": params, "batch_stats": batch_stats}
    n_shards = int(mesh.shape[axis])

    @jax.jit
    def predictor(wins):
        gather = pick_gather_level(model, wins.shape[2], n_shards)
        if gather == 0:
            # H cannot be sharded at all (not divisible by the mesh, or the
            # local block is below level-0 stride granularity): fall back to
            # the plain replicated forward. Entering the shard_map here would
            # gather immediately and return full-H blocks that out_specs
            # would wrongly concatenate to n_shards*H.
            out = model.apply(variables, wins.astype(dtype), train=False)
            return out[0] if isinstance(out, tuple) else out

        def body(v, xl):
            return spatial_forward(model, v, xl.astype(dtype), axis=axis,
                                   n_shards=n_shards, gather_level=gather)

        fn = jax.shard_map(body, mesh=mesh,
                           in_specs=(P(), P(None, None, axis)),
                           out_specs=P(None, None, axis))
        return fn(variables, wins)

    return predictor
