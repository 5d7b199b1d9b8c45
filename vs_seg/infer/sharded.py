"""Multi-device sliding-window inference: windows sharded over the mesh.

The reference evaluates windows serially on one GPU (sw_batch_size=1,
params/VSparams.py:568-574). Here the window set of ONE volume is partitioned
across the mesh `data` axis with `jax.shard_map`: each chip gathers + predicts
+ blend-accumulates its windows into a local accumulator pair, then a single
`psum` merges them (masked padding windows contribute zero weight, so the
merge is exact). With 8 windows on 8 devices the whole volume costs one
forward pass of wall-clock.

Works identically on a host-simulated CPU mesh (tests) and on GPUs.
"""

from __future__ import annotations

import weakref
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vs_seg.infer.sliding_window import (
    StagedVolume, _importance_map_device, stage_volume,
)


# predictor -> {config: jitted program}. Weak keys: each program closure pins
# the predictor (and the full parameter set it captures) on device, so a
# long-lived process cycling many checkpoints must not accumulate entries —
# dropping the predictor now releases its programs without requiring a manual
# clear_inference_caches() call (same pattern as sliding_window._OC_CACHE).
_PROGRAMS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _sharded_program(predictor, mesh, axis, roi, local_batches, sw_batch_size):
    """Build (and cache) the jitted shard_map window program. Rebuilding the
    closure per volume would key a fresh jit cache entry each call — a full
    retrace and compile per volume."""
    per_pred = _PROGRAMS.setdefault(predictor, {})
    key = (mesh, axis, roi, local_batches, sw_batch_size)
    if key not in per_pred:
        per_pred[key] = _build_sharded_program(
            predictor, mesh, axis, roi, local_batches, sw_batch_size)
    return per_pred[key]


_sharded_program.cache_clear = _PROGRAMS.clear  # API parity with lru_cache


def _build_sharded_program(predictor, mesh, axis, roi, local_batches,
                           sw_batch_size):
    # The program closure must NOT strongly reference the predictor, or the
    # cache value would keep its own weak key alive forever. per_device only
    # needs the predictor at trace time, and a (re)trace can only be triggered
    # through _sharded_program — which requires a live predictor as the key.
    pred_ref = weakref.ref(predictor)

    def per_device(vol, starts_l, mask_l, imp):
        predictor = pred_ref()
        assert predictor is not None, (
            "sharded window program retraced after its predictor was "
            "garbage-collected — rebuild via _sharded_program")
        s0, s1, s2, c = vol.shape

        def varying(x):
            # accumulators differ per device; mark them as varying over the
            # mesh axis so scan/fori carries typecheck under shard_map
            return jax.lax.pcast(x, (axis,), to="varying")

        out_acc = None
        w_acc = varying(jnp.zeros((s0, s1, s2, 1), jnp.float32))
        for b in range(local_batches):
            sl = slice(b * sw_batch_size, (b + 1) * sw_batch_size)
            bs = starts_l[sl]

            def gather(start):
                return jax.lax.dynamic_slice(
                    vol, (start[0], start[1], start[2], 0), (*roi, c))

            wins = jax.vmap(gather)(bs)
            preds = predictor(wins).astype(jnp.float32)
            if out_acc is None:
                out = varying(jnp.zeros((s0, s1, s2, preds.shape[-1]),
                                        jnp.float32))
            else:
                out = out_acc
            impw = imp[None, ..., None] * mask_l[sl][:, None, None, None, None]
            weighted = preds * impw

            def scatter(i, carry):
                out, w = carry
                idx = (bs[i, 0], bs[i, 1], bs[i, 2], 0)
                cur = jax.lax.dynamic_slice(out, idx, (*roi, preds.shape[-1]))
                out = jax.lax.dynamic_update_slice(out, cur + weighted[i], idx)
                cur_w = jax.lax.dynamic_slice(w, idx, (*roi, 1))
                w = jax.lax.dynamic_update_slice(w, cur_w + impw[i], idx)
                return out, w

            out_acc, w_acc = jax.lax.fori_loop(
                0, sw_batch_size, scatter, (out, w_acc))
        out_acc = jax.lax.psum(out_acc, axis)
        w_acc = jax.lax.psum(w_acc, axis)
        return out_acc / w_acc

    return jax.jit(jax.shard_map(
        per_device, mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P()),
        out_specs=P()))


def sliding_window_inference_sharded(
        volume, roi_size: Sequence[int], predictor: Callable, mesh: Mesh, *,
        overlap: float = 0.25, sw_batch_size: int = 1, mode: str = "gaussian",
        sigma_scale: float = 0.125, transfer_dtype=None, quantize: bool = False,
        predictor_layout: str = "hwdc", axis: str = "data") -> jnp.ndarray:
    """Whole-volume inference with windows data-parallel across `mesh`.

    `sw_batch_size` is PER DEVICE. Returns (H, W, D, out_channels), replicated.
    """
    n_dev = mesh.devices.size
    if isinstance(volume, StagedVolume):
        staged = volume
    else:
        # pad the window list to a multiple of n_dev * sw_batch_size
        staged = stage_volume(volume, roi_size, overlap=overlap,
                              sw_batch_size=n_dev * sw_batch_size,
                              transfer_dtype=transfer_dtype, quantize=quantize,
                              predictor_layout=predictor_layout)
    roi = staged.roi_size
    imp_dev = _importance_map_device(roi, mode, sigma_scale)
    vol = staged.vol_dev
    if staged.dequant is not None:
        from vs_seg.infer.sliding_window import _dequantize
        scale, offset = staged.dequant
        vol = _dequantize(vol, jnp.asarray(scale), jnp.asarray(offset))
    s0, s1, s2, c = vol.shape
    n_pad = staged.starts_padded.shape[0]
    assert n_pad % n_dev == 0
    local_n = n_pad // n_dev
    local_batches = -(-local_n // sw_batch_size)
    # pad local window count to a batch multiple
    total = n_dev * local_batches * sw_batch_size
    starts = np.zeros((total, 3), np.int32)
    starts[:n_pad] = staged.starts_padded
    mask = np.zeros(total, np.float32)
    mask[:n_pad] = staged.mask

    sharded = _sharded_program(predictor, mesh, axis, roi, local_batches,
                               sw_batch_size)

    starts_dev = jax.device_put(starts, NamedSharding(mesh, P(axis)))
    mask_dev = jax.device_put(mask, NamedSharding(mesh, P(axis)))
    blended = sharded(vol, starts_dev, mask_dev, imp_dev)
    (a0, a1), (b0, b1), (c0, c1) = staged.crops
    blended = blended[a0:a1, b0:b1, c0:c1, :]
    if staged.dfirst:
        blended = jnp.transpose(blended, (1, 2, 0, 3))
    return blended
