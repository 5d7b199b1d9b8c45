"""Sliding-window inference with Gaussian blending.

Replaces MONAI 0.4 `sliding_window_inference(mode="gaussian")` as used at
reference params/VSparams.py:568-574. Semantics reproduced exactly:
  - pad each dim to >= roi (symmetric, constant 0)
  - window starts: scan_interval = int(roi*(1-overlap)) (roi if dim==roi);
    scan_num = ceil(dim/interval); start_i = i*interval clamped so the window
    fits (MONAI dense_patch_slices, incl. duplicate clamped windows)
  - Gaussian importance map: impulse-at-center filtered with sigma =
    0.125*roi, truncated at 4*sigma, normalized to max 1, zeros replaced by
    the min nonzero value
  - out = sum(pred * imp) / sum(imp), crop padding

Design differences from the reference:
  - windows are evaluated in batches of `sw_batch_size` (reference: 1, serial)
  - the whole pipeline (slice windows -> predictor -> blend-accumulate) is a
    single jitted XLA program; window starts are traced values so one
    compilation serves every volume with the same padded shape
  - accumulation is f32 in-place via dynamic_update_slice on donated
    accumulators (no per-window output copies in device memory)
  - optional shape bucketing bounds the number of recompiles across a test
    set of heterogeneous volume shapes
"""

from __future__ import annotations

import math
import weakref
from functools import lru_cache, partial
from typing import Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@lru_cache(maxsize=8)
def _importance_map_device(roi_size: Tuple[int, ...], mode: str,
                           sigma_scale: float) -> jnp.ndarray:
    """Device-resident importance map, cached across volumes (38 MB of f32
    for a 384x384x64 ROI, uploaded once instead of per volume)."""
    if mode == "gaussian":
        imp = gaussian_importance_map(roi_size, sigma_scale)
    elif mode == "constant":
        imp = np.ones(roi_size, np.float32)
    else:
        raise ValueError(f"unsupported blend mode {mode}")
    return jnp.asarray(imp)


def gaussian_importance_map(roi_size: Sequence[int],
                            sigma_scale: float = 0.125) -> np.ndarray:
    """MONAI 0.4 compute_importance_map(mode=gaussian) equivalent.

    Filtering an impulse at the center voxel with a truncated (4*sigma)
    separable Gaussian equals the product of per-axis truncated Gaussians
    evaluated at the distance from center — computed here in closed form.
    """
    maps_1d = []
    for dim in roi_size:
        center = dim // 2
        sigma = sigma_scale * dim
        tail = int(4.0 * sigma + 0.5)
        x = np.arange(dim, dtype=np.float64) - center
        g = np.exp(-0.5 * (x / sigma) ** 2)
        g[np.abs(x) > tail] = 0.0
        maps_1d.append(g)
    imp = maps_1d[0][:, None, None] * maps_1d[1][None, :, None] * maps_1d[2][None, None, :]
    imp = (imp / imp.max()).astype(np.float32)
    nz = imp[imp != 0]
    if nz.size and (imp == 0).any():
        imp[imp == 0] = nz.min()
    return imp


def _scan_interval(image_size, roi_size, overlap: float) -> Tuple[int, ...]:
    return tuple(
        int(roi) if roi == dim else int(roi * (1 - overlap))
        for roi, dim in zip(roi_size, image_size))


def dense_patch_starts(image_size, roi_size, overlap: float) -> np.ndarray:
    """MONAI 0.4 dense_patch_slices window starts (duplicates preserved)."""
    intervals = _scan_interval(image_size, roi_size, overlap)
    per_dim = []
    for dim, roi, interval in zip(image_size, roi_size, intervals):
        if interval == 0:
            per_dim.append([0])
            continue
        scan_num = int(math.ceil(float(dim) / interval))
        starts = []
        for i in range(scan_num):
            start = i * interval
            start -= max(start + roi - dim, 0)
            starts.append(start)
        per_dim.append(starts)
    grid = np.stack(np.meshgrid(*per_dim, indexing="ij"), axis=-1)
    return grid.reshape(-1, 3).astype(np.int32)


@partial(jax.jit, static_argnames=("roi_size",))
def _gather_windows(volume, starts, *, roi_size):
    """volume (H,W,D,C), starts (sb,3) -> (sb, *roi, C)."""
    c = volume.shape[-1]

    def one(start):
        return jax.lax.dynamic_slice(volume, (start[0], start[1], start[2], 0),
                                     (*roi_size, c))

    return jax.vmap(one)(starts)


@partial(jax.jit, donate_argnums=(0, 1))
def _scatter_accumulate(out_acc, w_acc, preds, starts, mask, importance):
    """Accumulate pred*imp into out_acc and imp into w_acc at each window.

    out_acc (H,W,D,O), w_acc (H,W,D,1), preds (sb,*roi,O), starts (sb,3),
    mask (sb,). Donated accumulators -> true in-place HBM updates.
    """
    roi_o = preds.shape[1:]
    roi_w = (*preds.shape[1:4], 1)
    imp = importance[None, ..., None] * mask[:, None, None, None, None]
    weighted = preds.astype(jnp.float32) * imp

    def body(i, carry):
        out_acc, w_acc = carry
        s = starts[i]
        idx = (s[0], s[1], s[2], 0)
        cur = jax.lax.dynamic_slice(out_acc, idx, roi_o)
        out_acc = jax.lax.dynamic_update_slice(out_acc, cur + weighted[i], idx)
        cur_w = jax.lax.dynamic_slice(w_acc, idx, roi_w)
        w_acc = jax.lax.dynamic_update_slice(w_acc, cur_w + imp[i], idx)
        return out_acc, w_acc

    return jax.lax.fori_loop(0, preds.shape[0], body, (out_acc, w_acc))


@jax.jit
def _finalize(out_acc, w_acc):
    return out_acc / w_acc


@partial(jax.jit, static_argnames=("out_dtype",))
def _dequantize(vol_u8, scale, offset, out_dtype=jnp.bfloat16):
    return vol_u8.astype(out_dtype) * scale.astype(out_dtype) + offset.astype(out_dtype)


def count_windows(spatial_shape: Sequence[int], roi_size: Sequence[int],
                  overlap: float) -> int:
    """Number of sliding windows for a volume (after pad-to-roi). Order-
    invariant, so callers may pass (H, W, D) or (D, H, W) consistently."""
    padded = tuple(max(int(d), int(r)) for d, r in zip(spatial_shape, roi_size))
    return len(dense_patch_starts(padded, tuple(int(r) for r in roi_size),
                                  overlap))


class StagedVolume:
    """Host-prepared, device-uploaded volume ready for window inference.

    Created by `stage_volume`; staging can run in a background thread so the
    host prep and upload of case i+1 overlap with compute of case i.
    """

    __slots__ = ("vol_dev", "crops", "starts_padded", "mask", "roi_size",
                 "dfirst", "dequant")

    def __init__(self, vol_dev, crops, starts_padded, mask, roi_size, dfirst,
                 dequant):
        self.vol_dev = vol_dev
        self.crops = crops
        self.starts_padded = starts_padded
        self.mask = mask
        self.roi_size = roi_size
        self.dfirst = dfirst
        self.dequant = dequant


def stage_volume(volume: np.ndarray, roi_size: Sequence[int], *,
                 overlap: float = 0.25, sw_batch_size: int = 4,
                 bucket: Optional[Sequence[int]] = None,
                 transfer_dtype=None, quantize: bool = False,
                 predictor_layout: str = "hwdc") -> StagedVolume:
    """Host-side prep + upload: layout transpose, pad-to-roi, window placement,
    optional uint8 quantization of the transfer (max error ~0.02 of the value
    range — below bf16 representation error, and the predictor computes bf16).
    """
    volume = np.asarray(volume, dtype=np.float32)
    assert volume.ndim == 4, "expected (H, W, D, C)"
    roi_size = tuple(int(r) for r in roi_size)
    dfirst = predictor_layout == "dfirst"
    if dfirst:
        roi_size = (roi_size[2], roi_size[0], roi_size[1])
        if bucket is not None:
            bucket = (bucket[2], bucket[0], bucket[1])
    dequant = None
    pad_value = 0
    if quantize:
        # global stats on the ORIGINAL contiguous array (a strided scan of the
        # transposed view is ~5x slower). The range is extended to include
        # 0.0 so the zero pad-to-roi margin is representable: filling pads
        # with raw uint8 0 would dequantize to `lo` (e.g. ~-2 after intensity
        # normalization), corrupting every window that overlaps a pad plane.
        lo = min(float(volume.min()), 0.0)
        hi = max(float(volume.max()), 0.0)
        scale = (hi - lo) / 255.0 if hi > lo else 1.0
        inv_scale = np.float32(1.0 / scale)
        dequant = (np.float32(scale), np.float32(lo))
        out_dtype = np.dtype(np.uint8)
        # code for 0.0, same +0.5-truncation rounding as the block fill
        pad_value = int(np.clip(np.float32(0.0 - lo) * inv_scale + 0.5, 0, 255))
    elif transfer_dtype is not None:
        out_dtype = np.dtype(transfer_dtype)
    else:
        out_dtype = volume.dtype
    src = np.transpose(volume, (2, 0, 1, 3)) if dfirst else volume  # lazy view

    pads, crops = [], []
    for dim, roi in zip(src.shape[:3], roi_size):
        diff = max(roi - dim, 0)
        half = diff // 2
        pads.append((half, diff - half))
        crops.append((half, half + dim))
    padded_shape = [d + p0 + p1 for d, (p0, p1) in zip(src.shape[:3], pads)]
    # Window placement uses the un-bucketed extent (exact MONAI semantics);
    # bucketing only grows the array so the accumulator/gather programs
    # compile for O(1) distinct shapes. The margin gets zero blend weight and
    # lies outside `crops`, so results are bit-identical to unbucketed.
    starts = dense_patch_starts(tuple(padded_shape), roi_size, overlap)
    if bucket is not None:
        for i in range(3):
            padded_shape[i] += (-padded_shape[i]) % bucket[i]

    n = starts.shape[0]
    n_pad = -(-n // sw_batch_size) * sw_batch_size
    mask = np.zeros(n_pad, np.float32)
    mask[:n] = 1.0
    starts_padded = np.zeros((n_pad, 3), np.int32)
    starts_padded[:n] = starts

    # Fill the padded transfer buffer (layout transpose + optional
    # quantization) on the host, then upload it in one device_put.
    out = np.full((*padded_shape, src.shape[3]), pad_value, out_dtype)
    (a0, _), (b0, _), (c0, _) = pads
    block = src
    if quantize:
        # round-to-nearest via +0.5 truncation (np.round's banker's
        # rounding is much slower on large arrays)
        block = np.clip((block - lo) * inv_scale + 0.5, 0.0, 255.0
                        ).astype(np.uint8)
    out[a0:a0 + src.shape[0], b0:b0 + src.shape[1],
        c0:c0 + src.shape[2]] = block
    return StagedVolume(jax.device_put(out), crops, starts_padded, mask,
                        roi_size, dfirst, dequant)


# predictor -> {(win_shape, dtype): out_channels}; weak keys so a dropped
# predictor releases its entry (and an id()-recycled function can't inherit a
# stale count)
_OC_CACHE = weakref.WeakKeyDictionary()


def clear_inference_caches() -> None:
    """Release compiled window-loop programs and their captured predictors.

    `_fused_window_loop` jits with the predictor as a STATIC argument, so its
    cache strongly references every predictor closure (and the model params
    it captures in HBM). A long-lived process evaluating many checkpoints
    should call this between predictors to release the old params; a serving
    loop with one predictor should NOT (it would drop the warm executable).
    """
    _OC_CACHE.clear()
    _fused_window_loop.clear_cache()
    from vs_seg.infer import sharded
    sharded._sharded_program.cache_clear()


def _predictor_out_channels(predictor, win_shape, dtype) -> int:
    """Output channel count via one cached eval_shape (tracing the model per
    volume would cost seconds of host time)."""
    per_pred = _OC_CACHE.setdefault(predictor, {})
    key = (tuple(win_shape), jnp.dtype(dtype).name)
    if key not in per_pred:
        per_pred[key] = jax.eval_shape(
            predictor, jax.ShapeDtypeStruct(tuple(win_shape), dtype)).shape[-1]
    return per_pred[key]


@partial(jax.jit, static_argnames=("predictor", "sw_batch_size",
                                   "roi_size", "out_channels"))
def _fused_window_loop(vol_dev, starts, mask, importance, *, predictor,
                       sw_batch_size, roi_size, out_channels):
    """The WHOLE per-volume window loop (gather -> predict -> blend-scatter
    over all batches -> normalize) as ONE jitted program: a single dispatch
    per volume instead of ~3 per window batch. `out_channels` is supplied by
    the caller (cached eval_shape) so every batch runs inside the fori_loop
    and the predictor body is traced once."""
    c = vol_dev.shape[-1]
    n_batches = starts.shape[0] // sw_batch_size

    def gather(batch_starts):
        def one(s):
            return jax.lax.dynamic_slice(vol_dev, (s[0], s[1], s[2], 0),
                                         (*roi_size, c))
        return jax.vmap(one)(batch_starts)

    s0, s1, s2 = vol_dev.shape[:3]
    out_acc = jnp.zeros((s0, s1, s2, out_channels), jnp.float32)
    w_acc = jnp.zeros((s0, s1, s2, 1), jnp.float32)

    def body(b, carry):
        bs = jax.lax.dynamic_slice(starts, (b * sw_batch_size, 0),
                                   (sw_batch_size, 3))
        bm = jax.lax.dynamic_slice(mask, (b * sw_batch_size,),
                                   (sw_batch_size,))
        preds = predictor(gather(bs))
        with jax.named_scope("blend"):
            return _scatter_accumulate(*carry, preds, bs, bm, importance)

    out_acc, w_acc = jax.lax.fori_loop(0, n_batches, body, (out_acc, w_acc))
    return out_acc / w_acc


def sliding_window_inference(volume, roi_size: Sequence[int],
                             predictor: Callable, *, overlap: float = 0.25,
                             sw_batch_size: int = 4, mode: str = "gaussian",
                             sigma_scale: float = 0.125,
                             bucket: Optional[Sequence[int]] = None,
                             transfer_dtype=None, quantize: bool = False,
                             predictor_layout: str = "hwdc",
                             fused: bool = True) -> jnp.ndarray:
    """Run `predictor` over overlapping ROIs of a whole volume and blend.

    volume: (H, W, D, C) host array, or a `StagedVolume` from `stage_volume`
    (for prefetch pipelines). predictor: (N, *roi, C) -> (N, *roi, out),
    jit-traceable. bucket: optional per-dim multiples to round padded shapes
    up to, bounding recompilation across heterogeneous volumes.
    transfer_dtype: dtype for the host->device volume transfer (bf16 halves
    H2D bytes); quantize=True sends uint8 (quarter bytes) + dequantizes on
    device. predictor_layout: "hwdc" for (N, H, W, D, C) tiles, "dfirst" for
    the model-native (N, D, H, W, C) (no per-batch transposes).
    fused: run the whole window loop as one jitted program (default) or as
    one dispatch per window batch.
    Returns (H, W, D, out_channels) blended logits on device.
    """
    if isinstance(volume, StagedVolume):
        staged = volume
    else:
        staged = stage_volume(volume, roi_size, overlap=overlap,
                              sw_batch_size=sw_batch_size, bucket=bucket,
                              transfer_dtype=transfer_dtype, quantize=quantize,
                              predictor_layout=predictor_layout)
    roi_size = staged.roi_size

    vol_dev = staged.vol_dev
    if staged.dequant is not None:
        scale, offset = staged.dequant
        vol_dev = _dequantize(vol_dev, jnp.asarray(scale), jnp.asarray(offset))
    imp_dev = _importance_map_device(roi_size, mode, sigma_scale)
    s0, s1, s2 = vol_dev.shape[:3]  # padded volume dims (internal order)
    n_pad = staged.starts_padded.shape[0]
    assert n_pad % sw_batch_size == 0, (
        f"staged window list ({n_pad}, padded for "
        f"stage_volume(sw_batch_size=...)) is not divisible by the inference "
        f"sw_batch_size={sw_batch_size}: trailing windows would be silently "
        "dropped (NaN regions). Use the same sw_batch_size for staging and "
        "inference, or a divisor of the staged padding.")

    if fused:
        oc = _predictor_out_channels(
            predictor, (sw_batch_size, *roi_size, vol_dev.shape[-1]),
            vol_dev.dtype)
        blended = _fused_window_loop(
            vol_dev, jax.device_put(staged.starts_padded),
            jax.device_put(staged.mask), imp_dev, predictor=predictor,
            sw_batch_size=sw_batch_size, roi_size=roi_size, out_channels=oc)
        (a0, a1), (b0, b1), (c0, c1) = staged.crops
        blended = blended[a0:a1, b0:b1, c0:c1, :]
        if staged.dfirst:
            blended = jnp.transpose(blended, (1, 2, 0, 3))
        return blended

    out_acc = w_acc = None
    for b in range(n_pad // sw_batch_size):
        sl = slice(b * sw_batch_size, (b + 1) * sw_batch_size)
        batch_starts = jax.device_put(staged.starts_padded[sl])
        wins = _gather_windows(vol_dev, batch_starts, roi_size=roi_size)
        preds = predictor(wins)
        if out_acc is None:
            oc = preds.shape[-1]
            out_acc = jnp.zeros((s0, s1, s2, oc), jnp.float32)
            w_acc = jnp.zeros((s0, s1, s2, 1), jnp.float32)
        out_acc, w_acc = _scatter_accumulate(
            out_acc, w_acc, preds, batch_starts,
            jax.device_put(staged.mask[sl]), imp_dev)
    blended = _finalize(out_acc, w_acc)
    (a0, a1), (b0, b1), (c0, c1) = staged.crops
    blended = blended[a0:a1, b0:b1, c0:c1, :]
    if staged.dfirst:
        blended = jnp.transpose(blended, (1, 2, 0, 3))  # (D,H,W,O) -> (H,W,D,O)
    return blended
