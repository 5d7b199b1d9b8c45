"""Plain float32 references for the model forward and the window blend.

Both are written straight from the reference semantics, independently of the
production code paths they check:

* `reference_forward` evaluates UNet2d5_spvPA / UNet2d5 / UNet in eval mode
  from a variables tree, in the reference's own (B, H, W, D, C) order, with
  every conv a plain 3D `lax.conv_general_dilated` at HIGHEST precision, the
  skip connections concatenated, BatchNorm applied as written (not folded
  into the conv), the logit head unfolded, and each transpose conv computed
  as the adjoint (VJP) of the strided conv it inverts. The production model
  instead folds kd=1 convs to 2D, splits convs over the concat halves, folds
  BatchNorm and the head residual, and computes in bfloat16.
* `numpy_blend` / `numpy_scatter_accumulate` transcribe MONAI 0.4's
  Gaussian-blended sliding-window accumulation in numpy.
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

_DN = ("NHWDC", "HWDIO", "NHWDC")
_HI = jax.lax.Precision.HIGHEST


def _triple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (int(v),) * 3


def _pad(k):
    return [((ki - 1) // 2,) * 2 for ki in k]


def _conv(x, p, strides=(1, 1, 1)):
    """Same-padded Conv3d on (B, H, W, D, C), kernel (kh, kw, kd, I, O)."""
    w = p["kernel"]
    y = jax.lax.conv_general_dilated(x, w, _triple(strides), _pad(w.shape[:3]),
                                     dimension_numbers=_DN, precision=_HI)
    return y + p["bias"]


def _conv_transpose(x, p, strides):
    """torch ConvTranspose3d with MONAI's output_padding (output = input *
    stride): the adjoint of the strided conv out*stride -> in."""
    w = p["kernel"]                       # (kh, kw, kd, Cin, Cout)
    w_fwd = jnp.swapaxes(w, 3, 4)         # the forward conv Cout -> Cin
    s = _triple(strides)
    out_shape = (x.shape[0], *(n * si for n, si in zip(x.shape[1:4], s)),
                 w.shape[4])
    z = jnp.zeros(out_shape, x.dtype)
    _, vjp = jax.vjp(lambda t: jax.lax.conv_general_dilated(
        t, w_fwd, s, _pad(w.shape[:3]), dimension_numbers=_DN,
        precision=_HI), z)
    return vjp(x)[0] + p["bias"]


def _batchnorm(x, p, s, eps=1e-5):
    return (x - s["mean"]) / jnp.sqrt(s["var"] + eps) * p["scale"] + p["bias"]


def _act(x, kind, p):
    if kind == "prelu":
        a = p["act"]["alpha"]
        return jnp.where(x >= 0, x, a * x)
    if kind == "relu":
        return jnp.maximum(x, 0.0)
    if kind == "sigmoid":
        return 1.0 / (1.0 + jnp.exp(-x))
    return x


def _convolution(x, p, s, strides=(1, 1, 1), act="prelu", norm=True,
                 conv_only=False, transposed=False):
    y = (_conv_transpose(x, p["conv"], strides) if transposed
         else _conv(x, p["conv"], strides))
    if conv_only:
        return y
    if norm:
        y = _batchnorm(y, p["norm"], s["norm"])
    return _act(y, act, p)


def _residual_unit(x, p, s, kernel, strides, subunits, last_conv_only):
    cx = x
    for su in range(subunits):
        cx = _convolution(cx, p[f"unit{su}"], s.get(f"unit{su}", {}),
                          strides if su == 0 else (1, 1, 1),
                          conv_only=last_conv_only and su == subunits - 1)
    res = _conv(x, p["residual"], strides) if "residual" in p else x
    return cx + res


def _attention(x, p):
    a1 = _convolution(x, p["conv1"], {}, act="relu", norm=False)
    att = _convolution(a1, p["conv2"], {}, act="sigmoid", norm=False)
    return att, att * x + x


def _unet2d5_spvpa(m, p, s, x):
    n = len(m.strides)
    att_maps, skips = [], []
    for i in range(n):
        x = _residual_unit(x, p[f"down_{i}"], s[f"down_{i}"],
                           m.kernel_sizes[i], (1, 1, 1), m.num_res_units,
                           False)
        skips.append(x)
        x = _convolution(x, p[f"downsample_{i}"], s[f"downsample_{i}"],
                         m.strides[i])
    if m.attention_module:
        att, x = _attention(x, p["bottom_att"])
        att_maps.append(att)
    x = _residual_unit(x, p["bottom"], s["bottom"], m.kernel_sizes[n],
                       (1, 1, 1), m.num_res_units, False)
    for i in reversed(range(n)):
        x = _convolution(x, p[f"upsample_{i}"], s[f"upsample_{i}"],
                         m.strides[i], transposed=True)
        x = jnp.concatenate([skips[i], x], axis=-1)
        if m.attention_module:
            att, x = _attention(x, p[f"upatt_{i}"])
            att_maps.append(att)
        x = _residual_unit(x, p[f"up_{i}"], s.get(f"up_{i}", {}), m.kernel_sizes[i],
                           (1, 1, 1), 1, i == 0)
    return x, tuple(att_maps)


def _unet(m, p, s, x):
    n = len(m.strides)

    def down(x, name, strides):
        if m.num_res_units > 0:
            return _residual_unit(x, p[name], s[name], m.kernel_size, strides,
                                  m.num_res_units, False)
        return _convolution(x, p[name], s[name], strides)

    skips = []
    for i in range(n):
        x = down(x, f"down_{i}", m.strides[i])
        skips.append(x)
    x = down(x, "bottom", (1, 1, 1))
    for i in reversed(range(n)):
        top = i == 0
        x = jnp.concatenate([skips[i], x], axis=-1)
        x = _convolution(x, p[f"up_{i}"], s.get(f"up_{i}", {}), m.strides[i],
                         transposed=True,
                         conv_only=top and m.num_res_units == 0)
        if m.num_res_units > 0:
            x = _residual_unit(x, p[f"upres_{i}"], s.get(f"upres_{i}", {}),
                               m.kernel_size, (1, 1, 1), 1, top)
    return x


def reference_forward(model, variables, x):
    """Eval-mode float32 forward. `x` and the result are in the production
    (B, D, H, W, C) layout; returns what `model.apply(..., train=False)`
    returns: (logits, att_maps) for UNet2d5_spvPA, logits otherwise."""
    from vs_seg.models import UNet, UNet2d5, UNet2d5_spvPA

    p = variables["params"]
    s = variables.get("batch_stats", {})
    xr = jnp.transpose(jnp.asarray(x, jnp.float32), (0, 2, 3, 1, 4))

    def back(t):
        return jnp.transpose(t, (0, 3, 1, 2, 4))

    if isinstance(model, UNet2d5_spvPA):
        logits, atts = _unet2d5_spvpa(model, p, s, xr)
        return back(logits), tuple(back(a) for a in atts)
    if isinstance(model, UNet2d5):
        net = UNet2d5_spvPA(
            out_channels=model.out_channels, channels=model.channels,
            strides=model.strides, kernel_sizes=model.kernel_sizes,
            sample_kernel_sizes=model.sample_kernel_sizes,
            num_res_units=model.num_res_units, attention_module=False)
        logits, _ = _unet2d5_spvpa(net, p["net"], s.get("net", {}), xr)
        return back(logits)
    if isinstance(model, UNet):
        return back(_unet(model, p, s, xr))
    raise TypeError(f"no reference forward for {type(model).__name__}")


def numpy_scatter_accumulate(out_acc, w_acc, preds, starts, mask, importance):
    """numpy transcription of sliding_window._scatter_accumulate: window i
    adds preds[i]*imp*mask[i] to out_acc and imp*mask[i] to w_acc at
    starts[i]."""
    out_acc = np.array(out_acc, np.float32)
    w_acc = np.array(w_acc, np.float32)
    roi = preds.shape[1:4]
    for i, st in enumerate(np.asarray(starts)):
        sl = tuple(slice(int(a), int(a) + r) for a, r in zip(st, roi))
        imp = np.asarray(importance, np.float32)[..., None] * float(mask[i])
        out_acc[sl] += np.asarray(preds[i], np.float32) * imp
        w_acc[sl] += imp
    return out_acc, w_acc


def numpy_blend(volume: np.ndarray, roi: Sequence[int], overlap: float,
                predictor_np: Callable, mode: str = "gaussian") -> np.ndarray:
    """MONAI 0.4 sliding_window_inference on an (H, W, D, C) volume: pad to
    the ROI, predict every window, Gaussian- (or constant-) weighted
    average, crop."""
    from vs_seg.infer.sliding_window import (dense_patch_starts,
                                             gaussian_importance_map)
    H, W, D, C = volume.shape
    pads, crops = [], []
    for dim, r in zip((H, W, D), roi):
        diff = max(r - dim, 0)
        pads.append((diff // 2, diff - diff // 2))
        crops.append((diff // 2, diff // 2 + dim))
    vol = np.pad(volume, pads + [(0, 0)])
    starts = dense_patch_starts(vol.shape[:3], roi, overlap)
    imp = (gaussian_importance_map(roi) if mode == "gaussian"
           else np.ones(roi, np.float32))
    preds = np.stack([
        predictor_np(vol[s[0]:s[0] + roi[0], s[1]:s[1] + roi[1],
                         s[2]:s[2] + roi[2]][None])[0] for s in starts])
    out, wsum = numpy_scatter_accumulate(
        np.zeros((*vol.shape[:3], preds.shape[-1]), np.float32),
        np.zeros((*vol.shape[:3], 1), np.float32), preds, starts,
        np.ones(len(starts), np.float32), imp)
    blended = out / wsum
    (h0, h1), (w0, w1), (d0, d1) = crops
    return blended[h0:h1, w0:w1, d0:d1]
