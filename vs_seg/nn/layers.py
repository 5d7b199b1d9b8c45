"""Low-level NN primitives (channels-last NDHWC).

Semantics match the reference building blocks exactly so that imported
reference checkpoints reproduce outputs:
  - conv / transpose-conv padding arithmetic: reference
    params/networks/blocks/convolutions.py:85,114-135 (MONAI same_padding +
    output_padding = strides + 2*padding - dilation*(kernel-1) - 1, giving
    output = input * stride for the transpose path)
  - BatchNorm: torch BatchNorm3d semantics (biased batch stats for
    normalization, unbiased for the running-var update, momentum 0.1, eps 1e-5)
  - PReLU: single shared parameter, init 0.25 (MONAI Act.PRELU default)
  - Dropout: elementwise, train-only, inverted scaling

Layout: activations (B, D, H, W, C) — depth adjacent to batch. This makes
every "2.5D" conv (kernel depth 1, stride depth 1 — levels 0-1 of the
reference net) a free-reshape 2D convolution over (B*D, H, W, C); full
(3,3,3) convs run as 3D convs in (D, H, W) spatial order.

Public API convention: kernel sizes/strides are given in reference (H, W, D)
order and conv kernels are stored (kh, kw, kd, Cin, Cout) — reordering to the
internal (D, H, W) spatial order happens inside `conv3d` (a trace-time weight
transpose, fused by XLA). Activations stay in `dtype` (bfloat16 by default)
end-to-end; BatchNorm statistics are computed in float32.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vs_seg.nn.module import Module, constant, ones, uniform, zeros

Shape3 = Tuple[int, int, int]

_DN3 = ("NDHWC", "DHWIO", "NDHWC")
_DN2 = ("NHWC", "HWIO", "NHWC")

# When set to a list (see eval/flops.py), conv3d appends its analytic FLOP
# count (2 * out_elems * kh*kw*kd * Cin) at trace time — the shape-derived
# FLOP count that achieved-rate figures divide by.
_FLOP_TRACE: Optional[list] = None

# Spatial-sharding context (infer/spatial.py): when set to (axis_name, n)
# inside a shard_map region, conv3d sees LOCAL H blocks and exchanges conv
# halos with jax.lax.ppermute instead of zero-padding H (SURVEY §5: sharding
# one window/volume across the mesh — the reference's "long context" analog,
# counterpart of the tiling at params/VSparams.py:568-574).
_SPATIAL: Optional[Tuple[str, int]] = None


class spatial_sharding:
    """Context manager enabling halo-exchange convs (trace-time toggle)."""

    def __init__(self, axis_name: str, n_shards: int):
        self.ctx = (axis_name, int(n_shards))

    def __enter__(self):
        global _SPATIAL
        self._prev, _SPATIAL = _SPATIAL, self.ctx

    def __exit__(self, *exc):
        global _SPATIAL
        _SPATIAL = self._prev


def _triple(v) -> Shape3:
    if isinstance(v, (tuple, list)):
        assert len(v) == 3
        return tuple(int(x) for x in v)
    return (int(v),) * 3


def same_padding(kernel_size, dilation=1) -> Shape3:
    """MONAI same_padding: (k - 1) // 2 * d per dim (odd kernels exact)."""
    k = np.asarray(_triple(kernel_size))
    d = np.asarray(_triple(dilation))
    return tuple(int(p) for p in (k - 1) // 2 * d)


def _d2c_enabled() -> bool:
    import os
    return os.environ.get("VS_D2C", "0") == "1"


def _dot11_enabled() -> bool:
    import os
    return os.environ.get("VS_DOT11", "0") == "1"


def conv3d(x: jnp.ndarray, w: jnp.ndarray, b: Optional[jnp.ndarray],
           strides: Shape3, padding: Sequence[Tuple[int, int]],
           dtype=jnp.bfloat16, lhs_dilation: Optional[Shape3] = None) -> jnp.ndarray:
    """Convolution on (B, D, H, W, C) activations.

    `strides`/`padding`/`lhs_dilation` and the kernel `w` (kh,kw,kd,I,O) are
    given in reference (H, W, D) order. Depth-trivial convs (kd == 1 and unit
    depth stride/dilation) are folded to 2D over (B*D, H, W, C) — a free
    reshape since D is adjacent to batch.
    """
    precision = (jax.lax.Precision.HIGHEST if dtype == jnp.float32 else None)
    x = x.astype(dtype)
    w = w.astype(dtype)
    B, D = x.shape[0], x.shape[1]
    kh, kw, kd = w.shape[0], w.shape[1], w.shape[2]
    sh, sw, sd = strides
    ph, pw, pd = padding
    ld = lhs_dilation or (1, 1, 1)
    if _SPATIAL is not None:
        # x is a LOCAL H block inside a shard_map region: replace H zero
        # padding with a neighbor halo exchange (exact vs the dense conv —
        # tests/test_spatial.py).
        from vs_seg.ops.halo import exchange_halo
        axis_name, n_shards = _SPATIAL
        if ld[0] == 1:
            halo = (int(ph[0]), max(kh - int(ph[0]) - sh, 0))
            ph = (0, 0)
        else:
            # transpose conv in H (lhs-dilated): with MONAI's output_padding
            # (output = input*stride, convolutions.py:114-135) the padding is
            # lo = kh-1-p, hi = s+p-1. Per shard: output block [a, a+hl*s)
            # (a = shard_idx*hl*s) reads global dilated positions
            # [a-lo, a+hl*s-1+p]; real (non-dilation-zero) rows at multiples
            # of s give halos (lo//s, ceil(p/s)), and local re-padding
            # (lo%s, p-1+s*(1-ceil(p/s))) realigns the dilated block so
            # local output row o is exactly global row a+o. Exact vs dense:
            # tests/test_spatial.py::test_spatial_transpose_conv_matches_dense.
            s_h = int(ld[0])
            lo = int(ph[0])
            p_h = kh - 1 - lo
            assert p_h >= 0 and int(ph[1]) == s_h + p_h - 1, (
                "spatial sharding supports MONAI transpose-conv arithmetic "
                f"only (output = input*stride); got kh={kh} ld={s_h} ph={ph}")
            halo_r = -(-p_h // s_h)
            halo = (lo // s_h, halo_r)
            ph = (lo % s_h, p_h - 1 + s_h * (1 - halo_r))
        x = exchange_halo(x, halo, axis_name, spatial_axis=2,
                          n_shards=n_shards)
    if ((kh, kw, kd) == (1, 1, 1) and (sh, sw, sd) == (1, 1, 1)
            and lhs_dilation is None
            and tuple(ph) == tuple(pw) == tuple(pd) == (0, 0)
            and _dot11_enabled()):
        # 1x1x1 stride-1 conv as a direct channel contraction (VS_DOT11=1,
        # default off). Same values as the conv; whether it is faster on
        # the GPU has not been measured.
        y = jax.lax.dot_general(x, w[0, 0, 0], (((4,), (0,)), ((), ())),
                                precision=precision)
    elif kd == 1 and sd == 1 and ld[2] == 1 and tuple(pd) == (0, 0):
        y = jax.lax.conv_general_dilated(
            x.reshape(B * D, *x.shape[2:]), w[:, :, 0],
            window_strides=(sh, sw), padding=[ph, pw],
            lhs_dilation=None if lhs_dilation is None else ld[:2],
            dimension_numbers=_DN2, precision=precision)
        y = y.reshape(B, D, *y.shape[1:])
    elif (kd == 3 and tuple(pd) == (1, 1) and lhs_dilation is None
          and _SPATIAL is None and _d2c_enabled()):
        # depth-in-channels (VS_D2C=1, default off): a (3,3,3) conv as ONE
        # folded-2D conv whose input stacks the d-1/d/d+1 planes along C
        # (kd*Cin input channels), keeping every level in the folded-2D
        # layout. Exact: channel index dd*Cin+c matches the
        # (kh,kw,kd,Cin,Cout) -> (kh,kw,kd*Cin,Cout) weight reshape.
        C = x.shape[-1]
        zeros = ((0, 0),)
        x_m = jnp.pad(x, zeros + ((1, 0),) + zeros * 3)[:, :D]
        x_p = jnp.pad(x, zeros + ((0, 1),) + zeros * 3)[:, 1:]
        xcat = jnp.concatenate([x_m, x, x_p], axis=-1)
        if sd != 1:
            xcat = xcat[:, ::sd]
        Dc = xcat.shape[1]
        y = jax.lax.conv_general_dilated(
            xcat.reshape(B * Dc, *xcat.shape[2:]),
            w.reshape(w.shape[0], w.shape[1], 3 * C, w.shape[4]),
            window_strides=(sh, sw), padding=[ph, pw],
            dimension_numbers=_DN2, precision=precision)
        y = y.reshape(B, Dc, *y.shape[1:])
    else:
        y = jax.lax.conv_general_dilated(
            x, jnp.transpose(w, (2, 0, 1, 3, 4)),
            window_strides=(sd, sh, sw), padding=[pd, ph, pw],
            lhs_dilation=None if lhs_dilation is None else (ld[2], ld[0], ld[1]),
            dimension_numbers=_DN3, precision=precision)
    if b is not None:
        y = y + b.astype(y.dtype)
    if _FLOP_TRACE is not None:
        _FLOP_TRACE.append(2 * int(np.prod(y.shape)) * int(np.prod(w.shape[:4])))
    return y


class Conv3d(Module):
    """Plain 3D convolution with torch-Conv3d-compatible init and padding.

    `x` may be a PAIR (xa, xb) of tensors standing for their channel concat:
    the conv is computed as conv(xa, w[..., :ca, :]) + conv(xb, w[..., ca:, :])
    — algebraically identical to conv(concat), with the SAME parameter tensor,
    but without materializing the concatenated activation."""

    features: int
    kernel_size: Shape3
    strides: Shape3 = (1, 1, 1)
    padding: Optional[Shape3] = None  # None -> same_padding
    use_bias: bool = True
    dtype: jnp.dtype = jnp.bfloat16

    def __call__(self, x, affine=None):
        k = _triple(self.kernel_size)
        s = _triple(self.strides)
        p = same_padding(k) if self.padding is None else _triple(self.padding)
        pair = isinstance(x, (tuple, list))
        cin = (sum(v.shape[-1] for v in x) if pair else x.shape[-1])
        # torch Conv3d default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for both
        # kernel (kaiming_uniform with a=sqrt(5)) and bias.
        init = uniform(1.0 / np.sqrt(cin * int(np.prod(k))))
        w = self.param("kernel", init, (*k, cin, self.features), jnp.float32)
        b = (self.param("bias", init, (self.features,), jnp.float32)
             if self.use_bias else None)
        if affine is not None:
            # fold a frozen per-out-channel affine (e.g. eval BatchNorm) into
            # the weights, in f32: conv(x, w)*inv + shift == conv(x, w*inv)
            # + (b*inv + shift)
            inv, shift = affine
            w = w * inv
            b = shift if b is None else b * inv + shift
        pads = [(pi, pi) for pi in p]
        if pair:
            ca = x[0].shape[-1]
            ya = conv3d(x[0], w[..., :ca, :], None, s, pads, dtype=self.dtype)
            yb = conv3d(x[1], w[..., ca:, :], b, s, pads, dtype=self.dtype)
            return ya + yb
        return conv3d(x, w, b, s, pads, dtype=self.dtype)


class ConvTranspose3d(Module):
    """Transpose conv with exact torch-ConvTranspose3d output arithmetic.

    With MONAI's output_padding choice (reference convolutions.py:114-135) the
    output shape is exactly input*stride. Implemented as an input-dilated conv
    with spatially flipped kernels (the adjoint of the strided conv).
    """

    features: int
    kernel_size: Shape3
    strides: Shape3 = (1, 1, 1)
    use_bias: bool = True
    dtype: jnp.dtype = jnp.bfloat16

    def __call__(self, x, affine=None):
        k = np.asarray(_triple(self.kernel_size))
        s = np.asarray(_triple(self.strides))
        p = np.asarray(same_padding(tuple(k)))
        output_padding = s + 2 * p - (k - 1) - 1
        # dilated-input conv padding: (k-1-p) low, (k-1-p+output_padding) high
        pad = [(int(ki - 1 - pi), int(ki - 1 - pi + opi))
               for ki, pi, opi in zip(k, p, output_padding)]
        cin = x.shape[-1]
        # torch ConvTranspose3d init: fan_in = Cout * prod(k) (weight shape (Cin,Cout,k..))
        init = uniform(1.0 / np.sqrt(self.features * int(np.prod(k))))
        w = self.param("kernel", init, (*[int(v) for v in k], cin, self.features),
                       jnp.float32)
        b = (self.param("bias", init, (self.features,), jnp.float32)
             if self.use_bias else None)
        if affine is not None:
            inv, shift = affine
            w = w * inv
            b = shift if b is None else b * inv + shift
        return conv3d(x, jnp.flip(w, axis=(0, 1, 2)), b, (1, 1, 1), pad,
                      dtype=self.dtype, lhs_dilation=tuple(int(v) for v in s))


class BatchNorm(Module):
    """torch BatchNorm3d semantics over NDHWC (normalize with biased batch
    stats; running var updated with the unbiased estimate).

    `fold=True` (eval only) returns the equivalent per-channel affine
    (inv, shift) instead of applying it, so the caller can fold the frozen
    normalization into the preceding conv's weights — one fewer full-tensor
    pass per Convolution block at inference (`features` supplies the channel
    count since no activation is seen)."""

    momentum: float = 0.1
    eps: float = 1e-5
    features: Optional[int] = None

    def __call__(self, x, train: bool, fold: bool = False):
        c = self.features if x is None else x.shape[-1]
        scale = self.param("scale", ones, (c,), jnp.float32)
        bias = self.param("bias", zeros, (c,), jnp.float32)
        ra_mean = self.variable("batch_stats", "mean",
                                lambda: jnp.zeros((c,), jnp.float32))
        ra_var = self.variable("batch_stats", "var",
                               lambda: jnp.ones((c,), jnp.float32))
        if fold:
            if train:
                raise ValueError("BN folding is an eval-only transformation")
            inv = jax.lax.rsqrt(ra_var.value + self.eps) * scale
            return inv, bias - ra_mean.value * inv
        x_dtype = x.dtype
        if train:
            axes = tuple(range(x.ndim - 1))
            xf = x.astype(jnp.float32)
            mean = jnp.mean(xf, axes)
            var = jnp.mean(jnp.square(xf), axes) - jnp.square(mean)
            if not self.is_initializing():
                n = float(np.prod([x.shape[a] for a in axes]))
                unbiased = var * (n / max(n - 1.0, 1.0))
                m = self.momentum
                ra_mean.value = (1 - m) * ra_mean.value + m * mean
                ra_var.value = (1 - m) * ra_var.value + m * unbiased
        else:
            mean, var = ra_mean.value, ra_var.value
        inv = jax.lax.rsqrt(var + self.eps) * scale
        if x_dtype == jnp.float32:
            return (x - mean) * inv + bias
        # low-precision activations: fold into a single scale/shift applied
        # in the activation dtype (stats/params stay f32)
        shift = bias - mean * inv
        return x * inv.astype(x_dtype) + shift.astype(x_dtype)


class PReLU(Module):
    """Single shared slope (torch PReLU num_parameters=1, init 0.25 — the
    MONAI Act.PRELU default used at reference convolutions.py:96)."""

    def __call__(self, x):
        a = self.param("alpha", constant(0.25), (1,), jnp.float32)
        return jnp.maximum(x, 0) + a.astype(x.dtype) * jnp.minimum(x, 0)


class Dropout(Module):
    """Inverted dropout (torch semantics). The Bernoulli mask is drawn by
    thresholding one u16 random word per element instead of a f32 uniform —
    half the generated bits. Keep probability is quantized to 1/65536 (6e-7
    absolute for the reference rate 0.1); the inverted scale uses the exact
    quantized keep, so E[dropout(x)] == x holds exactly."""

    rate: float

    def __call__(self, x, train: bool):
        if not train or self.rate == 0.0:
            return x
        thresh = int(round((1.0 - self.rate) * 65536.0))
        if thresh >= 65536:  # rate below representable: identity
            return x
        keep = thresh / 65536.0
        rng = self.make_rng("dropout")
        mask = jax.random.bits(rng, x.shape, jnp.uint16) < jnp.uint16(thresh)
        return jnp.where(mask, x / keep, 0.0)
