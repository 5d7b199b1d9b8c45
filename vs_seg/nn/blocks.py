"""Composite NN blocks mirroring the reference block zoo.

  Convolution  -- (Conv|ConvTrans) -> Norm -> (Dropout) -> (Act)
                  (reference params/networks/blocks/convolutions.py:22-156)
  ResidualUnit -- N sequential Convolutions + additive residual (1x1 conv when
                  channels change; reference convolutions.py:159-255)
  AttentionBlock1/2 -- spatial-gating attention producing a single-channel map
                  (reference params/networks/blocks/attentionblock.py:6-47)

All blocks are modules (nn/module.py) on NDHWC; `train` switches
BatchNorm/Dropout mode (replacing torch's module-level train()/eval() state).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vs_seg.nn.layers import (
    BatchNorm, Conv3d, ConvTranspose3d, Dropout, PReLU, Shape3, _triple,
    conv3d, same_padding,
)
from vs_seg.nn.module import Module


def folded_conv_affine(unit_params, unit_stats):
    """Eval BatchNorm folded into a post-conv affine INCLUDING the conv
    bias: y = conv(x) * scale + shift."""
    ub = unit_stats["norm"]
    inv = unit_params["norm"]["scale"] * jax.lax.rsqrt(ub["var"] + 1e-5)
    shift = (unit_params["norm"]["bias"] - ub["mean"] * inv
             + unit_params["conv"]["bias"] * inv)
    return inv, shift


def _center_embed(wr, k: Shape3):
    """A 1x1x1 kernel zero-padded to a centred `k` kernel (same values).
    Built by pad: an .at[].set scatter miscomposes with the manual mesh
    inside shard_map regions."""
    return jnp.pad(wr, [(k[0] // 2,) * 2, (k[1] // 2,) * 2,
                        (k[2] // 2,) * 2, (0, 0), (0, 0)])


def _conv_maybe_pair(x, w, b, pads, dtype):
    """conv3d on an activation or on a channel-concat pair (xa, xb)."""
    one = (1, 1, 1)
    if isinstance(x, (tuple, list)):
        ca = x[0].shape[-1]
        return (conv3d(x[0], w[..., :ca, :], None, one, pads, dtype=dtype)
                + conv3d(x[1], w[..., ca:, :], b, one, pads, dtype=dtype))
    return conv3d(x, w, b, one, pads, dtype=dtype)


class Convolution(Module):
    """Conv -> BatchNorm -> Dropout -> Activation, or conv_only."""

    features: int
    kernel_size: Shape3
    strides: Shape3 = (1, 1, 1)
    act: Optional[str] = "prelu"       # "prelu" | "relu" | "sigmoid" | None
    norm: Optional[str] = "batch"      # "batch" | None
    dropout: Optional[float] = None
    conv_only: bool = False
    is_transposed: bool = False
    dtype: jnp.dtype = jnp.bfloat16

    def __call__(self, x, train: bool = False):
        conv_cls = ConvTranspose3d if self.is_transposed else Conv3d
        conv = conv_cls(self.features, self.kernel_size, _triple(self.strides),
                        dtype=self.dtype, name="conv")
        if self.conv_only:
            return conv(x)
        if self.norm == "batch":
            if train:
                y = BatchNorm(name="norm")(conv(x), train)
            else:
                # frozen BN folds into the conv weights: one fewer full-tensor
                # pass per block at inference, numerically the same affine
                affine = BatchNorm(name="norm", features=self.features)(
                    None, train, fold=True)
                y = conv(x, affine=affine)
        elif self.norm is None:
            y = conv(x)
        else:
            raise ValueError(f"unsupported norm {self.norm}")
        if self.dropout:
            y = Dropout(self.dropout, name="dropout")(y, train)
        if self.act == "prelu":
            y = PReLU(name="act")(y)
        elif self.act == "relu":
            y = jax.nn.relu(y)
        elif self.act == "sigmoid":
            y = jax.nn.sigmoid(y)
        elif self.act is not None:
            raise ValueError(f"unsupported act {self.act}")
        return y


class ResidualUnit(Module):
    """`subunits` Convolutions + additive residual.

    Residual branch: identity if same channels and stride 1; otherwise a conv
    (1x1x1 kernel when stride==1, reference convolutions.py:241-250).
    `last_conv_only` strips norm/act from the final subunit (logit head).
    """

    features: int
    kernel_size: Shape3
    strides: Shape3 = (1, 1, 1)
    subunits: int = 2
    act: Optional[str] = "prelu"
    norm: Optional[str] = "batch"
    dropout: Optional[float] = None
    last_conv_only: bool = False
    dtype: jnp.dtype = jnp.bfloat16

    def __call__(self, x, train: bool = False):
        strides = _triple(self.strides)
        pair = isinstance(x, (tuple, list))
        in_features = (sum(v.shape[-1] for v in x) if pair else x.shape[-1])
        cx = x
        subunits = max(1, self.subunits)
        for su in range(subunits):
            conv_only = self.last_conv_only and su == subunits - 1
            cx = Convolution(
                self.features, self.kernel_size,
                strides if su == 0 else (1, 1, 1),
                act=self.act, norm=self.norm, dropout=self.dropout,
                conv_only=conv_only, dtype=self.dtype, name=f"unit{su}",
            )(cx, train)
        if int(np.prod(strides)) != 1 or in_features != self.features:
            rkernel = self.kernel_size if int(np.prod(strides)) != 1 else (1, 1, 1)
            rpad = None if int(np.prod(strides)) != 1 else (0, 0, 0)
            res = Conv3d(self.features, rkernel, strides, padding=rpad,
                         dtype=self.dtype, name="residual")(x)
            if self._res331_enabled(train, pair, rkernel):
                # VS_RES331=1 (default off): the pair-input 1x1x1 residual
                # recomputed as a (3,3,1) conv with wr centre-embedded in a
                # zero kernel — 9x the MACs of a cheap conv, identical
                # values. The traced 1x1 conv above keeps the parameters
                # and falls to DCE. Exactness:
                # tests/test_model.py::test_res331_matches_reference.
                p = self.variables["params"]["residual"]
                k = _triple(self.kernel_size)
                res = _conv_maybe_pair(
                    x, _center_embed(p["kernel"], k), p["bias"],
                    [(pi, pi) for pi in same_padding(k)], self.dtype)
        else:
            if pair:
                raise ValueError("identity residual undefined for pair input")
            res = x
        out = cx + res
        if self._headfold_enabled(train, in_features):
            # Conv-only logit head (up_0: subunits=1 + last_conv_only,
            # reference convolutions.py:218,231): with NO norm/act between,
            # out = conv0(x) + b0 + conv1x1(x) + br is LINEAR in the
            # kernels, so the residual folds EXACTLY into unit0's conv
            # (wr centre-embedded, biases summed) with unchanged
            # cin/cout/kernel/strides: one conv and no add instead of two
            # convs and an add. Exactness pinned by
            # tests/test_model.py::test_headfold_matches_reference;
            # VS_HEADFOLD=0 restores the unfolded head.
            p = self.variables["params"]
            k = _triple(self.kernel_size)
            wf = p["unit0"]["conv"]["kernel"] + _center_embed(
                p["residual"]["kernel"], k)
            bf = p["unit0"]["conv"]["bias"] + p["residual"]["bias"]
            return _conv_maybe_pair(x, wf, bf,
                                    [(pi, pi) for pi in same_padding(k)],
                                    self.dtype)
        if self._resfold_enabled(train, in_features):
            # VS_RESFOLD=1 (default off): at eval, the 1x1 residual as
            # extra output channels of unit0's conv (wr centre-embedded in
            # a zero (3,3,1) kernel); unit1 + the add recomputed from the
            # folded params so the traced chain above falls to DCE.
            # Exactness: tests/test_model.py::test_resfold_matches_reference.
            return self._resfold_apply(x, in_features)
        return out

    def _res331_enabled(self, train: bool, pair: bool, rkernel) -> bool:
        return (not train and pair and _triple(rkernel) == (1, 1, 1)
                and _triple(self.kernel_size) == (3, 3, 1)
                and not self.is_initializing()
                and os.environ.get("VS_RES331", "0") == "1")

    def _headfold_enabled(self, train: bool, in_features: int) -> bool:
        return (not train and self.last_conv_only and self.subunits == 1
                and int(np.prod(_triple(self.strides))) == 1
                and in_features != self.features
                and not self.is_initializing()
                and os.environ.get("VS_HEADFOLD", "1") == "1")

    def _resfold_enabled(self, train: bool, in_features: int) -> bool:
        return (not train and self.subunits == 2 and not self.last_conv_only
                and _triple(self.strides) == (1, 1, 1)
                and _triple(self.kernel_size) == (3, 3, 1)
                and self.act == "prelu" and self.norm == "batch"
                and in_features != self.features
                and not self.is_initializing()
                and os.environ.get("VS_RESFOLD", "0") == "1")

    def _resfold_apply(self, x, in_features: int):
        p = self.variables["params"]
        bs = self.variables["batch_stats"]
        inv0, b0 = folded_conv_affine(p["unit0"], bs["unit0"])
        inv1, b1 = folded_conv_affine(p["unit1"], bs["unit1"])
        a0 = p["unit0"]["act"]["alpha"]
        a1 = p["unit1"]["act"]["alpha"]
        w0 = p["unit0"]["conv"]["kernel"] * inv0
        w1 = p["unit1"]["conv"]["kernel"] * inv1
        k = _triple(self.kernel_size)
        f = self.features
        wcat = jnp.concatenate(
            [w0, _center_embed(p["residual"]["kernel"], k)], axis=-1)
        bcat = jnp.concatenate([b0, p["residual"]["bias"]])
        pads = [(pi, pi) for pi in same_padding(k)]
        ycat = _conv_maybe_pair(x, wcat, bcat, pads, self.dtype)
        y0, r = ycat[..., :f], ycat[..., f:]
        u0 = jnp.maximum(y0, 0) + a0.astype(y0.dtype) * jnp.minimum(y0, 0)
        y1 = conv3d(u0, w1, b1, (1, 1, 1), pads, dtype=self.dtype)
        u1 = jnp.maximum(y1, 0) + a1.astype(y1.dtype) * jnp.minimum(y1, 0)
        return u1 + r


class AttentionBlock1(Module):
    """conv(C -> C/2, ReLU) -> conv(C/2 -> 1, Sigmoid); returns (att, x) —
    or, with gate=True, (att, att*x + x) applying AttentionBlock2 inline.

    Reference attentionblock.py:6-35 (norm=None, dropout=None inside).
    """

    kernel_size: Shape3
    dtype: jnp.dtype = jnp.bfloat16

    def __call__(self, x, train: bool = False,
                 gate: bool = False) -> Tuple[jnp.ndarray, jnp.ndarray]:
        pair = isinstance(x, (tuple, list))
        c = (sum(v.shape[-1] for v in x) if pair else x.shape[-1])
        a1 = Convolution(c // 2, self.kernel_size, act="relu", norm=None,
                         dropout=None, dtype=self.dtype, name="conv1")(x, train)
        att = Convolution(1, self.kernel_size, act="sigmoid", norm=None,
                          dropout=None, dtype=self.dtype, name="conv2")(a1, train)
        if not gate:
            return att, x

        xs = tuple(x) if pair else (x,)
        if (not train and len({v.shape[-1] for v in xs}) == 1
                and os.environ.get("VS_WIDE_ATT") == "1"):
            # VS_WIDE_ATT=1 (default off): tile the C->1 conv2 weights to
            # C->Cx so the attention map is born replicated over Cx
            # channels and every consumer (sigmoid, att*x + x) runs at full
            # channel width instead of on a (..., 1) tensor. Numerically
            # identical (each wide channel is the same dot product); the
            # model's att-map output is a channel slice of the wide map.
            p = self.variables["params"]["conv2"]["conv"]
            cw = xs[0].shape[-1]
            w2w = jnp.tile(p["kernel"], (1, 1, 1, 1, cw))
            b2w = jnp.broadcast_to(p["bias"].reshape(-1), (cw,))
            pads = [(pi, pi) for pi in same_padding(_triple(self.kernel_size))]
            att_w = jax.nn.sigmoid(
                conv3d(a1, w2w, b2w, (1, 1, 1), pads, dtype=self.dtype))
            gated = tuple(att_w.astype(v.dtype) * v + v for v in xs)
            return att_w[..., :1], (gated if pair else gated[0])
        return att, attention_gate(att, x)


def attention_gate(att: jnp.ndarray, x):
    """AttentionBlock2: out = att*x + x (residual spatial gating,
    reference attentionblock.py:43-47). Parameter-free, so a function.
    Accepts a pair (xa, xb) standing for channel-concat: gates each half."""
    if isinstance(x, (tuple, list)):
        return tuple(att.astype(v.dtype) * v + v for v in x)
    return att * x + x
