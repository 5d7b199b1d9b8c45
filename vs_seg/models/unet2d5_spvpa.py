"""UNet2d5_spvPA — 6-level 2.5D residual U-Net with deep spatial-attention
supervision, as a functional module (nn/module.py).

Topology matches the reference recursion exactly
(params/networks/nets/unet2d5_spvPA.py:56-93, model config
params/VSparams.py:343-374):

  level i = 0..4 (channels c_i, stride s_i, kernel k_i, sample kernel sk_i):
    down_i      ResidualUnit(c_{i-1} -> c_i, stride 1, `num_res_units` subunits)
    downsample_i Convolution(c_i -> c_i, stride s_i, kernel sk_i)
    ... recurse ...
    upsample_i  ConvTranspose Convolution(c_{i+1} -> c_i, stride s_i, kernel sk_i)
    concat([down_i_out, upsampled], channel)          # SkipConnection order
    upatt_i     AttentionBlock1(2*c_i) + gate         # if attention
    up_i        ResidualUnit(2*c_i -> outc_i, 1 subunit,
                             last_conv_only at top)   # outc_0 = out_channels
  bottom: AttentionBlock1(c_4) + gate, ResidualUnit(c_4 -> c_5)

The reference collects attention maps statefully via forward hooks
(unet2d5_spvPA.py:101-104); here they are returned functionally, ordered
coarsest -> finest exactly like the hook firing order (bottom att fires first,
then decoder attentions bottom-up).

Returns (logits, att_maps): logits (B, H, W, D, out_channels);
att_maps[k] each (B, h_k, w_k, d_k, 1).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax.numpy as jnp

from vs_seg.nn.blocks import AttentionBlock1, Convolution, ResidualUnit
from vs_seg.nn.layers import Shape3
from vs_seg.nn.module import Module, remat


class UNet2d5_spvPA(Module):
    out_channels: int = 2
    channels: Sequence[int] = (16, 32, 48, 64, 80, 96)
    strides: Sequence[Shape3] = ((2, 2, 1), (2, 2, 1), (2, 2, 2), (2, 2, 2), (2, 2, 2))
    kernel_sizes: Sequence[Shape3] = (
        (3, 3, 1), (3, 3, 1), (3, 3, 3), (3, 3, 3), (3, 3, 3), (3, 3, 3))
    sample_kernel_sizes: Sequence[Shape3] = (
        (3, 3, 1), (3, 3, 1), (3, 3, 3), (3, 3, 3), (3, 3, 3))
    num_res_units: int = 2
    dropout: Optional[float] = 0.1
    attention_module: bool = True
    dtype: jnp.dtype = jnp.bfloat16
    # rematerialize the top levels' block activations in the backward pass
    # (jax.checkpoint): less activation memory for a second forward of those
    # blocks. Off by default.
    remat: bool = False

    def __call__(self, x, train: bool = False):
        assert len(self.channels) == len(self.kernel_sizes) \
            == len(self.strides) + 1 == len(self.sample_kernel_sizes) + 1
        if self.num_res_units < 1:
            # the reference's num_res_units=0 branches are latently broken
            # (unet2d5_spvPA.py:195-200 returns the nn.Identity CLASS in the
            # no-attention case, and the attention case never reduces
            # channels) — refuse loudly rather than diverge silently
            raise NotImplementedError(
                "num_res_units < 1 mirrors a latently broken reference branch")
        n = len(self.strides)  # number of down/up levels (5)
        common = dict(norm="batch", dropout=self.dropout, dtype=self.dtype)
        # Selective rematerialization: only the top levels hold large
        # activations (L0 at 384x384x64 is ~300 MB/buffer); deeper levels keep
        # their residuals to avoid recompute cost.
        remat_levels = 2

        def blocks(level):
            if self.remat and train and level < remat_levels:
                return remat(ResidualUnit), remat(Convolution)
            return ResidualUnit, Convolution

        att_maps = []

        # --- encoder ---
        skips = []
        for i in range(n):
            ResidualUnit_, Convolution_ = blocks(i)
            x = ResidualUnit_(self.channels[i], self.kernel_sizes[i],
                              subunits=self.num_res_units,
                              name=f"down_{i}", **common)(x, train)
            skips.append(x)
            x = Convolution_(self.channels[i], self.sample_kernel_sizes[i],
                             self.strides[i], name=f"downsample_{i}", **common)(x, train)

        # --- bottom (reference _get_bottom_layer, unet2d5_spvPA.py:152-158) ---
        if self.attention_module:
            att, x = AttentionBlock1(self.kernel_sizes[n], dtype=self.dtype,
                                     name="bottom_att")(x, train, gate=True)
            att_maps.append(att)
        x = ResidualUnit(self.channels[n], self.kernel_sizes[n],
                         subunits=self.num_res_units, name="bottom", **common)(x, train)

        # --- decoder ---
        for i in reversed(range(n)):
            ResidualUnit_, Convolution_ = blocks(i)
            x = Convolution_(self.channels[i], self.sample_kernel_sizes[i],
                             self.strides[i], is_transposed=True,
                             name=f"upsample_{i}", **common)(x, train)
            # SkipConnection concat, held as a PAIR: every consumer splits its
            # conv over the halves (exact; avoids the materialized concat and
            # its layout-transpose copies — nn/layers.Conv3d pair path)
            x = (skips[i], x.astype(skips[i].dtype))
            if self.attention_module:
                att, x = AttentionBlock1(self.kernel_sizes[i], dtype=self.dtype,
                                         name=f"upatt_{i}")(x, train, gate=True)
                att_maps.append(att)
            outc = self.out_channels if i == 0 else self.channels[i]
            x = ResidualUnit_(outc, self.kernel_sizes[i], subunits=1,
                              last_conv_only=(i == 0), name=f"up_{i}", **common)(x, train)

        return x, tuple(att_maps)
