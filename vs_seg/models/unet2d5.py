"""UNet2d5 — the no-attention variant (reference params/networks/nets/unet2d5.py).

Identical topology to UNet2d5_spvPA with the attention module disabled and a
plain `x -> logits` forward. Kept as a distinct class for reference API parity.
"""

from __future__ import annotations

import jax.numpy as jnp

from vs_seg.models.unet2d5_spvpa import UNet2d5_spvPA
from vs_seg.nn.module import Module


class UNet2d5(Module):
    out_channels: int = 2
    channels: tuple = (16, 32, 48, 64, 80, 96)
    strides: tuple = ((2, 2, 1), (2, 2, 1), (2, 2, 2), (2, 2, 2), (2, 2, 2))
    kernel_sizes: tuple = ((3, 3, 1), (3, 3, 1), (3, 3, 3), (3, 3, 3), (3, 3, 3), (3, 3, 3))
    sample_kernel_sizes: tuple = ((3, 3, 1), (3, 3, 1), (3, 3, 3), (3, 3, 3), (3, 3, 3))
    num_res_units: int = 2
    dropout: float = 0.1
    dtype: jnp.dtype = jnp.bfloat16

    def __call__(self, x, train: bool = False):
        logits, _ = UNet2d5_spvPA(
            out_channels=self.out_channels, channels=self.channels,
            strides=self.strides, kernel_sizes=self.kernel_sizes,
            sample_kernel_sizes=self.sample_kernel_sizes,
            num_res_units=self.num_res_units, dropout=self.dropout,
            attention_module=False, dtype=self.dtype, name="net",
        )(x, train)
        return logits
