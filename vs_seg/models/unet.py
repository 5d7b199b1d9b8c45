"""Classic MONAI-style UNet (reference params/networks/nets/unet.py:25-151).

Unused by the reference training flow but part of its model zoo; provided for
API-surface parity. Down layers are *strided* ResidualUnits (unlike UNet2d5
which uses separate downsample convs); up layers are a transpose Convolution
followed by a 1-subunit ResidualUnit.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import jax.numpy as jnp

from vs_seg.nn.blocks import Convolution, ResidualUnit
from vs_seg.nn.layers import _triple
from vs_seg.nn.module import Module


class UNet(Module):
    out_channels: int
    channels: Sequence[int]
    strides: Sequence[Union[int, tuple]]
    kernel_size: Union[int, tuple] = 3
    up_kernel_size: Union[int, tuple] = 3
    num_res_units: int = 0
    dropout: Optional[float] = None
    dtype: jnp.dtype = jnp.bfloat16

    def __call__(self, x, train: bool = False):
        n = len(self.strides)
        common = dict(norm="batch", dropout=self.dropout, dtype=self.dtype)

        def down_layer(x, features, strides, name):
            if self.num_res_units > 0:
                return ResidualUnit(features, _triple(self.kernel_size),
                                    _triple(strides), subunits=self.num_res_units,
                                    name=name, **common)(x, train)
            return Convolution(features, _triple(self.kernel_size),
                               _triple(strides), name=name, **common)(x, train)

        skips = []
        for i in range(n):
            x = down_layer(x, self.channels[i], self.strides[i], f"down_{i}")
            skips.append(x)
        x = down_layer(x, self.channels[n], (1, 1, 1), "bottom")

        for i in reversed(range(n)):
            is_top = i == 0
            x = jnp.concatenate([skips[i], x.astype(skips[i].dtype)], axis=-1)
            outc = self.out_channels if is_top else self.channels[i - 1]
            x = Convolution(outc, _triple(self.up_kernel_size), _triple(self.strides[i]),
                            is_transposed=True,
                            conv_only=is_top and self.num_res_units == 0,
                            name=f"up_{i}", **common)(x, train)
            if self.num_res_units > 0:
                x = ResidualUnit(outc, _triple(self.kernel_size), subunits=1,
                                 last_conv_only=is_top, name=f"upres_{i}",
                                 **common)(x, train)
        return x
