"""Analytic FLOP accounting for the flagship forward pass.

Counts convolution MACs (2 * out_elems * kh*kw*kd * Cin) by tracing the model
with `jax.eval_shape` under a trace-time hook in nn/layers.conv3d — no device
work, exact for any input shape. Convs are >99% of the network FLOPs
(reference model: params/networks/nets/unet2d5_spvPA.py:56-93); BN/PReLU/
attention elementwise ops are excluded, so a rate derived from this count is
slightly conservative.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def forward_conv_flops(model, variables, input_shape) -> int:
    """Total conv FLOPs of one eval-mode forward at `input_shape` (B,D,H,W,C)."""
    from vs_seg.nn import layers

    x = jax.ShapeDtypeStruct(tuple(input_shape), jnp.float32)
    layers._FLOP_TRACE = trace = []
    try:
        jax.eval_shape(lambda v, i: model.apply(v, i, train=False),
                       variables, x)
    finally:
        layers._FLOP_TRACE = None
    return int(sum(trace))
