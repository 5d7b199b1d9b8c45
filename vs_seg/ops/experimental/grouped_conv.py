"""Grouped-output matmul formulation of small-channel 3x3 convolutions.

Matrix units run convs with few output channels far below their peak. This
formulation packs G consecutive W-position outputs into the matmul N dim
(N = G*C_out), trading a (G+2)/G K-dim redundancy for a wider product:

  out[h, g*G_out + j, co] = sum_{dh, dw, c} w[dh, dw, c, co] x[h+dh-1, g*G-1+j+dw, c]
  => P[(h, g), (dh, r, c)] @ Wb[(dh, r, c), (j, co)]
  with r in [0, G+2): the G-wide group plus one halo column each side, and
  Wb[(dh, r, c), (j, co)] = w[dh, r-j, c, co] if 0 <= r-j < 3 else 0
  (a block-Toeplitz expansion of the 3x3 kernel).

Useful fraction of the computed FLOPs: 9*G / (3*(G+2)*G) = 3/(G+2), 30% at
G=8. Not measured on the GPU.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def build_block_toeplitz(w: jnp.ndarray, group: int) -> jnp.ndarray:
    """(3, 3, C, Co) kernel -> ((G+2)*3*C, G*Co) block-Toeplitz matrix.

    K index order: (dh, r, c) with r in [0, G+2); N index order: (j, co).
    """
    kh, kw, c, co = w.shape
    assert kh == 3 and kw == 3
    g = group
    wb = jnp.zeros((3, g + 2, c, g, co), w.dtype)
    for j in range(g):
        for dw in range(3):
            r = j + dw  # input column r covers output j with tap dw
            wb = wb.at[:, r, :, j, :].set(w[:, dw, :, :])
    return wb.reshape(3 * (g + 2) * c, g * co)


def grouped_conv2d(x: jnp.ndarray, w: jnp.ndarray, group: int = None,
                   precision=None) -> jnp.ndarray:
    """3x3 stride-1 same-pad 2D conv via grouped-output matmul.

    x (B, H, W, C); w (3, 3, C, Co); W must divide by `group`
    (default 128 // C_out capped to W). Returns (B, H, W, Co).
    Materializes the patches in device memory.
    """
    b, h, wdim, c = x.shape
    co = w.shape[-1]
    g = group or max(1, min(128 // co, wdim))
    assert wdim % g == 0, f"W={wdim} not divisible by group={g}"
    ng = wdim // g
    wb = build_block_toeplitz(w, g)  # (3*(g+2)*c, g*co)

    xp = jnp.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    # patches P[(b, h, ng), (dh, r, c)]: padded rows h+dh, padded cols n*g + r
    idx = (np.arange(ng)[:, None] * g + np.arange(g + 2)[None, :])  # (ng, g+2)
    patches = xp[:, :, idx, :]            # (b, H+2, ng, g+2, c)
    p = jnp.stack([patches[:, dh:dh + h] for dh in range(3)], axis=3)
    # p: (b, h, ng, 3, g+2, c) -> (b*h*ng, 3*(g+2)*c)
    p = p.reshape(b * h * ng, 3 * (g + 2) * c)
    out = jnp.dot(p, wb, precision=precision,
                  preferred_element_type=jnp.float32)
    return out.reshape(b, h, ng * g, co)
