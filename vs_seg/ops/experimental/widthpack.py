"""Width-packed small-channel convolution (pure XLA).

Matrix units run small-channel convs (the reference net's L0/L1 levels run
16/32-channel (3,3,1) convs) far below their peak. Because activations are channels-last with W adjacent
to C, the reshape (…, W, C) -> (…, W/p, p*C) is FREE (a view), and a 3x3
stride-1 same-padding conv is exactly equivalent to a 3x3 conv on the packed
layout with a block-sparse (p*C -> p*Co) kernel:

  out px w = p*j + r takes input px p*j + r + dw - 1 (dw in 0..2), which lives
  in packed col j + dj - 1 at phase s with  dw = p*(dj-1) + s - r + 1;
  W2[kh, dj, s*C+c, r*Co+co] = w[kh, dw, c, co]  where 0 <= dw < 3, else 0.

Cost model: p x more MACs (the packed kernel is 1/p dense) at p*C channels
of matrix-unit width — a net win whenever eff(p*C)/eff(C) > p. Not measured
on the GPU. Numerically exact (same taps, same adds; tested vs lax conv).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def widthpack_kernel(w: jnp.ndarray, p: int) -> jnp.ndarray:
    """(kh, 3, C, Co) kernel -> (kh, 3, p*C, p*Co) packed kernel."""
    kh, kw, c, co = w.shape
    assert kw == 3, "width packing is specialized to kw == 3"
    # scatter indices are static; build a (kh, 3, p, C, p, Co) zero tensor and
    # place w[:, dw] blocks — traced once per conv, fused into a constant by
    # XLA when w is a parameter
    blocks = []
    for dj in range(3):
        rows = []
        for s in range(p):
            cols = []
            for r in range(p):
                dw = p * (dj - 1) + s - r + 1
                if 0 <= dw < 3:
                    cols.append(w[:, dw])
                else:
                    cols.append(jnp.zeros_like(w[:, 0]))
            rows.append(jnp.stack(cols, axis=2))   # (kh, C, p, Co)
        blocks.append(jnp.stack(rows, axis=1))      # (kh, p, C, p, Co)
    w2 = jnp.stack(blocks, axis=1)                  # (kh, 3, p, C, p, Co)
    return w2.reshape(kh, 3, p * c, p * co)


def conv2d_widthpacked(x: jnp.ndarray, w: jnp.ndarray, p: int,
                       precision=None) -> jnp.ndarray:
    """3x(3)x stride-1 same-pad 2D conv on (B, H, W, C) via width packing.

    Requires W % p == 0. kh (the H kernel extent) is free. Exact.
    """
    b, h, W, c = x.shape
    kh, kw, _, co = w.shape
    assert kw == 3 and W % p == 0
    w2 = widthpack_kernel(w, p)
    xp = x.reshape(b, h, W // p, p * c)
    y = jax.lax.conv_general_dilated(
        xp, w2, (1, 1), [((kh - 1) // 2, (kh - 1) // 2), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"), precision=precision)
    return y.reshape(b, h, W, co)
