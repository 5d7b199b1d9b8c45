"""Dice loss family + the composite supervised-attention loss.

JAX (channels-last) re-implementations of the reference loss zoo
(params/losses/dice_spvPA.py): `dice_loss` (hardness-weight-capable fork,
ref :24-167), `dice_spvpa_loss` (ref :170-297), `masked_dice_loss` (:300-331),
`generalized_dice_loss` (:334-465), `generalized_wasserstein_dice_loss`
(:468-636).

Layout: predictions (B, *spatial, C); targets (B, *spatial, 1) label indices
or (B, *spatial, C) one-hot. Everything is a pure function of arrays, jittable
and differentiable; the hardness weight intentionally carries gradients
(reference dice_spvPA.py:279-283 does NOT detach it).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp


def one_hot(labels: jnp.ndarray, num_classes: int) -> jnp.ndarray:
    """(B, *S, 1) label indices -> (B, *S, C) one-hot (monai.networks.one_hot)."""
    squeezed = labels[..., 0].astype(jnp.int32)
    return jax.nn.one_hot(squeezed, num_classes, dtype=jnp.float32)


def _reduce(f: jnp.ndarray, reduction: str) -> jnp.ndarray:
    if reduction == "mean":
        return jnp.mean(f)
    if reduction == "sum":
        return jnp.sum(f)
    if reduction == "none":
        return f
    raise ValueError(f"Unsupported reduction: {reduction}")


def _prepare(pred, target, *, sigmoid, softmax, to_onehot_y, include_background):
    n_pred_ch = pred.shape[-1]
    if sigmoid:
        pred = jax.nn.sigmoid(pred)
    if softmax and n_pred_ch > 1:
        pred = jax.nn.softmax(pred, axis=-1)
    if to_onehot_y and n_pred_ch > 1:
        target = one_hot(target, n_pred_ch)
    if not include_background and n_pred_ch > 1:
        pred = pred[..., 1:]
        target = target[..., 1:]
    assert target.shape == pred.shape, \
        f"ground truth has differing shape ({target.shape}) from input ({pred.shape})"
    return pred, target


def dice_loss(pred: jnp.ndarray, target: jnp.ndarray, *,
              include_background: bool = True, to_onehot_y: bool = False,
              sigmoid: bool = False, softmax: bool = False,
              squared_pred: bool = False, jaccard: bool = False,
              hardness_weight: Optional[jnp.ndarray] = None,
              reduction: str = "mean", smooth: float = 1e-5) -> jnp.ndarray:
    """Soft Dice with optional hardness weighting (reference dice_spvPA.py:90-167)."""
    pred, target = _prepare(pred, target, sigmoid=sigmoid, softmax=softmax,
                            to_onehot_y=to_onehot_y,
                            include_background=include_background)
    if hardness_weight is not None and not include_background and pred.shape[-1] != hardness_weight.shape[-1]:
        hardness_weight = hardness_weight[..., 1:]
    reduce_axis = tuple(range(1, pred.ndim - 1))  # spatial dims only

    w = hardness_weight if hardness_weight is not None else 1.0
    intersection = jnp.sum(w * target * pred, axis=reduce_axis)
    if squared_pred:
        target = jnp.square(target)
        pred = jnp.square(pred)
    ground_o = jnp.sum(w * target, axis=reduce_axis)
    pred_o = jnp.sum(w * pred, axis=reduce_axis)
    denominator = ground_o + pred_o
    if jaccard:
        denominator = 2.0 * (denominator - intersection)
    f = 1.0 - (2.0 * intersection + smooth) / (denominator + smooth)
    return _reduce(f, reduction)


def masked_dice_loss(pred, target, mask=None, **kwargs):
    """Dice over a binary region mask (reference dice_spvPA.py:300-331)."""
    if mask is not None:
        pred = pred * mask
        target = target * mask
    return dice_loss(pred, target, **kwargs)


def generalized_dice_loss(pred, target, *, include_background: bool = True,
                          to_onehot_y: bool = False, sigmoid: bool = False,
                          softmax: bool = False, w_type: str = "square",
                          reduction: str = "mean", smooth: float = 1e-5):
    """Sudre et al. 2017 generalized Dice (reference dice_spvPA.py:334-465)."""
    pred, target = _prepare(pred, target, sigmoid=sigmoid, softmax=softmax,
                            to_onehot_y=to_onehot_y,
                            include_background=include_background)
    reduce_axis = tuple(range(1, pred.ndim - 1))
    intersection = jnp.sum(target * pred, axis=reduce_axis)
    ground_o = jnp.sum(target, axis=reduce_axis)
    pred_o = jnp.sum(pred, axis=reduce_axis)
    denominator = ground_o + pred_o
    if w_type == "simple":
        w = 1.0 / ground_o
    elif w_type == "square":
        w = 1.0 / (ground_o * ground_o)
    else:
        w = jnp.ones_like(ground_o)
    # replace infs (empty classes) with the per-sample max of the finite weights
    isinf = jnp.isinf(w)
    finite_max = jnp.max(jnp.where(isinf, 0.0, w), axis=-1, keepdims=True)
    w = jnp.where(isinf, finite_max, w)
    f = 1.0 - (2.0 * jnp.sum(intersection * w, -1) + smooth) / (
        jnp.sum(denominator * w, -1) + smooth)
    return _reduce(f, reduction)


def generalized_wasserstein_dice_loss(pred, target, dist_matrix,
                                      smooth: float = 1e-5):
    """Fidon et al. 2017 GWDL with GDL-style weighting
    (reference dice_spvPA.py:468-636)."""
    m = jnp.asarray(dist_matrix, dtype=jnp.float32)
    m = m / jnp.max(m)
    num_classes = m.shape[0]
    b = pred.shape[0]
    flat_pred = pred.reshape(b, -1, pred.shape[-1])           # (B, V, C)
    flat_target = target.reshape(b, -1).astype(jnp.int32)     # (B, V)
    probs = jax.nn.softmax(flat_pred, axis=-1)
    # wasserstein distance at each voxel: sum_c M[y, c] * p_c
    m_rows = m[flat_target]                                   # (B, V, C)
    wass = jnp.sum(m_rows * probs, axis=-1)                   # (B, V)
    onehot_t = jax.nn.one_hot(flat_target, num_classes)       # (B, V, C)
    volumes = jnp.sum(onehot_t, axis=1)                       # (B, C)
    alpha = 1.0 / (volumes + 1.0)
    alpha_map = jnp.take_along_axis(alpha, flat_target, axis=1)  # (B, V)
    true_pos = jnp.sum(alpha_map * (1.0 - wass), axis=1)
    denom = jnp.sum(alpha_map * (2.0 - wass), axis=1)
    wass_dice = (2.0 * true_pos + smooth) / (denom + smooth)
    return jnp.mean(1.0 - wass_dice)


def _maxpool3d_squeezed(x: jnp.ndarray, window: Sequence[int]) -> jnp.ndarray:
    """MaxPool3d(kernel=stride=window) on squeezed (B, S0, S1, S2)."""
    dims = (1, *window)
    return jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, dims, dims, "VALID")


def _dice_single_channel(pred4: jnp.ndarray, target4: jnp.ndarray,
                         smooth: float) -> jnp.ndarray:
    """Soft Dice on squeezed single-channel (B, S0, S1, S2) arrays — the same
    math as dice_loss(..., C=1) but without the trailing 1-sized channel dim,
    so the reductions run on (B, S0, S1, S2) arrays with a wide minor dim."""
    ax = (1, 2, 3)
    intersection = jnp.sum(target4 * pred4, ax)
    denominator = jnp.sum(target4, ax) + jnp.sum(pred4, ax)
    f = 1.0 - (2.0 * intersection + smooth) / (denominator + smooth)
    return jnp.mean(f)


def dice_spvpa_loss(logits: jnp.ndarray, att_maps: Tuple[jnp.ndarray, ...],
                    target: jnp.ndarray, *, supervised_attention: bool = True,
                    hardness_weighting: bool = True,
                    hardness_lambda: float = 0.6,
                    smooth: float = 1e-5) -> jnp.ndarray:
    """Composite loss on (logits, att_maps) (reference dice_spvPA.py:238-297).

    att_maps ordered coarsest -> finest (as returned by our model / as the
    reference hooks append them). The GT pyramid is built finest-first with
    MaxPool downsampling by the shape ratio between consecutive attention maps
    (reference :261-277); each level weighted 1/L. The hardness weight
    w = 0.6*|softmax(x) - onehot(y)| + 0.4 is NOT stop-gradiented (ref :281).
    """
    total_att_loss = 0.0
    if supervised_attention and len(att_maps) > 0:
        L = len(att_maps)
        g = target.astype(jnp.float32)[..., 0]  # squeezed (B, S0, S1, S2)
        for level in range(L):
            att = att_maps[L - level - 1][..., 0]  # finest first
            att_loss = _dice_single_channel(att.astype(jnp.float32), g, smooth)
            total_att_loss = total_att_loss + att_loss / L
            if level < L - 1:
                cur = att_maps[L - level - 1].shape
                nxt = att_maps[L - level - 2].shape
                assert all(c % n == 0 for c, n in zip(cur, nxt))
                ratio = tuple(c // n for c, n in zip(cur[1:4], nxt[1:4]))
                g = _maxpool3d_squeezed(g, ratio)

    hardness_weight = None
    if hardness_weighting:
        probs = jax.nn.softmax(logits, axis=-1)
        onehot_t = one_hot(target, logits.shape[-1])
        hardness_weight = (hardness_lambda * jnp.abs(probs - onehot_t)
                           + (1.0 - hardness_lambda))

    pred_loss = dice_loss(logits, target, to_onehot_y=True, softmax=True,
                          hardness_weight=hardness_weight, smooth=smooth)
    return total_att_loss + pred_loss
