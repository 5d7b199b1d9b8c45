"""Loss parity vs torch implementations of the reference formulas
(params/losses/dice_spvPA.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vs_seg.eval.metrics import dice_score
from vs_seg.losses import (
    dice_loss, dice_spvpa_loss, generalized_dice_loss,
    generalized_wasserstein_dice_loss, masked_dice_loss,
)


def torch_dice(inp, tgt, *, include_background=True, to_onehot_y=False,
               softmax=False, hardness_weight=None, smooth=1e-5,
               squared_pred=False, jaccard=False):
    """Reference DiceLoss math (dice_spvPA.py:90-167) in torch NCHWD."""
    n = inp.shape[1]
    if softmax and n > 1:
        inp = torch.softmax(inp, dim=1)
    if to_onehot_y and n > 1:
        tgt = F.one_hot(tgt[:, 0].long(), n).permute(0, 4, 1, 2, 3).float()
    if not include_background and n > 1:
        inp, tgt = inp[:, 1:], tgt[:, 1:]
        if hardness_weight is not None and hardness_weight.shape[1] == n:
            hardness_weight = hardness_weight[:, 1:]
    axes = list(range(2, inp.dim()))
    w = hardness_weight if hardness_weight is not None else 1.0
    intersection = (w * tgt * inp).sum(dim=axes)
    if squared_pred:
        tgt, inp = tgt ** 2, inp ** 2
    ground = (w * tgt).sum(dim=axes)
    pred = (w * inp).sum(dim=axes)
    denom = ground + pred
    if jaccard:
        denom = 2.0 * (denom - intersection)
    return (1.0 - (2.0 * intersection + smooth) / (denom + smooth)).mean()


def to_last(t):
    return jnp.asarray(t.numpy().transpose(0, 4, 2, 3, 1).copy())


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(to_onehot_y=True, softmax=True),
    dict(include_background=False, to_onehot_y=True),
    dict(squared_pred=True, softmax=True, to_onehot_y=True),
    dict(jaccard=True, softmax=True, to_onehot_y=True),
])
def test_dice_loss_matches_reference_math(kwargs, rng):
    torch.manual_seed(0)
    logits = torch.randn(2, 2, 6, 6, 4)
    labels = torch.randint(0, 2, (2, 1, 6, 6, 4)).float()
    tgt = labels if kwargs.get("to_onehot_y") else torch.cat([1 - labels, labels], 1)
    ref = torch_dice(logits, tgt, **kwargs)
    ours = dice_loss(to_last(logits), to_last(tgt), **kwargs)
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5, atol=1e-6)


def test_dice_loss_hardness_weight(rng):
    torch.manual_seed(1)
    logits = torch.randn(2, 2, 4, 4, 4)
    labels = torch.randint(0, 2, (2, 1, 4, 4, 4)).float()
    probs = torch.softmax(logits, 1)
    onehot = F.one_hot(labels[:, 0].long(), 2).permute(0, 4, 1, 2, 3).float()
    w = 0.6 * (probs - onehot).abs() + 0.4
    ref = torch_dice(logits, labels, to_onehot_y=True, softmax=True,
                     hardness_weight=w)
    ours = dice_loss(to_last(logits), to_last(labels), to_onehot_y=True,
                     softmax=True, hardness_weight=to_last(w))
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5, atol=1e-6)


def test_dice_spvpa_full_composite(rng):
    """Composite loss with att pyramid + hardness, vs a direct torch
    transcription of reference dice_spvPA.py:238-297."""
    torch.manual_seed(2)
    B = 2
    shapes = [(2, 2, 2), (4, 4, 4), (8, 8, 8), (16, 16, 8)]  # coarse -> fine
    att_maps_t = [torch.rand(B, 1, *s) for s in shapes]
    logits_t = torch.randn(B, 2, 16, 16, 8)
    target_t = torch.randint(0, 2, (B, 1, 16, 16, 8)).float()

    # reference math in torch
    L = len(att_maps_t)
    total_att = 0.0
    G = target_t
    for level in range(L):
        total_att = total_att + torch_dice(att_maps_t[L - level - 1], G) / L
        if level < L - 1:
            cur = att_maps_t[L - level - 1].shape
            nxt = att_maps_t[L - level - 2].shape
            ratio = [c // n for c, n in zip(cur[2:], nxt[2:])]
            G = torch.nn.MaxPool3d(kernel_size=ratio, stride=ratio)(G)
    probs = torch.softmax(logits_t, 1)
    onehot = F.one_hot(target_t[:, 0].long(), 2).permute(0, 4, 1, 2, 3).float()
    w = 0.6 * (probs - onehot).abs() + 0.4
    ref = total_att + torch_dice(logits_t, target_t, to_onehot_y=True,
                                 softmax=True, hardness_weight=w)

    ours = dice_spvpa_loss(to_last(logits_t), tuple(to_last(a) for a in att_maps_t),
                           to_last(target_t))
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5, atol=1e-6)


def test_masked_dice(rng):
    logits = torch.randn(1, 2, 4, 4, 4)
    labels = torch.randint(0, 2, (1, 1, 4, 4, 4)).float()
    mask = torch.randint(0, 2, (1, 1, 4, 4, 4)).float()
    ref = torch_dice(logits * mask, labels * mask, to_onehot_y=True, softmax=False)
    ours = masked_dice_loss(to_last(logits), to_last(labels), mask=to_last(mask),
                            to_onehot_y=True)
    # NOTE: reference masks BEFORE onehot/softmax; ours too (semantics match,
    # the torch_dice call above applies mask pre-onehot identically)
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5, atol=1e-6)


def test_generalized_dice_empty_class_weight_replacement(rng):
    torch.manual_seed(3)
    logits = torch.randn(2, 3, 4, 4, 4)
    labels = torch.randint(0, 2, (2, 1, 4, 4, 4)).float()  # class 2 empty
    ours = generalized_dice_loss(to_last(logits), to_last(labels),
                                 to_onehot_y=True, softmax=True)
    assert np.isfinite(float(ours))

    # reference math
    probs = torch.softmax(logits, 1)
    onehot = F.one_hot(labels[:, 0].long(), 3).permute(0, 4, 1, 2, 3).float()
    axes = [2, 3, 4]
    inter = (onehot * probs).sum(dim=axes)
    ground = onehot.sum(dim=axes)
    pred = probs.sum(dim=axes)
    w = 1.0 / (ground * ground)
    for b in w:
        infs = torch.isinf(b)
        b[infs] = 0.0
        b[infs] = torch.max(b)
    f = 1.0 - (2.0 * (inter * w).sum(1) + 1e-5) / (((ground + pred) * w).sum(1) + 1e-5)
    np.testing.assert_allclose(float(ours), float(f.mean()), rtol=1e-4)


def test_gwdl_runs_and_is_reasonable(rng):
    torch.manual_seed(4)
    logits = torch.randn(2, 2, 4, 4, 4)
    labels = torch.randint(0, 2, (2, 4, 4, 4))
    m = np.array([[0.0, 1.0], [1.0, 0.0]])
    ours = generalized_wasserstein_dice_loss(
        to_last(logits), jnp.asarray(labels.numpy()), m)
    assert 0.0 <= float(ours) <= 1.0
    # perfect prediction -> ~0 loss
    perfect = F.one_hot(labels, 2).float().numpy() * 20 - 10
    loss0 = generalized_wasserstein_dice_loss(
        jnp.asarray(perfect), jnp.asarray(labels.numpy()), m)
    assert float(loss0) < 0.01


def test_dice_score_metric(rng):
    torch.manual_seed(5)
    probs = torch.rand(1, 2, 8, 8, 4)
    label = torch.randint(0, 2, (1, 1, 8, 8, 4)).float()
    # reference metric: argmax -> onehot -> 1 - Dice(include_background=False)
    y_pred = probs.argmax(dim=1, keepdim=True)
    y_onehot = F.one_hot(y_pred[:, 0], 2).permute(0, 4, 1, 2, 3).float()
    ref = 1.0 - torch_dice(y_onehot, label, include_background=False,
                           to_onehot_y=True)
    ours = dice_score(to_last(probs), to_last(label))
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5, atol=1e-6)
    # perfect prediction -> 1.0
    perfect = F.one_hot(label[:, 0].long(), 2).permute(0, 4, 1, 2, 3).float()
    assert float(dice_score(to_last(perfect), to_last(label))) > 0.999


def test_segmentation_volume_ml():
    from vs_seg.eval.metrics import segmentation_volume_ml
    lbl = np.zeros((10, 10, 10))
    lbl[:5, :5, :2] = 1  # 50 voxels
    aff = np.diag([0.5, 0.5, 2.0, 1.0])  # 0.5mm^3 per voxel
    np.testing.assert_allclose(segmentation_volume_ml(lbl, aff), 50 * 0.5 / 1000)
