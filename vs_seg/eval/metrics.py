"""Evaluation metrics.

`dice_score`: argmax -> one-hot -> 1 - Dice(include_background=False), exactly
the reference metric (params/VSparams.py:393-408).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from vs_seg.losses.dice import dice_loss, one_hot


def dice_score(predicted_probabilities: jnp.ndarray, label: jnp.ndarray) -> jnp.ndarray:
    """Hard Dice of argmax vs label. pred: (B, *S, C); label: (B, *S, 1)."""
    n_classes = predicted_probabilities.shape[-1]
    y_pred = jnp.argmax(predicted_probabilities, axis=-1)[..., None]
    y_pred = one_hot(y_pred, n_classes)
    return 1.0 - dice_loss(y_pred, label, include_background=False,
                           to_onehot_y=True, softmax=False, reduction="mean")


def segmentation_volume_ml(labelmap, affine) -> float:
    """Segmented volume in millilitres: voxel count x |det(affine[:3,:3])| mm^3.

    Clinical volumetry output (the reference reports Dice only; tumour volume
    is the standard companion metric for VS growth assessment)."""
    import numpy as np
    voxel_mm3 = abs(float(np.linalg.det(np.asarray(affine)[:3, :3])))
    # count FOREGROUND voxels (any non-background class) — summing raw class
    # indices would double-count class-2 voxels in multi-class configs
    count = float(np.count_nonzero(np.asarray(labelmap)))
    return count * voxel_mm3 / 1000.0


def center_of_mass_slice(label) -> int:
    """Weighted center-of-mass slice index along the last spatial axis
    (reference params/VSparams.py:249-264); uniform weights if label empty."""
    import numpy as np
    label = np.asarray(label)
    num_slices = label.shape[2]
    masses = label.reshape(-1, num_slices).sum(axis=0)
    total = masses.sum()
    weights = (masses / total) if total > 0 else np.full(num_slices, 1.0 / num_slices)
    return int(round(float((weights * np.arange(num_slices)).sum())))
