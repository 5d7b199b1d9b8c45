"""Matplotlib artifact generation (reference figure outputs).

  - transform sanity PNG (reference params/VSparams.py:266-297)
  - loss/Dice curves (reference :530-545)
  - per-case inference 3-panel PNGs (:596-612)
  - Dice histogram (:614-616)

matplotlib is imported by the figure functions, not by this module: where
it is not installed, each function logs that its figure was skipped and
returns, and training and inference run on without figures.
"""

from __future__ import annotations

import functools
import logging
import os

import numpy as np

from vs_seg.eval.metrics import center_of_mass_slice


def _pyplot():
    """matplotlib's pyplot on the file-only Agg backend, or None."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    from matplotlib import pyplot
    return pyplot


def _needs_matplotlib(fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        plt = _pyplot()
        if plt is None:
            logging.getLogger().info(
                "matplotlib is not installed; skipped figure %s", fn.__name__)
            return
        fn(plt, *args, **kwargs)
    return wrapper


@_needs_matplotlib
def save_transform_check(plt, image, label, figures_path: str) -> None:
    """image/label: (H, W, D) arrays after val transforms."""
    slice_idx = center_of_mass_slice(label)
    plt.figure("check", (12, 6))
    plt.clf()
    plt.subplot(1, 2, 1)
    plt.title("image")
    plt.imshow(image[:, :, slice_idx], cmap="gray", interpolation="none")
    plt.subplot(1, 2, 2)
    plt.title("label")
    plt.imshow(label[:, :, slice_idx], interpolation="none")
    plt.savefig(os.path.join(figures_path, "check_validation_image_and_label.png"))
    plt.close("all")


@_needs_matplotlib
def save_loss_and_dice_curves(plt, epoch_loss_values, metric_values, val_interval: int,
                              figures_path: str) -> None:
    plt.figure("train", (12, 6))
    plt.clf()
    plt.subplot(1, 2, 1)
    plt.title("Epoch Average Loss")
    plt.xlabel("epoch")
    plt.plot([i + 1 for i in range(len(epoch_loss_values))], epoch_loss_values)
    plt.subplot(1, 2, 2)
    plt.title("Val Mean Dice")
    plt.xlabel("epoch")
    plt.plot([val_interval * (i + 1) for i in range(len(metric_values))],
             metric_values)
    plt.savefig(os.path.join(figures_path,
                             "epoch_average_loss_and_val_mean_dice.png"))
    plt.close("all")


@_needs_matplotlib
def save_inference_panel(plt, image, label, pred_argmax, dice: float, index: int,
                         figures_path: str) -> None:
    """image/label/pred_argmax: (H, W, D)."""
    slice_idx = center_of_mass_slice(label)
    plt.figure("check", (18, 6))
    plt.clf()
    plt.subplot(1, 3, 1)
    plt.title(f"image {index}, slice = {slice_idx}")
    plt.imshow(image[:, :, slice_idx], cmap="gray", interpolation="none")
    plt.subplot(1, 3, 2)
    plt.title(f"label {index}")
    plt.imshow(label[:, :, slice_idx], interpolation="none")
    plt.subplot(1, 3, 3)
    plt.title(f"output {index}, dice = {dice:.4}")
    plt.imshow(pred_argmax[:, :, slice_idx], interpolation="none")
    plt.savefig(os.path.join(figures_path, f"best_model_output_val{index}.png"))
    plt.close("all")


@_needs_matplotlib
def save_dice_histogram(plt, dice_scores, figures_path: str) -> None:
    plt.figure("dice score histogram")
    plt.clf()
    plt.hist(np.asarray(dice_scores), bins=np.arange(0, 1.01, 0.01))
    plt.savefig(os.path.join(figures_path,
                             "best_model_output_dice_score_histogram.png"))
    plt.close("all")
