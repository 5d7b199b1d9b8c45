"""Whole-volume inference driver (reference run_inference, params/VSparams.py:552-619).

Per test case: Gaussian-blended sliding-window inference -> hard Dice vs label
-> NIFTI export of the argmax labelmap using the *label's* original affine
(reference :585-594) -> center-of-mass-slice 3-panel PNG. Afterwards: Dice
histogram + mean±std log.
"""

from __future__ import annotations

import logging
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from vs_seg.data import nifti
from vs_seg.eval import figures
from vs_seg.eval.metrics import dice_score, segmentation_volume_ml
from vs_seg.infer.sliding_window import (
    count_windows, sliding_window_inference, stage_volume)


def make_predictor(model, params, batch_stats, dtype=jnp.bfloat16) -> Callable:
    """(N, *roi, C) -> (N, *roi, out) logits; closes over fixed variables so
    the sliding-window jit caches one executable per padded shape."""
    variables = {"params": params, "batch_stats": batch_stats}

    @jax.jit
    def predictor(wins):
        # the sliding-window engine runs D-first internally, matching the
        # model's (N, D, H, W, C) layout — no per-batch transposes
        out = model.apply(variables, wins.astype(dtype), train=False)
        return out[0] if isinstance(out, tuple) else out

    return predictor


def run_inference(cfg, model, params, batch_stats, test_loader,
                  logger: Optional[logging.Logger] = None,
                  export: Optional[bool] = None,
                  make_figures: bool = True,
                  mesh=None):
    """Returns (dice_scores, wall_seconds_per_volume).

    With `mesh` (or cfg.sharded_inference and >1 device), each volume's
    windows run data-parallel across the mesh (infer/sharded.py).
    """
    logger = logger or logging.getLogger()
    logger.info("Running inference...")
    export = cfg.export_inferred_segmentations if export is None else export
    dtype = jnp.bfloat16 if cfg.infer_dtype == "bfloat16" else jnp.float32
    predictor = make_predictor(model, params, batch_stats, dtype=dtype)

    if mesh is None and (getattr(cfg, "sharded_inference", False)
                         or getattr(cfg, "spatial_inference", False)):
        from vs_seg.parallel.mesh import make_mesh
        mesh = make_mesh()
    spatial = (mesh is not None and mesh.devices.size > 1
               and getattr(cfg, "spatial_inference", False))
    sharded = (mesh is not None and mesh.devices.size > 1 and not spatial)
    if spatial:
        from vs_seg.infer.spatial import make_spatial_predictor
        logger.info("spatially sharded inference (H over %d devices)",
                    mesh.devices.size)
        predictor = make_spatial_predictor(model, params, batch_stats,
                                           mesh, dtype=dtype)
    if sharded:
        from vs_seg.infer.sharded import sliding_window_inference_sharded
        logger.info("sharded window inference over %d devices", mesh.devices.size)

    # Host prep + H2D upload of case i+1 overlaps compute of case i (the
    # reference loads/uploads serially, VSparams.py:566-569). Shape bucketing
    # bounds the number of distinct compiled programs across the heterogeneous
    # whole-volume test set (reference protocol: no crop at test time).
    bucket = getattr(cfg, "sw_bucket", None)
    quantize = bool(getattr(cfg, "quantize_transfer", False))
    transfer_dtype = (None if quantize
                      else (dtype if dtype != jnp.float32 else None))
    sw_batch = 1 if spatial else cfg.sw_batch_size

    def stage(data):
        image = np.transpose(data["image"][0], (1, 2, 3, 0))  # (H, W, D, C)
        label = np.transpose(data["label"][0], (1, 2, 3, 0))
        if sharded:
            # per-DEVICE batch sized to this volume's window count: with the
            # reference protocol (~8 windows) on an 8-chip mesh each device
            # gets 1 window — a fixed cfg.sw_batch_size per device would
            # make every chip compute a full batch of mostly masked padding
            n_win = count_windows(image.shape[:3],
                                  cfg.sliding_window_inferer_roi_size,
                                  cfg.sw_overlap)
            per_dev = max(1, min(cfg.sw_batch_size,
                                 -(-n_win // mesh.devices.size)))
            batch = mesh.devices.size * per_dev
        else:
            per_dev = sw_batch
            batch = sw_batch
        staged = stage_volume(image, cfg.sliding_window_inferer_roi_size,
                              overlap=cfg.sw_overlap, sw_batch_size=batch,
                              bucket=bucket, transfer_dtype=transfer_dtype,
                              quantize=quantize, predictor_layout="dfirst")
        return image, label, staged, data, per_dev

    pool = ThreadPoolExecutor(1)
    try:
        futures = deque()
        it = iter(test_loader)
        for data in it:
            futures.append(pool.submit(stage, data))
            if len(futures) >= 2:
                break

        dice_scores = np.zeros(len(test_loader))
        times = []
        i = -1
        while futures:
            i += 1
            data_next = next(it, None)
            if data_next is not None:
                futures.append(pool.submit(stage, data_next))
            logger.info("starting image %d", i)
            image, label, staged, data, per_dev = futures.popleft().result()

            t0 = time.perf_counter()
            if sharded:
                outputs = sliding_window_inference_sharded(
                    staged, cfg.sliding_window_inferer_roi_size, predictor, mesh,
                    overlap=cfg.sw_overlap, sw_batch_size=per_dev,
                    mode="gaussian", predictor_layout="dfirst")
            else:
                outputs = sliding_window_inference(
                    staged, cfg.sliding_window_inferer_roi_size, predictor,
                    overlap=cfg.sw_overlap, sw_batch_size=per_dev,
                    mode="gaussian", predictor_layout="dfirst")
            jax.block_until_ready(outputs)
            times.append(time.perf_counter() - t0)

            dice = float(dice_score(outputs[None].astype(jnp.float32),
                                    jnp.asarray(label[None])))
            dice_scores[i] = dice
            logger.info("dice_score = %s", dice)

            # argmax on device, transfer as uint8 (4x less D2H traffic than int32)
            pred_argmax = np.asarray(jnp.argmax(outputs, axis=-1).astype(jnp.uint8))

            # clinical volumetry (predicted vs ground-truth volume)
            meta = data["label_meta"][0]
            pred_ml = segmentation_volume_ml(pred_argmax, meta["affine"])
            gt_ml = segmentation_volume_ml(label[..., 0], meta["affine"])
            logger.info("volumetry: predicted = %.3f ml, ground truth = %.3f ml",
                        pred_ml, gt_ml)

            if export:
                logger.info("export to nifti...")
                meta = data["label_meta"][0]
                folder_name = os.path.basename(
                    os.path.dirname(meta["filename_or_obj"]))
                out_dir = os.path.join(cfg.results_folder_path,
                                       "inferred_segmentations_nifti", folder_name)
                base = os.path.basename(meta["filename_or_obj"])
                base = base.replace(".nii.gz", "").replace(".nii", "")
                nifti.write_labelmap(
                    pred_argmax.astype(np.float32),
                    os.path.join(out_dir, base + ".nii.gz"),
                    affine=meta["affine"], target_affine=meta["original_affine"],
                    target_shape=meta.get("spatial_shape"))

            if make_figures:
                figures.save_inference_panel(image[..., 0], label[..., 0],
                                             pred_argmax, dice, i, cfg.figures_path)

    finally:
        # release the staging thread and its pinned host buffers —
        # repeated run_inference calls in one process must not leak
        pool.shutdown(wait=False, cancel_futures=True)

    if make_figures:
        figures.save_dice_histogram(dice_scores, cfg.figures_path)
    logger.info("all_dice_scores = %s", dice_scores)
    logger.info("mean_dice_score = %s +- %s", dice_scores.mean(), dice_scores.std())
    if times:
        steady = times[1:] if len(times) > 1 else times
        logger.info("volumes/sec (steady-state) = %.3f",
                    1.0 / (sum(steady) / len(steady)))
    return dice_scores, times
