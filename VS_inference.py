#!/usr/bin/env python3
"""Inference entry point — CLI-compatible with the reference VS_inference.py.

Flow (reference VS_inference.py:15-42): parse args -> logger -> split CSV ->
test transforms -> cached test loader -> model -> load best checkpoint ->
sliding-window inference + Dice + NIFTI export + figures.

Accepts our full-state .ckpt checkpoints or reference .pth state_dicts
(auto-converted via vs_seg.compat.torch_import).
"""

import argparse
import os

from vs_seg.core import (add_reference_cli_flags, config_from_args,
                         create_results_folders, log_parameters,
                         set_up_logger)
from vs_seg.data.dataset import CacheDataset, DataLoader, load_split_csv
from vs_seg.data.transforms import get_transforms
from vs_seg.infer import run_inference
from vs_seg.models import build_model


def load_model_state(cfg, model):
    """best_metric_model.ckpt (ours) or best_metric_model.pth (reference).

    The loaded parameter tree is validated against `model`'s expected
    structure/shapes — a checkpoint from a different architecture config
    fails loudly here instead of at trace time deep inside the first step."""
    ckpt_path = os.path.join(cfg.model_path, "best_metric_model.ckpt")
    pth_path = os.path.join(cfg.model_path, "best_metric_model.pth")
    if os.path.exists(ckpt_path):
        from vs_seg.train.checkpoint import load_checkpoint
        state = load_checkpoint(ckpt_path)
        params, stats = state["params"], state["batch_stats"]
    elif os.path.exists(pth_path):
        from vs_seg.compat.torch_import import import_unet2d5_spvpa, load_pth
        params, stats = import_unet2d5_spvpa(
            load_pth(pth_path), channels=tuple(cfg.channels),
            num_res_units=cfg.num_res_units, attention=cfg.attention)
    else:
        raise FileNotFoundError(f"no checkpoint under {cfg.model_path}")

    import jax
    from vs_seg.train.trainer import init_model, minimal_input_shape
    expect = jax.eval_shape(
        lambda: init_model(model, 0, input_shape=minimal_input_shape(model)))
    got_shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), params)
    want_shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                         expect["params"])
    if got_shapes != want_shapes:
        raise ValueError(
            "checkpoint parameter tree does not match the configured model "
            f"architecture (cfg: channels={cfg.channels}, "
            f"attention={cfg.attention})")
    return params, stats


def main(argv=None):
    parser = argparse.ArgumentParser()
    add_reference_cli_flags(parser)
    cfg = config_from_args(parser.parse_args(argv))

    create_results_folders(cfg)
    logger = set_up_logger(cfg, "test_log.txt")
    log_parameters(cfg, logger)

    _, _, test_files = load_split_csv(cfg.split_csv, cfg.dataset, cfg.data_root)
    logger.info("Number of images in test set = %d", len(test_files))
    _, _, test_t = get_transforms(cfg.pad_crop_shape_test)
    logger.info("Caching test data set...")
    test_ds = CacheDataset(test_files, test_t, num_workers=cfg.num_workers)
    test_loader = DataLoader(test_ds, batch_size=1)

    model = build_model(cfg)
    params, batch_stats = load_model_state(cfg, model)
    dice_scores, times = run_inference(cfg, model, params, batch_stats,
                                       test_loader, logger=logger)
    return dice_scores, times


if __name__ == "__main__":
    main()
