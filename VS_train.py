#!/usr/bin/env python3
"""Training entry point — CLI-compatible with the reference VS_train.py.

Flow (reference VS_train.py:15-51): parse args -> results folders -> logger ->
parameter dump -> split CSV -> transforms -> transform sanity figure -> cached
loaders -> model/loss/optimizer -> training loop -> loss/Dice curves.
"""

import argparse
import os

from vs_seg.core import (add_reference_cli_flags, config_from_args,
                         create_results_folders, log_parameters,
                         set_up_logger)
from vs_seg.data.dataset import CacheDataset, DataLoader, load_split_csv
from vs_seg.data.transforms import get_transforms
from vs_seg.eval import figures
from vs_seg.models import build_model
from vs_seg.train import Trainer


def main(argv=None):
    parser = argparse.ArgumentParser()
    add_reference_cli_flags(parser)
    cfg = config_from_args(parser.parse_args(argv))

    # multi-host (DCN): initialize from env if a coordinator is configured
    # (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID), build the
    # (dcn, data) mesh and shard the training set per host (SURVEY §2.5).
    import jax
    from vs_seg.parallel import distributed as dist
    coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coord:
        dist.initialize(coord,
                        int(os.environ["JAX_NUM_PROCESSES"]),
                        int(os.environ["JAX_PROCESS_ID"]))
    multihost = jax.process_count() > 1
    mesh = dist.make_global_mesh() if multihost else None

    create_results_folders(cfg)
    logger = set_up_logger(cfg, "training_log.txt")
    log_parameters(cfg, logger)

    train_files, val_files, _ = load_split_csv(cfg.split_csv, cfg.dataset,
                                               cfg.data_root)
    if multihost:
        train_files = dist.shard_files_for_process(train_files)
        logger.info("multi-host: process %d/%d holds %d training cases",
                    jax.process_index(), jax.process_count(), len(train_files))
    logger.info("Number of images in training set   = %d", len(train_files))
    logger.info("Number of images in validation set = %d", len(val_files))
    train_t, val_t, _ = get_transforms(cfg.pad_crop_shape)

    # transform sanity figure (reference VSparams.py:266-297)
    import numpy as np
    check = val_t(dict(val_files[0]), np.random.default_rng(cfg.seed))
    logger.info("Validation image shape = %s", check["image"].shape)
    figures.save_transform_check(check["image"][0], check["label"][0],
                                 cfg.figures_path)

    logger.info("Caching training data set...")
    train_ds = CacheDataset(train_files, train_t, num_workers=cfg.num_workers)
    logger.info("Caching validation data set...")
    val_ds = CacheDataset(val_files, val_t, num_workers=cfg.num_workers)
    if cfg.device_cache:
        from vs_seg.data.device_pipeline import (DeviceCachedDataset,
                                                 DeviceLoader)
        logger.info("Uploading training set to HBM (device-side augmentation)")
        train_loader = DeviceLoader(
            DeviceCachedDataset(train_ds.cache, cfg.pad_crop_shape),
            batch_size=cfg.train_batch_size, shuffle=True, seed=cfg.seed)
        val_loader = DeviceLoader(
            DeviceCachedDataset(val_ds.cache, cfg.pad_crop_shape,
                                augment=False),  # val never flips (ref :228)
            batch_size=1, seed=cfg.seed + 1)
    else:
        train_loader = DataLoader(train_ds, batch_size=cfg.train_batch_size,
                                  shuffle=True, seed=cfg.seed,
                                  prefetch=cfg.prefetch_depth)
        val_loader = DataLoader(val_ds, batch_size=1)

    logger.info("Setting up the model type...")
    model = build_model(cfg)
    tb_writer = None
    try:
        from tensorboardX import SummaryWriter
        tb_writer = SummaryWriter()
    except Exception:
        logger.info("tensorboardX unavailable; skipping TB logging")

    trainer = Trainer(cfg, model, logger=logger, tb_writer=tb_writer, mesh=mesh)
    resume_path = os.path.join(cfg.model_path, "last_epoch_model.ckpt")
    if getattr(cfg, "resume", False) and os.path.exists(resume_path):
        logger.info("Resuming full training state from %s", resume_path)
        state = trainer.restore_state(resume_path)
    else:
        state = trainer.init_state()
    state, epoch_loss_values, metric_values = trainer.fit(
        state, train_loader, val_loader)

    figures.save_loss_and_dice_curves(epoch_loss_values, metric_values,
                                      cfg.val_interval, cfg.figures_path)
    return state


if __name__ == "__main__":
    main()
