"""End-to-end slice: debug-scale training on synthetic NIFTIs + full inference
with NIFTI export — exercises every layer once (SURVEY.md §7 stage 5/6)."""

import dataclasses
import os

import numpy as np
import pytest

from vs_seg.core.config import Config
from vs_seg.data import nifti
from vs_seg.data.dataset import CacheDataset, DataLoader, load_split_csv
from vs_seg.data.transforms import get_transforms
from vs_seg.infer import run_inference
from vs_seg.models import build_model
from vs_seg.train import Trainer


def tiny_config(root, tmp) -> Config:
    cfg = Config(
        data_root=str(root),
        split_csv=os.path.join(root, "split_synthetic.csv"),
        results_folder_name="e2e",
        num_epochs=2,
        val_interval=1,
        epochs_with_const_lr=1,
        pad_crop_shape=(32, 32, 16),
        pad_crop_shape_test=(32, 32, 16),
        sliding_window_inferer_roi_size=(32, 32, 16),
        channels=(4, 8, 12, 16),
        strides=((2, 2, 1), (2, 2, 2), (2, 2, 2)),
        kernel_sizes=((3, 3, 1), (3, 3, 3), (3, 3, 3), (3, 3, 3)),
        sample_kernel_sizes=((3, 3, 1), (3, 3, 3), (3, 3, 3)),
        compute_dtype="float32",
        infer_dtype="float32",
        sw_batch_size=2,
        num_workers=2,
    )
    return cfg


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    from vs_seg.data.synthetic import generate_dataset
    root = tmp_path_factory.mktemp("e2e_data")
    generate_dataset(str(root), n_train=2, n_val=1, n_test=2, shape=(48, 48, 16))
    cfg = tiny_config(str(root), tmp_path_factory.mktemp("e2e_out"))

    train_files, val_files, test_files = load_split_csv(
        cfg.split_csv, cfg.dataset, cfg.data_root)
    train_t, val_t, test_t = get_transforms(cfg.pad_crop_shape)
    train_loader = DataLoader(CacheDataset(train_files, train_t, 2),
                              batch_size=1, shuffle=True)
    val_loader = DataLoader(CacheDataset(val_files, val_t, 1), batch_size=1)
    test_loader = DataLoader(CacheDataset(test_files, test_t, 1), batch_size=1)

    os.makedirs(cfg.model_path, exist_ok=True)
    os.makedirs(cfg.figures_path, exist_ok=True)
    model = build_model(cfg)
    trainer = Trainer(cfg, model)
    state = trainer.init_state()
    state, losses, metrics = trainer.fit(state, train_loader, val_loader)
    return cfg, model, trainer, state, losses, metrics, test_loader


def test_training_ran_and_checkpointed(e2e):
    cfg, model, trainer, state, losses, metrics, _ = e2e
    assert len(losses) == cfg.num_epochs
    assert all(np.isfinite(v) for v in losses)
    assert len(metrics) == cfg.num_epochs // cfg.val_interval
    assert os.path.exists(os.path.join(cfg.model_path, "best_metric_model.ckpt"))
    assert os.path.exists(os.path.join(cfg.model_path, "last_epoch_model.ckpt"))


def test_checkpoint_resume_roundtrip(e2e):
    cfg, model, trainer, state, *_ = e2e
    restored = trainer.restore_state(
        os.path.join(cfg.model_path, "last_epoch_model.ckpt"))
    assert restored["epoch"] == cfg.num_epochs
    # params identical to final state
    import jax
    for (p1, a), (p2, b) in zip(
            jax.tree_util.tree_flatten_with_path(state["params"])[0],
            jax.tree_util.tree_flatten_with_path(restored["params"])[0]):
        assert p1 == p2
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_inference_with_export(e2e):
    cfg, model, trainer, state, _, _, test_loader = e2e
    dice_scores, times = run_inference(
        cfg, model, state["params"], state["batch_stats"], test_loader,
        make_figures=True)
    assert dice_scores.shape == (2,)
    assert np.isfinite(dice_scores).all()
    # NIFTI exports exist and load, with the ORIGINAL (non-RAS) affine
    export_root = os.path.join(cfg.results_folder_path,
                               "inferred_segmentations_nifti")
    cases = sorted(os.listdir(export_root))
    assert len(cases) == 2
    f = os.path.join(export_root, cases[0], os.listdir(
        os.path.join(export_root, cases[0]))[0])
    img = nifti.load(f)
    assert img.data.shape == (48, 48, 16)
    assert set(np.unique(img.data)) <= {0.0, 1.0}
    # original affine has negative diag entries (synthetic LPS-ish affine)
    assert img.affine[0, 0] < 0
    # figures written
    assert os.path.exists(os.path.join(
        cfg.figures_path, "best_model_output_dice_score_histogram.png"))
    assert os.path.exists(os.path.join(cfg.figures_path,
                                       "best_model_output_val0.png"))


def test_resume_continues_training(e2e):
    """True mid-training resume (the reference cannot do this, SURVEY.md §5)."""
    import dataclasses
    cfg, model, trainer, state, losses, _, _ = e2e
    restored = trainer.restore_state(
        os.path.join(cfg.model_path, "last_epoch_model.ckpt"))
    cfg3 = dataclasses.replace(cfg, num_epochs=cfg.num_epochs + 1)
    from vs_seg.train import Trainer
    trainer3 = Trainer(cfg3, model)
    from vs_seg.data.dataset import CacheDataset, DataLoader, load_split_csv
    from vs_seg.data.transforms import get_transforms
    train_files, val_files, _ = load_split_csv(cfg.split_csv, cfg.dataset,
                                               cfg.data_root)
    train_t, val_t, _ = get_transforms(cfg.pad_crop_shape)
    train_loader = DataLoader(CacheDataset(train_files, train_t, 1), batch_size=1)
    val_loader = DataLoader(CacheDataset(val_files, val_t, 1), batch_size=1)
    state3, losses3, _ = trainer3.fit(restored, train_loader, val_loader)
    assert len(losses3) == 1  # only the one new epoch ran
    assert state3["epoch"] == cfg.num_epochs + 1


def test_inference_spatial_matches_plain(e2e):
    """run_inference with --spatial_inference (H sharded over the 8-device
    CPU mesh, halo-exchange convs) must reproduce the plain path's Dice."""
    import dataclasses as dc
    cfg, model, trainer, state, _, _, test_loader = e2e
    ref, _ = run_inference(cfg, model, state["params"], state["batch_stats"],
                           test_loader, make_figures=False, export=False)
    cfg2 = dc.replace(cfg, spatial_inference=True)
    out, _ = run_inference(cfg2, model, state["params"], state["batch_stats"],
                           test_loader, make_figures=False, export=False)
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_legacy_threefry_checkpoint_rng_restores():
    """Checkpoints from before the rbg switch stored 2-word threefry key
    data; wrap_rng_data must infer the impl from the shape and keep working."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from vs_seg.train.trainer import wrap_rng_data
    legacy = jax.random.key_data(jax.random.key(7))         # (2,) threefry
    modern = jax.random.key_data(jax.random.key(7, impl="rbg"))  # (4,) rbg
    for data in (legacy, modern, np.asarray(legacy)):
        key = wrap_rng_data(data)
        a, b = jax.random.split(key)
        # usable for sampling and folding
        bits = jax.random.bits(a, (4,), jnp.uint16)
        assert bits.shape == (4,)
        assert not jnp.array_equal(jax.random.key_data(a),
                                   jax.random.key_data(b))
