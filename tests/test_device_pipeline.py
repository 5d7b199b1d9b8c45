"""HBM-cached device pipeline: crop/flip semantics match the host transforms."""

import jax
import numpy as np

from vs_seg.data.device_pipeline import DeviceCachedDataset, DeviceLoader


def _samples(rng, n=3, shape=(20, 18, 10)):
    out = []
    for i in range(n):
        img = rng.normal(size=(1, *shape)).astype(np.float32)
        lbl = (rng.random((1, *shape)) > 0.7).astype(np.float32)
        out.append({"image": img, "label": lbl})
    return out


def test_device_crop_within_volume_and_joint(rng):
    samples = _samples(rng)
    crop = (8, 8, 4)  # (H, W, D)
    ds = DeviceCachedDataset(samples, crop)
    assert len(ds) == 3
    src_img = np.transpose(samples[1]["image"][0], (2, 0, 1))  # (D, H, W)
    src_lbl = np.transpose(samples[1]["label"][0], (2, 0, 1))

    for seed in range(6):
        img, lbl = ds.sample(1, jax.random.key(seed))
        assert img.shape == (1, 4, 8, 8, 1)  # (B, D, H, W, C)
        assert lbl.shape == (1, 4, 8, 8, 1)
        got = np.asarray(img[0, :, :, :, 0], dtype=np.float32)
        got_l = np.asarray(lbl[0, :, :, :, 0])
        # the crop (possibly H-flipped) must appear verbatim in the source
        cand = [got, got[:, ::-1, :]]
        found = False
        for g, gl in [(cand[0], got_l), (cand[1], got_l[:, ::-1, :])]:
            for d0 in range(src_img.shape[0] - 4 + 1):
                for h0 in range(src_img.shape[1] - 8 + 1):
                    for w0 in range(src_img.shape[2] - 8 + 1):
                        window = src_img[d0:d0 + 4, h0:h0 + 8, w0:w0 + 8]
                        if np.allclose(window, g, atol=0.02):
                            np.testing.assert_array_equal(
                                src_lbl[d0:d0 + 4, h0:h0 + 8, w0:w0 + 8], gl)
                            found = True
                            break
                    if found:
                        break
                if found:
                    break
            if found:
                break
        assert found, f"crop (seed {seed}) not found in source volume"


def test_device_loader_epochs_differ(rng):
    samples = _samples(rng, n=2, shape=(12, 12, 8))
    ds = DeviceCachedDataset(samples, (8, 8, 4))
    loader = DeviceLoader(ds, batch_size=1, shuffle=True, seed=0)
    e1 = [np.asarray(i) for i, _ in loader]
    e2 = [np.asarray(i) for i, _ in loader]
    assert len(e1) == 2
    assert not all(np.array_equal(a, b) for a, b in zip(e1, e2))


def test_device_pipeline_trains(rng):
    """One epoch of Trainer.fit through the device pipeline."""
    from vs_seg.core.config import Config
    from vs_seg.models import build_model
    from vs_seg.train import Trainer
    import tempfile

    samples = _samples(rng, n=2, shape=(16, 16, 8))
    with tempfile.TemporaryDirectory() as td:
        cfg = Config(data_root=td, results_folder_name="dp",
                     num_epochs=1, val_interval=1, epochs_with_const_lr=1,
                     pad_crop_shape=(16, 16, 8),
                     channels=(4, 8, 12), strides=((2, 2, 1), (2, 2, 2)),
                     kernel_sizes=((3, 3, 1), (3, 3, 3), (3, 3, 3)),
                     sample_kernel_sizes=((3, 3, 1), (3, 3, 3)),
                     compute_dtype="float32")
        import os
        os.makedirs(cfg.model_path, exist_ok=True)
        ds = DeviceCachedDataset(samples, cfg.pad_crop_shape,
                                 image_dtype=np.float32)
        loader = DeviceLoader(ds, batch_size=1, shuffle=True)
        model = build_model(cfg)
        trainer = Trainer(cfg, model)
        state = trainer.init_state()
        state, losses, metrics = trainer.fit(state, loader, loader)
        assert len(losses) == 1 and np.isfinite(losses[0])


def test_device_cache_heterogeneous_shapes(rng):
    """SpatialPad only lower-bounds shapes; volumes above the floor must
    stack (end-padded) with crops drawn only from each volume's true extent."""
    shapes = [(20, 18, 10), (24, 18, 12), (20, 22, 10)]
    samples = []
    for s in shapes:
        img = rng.normal(size=(1, *s)).astype(np.float32) + 10.0  # all >> 0
        lbl = (rng.random((1, *s)) > 0.7).astype(np.float32)
        samples.append({"image": img, "label": lbl})
    ds = DeviceCachedDataset(samples, (8, 8, 4))
    for i in range(3):
        for seed in range(4):
            img, _ = ds.sample(i, jax.random.key(seed))
            got = np.asarray(img, dtype=np.float32)
            assert got.shape == (1, 4, 8, 8, 1)
            # crops never touch the zero padding (source values are all >= ~5)
            assert got.min() > 1.0, (i, seed, got.min())


def test_device_cache_no_augment_is_deterministic_crop_only(rng):
    """augment=False (validation): no flip — the crop appears UNFLIPPED."""
    samples = _samples(rng, n=1, shape=(12, 12, 8))
    ds = DeviceCachedDataset(samples, (8, 8, 4), augment=False)
    src = np.transpose(samples[0]["image"][0], (2, 0, 1))  # (D, H, W)
    for seed in range(8):
        img, _ = ds.sample(0, jax.random.key(seed))
        got = np.asarray(img[0, :, :, :, 0], dtype=np.float32)
        found = any(
            np.allclose(src[d0:d0 + 4, h0:h0 + 8, w0:w0 + 8], got, atol=0.02)
            for d0 in range(src.shape[0] - 3)
            for h0 in range(src.shape[1] - 7)
            for w0 in range(src.shape[2] - 7))
        assert found, f"unflipped crop not found (seed {seed})"
