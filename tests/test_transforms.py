import numpy as np

from vs_seg.data import nifti
from vs_seg.data.dataset import CacheDataset, DataLoader, load_split_csv
from vs_seg.data.transforms import (
    AddChannel, Compose, LoadNifti, NormalizeIntensity, Orientation,
    RandFlip, RandSpatialCrop, SpatialPad, get_transforms,
)


def test_normalize_intensity(rng):
    arr = rng.normal(5.0, 3.0, size=(1, 8, 8, 4)).astype(np.float32)
    out = NormalizeIntensity()({"image": arr})
    x = out["image"]
    assert abs(float(x.mean())) < 1e-5
    assert abs(float(x.std()) - 1.0) < 1e-5


def test_spatial_pad_semantics(rng):
    arr = rng.normal(size=(1, 5, 10, 3)).astype(np.float32)
    out = SpatialPad((8, 8, 8), keys=("image",))({"image": arr})
    assert out["image"].shape == (1, 8, 10, 8)
    # symmetric: pad (1,2) on dim0 (d=3), no-op on dim1, (2,3) on dim2 (d=5)
    np.testing.assert_array_equal(out["image"][0, 1:6, :, 2:5], arr[0])


def test_rand_crop_fixed_size(rng):
    arr = np.arange(1 * 10 * 12 * 6, dtype=np.float32).reshape(1, 10, 12, 6)
    t = RandSpatialCrop((4, 4, 4), keys=("image",))
    for _ in range(10):
        out = t({"image": arr}, rng)
        assert out["image"].shape == (1, 4, 4, 4)
    # identity on dims where size == roi
    out = RandSpatialCrop((10, 12, 6), keys=("image",))({"image": arr}, rng)
    np.testing.assert_array_equal(out["image"], arr)


def test_rand_flip_joint(rng):
    img = np.arange(8, dtype=np.float32).reshape(1, 2, 2, 2)
    lbl = img * 10
    t = RandFlip(prob=1.0, spatial_axis=0)
    out = t({"image": img, "label": lbl}, rng)
    np.testing.assert_array_equal(out["image"], img[:, ::-1])
    np.testing.assert_array_equal(out["label"], lbl[:, ::-1])


def test_full_pipeline_on_synthetic(synthetic_root):
    train_files, val_files, test_files = load_split_csv(
        synthetic_root + "/split_synthetic.csv", "T1", synthetic_root)
    assert len(train_files) == 2 and len(val_files) == 2 and len(test_files) == 2
    train_t, _, test_t = get_transforms((64, 64, 24))
    ds = CacheDataset(train_files, train_t, num_workers=2)
    sample = ds.get(0, np.random.default_rng(0))
    assert sample["image"].shape == (1, 64, 64, 24)
    assert sample["label"].shape == (1, 64, 64, 24)
    assert set(np.unique(sample["label"])) <= {0.0, 1.0}
    # image is RAS-oriented now
    ornt = nifti.io_orientation(sample["image_meta"]["affine"])
    np.testing.assert_array_equal(ornt, np.array([[0, 1], [1, 1], [2, 1]]))
    # original_affine preserved for export round-trip
    assert not np.allclose(sample["image_meta"]["affine"],
                           sample["image_meta"]["original_affine"])

    # test pipeline keeps whole volume
    ds_test = CacheDataset(test_files, test_t, num_workers=1)
    s = ds_test.get(0, np.random.default_rng(0))
    assert s["image"].shape == (1, 48, 48, 16)


def test_loader_batching_and_shuffle(synthetic_root):
    train_files, _, _ = load_split_csv(
        synthetic_root + "/split_synthetic.csv", "T1", synthetic_root)
    train_t, _, _ = get_transforms((32, 32, 16))
    ds = CacheDataset(train_files, train_t, num_workers=1)
    loader = DataLoader(ds, batch_size=2, shuffle=True, seed=0)
    batches = list(loader)
    assert len(batches) == 1
    assert batches[0]["image"].shape == (2, 1, 32, 32, 16)
    # epochs differ (random crop/flip re-applied)
    b2 = list(loader)[0]
    assert not np.array_equal(batches[0]["image"], b2["image"])


def test_spacing_transform(rng):
    from vs_seg.data.transforms import Spacing
    arr = rng.normal(size=(1, 20, 20, 10)).astype(np.float32)
    lbl = (rng.random((1, 20, 20, 10)) > 0.5).astype(np.float32)
    aff = np.diag([0.5, 0.5, 2.0, 1.0])
    sample = {"image": arr, "label": lbl,
              "image_meta": {"affine": aff.copy()},
              "label_meta": {"affine": aff.copy()}}
    out = Spacing((1.0, 1.0, 1.0))(sample)
    assert out["image"].shape == (1, 10, 10, 20)
    assert out["label"].shape == (1, 10, 10, 20)
    assert set(np.unique(out["label"])) <= {0.0, 1.0}  # nearest for labels
    new_zooms = np.sqrt((out["image_meta"]["affine"][:3, :3] ** 2).sum(axis=0))
    np.testing.assert_allclose(new_zooms, [1.0, 1.0, 1.0], rtol=1e-6)
