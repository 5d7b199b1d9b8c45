import numpy as np
import pytest

from vs_seg.data import nifti


def test_save_load_roundtrip(tmp_path, rng):
    data = rng.normal(size=(13, 9, 7)).astype(np.float32)
    aff = np.diag([-0.5, 0.8, 1.5, 1.0])
    aff[:3, 3] = [1.0, -2.0, 3.0]
    path = str(tmp_path / "x.nii.gz")
    nifti.save(nifti.NiftiImage(data, aff), path)
    img = nifti.load(path)
    np.testing.assert_allclose(img.data, data, rtol=1e-6)
    np.testing.assert_allclose(img.affine, aff, atol=1e-5)


def test_save_load_uncompressed_int(tmp_path, rng):
    data = rng.integers(0, 2, size=(5, 6, 7)).astype(np.uint8)
    path = str(tmp_path / "seg.nii")
    nifti.save(nifti.NiftiImage(data, np.eye(4)), path)
    img = nifti.load(path, dtype=None)
    assert img.data.dtype == np.uint8
    np.testing.assert_array_equal(img.data, data)


def test_scl_slope_applied(tmp_path, rng):
    # Hand-write a header with slope/inter and check get_fdata-like scaling.
    import gzip
    import struct
    data = rng.integers(-100, 100, size=(4, 4, 4)).astype(np.int16)
    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 3, 4, 4, 4, 1, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, 4)  # int16
    struct.pack_into("<h", hdr, 72, 16)
    struct.pack_into("<8f", hdr, 76, 1, 1, 1, 1, 1, 1, 1, 1)
    struct.pack_into("<f", hdr, 108, 352.0)
    struct.pack_into("<2f", hdr, 112, 2.0, 5.0)  # slope=2, inter=5
    struct.pack_into("<2h", hdr, 252, 0, 1)
    struct.pack_into("<12f", hdr, 280, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0)
    hdr[344:348] = b"n+1\x00"
    path = str(tmp_path / "scaled.nii.gz")
    with gzip.open(path, "wb") as f:
        f.write(bytes(hdr) + data.tobytes(order="F"))
    img = nifti.load(path)
    np.testing.assert_allclose(img.data, data.astype(np.float32) * 2 + 5)


def test_reorient_to_ras():
    # LPS affine: flip first two axes to get RAS.
    aff = np.diag([-1.0, -1.0, 1.0, 1.0])
    aff[:3, 3] = [10.0, 20.0, -5.0]
    data = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
    new_data, new_aff, _ = nifti.reorient_to(data, aff, "RAS")
    np.testing.assert_array_equal(new_data, data[::-1, ::-1, :])
    # New affine must map voxel (i,j,k) to the same world point as the old
    # affine mapped the corresponding original voxel.
    old_pt = aff @ np.array([0, 0, 0, 1.0])
    new_pt = new_aff @ np.array([1, 2, 0, 1.0])
    np.testing.assert_allclose(old_pt, new_pt, atol=1e-6)
    ornt = nifti.io_orientation(new_aff)
    np.testing.assert_array_equal(ornt, np.array([[0, 1], [1, 1], [2, 1]]))


def test_reorient_axis_swap():
    # Affine that swaps axes (voxel axis 0 -> world S, axis 2 -> world R).
    aff = np.zeros((4, 4))
    aff[2, 0] = 2.0   # voxel i moves world z
    aff[1, 1] = 1.0   # voxel j moves world y
    aff[0, 2] = -0.5  # voxel k moves world -x
    aff[3, 3] = 1.0
    data = np.random.default_rng(1).normal(size=(3, 4, 5)).astype(np.float32)
    new_data, new_aff, _ = nifti.reorient_to(data, aff, "RAS")
    assert new_data.shape == (5, 4, 3)
    ornt = nifti.io_orientation(new_aff)
    np.testing.assert_array_equal(ornt, np.array([[0, 1], [1, 1], [2, 1]]))
    # world position of a voxel must be preserved through reorientation
    voxels = np.array([[1, 2, 3, 1], [0, 0, 0, 1], [2, 3, 4, 1]], dtype=float).T
    old_world = aff @ voxels
    # brute-force check: every value present at same world coordinate
    for idx in np.ndindex(*data.shape):
        w = (aff @ np.array([*idx, 1.0]))[:3]
        # find matching voxel in new grid
        inv = np.linalg.inv(new_aff)
        nidx = inv @ np.array([*w, 1.0])
        nidx = np.round(nidx[:3]).astype(int)
        assert new_data[tuple(nidx)] == data[idx]


def test_write_labelmap_roundtrip(tmp_path):
    # Simulate export path: data in RAS, original affine LPS -> written file
    # must equal the original-orientation volume.
    orig_aff = np.diag([-1.0, -1.0, 2.0, 1.0])
    orig_aff[:3, 3] = [5.0, 6.0, 7.0]
    orig_data = np.random.default_rng(2).integers(0, 2, size=(6, 5, 4)).astype(np.float32)
    ras_data, ras_aff, _ = nifti.reorient_to(orig_data, orig_aff, "RAS")
    out = str(tmp_path / "seg_out.nii.gz")
    nifti.write_labelmap(ras_data, out, affine=ras_aff, target_affine=orig_aff)
    img = nifti.load(out)
    np.testing.assert_array_equal(img.data, orig_data)
    np.testing.assert_allclose(img.affine, orig_aff, atol=1e-5)


def test_orientation_roundtrip_fuzz(tmp_path, rng):
    """Export round-trip through original_affine for ALL 48 axis
    orientations: a labelmap written back with the original affine must
    overlay the source voxels exactly (the property that decides whether
    exported segmentations align with the originals — SURVEY 'hard parts')."""
    import itertools
    from vs_seg.data import nifti

    data = (rng.random((6, 5, 4)) > 0.6).astype(np.float32)
    n = 0
    for perm in itertools.permutations(range(3)):
        for sx in (1, -1):
            for sy in (1, -1):
                for sz in (1, -1):
                    rot = np.zeros((3, 3))
                    for i, p in enumerate(perm):
                        rot[i, p] = (sx, sy, sz)[i] * (1.0 + 0.5 * p)
                    affine = np.eye(4)
                    affine[:3, :3] = rot
                    affine[:3, 3] = [3.0, -7.0, 11.0]
                    src = tmp_path / f"src{n}.nii.gz"
                    nifti.save(nifti.NiftiImage(data, affine), str(src))
                    img = nifti.load(str(src))
                    # reorient to RAS (what the pipeline sees) ...
                    ras, ras_affine, _ = nifti.reorient_to(img.data, img.affine)
                    out = tmp_path / f"out{n}.nii.gz"
                    # ... and write the "prediction" back with the ORIGINAL
                    # affine, as run_inference does
                    nifti.write_labelmap(ras, str(out), affine=ras_affine,
                                         target_affine=affine)
                    back = nifti.load(str(out), dtype=None)
                    np.testing.assert_array_equal(
                        np.asarray(back.data, np.float32), data,
                        err_msg=f"orientation {perm} {(sx, sy, sz)}")
                    np.testing.assert_allclose(back.affine, affine, atol=1e-5)
                    n += 1
    assert n == 48


def test_write_labelmap_resamples_spacing_output(tmp_path):
    """A labelmap whose affine differs from original_affine by more than a
    permutation/flip (e.g. after a Spacing transform) must be RESAMPLED back
    onto the original grid — MONAI write_nifti's resample=True path
    (reference params/VSparams.py:591-594), not just reoriented."""
    rng = np.random.default_rng(7)
    orig_aff = np.diag([-1.0, -1.0, 2.0, 1.0])  # LPS, anisotropic z
    orig_aff[:3, 3] = [4.0, -2.0, 9.0]
    orig_data = rng.integers(0, 3, size=(6, 5, 4)).astype(np.float32)

    # pipeline view: reorient to RAS, then a Spacing halves the z voxel size
    ras, ras_aff, _ = nifti.reorient_to(orig_data, orig_aff)
    fine = np.repeat(ras, 2, axis=2)
    fine_aff = np.asarray(ras_aff, np.float64).copy()
    fine_aff[:3, 2] *= 0.5

    out = str(tmp_path / "seg.nii.gz")
    nifti.write_labelmap(fine, out, affine=fine_aff, target_affine=orig_aff,
                         target_shape=orig_data.shape)
    img = nifti.load(out)
    np.testing.assert_allclose(img.affine, orig_aff, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(img.data, np.float32), orig_data)
