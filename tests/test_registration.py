import numpy as np

from vs_seg.data import nifti
from vs_seg.preprocessing.registration import read_itk_tfm, resample_to_reference


def test_read_itk_tfm(tmp_path):
    tfm = tmp_path / "t.tfm"
    tfm.write_text(
        "#Insight Transform File V1.0\n"
        "#Transform 0\n"
        "Transform: AffineTransform_double_3_3\n"
        "Parameters: 1 0 0 0 1 0 0 0 1 2 -3 4\n"
        "FixedParameters: 10 20 30\n")
    M = read_itk_tfm(str(tfm))
    np.testing.assert_allclose(M[:3, :3], np.eye(3))
    np.testing.assert_allclose(M[:3, 3], [2, -3, 4])


def test_resample_identity(rng):
    data = rng.normal(size=(10, 12, 8)).astype(np.float32)
    aff = np.diag([1.0, 1.0, 2.0, 1.0])
    img = nifti.NiftiImage(data, aff)
    out = resample_to_reference(img, img)
    np.testing.assert_allclose(out.data, data, atol=1e-4)


def test_resample_translation(rng):
    # moving shifted by +2mm in world x (RAS) relative to reference grid
    data = rng.normal(size=(16, 16, 8)).astype(np.float32)
    ref_aff = np.eye(4)
    mov_aff = np.eye(4)
    mov_aff[0, 3] = 2.0  # moving voxel 0 sits at world x=2
    ref = nifti.NiftiImage(np.zeros_like(data), ref_aff)
    mov = nifti.NiftiImage(data, mov_aff)
    out = resample_to_reference(mov, ref, order=0)
    # reference voxel (i+2) world x = i+2 maps to moving voxel i
    np.testing.assert_allclose(out.data[2:, :, :], data[:-2, :, :])


def test_resample_with_tfm_translation(tmp_path, rng):
    # ITK transform translating fixed->moving by +5mm LPS x == -5mm RAS x
    tfm = tmp_path / "t.tfm"
    tfm.write_text(
        "Transform: AffineTransform_double_3_3\n"
        "Parameters: 1 0 0 0 1 0 0 0 1 5 0 0\n"
        "FixedParameters: 0 0 0\n")
    M = read_itk_tfm(str(tfm))
    data = rng.normal(size=(16, 8, 8)).astype(np.float32)
    img = nifti.NiftiImage(data, np.eye(4))
    out = resample_to_reference(img, img, tfm_lps=M, order=0)
    # LPS +5 == RAS -5: reference voxel i maps to moving voxel i-5
    np.testing.assert_allclose(out.data[5:, :, :], data[:-5, :, :])
