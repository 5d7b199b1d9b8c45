import numpy as np

from vs_seg.data import nifti
from vs_seg.native.decoder import (convert_to_float32, native_available,
                                   read_file_bytes)


def test_native_compiles_and_reads_gz(tmp_path, rng):
    assert native_available(), "g++/zlib native decoder failed to build"
    data = rng.normal(size=(9, 7, 5)).astype(np.float32)
    path = str(tmp_path / "vol.nii.gz")
    nifti.save(nifti.NiftiImage(data, np.eye(4)), path)
    raw = read_file_bytes(path)
    assert raw is not None
    # same bytes the python gzip path produces
    import gzip
    with gzip.open(path, "rb") as f:
        assert raw == f.read()
    # full load goes through the native path and round-trips
    img = nifti.load(path)
    np.testing.assert_allclose(img.data, data, rtol=1e-6)


def test_native_uncompressed_passthrough(tmp_path, rng):
    data = rng.integers(0, 255, size=(4, 4, 4)).astype(np.uint8)
    path = str(tmp_path / "vol.nii")
    nifti.save(nifti.NiftiImage(data, np.eye(4)), path)
    raw = read_file_bytes(path)
    with open(path, "rb") as f:
        assert raw == f.read()


def test_native_dtype_conversion(rng):
    if not native_available():
        return
    src = rng.integers(-1000, 1000, size=100).astype("<i2")
    out = convert_to_float32(src.tobytes(), 100, 4, 2.0, 5.0)
    np.testing.assert_allclose(out, src.astype(np.float32) * 2.0 + 5.0)


def test_multi_member_gzip_decodes_fully(tmp_path):
    """bgzip-style concatenated gzip members must fully decode — stopping at
    the first member would silently truncate the volume payload."""
    import gzip
    from vs_seg.native.decoder import read_file_bytes
    a, b = b"x" * 70000, b"y" * 50000
    path = tmp_path / "multi.gz"
    path.write_bytes(gzip.compress(a) + gzip.compress(b))
    data = read_file_bytes(str(path))
    if data is None:  # native lib unavailable: python fallback handles it
        import pytest
        pytest.skip("native decoder not built")
    assert data == a + b
