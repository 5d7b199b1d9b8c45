"""Preprocessing toolchain tests: minimal DICOM writer (test-only) ->
series assembly, affine correctness, RTSTRUCT contour rasterization."""

import os
import struct

import numpy as np
import pytest

from vs_seg.preprocessing import convert
from vs_seg.preprocessing.dicom import read_dicom, pixel_array


def _el(group, elem, vr, payload: bytes) -> bytes:
    head = struct.pack("<HH", group, elem) + vr
    if vr in (b"OB", b"OW", b"SQ", b"UN", b"UT"):
        return head + b"\x00\x00" + struct.pack("<I", len(payload)) + payload
    return head + struct.pack("<H", len(payload)) + payload


def _txt(s):
    b = str(s).encode()
    return b + b" " if len(b) % 2 else b


def write_mr_slice(path, pixels: np.ndarray, ipp, iop, spacing, series_uid,
                   sop_uid, desc="t1 image"):
    body = b""
    body += _el(0x0008, 0x0018, b"UI", _txt(sop_uid))
    body += _el(0x0008, 0x0060, b"CS", _txt("MR"))
    body += _el(0x0008, 0x103E, b"LO", _txt(desc))
    body += _el(0x0020, 0x000E, b"UI", _txt(series_uid))
    body += _el(0x0020, 0x0032, b"DS", _txt("\\".join(f"{v:g}" for v in ipp)))
    body += _el(0x0020, 0x0037, b"DS", _txt("\\".join(f"{v:g}" for v in iop)))
    body += _el(0x0028, 0x0010, b"US", struct.pack("<H", pixels.shape[0]))
    body += _el(0x0028, 0x0011, b"US", struct.pack("<H", pixels.shape[1]))
    body += _el(0x0028, 0x0030, b"DS", _txt(f"{spacing[0]:g}\\{spacing[1]:g}"))
    body += _el(0x0028, 0x0100, b"US", struct.pack("<H", 16))
    body += _el(0x0028, 0x0103, b"US", struct.pack("<H", 1))
    body += _el(0x0028, 0x1052, b"DS", _txt("0"))
    body += _el(0x0028, 0x1053, b"DS", _txt("1"))
    body += _el(0x7FE0, 0x0010, b"OW", pixels.astype("<i2").tobytes())
    meta_el = _el(0x0002, 0x0010, b"UI", _txt("1.2.840.10008.1.2.1"))
    meta = _el(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta_el))) + meta_el
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM" + meta + body)


def _item(payload: bytes) -> bytes:
    return struct.pack("<HHI", 0xFFFE, 0xE000, len(payload)) + payload


def write_rtstruct(path, contours_lps, roi_name="VS_tumor", series_uid="1.2.3",
                   sop_uid="1.2.3.4.5"):
    roi_seq = _item(_el(0x3006, 0x0022, b"IS", _txt("1"))
                    + _el(0x3006, 0x0026, b"LO", _txt(roi_name)))
    contour_items = b""
    for pts in contours_lps:
        flat = "\\".join(f"{v:.4f}" for v in np.asarray(pts).ravel())
        contour_items += _item(
            _el(0x3006, 0x0046, b"IS", _txt(str(len(pts))))
            + _el(0x3006, 0x0050, b"DS", _txt(flat)))
    roi_contour = _item(
        _el(0x3006, 0x0040, b"SQ", contour_items)
        + _el(0x3006, 0x0084, b"IS", _txt("1")))
    # real TCIA RTSTRUCT nesting: the referenced image SeriesInstanceUID
    # lives in ReferencedFrameOfReference > RTReferencedStudy >
    # RTReferencedSeries — NOT in a top-level element
    ref_series = _item(_el(0x0020, 0x000E, b"UI", _txt(series_uid)))
    ref_study = _item(_el(0x0008, 0x1155, b"UI", _txt("1.2.840.999.1"))
                      + _el(0x3006, 0x0014, b"SQ", ref_series))
    ref_for = _item(_el(0x0020, 0x0052, b"UI", _txt("1.2.840.999.2"))
                    + _el(0x3006, 0x0012, b"SQ", ref_study))
    body = b""
    body += _el(0x0008, 0x0018, b"UI", _txt(sop_uid))
    body += _el(0x0008, 0x0060, b"CS", _txt("RTSTRUCT"))
    body += _el(0x3006, 0x0010, b"SQ", ref_for)
    body += _el(0x3006, 0x0020, b"SQ", roi_seq)
    body += _el(0x3006, 0x0039, b"SQ", roi_contour)
    meta_el = _el(0x0002, 0x0010, b"UI", _txt("1.2.840.10008.1.2.1"))
    meta = _el(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta_el))) + meta_el
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM" + meta + body)


def write_rt_linked(path, modality, sop_uid, ref_sop_uid):
    """RTPLAN (ReferencedStructureSetSequence) or RTDOSE
    (ReferencedRTPlanSequence) stub referencing another RT object's SOP UID."""
    seq_tag = {"RTPLAN": (0x300C, 0x0060), "RTDOSE": (0x300C, 0x0002)}[modality]
    ref_item = _item(_el(0x0008, 0x1155, b"UI", _txt(ref_sop_uid)))
    body = b""
    body += _el(0x0008, 0x0018, b"UI", _txt(sop_uid))
    body += _el(0x0008, 0x0060, b"CS", _txt(modality))
    body += _el(seq_tag[0], seq_tag[1], b"SQ", ref_item)
    meta_el = _el(0x0002, 0x0010, b"UI", _txt("1.2.840.10008.1.2.1"))
    meta = _el(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta_el))) + meta_el
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM" + meta + body)


@pytest.fixture()
def dicom_case(tmp_path, rng):
    """Axial series: 4 slices 16x16, 1mm in-plane, 2mm slice step."""
    case = tmp_path / "case"
    case.mkdir()
    series_uid = "1.2.826.0.1.999"
    vol = rng.integers(-50, 200, size=(16, 16, 4)).astype(np.int16)
    for k in range(4):
        write_mr_slice(str(case / f"IMG{k:04d}.dcm"), vol[:, :, k],
                       ipp=(-10.0, -20.0, 5.0 + 2.0 * k),
                       iop=(1, 0, 0, 0, 1, 0), spacing=(1.0, 1.0),
                       series_uid=series_uid, sop_uid=f"1.2.3.{k}")
    # circular contour of radius 3mm centered at voxel (8, 8) of slice 1 (LPS)
    center_lps = np.array([-10.0 + 8 * 1.0, -20.0 + 8 * 1.0, 7.0])
    theta = np.linspace(0, 2 * np.pi, 33)[:-1]
    circle = np.stack([center_lps[0] + 3.0 * np.cos(theta),
                       center_lps[1] + 3.0 * np.sin(theta),
                       np.full_like(theta, 7.0)], axis=1)
    write_rtstruct(str(case / "RTSS.dcm"), [circle], series_uid=series_uid)
    return case, vol


def test_read_mr_slice(dicom_case):
    case, vol = dicom_case
    ds = read_dicom(str(case / "IMG0000.dcm"))
    assert ds["Modality"] == "MR"
    assert int(ds["Rows"]) == 16
    np.testing.assert_array_equal(pixel_array(ds), vol[:, :, 0])
    assert ds["ImagePositionPatient"] == [-10.0, -20.0, 5.0]


def test_load_series_volume_and_affine(dicom_case):
    case, vol = dicom_case
    files = sorted(str(case / f) for f in os.listdir(case) if f.startswith("IMG"))
    volume, affine = convert.load_series(files)
    np.testing.assert_array_equal(volume, vol.astype(np.float32))
    # voxel (r, c, k) -> RAS world; LPS IPP (-10,-20,5) -> RAS (10, 20, 5)
    origin = affine @ np.array([0, 0, 0, 1.0])
    np.testing.assert_allclose(origin[:3], [10.0, 20.0, 5.0])
    # +1 row (axis 0) moves along LPS +y = RAS -y
    step_r = (affine @ np.array([1, 0, 0, 1.0]))[:3] - origin[:3]
    np.testing.assert_allclose(step_r, [0.0, -1.0, 0.0], atol=1e-9)
    step_k = (affine @ np.array([0, 0, 1, 1.0]))[:3] - origin[:3]
    np.testing.assert_allclose(step_k, [0.0, 0.0, 2.0], atol=1e-9)


def test_convert_case_with_rtstruct(dicom_case, tmp_path):
    case, vol = dicom_case
    out = convert.convert_case(str(case), str(tmp_path / "out"), dataset="T1")
    assert set(out) == {"image", "label"}
    from vs_seg.data import nifti
    seg = nifti.load(out["label"], dtype=None)
    assert seg.data.shape == (16, 16, 4)
    # circle radius 3 on slice 1 -> ~pi*9 = 28 voxels, centered at (8, 8)
    k_counts = [int(seg.data[:, :, k].sum()) for k in range(4)]
    assert k_counts[1] > 20 and sum(k_counts) == k_counts[1]
    assert seg.data[8, 8, 1] == 1
    assert seg.data[8, 12, 1] == 0  # outside radius 3


def test_rasterize_xor_hole():
    # outer square with inner square -> ring (even-odd rule)
    affine = np.eye(4)
    outer = np.array([[0.5, 0.5, 0], [10.5, 0.5, 0], [10.5, 10.5, 0], [0.5, 10.5, 0]])
    inner = np.array([[3.5, 3.5, 0], [7.5, 3.5, 0], [7.5, 7.5, 0], [3.5, 7.5, 0]])
    flip = np.diag([-1.0, -1.0, 1.0])
    outer_lps = (flip @ outer.T).T
    inner_lps = (flip @ inner.T).T
    seg = convert.rasterize_contours([outer_lps, inner_lps], affine, (12, 12, 1))
    assert seg[5, 5, 0] == 0  # hole
    assert seg[2, 5, 0] == 1  # ring


def _make_case_pair(root, rng, case=1):
    """vs_gk_<case>_{t1,t2} folders with IMG slices, RTSS, and a .tfm."""
    import json as _json
    for tag, uid in (("t1", f"1.2.3.{case}.1"), ("t2", f"1.2.3.{case}.2")):
        d = root / f"vs_gk_{case}_{tag}"
        d.mkdir(parents=True)
        for k in range(3):
            write_mr_slice(str(d / f"IMG{k:04d}.dcm"),
                           rng.integers(0, 200, size=(12, 12)).astype(np.int16),
                           ipp=(-5.0, -5.0, 2.0 * k), iop=(1, 0, 0, 0, 1, 0),
                           spacing=(1.0, 1.0), series_uid=uid,
                           sop_uid=f"{uid}.{k}", desc=f"{tag}_tse image")
        circle = [[-5 + 6 + 2 * np.cos(t), -5 + 6 + 2 * np.sin(t), 2.0]
                  for t in np.linspace(0, 2 * np.pi, 17)[:-1]]
        write_rtstruct(str(d / "RTSS.dcm"), [np.asarray(circle)],
                       series_uid=uid, sop_uid=f"{uid}.rtss")
        # reference-layout contours.json (structure list) + identity .tfm
        with open(d / "contours.json", "w") as f:
            _json.dump([{"structure_name": "tumour",
                         "LPS_contour_points": [circle]}], f)
        tfm = ("#Insight Transform File V1.0\n#Transform 0\n"
               "Transform: AffineTransform_double_3_3\n"
               "Parameters: 1 0 0 0 1 0 0 0 1 0 0 0\n"
               "FixedParameters: 0 0 0\n")
        name = ("inv_T1_LPS_to_T2_LPS.tfm" if tag == "t1"
                else "inv_T2_LPS_to_T1_LPS.tfm")
        (d / name).write_text(tfm)


def test_build_bids_dataset(tmp_path, rng):
    """Generated tree must match the structure of the reference's shipped
    VS-SEG-BIDS-nonifti sample (VERDICT r2 task 6)."""
    from vs_seg.preprocessing.bids import build_bids_dataset
    import json as _json
    _make_case_pair(tmp_path / "cases", rng, case=1)
    out = str(tmp_path / "bids")
    written = build_bids_dataset(str(tmp_path / "cases"), out)
    assert len(written) == 2  # T1w + T2w
    # root artifacts
    for p in ("README", "dataset_description.json", "participants.tsv"):
        assert os.path.exists(os.path.join(out, p)), p
    # raw layout: NO ses- level (reference sample tree)
    for mod in ("T1w", "T2w"):
        assert os.path.exists(os.path.join(
            out, "sub-001", "anat", f"sub-001_{mod}.nii.gz"))
        sidecar = os.path.join(out, "sub-001", "anat", f"sub-001_{mod}.json")
        assert os.path.exists(sidecar)
        with open(sidecar) as f:
            sd = _json.load(f)
        assert sd["Modality"] == "MR"
        assert "SeriesDescription" in sd
    # sourcedata copies
    assert os.path.exists(os.path.join(
        out, "sourcedata", "contours", "sub-001", "anat",
        "sub-001_contours_space-individual_T1w.json"))
    assert os.path.exists(os.path.join(
        out, "sourcedata", "registration_matrices", "sub-001", "anat",
        "sub-001_inv_T1_LPS_to_T2_LPS.tfm"))
    # derivatives: masks + registered images, each with a description json
    for deriv, fname in [
            ("manual_segmentation_masks_of_T1w",
             "sub-001_space-individual_desc-tumor_mask.nii.gz"),
            ("manual_segmentation_masks_of_T2w",
             "sub-001_space-individual_desc-tumor_mask.nii.gz"),
            ("T1w_registered_to_T2w", "sub-001_space-individual_T1w.nii.gz"),
            ("T2w_registered_to_T1w", "sub-001_space-individual_T2w.nii.gz")]:
        base = os.path.join(out, "derivatives", deriv)
        assert os.path.exists(os.path.join(base, "dataset_description.json"))
        assert os.path.exists(os.path.join(base, "sub-001", "anat", fname))
        assert os.path.exists(os.path.join(
            base, "sub-001", "anat",
            fname.replace(".nii.gz", ".json")))
    # mask sidecar has the reference's provenance keys
    with open(os.path.join(
            out, "derivatives", "manual_segmentation_masks_of_T1w", "sub-001",
            "anat", "sub-001_space-individual_desc-tumor_mask.json")) as f:
        mj = _json.load(f)
    assert mj["Manual"] is True
    assert mj["SpatialReference"] == "sub-001/anat/sub-001_T1w.nii.gz"
    # identity tfm + same grid -> registered image equals the raw image
    from vs_seg.data import nifti
    raw = nifti.load(os.path.join(out, "sub-001", "anat",
                                  "sub-001_T1w.nii.gz"))
    reg = nifti.load(os.path.join(
        out, "derivatives", "T1w_registered_to_T2w", "sub-001", "anat",
        "sub-001_space-individual_T1w.nii.gz"))
    np.testing.assert_allclose(np.asarray(reg.data), np.asarray(raw.data),
                               atol=1e-4)
    # mask is non-empty and binary
    mask = nifti.load(os.path.join(
        out, "derivatives", "manual_segmentation_masks_of_T1w", "sub-001",
        "anat", "sub-001_space-individual_desc-tumor_mask.nii.gz"), dtype=None)
    assert set(np.unique(mask.data)) == {0, 1}


def test_restructure_tcia_pairs_rtss_exactly(tmp_path, rng):
    """RTSS-to-series pairing via the nested RT Referenced Study/Series
    sequences, with prefix-adversarial UIDs ('...1.1' vs '...1.10'): each
    series folder must receive exactly its own RTSS."""
    root = tmp_path / "tcia"
    case = root / "VS-SEG-001"
    t1_uid, t2_uid = "1.2.826.0.1.1", "1.2.826.0.1.10"  # prefix pair
    for tag, uid, sub in [("t1", t1_uid, "a"), ("t2", t2_uid, "b")]:
        d = case / sub
        d.mkdir(parents=True)
        for k in range(2):
            write_mr_slice(str(d / f"IMG{k:04d}.dcm"),
                           rng.integers(0, 100, size=(8, 8)).astype(np.int16),
                           ipp=(0, 0, 2.0 * k), iop=(1, 0, 0, 0, 1, 0),
                           spacing=(1.0, 1.0), series_uid=uid,
                           sop_uid=f"{uid}.{k}", desc=f"{tag} image")
        pts = np.array([[0.0, 0.0, 0.0], [2.0, 0.0, 0.0], [2.0, 2.0, 0.0]])
        write_rtstruct(str(d / "RTSS.dcm"), [pts], roi_name=f"vs_{tag}",
                       series_uid=uid)
    out = tmp_path / "out"
    created = convert.restructure_tcia(str(root), str(out),
                                       require_complete=False)
    assert sorted(os.path.basename(c) for c in created) == [
        "vs_gk_1_t1", "vs_gk_1_t2"]
    for tag, uid in [("t1", t1_uid), ("t2", t2_uid)]:
        dest = out / f"vs_gk_1_{tag}"
        assert (dest / "RTSS.dcm").exists(), f"{tag}: RTSS not paired"
        names = sorted(os.listdir(dest))
        assert names == ["IMG0000.dcm", "IMG0001.dcm", "RTSS.dcm"]
        # the copied RTSS must reference THIS series (prefix-safety)
        ds = read_dicom(str(dest / "RTSS.dcm"))
        ref = ds["ReferencedFrameOfReferenceSequence"][0][
            "RTReferencedStudySequence"][0][
            "RTReferencedSeriesSequence"][0]["SeriesInstanceUID"]
        assert ref == uid


def _write_full_rt_case(root, rng, case=1):
    """VS-SEG-<case> download with the complete RT bundle per modality:
    MR series + RTSTRUCT + RTPLAN + RTDOSE, chained by SOP UIDs exactly like
    the reference expects (TCIA_data_convert...py:77-120)."""
    casedir = root / f"VS-SEG-{case:03d}"
    for tag, sub in (("t1", "a"), ("t2", "b")):
        uid = f"1.2.826.{case}.{1 if tag == 't1' else 2}"
        d = casedir / sub
        d.mkdir(parents=True)
        for k in range(2):
            write_mr_slice(str(d / f"1-{k + 1:03d}.dcm"),
                           rng.integers(0, 100, size=(8, 8)).astype(np.int16),
                           ipp=(0, 0, 2.0 * k), iop=(1, 0, 0, 0, 1, 0),
                           spacing=(1.0, 1.0), series_uid=uid,
                           sop_uid=f"{uid}.{k}", desc=f"{tag}_tse")
        pts = np.array([[0.0, 0.0, 0.0], [2.0, 0.0, 0.0], [2.0, 2.0, 0.0]])
        rtdir = casedir / f"rt_{tag}"
        rtdir.mkdir()
        write_rtstruct(str(rtdir / "RTSS.dcm"), [pts], series_uid=uid,
                       sop_uid=f"{uid}.rtss")
        write_rt_linked(str(rtdir / "RTPLAN.dcm"), "RTPLAN",
                        sop_uid=f"{uid}.plan", ref_sop_uid=f"{uid}.rtss")
        write_rt_linked(str(rtdir / "RTDOSE.dcm"), "RTDOSE",
                        sop_uid=f"{uid}.dose", ref_sop_uid=f"{uid}.plan")
    return casedir


def test_restructure_tcia_full_rt_bundle(tmp_path, rng):
    """RTPLAN/RTDOSE chaining + completeness asserts (VERDICT r2 task 3a):
    each vs_gk folder receives IMG* + RTSS + RTPLAN + RTDOSE, each RT file
    chained to ITS modality's bundle."""
    root = tmp_path / "tcia"
    _write_full_rt_case(root, rng, case=1)
    out = tmp_path / "out"
    created = convert.restructure_tcia(str(root), str(out))  # strict default
    assert sorted(os.path.basename(c) for c in created) == [
        "vs_gk_1_t1", "vs_gk_1_t2"]
    for tag in ("t1", "t2"):
        uid = f"1.2.826.1.{1 if tag == 't1' else 2}"
        dest = out / f"vs_gk_1_{tag}"
        names = sorted(os.listdir(dest))
        assert names == ["IMG0000.dcm", "IMG0001.dcm", "RTDOSE.dcm",
                         "RTPLAN.dcm", "RTSS.dcm"]
        plan = read_dicom(str(dest / "RTPLAN.dcm"))
        assert plan["ReferencedStructureSetSequence"][0][
            "ReferencedSOPInstanceUID"] == f"{uid}.rtss"
        dose = read_dicom(str(dest / "RTDOSE.dcm"))
        assert dose["ReferencedRTPlanSequence"][0][
            "ReferencedSOPInstanceUID"] == f"{uid}.plan"


def test_restructure_tcia_incomplete_asserts(tmp_path, rng):
    """The reference asserts completeness (:57,125-126); strict mode must
    fail loudly on a case missing its RTPLAN/RTDOSE."""
    root = tmp_path / "tcia"
    casedir = _write_full_rt_case(root, rng, case=2)
    os.remove(casedir / "rt_t1" / "RTPLAN.dcm")
    with pytest.raises(AssertionError):
        convert.restructure_tcia(str(root), str(tmp_path / "out"))


def test_restructure_tcia_unclassified_series_raises(tmp_path, rng):
    """An MR series whose description names neither t1 nor t2 must raise
    (reference :72) instead of being silently dropped (VERDICT r2 task 3c)."""
    root = tmp_path / "tcia"
    d = root / "VS-SEG-003" / "x"
    d.mkdir(parents=True)
    write_mr_slice(str(d / "IMG0000.dcm"),
                   rng.integers(0, 100, size=(8, 8)).astype(np.int16),
                   ipp=(0, 0, 0), iop=(1, 0, 0, 0, 1, 0), spacing=(1.0, 1.0),
                   series_uid="9.9.9", sop_uid="9.9.9.0", desc="flair axial")
    with pytest.raises(ValueError, match="names neither t1 nor t2"):
        convert.restructure_tcia(str(root), str(tmp_path / "out"),
                                 require_complete=False)
    # warn mode: skipped, not raised
    created = convert.restructure_tcia(str(root), str(tmp_path / "out2"),
                                       require_complete=False,
                                       on_unclassified="warn")
    assert created == []


def test_rasterize_oblique_plane(rng):
    """Contours on a plane tilted 45 deg about the row axis must rasterize
    along the plane (VERDICT r2 task 3b) — the old median-slice fill would
    collapse everything onto one k."""
    affine = np.eye(4)  # voxel == RAS world
    flip3 = np.diag([-1.0, -1.0, 1.0])
    # rectangle in the plane k = c - 8 (normal (0, -1, 1)/sqrt2): corners
    # span rows 2..10, cols 2..13.5, k = col - 8 (the .5 keeps the upper edge
    # off pixel centers — a center exactly on the boundary is excluded by the
    # half-open scanline convention, which is fine but degenerate to test)
    corners_ras = np.array([
        [2.0, 2.0, -6.0], [2.0, 13.5, 5.5], [10.0, 13.5, 5.5],
        [10.0, 2.0, -6.0]])
    contour_lps = (flip3 @ corners_ras.T).T
    seg = convert.rasterize_contours([contour_lps], affine, (16, 16, 16))
    filled = np.argwhere(seg)
    assert len(filled), "oblique contour rasterized nothing"
    # every filled voxel lies on the plane k = col - 8 (within rounding)
    np.testing.assert_array_equal(filled[:, 2], filled[:, 1] - 8)
    # k varies across the fill -> genuinely oblique, not a single slice
    assert len(np.unique(filled[:, 2])) > 5
    # rows span the rectangle interior
    assert filled[:, 0].min() >= 2 and filled[:, 0].max() <= 10


def test_rasterize_axis_aligned_unchanged(rng):
    """The oblique generalization must reduce exactly to the old single-slice
    fill for slice-aligned contours (circle fixture from dicom_case)."""
    affine = np.eye(4)
    theta = np.linspace(0, 2 * np.pi, 33)[:-1]
    circle_ras = np.stack([8 + 3.0 * np.cos(theta), 8 + 3.0 * np.sin(theta),
                           np.full_like(theta, 5.0)], axis=1)
    flip3 = np.diag([-1.0, -1.0, 1.0])
    seg = convert.rasterize_contours([(flip3 @ circle_ras.T).T], affine,
                                     (16, 16, 8))
    k_counts = [int(seg[:, :, k].sum()) for k in range(8)]
    assert k_counts[5] > 20 and sum(k_counts) == k_counts[5]
    assert seg[8, 8, 5] == 1 and seg[8, 12, 5] == 0


def test_preprocessing_cli_convert_no_registration(tmp_path, rng):
    """`python -m vs_seg.preprocessing convert` produces the reference
    output layout (data_conversion.py:486-526, no-registration branch)."""
    from vs_seg.preprocessing.__main__ import main

    cases = tmp_path / "cases"
    _make_case_pair(cases, rng, case=7)
    out = tmp_path / "out"
    assert main(["convert", "-i", str(cases), "-o", str(out)]) == 0
    case_out = out / "vs_gk_7"
    for f in ("vs_gk_t1_refT1.nii.gz", "vs_gk_t2_refT2.nii.gz",
              "vs_gk_seg_refT1.nii.gz", "vs_gk_seg_refT2.nii.gz"):
        assert (case_out / f).exists(), f


def test_preprocessing_cli_convert_registered(tmp_path, rng):
    """--register T2: T1 resampled onto the T2 grid via the case's
    inv_T1_LPS_to_T2_LPS.tfm; the T2 contours rasterized on the T2 grid
    (data_conversion.py:445-526). With the fixture's identity transform
    and identical grids, the resampled T1 equals the native T1."""
    from vs_seg.data import nifti
    from vs_seg.preprocessing.__main__ import main
    from vs_seg.preprocessing.convert import load_series

    cases = tmp_path / "cases"
    _make_case_pair(cases, rng, case=3)
    out = tmp_path / "out"
    assert main(["convert", "-i", str(cases), "-o", str(out),
                 "--register", "T2"]) == 0
    case_out = out / "vs_gk_3"
    names = sorted(p.name for p in case_out.iterdir())
    assert names == ["vs_gk_seg_refT2.nii.gz", "vs_gk_t1_refT2.nii.gz",
                     "vs_gk_t2_refT2.nii.gz"]
    moved = nifti.load(str(case_out / "vs_gk_t1_refT2.nii.gz"))
    native, _ = load_series(sorted(
        str(p) for p in (cases / "vs_gk_3_t1").glob("IMG*.dcm")))
    np.testing.assert_allclose(np.asarray(moved.data).squeeze(),
                               native.squeeze(), atol=1e-3)


def test_preprocessing_cli_bids_and_restructure_smoke(tmp_path, rng):
    from vs_seg.preprocessing.__main__ import main

    cases = tmp_path / "cases"
    _make_case_pair(cases, rng, case=2)
    out = tmp_path / "bids"
    assert main(["bids", "-i", str(cases), "-o", str(out)]) == 0
    assert (out / "dataset_description.json").exists()


def test_preprocessing_cli_restructure(tmp_path, rng):
    """`python -m vs_seg.preprocessing restructure` end to end on a
    full RT bundle download."""
    from vs_seg.preprocessing.__main__ import main

    raw = tmp_path / "raw"
    raw.mkdir()
    _write_full_rt_case(raw, rng, case=4)
    out = tmp_path / "cases"
    assert main(["restructure", "-i", str(raw), "-o", str(out)]) == 0
    for tag in ("t1", "t2"):
        d = out / f"vs_gk_4_{tag}"
        names = sorted(p.name for p in d.iterdir())
        assert "RTSS.dcm" in names and "RTPLAN.dcm" in names
        assert "RTDOSE.dcm" in names
        assert any(n.startswith("IMG") for n in names)
