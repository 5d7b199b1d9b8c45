"""DICOM -> NIFTI conversion toolchain (no 3D Slicer, no pydicom).

Replaces the reference offline preprocessing (SURVEY.md §3.5):
  - series assembly + LPS->RAS affine (reference data_conversion.py
    import_T1_and_T2_data:101-184 via Slicer DICOM import)
  - planar-contour rasterization to labelmaps (reference
    data_conversion.py:242-344 via SlicerRT; here: scanline polygon fill on
    the acquisition grid)
  - TCIA folder restructure (reference
    TCIA_data_convert_into_convenient_folder_structure.py)
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from vs_seg.data import nifti
from vs_seg.preprocessing.dicom import DicomDataset, pixel_array, read_dicom


def load_series(paths: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """Assemble image slices into a volume + RAS affine.

    Returns (volume (rows, cols, slices) float32, affine 4x4 RAS).
    Slices sorted by projection of ImagePositionPatient onto the slice normal.
    """
    slices = []
    for p in paths:
        ds = read_dicom(p)
        if "PixelData" not in ds:
            continue
        slices.append(ds)
    if not slices:
        raise ValueError("no image slices found")
    iop = np.asarray(slices[0]["ImageOrientationPatient"], dtype=np.float64)
    row_dir, col_dir = iop[:3], iop[3:]          # X: along columns; Y: along rows
    normal = np.cross(row_dir, col_dir)
    slices.sort(key=lambda ds: float(
        np.dot(np.asarray(ds["ImagePositionPatient"]), normal)))

    vols = []
    for ds in slices:
        arr = pixel_array(ds).astype(np.float32)
        slope = float(ds.get("RescaleSlope", 1.0) or 1.0)
        inter = float(ds.get("RescaleIntercept", 0.0) or 0.0)
        vols.append(arr * slope + inter)
    volume = np.stack(vols, axis=-1)  # (rows, cols, slices)

    ipp0 = np.asarray(slices[0]["ImagePositionPatient"], dtype=np.float64)
    spacing = np.asarray(slices[0]["PixelSpacing"], dtype=np.float64)  # (row, col)
    if len(slices) > 1:
        step = (np.asarray(slices[1]["ImagePositionPatient"]) - ipp0)
    else:
        step = normal * float(slices[0].get("SliceThickness", 1.0) or 1.0)

    # LPS affine: world = IPP + col_dir*rowspacing*r + row_dir*colspacing*c + step*k
    affine_lps = np.eye(4)
    affine_lps[:3, 0] = col_dir * spacing[0]
    affine_lps[:3, 1] = row_dir * spacing[1]
    affine_lps[:3, 2] = step
    affine_lps[:3, 3] = ipp0
    # LPS -> RAS: negate x and y world axes
    flip = np.diag([-1.0, -1.0, 1.0, 1.0])
    return volume, flip @ affine_lps


def _polygon_cells(r: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Scanline fill of a closed polygon in float (row, col) coords: returns
    the (M, 2) integer (row, col) cells whose centers are inside (even-odd
    rule — crossings paired, so nested rings XOR into holes downstream)."""
    n = len(r)
    cells = []
    for row in range(int(np.floor(r.min())), int(np.ceil(r.max())) + 1):
        xs = []
        y = row
        for i in range(n):
            y1, x1 = r[i], c[i]
            y2, x2 = r[(i + 1) % n], c[(i + 1) % n]
            if (y1 <= y < y2) or (y2 <= y < y1):
                t = (y - y1) / (y2 - y1)
                xs.append(x1 + t * (x2 - x1))
        xs.sort()
        for k in range(0, len(xs) - 1, 2):
            lo = int(np.ceil(xs[k] - 0.5))
            hi = int(np.floor(xs[k + 1] - 0.5))
            for col in range(lo, hi + 1):
                cells.append((row, col))
    return np.asarray(cells, dtype=np.int64).reshape(-1, 2)


def rasterize_contours(contours_lps: List[np.ndarray], affine_ras: np.ndarray,
                       shape: Tuple[int, int, int]) -> np.ndarray:
    """Rasterize planar contours (world LPS points, (N,3) each) to a labelmap
    on the image grid defined by the RAS affine + shape.

    Handles OBLIQUE contour planes (gantry-tilted acquisitions, or contours
    co-registered from another image's slices — reference
    data_conversion.py:242-344 gets this from SlicerRT): each contour's plane
    is fit to its points in voxel space; the polygon is filled in the two
    axes orthogonal to the plane's dominant axis, and each filled cell's
    coordinate along the dominant axis comes from the plane equation. For
    slice-aligned contours this reduces exactly to a single-slice fill.
    XOR accumulation keeps even-odd semantics for nested contours (holes).
    """
    inv = np.linalg.inv(affine_ras)
    flip = np.diag([-1.0, -1.0, 1.0, 1.0])
    labelmap = np.zeros(shape, dtype=bool)
    for pts in contours_lps:
        pts = np.asarray(pts, dtype=np.float64).reshape(-1, 3)
        if len(pts) < 3:
            continue
        ras = (flip[:3, :3] @ pts.T).T  # LPS -> RAS world
        hom = np.concatenate([ras, np.ones((len(ras), 1))], axis=1)
        vox = (inv @ hom.T).T[:, :3]
        # best-fit plane in voxel space: normal = least-variance direction
        ctr = vox.mean(axis=0)
        _, _, vt = np.linalg.svd(vox - ctr, full_matrices=False)
        normal = vt[-1]
        a = int(np.argmax(np.abs(normal)))
        if abs(normal[a]) < 1e-12:
            continue  # degenerate (collinear) contour
        p, q = [ax for ax in range(3) if ax != a]
        cells = _polygon_cells(vox[:, p], vox[:, q])
        if not len(cells):
            continue
        # dominant-axis coordinate of each cell from n . (x - ctr) = 0
        pa = ctr[a] - (normal[p] * (cells[:, 0] - ctr[p])
                       + normal[q] * (cells[:, 1] - ctr[q])) / normal[a]
        ka = np.round(pa).astype(np.int64)
        ok = ((ka >= 0) & (ka < shape[a])
              & (cells[:, 0] >= 0) & (cells[:, 0] < shape[p])
              & (cells[:, 1] >= 0) & (cells[:, 1] < shape[q]))
        idx: list = [None, None, None]
        idx[a], idx[p], idx[q] = ka[ok], cells[ok, 0], cells[ok, 1]
        labelmap[tuple(idx)] ^= True
    return labelmap.astype(np.uint8)


def extract_rtstruct_contours(ds: DicomDataset,
                              roi_name_pattern: str = r".*"
                              ) -> List[np.ndarray]:
    """All ContourData point lists (LPS mm) for ROIs matching the pattern."""
    roi_names = {}
    for item in ds.get("StructureSetROISequence", []):
        roi_names[str(item.get("ROINumber"))] = item.get("ROIName", "")
    contours = []
    pattern = re.compile(roi_name_pattern, re.IGNORECASE)
    for roi in ds.get("ROIContourSequence", []):
        number = str(roi.get("ReferencedROINumber"))
        if not pattern.match(str(roi_names.get(number, ""))):
            continue
        for c in roi.get("ContourSequence", []):
            data = c.get("ContourData")
            if data is None:
                continue
            contours.append(np.asarray(data, dtype=np.float64).reshape(-1, 3))
    return contours


def load_contours_json(path: str) -> List[np.ndarray]:
    """contours.json (reference data_conversion.py:217-240): LPS point lists."""
    with open(path) as f:
        payload = json.load(f)
    out = []

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            if node and isinstance(node[0], (int, float)) and len(node) % 3 == 0:
                out.append(np.asarray(node, dtype=np.float64).reshape(-1, 3))
            else:
                for v in node:
                    walk(v)

    walk(payload)
    return out


def _natkey(s: str):
    """natsort-equivalent key (reference uses natsorted for file order)."""
    return [int(t) if t.isdigit() else t.lower()
            for t in re.split(r"(\d+)", os.path.basename(s))]


def _rtss_referenced_series_uid(ds: DicomDataset) -> Optional[str]:
    """RTSTRUCT -> image series chain, exactly the reference path
    (TCIA_data_convert...py:77): ReferencedFrameOfReferenceSequence[0]
    .RTReferencedStudySequence[0].RTReferencedSeriesSequence[0]
    .SeriesInstanceUID."""
    try:
        return str(ds["ReferencedFrameOfReferenceSequence"][0]
                   ["RTReferencedStudySequence"][0]
                   ["RTReferencedSeriesSequence"][0]["SeriesInstanceUID"])
    except (KeyError, IndexError, TypeError):
        return None


def _first_ref_sop(ds: DicomDataset, seq_name: str) -> Optional[str]:
    try:
        return str(ds[seq_name][0]["ReferencedSOPInstanceUID"])
    except (KeyError, IndexError, TypeError):
        return None


def restructure_tcia(input_root: str, output_root: str, *,
                     require_complete: bool = True,
                     on_unclassified: str = "raise") -> List[str]:
    """Reorganize TCIA VS-SEG-* downloads into vs_gk_<n>_{t1,t2}/ folders
    (reference TCIA_data_convert_into_convenient_folder_structure.py).

    Per case: classify series by Modality (MR / RTSTRUCT / RTPLAN / RTDOSE),
    route MR series to t1/t2 by SeriesDescription, then chain the RT bundle
    exactly as the reference does (:77-120): RTSTRUCT by its nested referenced
    SeriesInstanceUID, RTPLAN by ReferencedStructureSetSequence SOP UID,
    RTDOSE by ReferencedRTPlanSequence SOP UID. Copies IMG*.dcm + RTSS.dcm
    [+ RTPLAN.dcm + RTDOSE.dcm].

    require_complete: enforce the reference's completeness asserts (equal
    modality counts, every bundle slot found, :57,125-126). With False,
    partially-downloaded cases copy whatever chains successfully.
    on_unclassified: "raise" (reference :72 raises on an MR series whose
    description names neither t1 nor t2) | "warn" | "skip".
    """
    import logging
    logger = logging.getLogger(__name__)
    created = []
    case_dirs = sorted(
        (d for d in os.listdir(input_root) if d.startswith("VS-SEG-")),
        key=lambda s: int(re.sub(r"\D", "", s) or 0))
    for case_dir in case_dirs:
        case_num = int(re.sub(r"\D", "", case_dir))
        series: Dict[str, dict] = {}
        rt: Dict[str, list] = {"RTSTRUCT": [], "RTPLAN": [], "RTDOSE": []}
        for dirpath, _, files in os.walk(os.path.join(input_root, case_dir)):
            for fname in sorted(files, key=_natkey):
                if not fname.lower().endswith(".dcm"):
                    continue
                path = os.path.join(dirpath, fname)
                try:
                    ds = read_dicom(path, headers_only=True)
                except Exception:
                    continue
                modality = str(ds.get("Modality", ""))
                if modality == "MR":
                    uid = str(ds.get("SeriesInstanceUID"))
                    series.setdefault(uid, {"files": [], "desc": str(
                        ds.get("SeriesDescription", "")).lower(), "ds": ds})
                    series[uid]["files"].append(path)
                elif modality in rt:
                    rt[modality].append((path, ds))
        if require_complete:
            counts = {"MR": len(series), **{k: len(v) for k, v in rt.items()}}
            assert len(set(counts.values())) == 1, (
                f"{case_dir}: did not find all required files "
                f"(series/RT counts {counts})")

        by_tag: Dict[str, dict] = {}
        for uid, info in series.items():
            if "t1" in info["desc"]:
                tag = "t1"
            elif "t2" in info["desc"]:
                tag = "t2"
            else:
                msg = (f"{case_dir}: MR series {uid} description "
                       f"{info['desc']!r} names neither t1 nor t2")
                if on_unclassified == "raise":
                    raise ValueError(msg)
                if on_unclassified == "warn":
                    logger.warning(msg)
                continue
            assert tag not in by_tag, (
                f"{case_dir}: multiple MR series classified as {tag}")
            by_tag[tag] = dict(info, uid=uid)

        for tag, info in sorted(by_tag.items()):
            dest = os.path.join(output_root, f"vs_gk_{case_num}_{tag}")
            os.makedirs(dest, exist_ok=True)
            for i, f in enumerate(sorted(info["files"], key=_natkey)):
                shutil.copy(f, os.path.join(dest, f"IMG{i:04d}.dcm"))

            # chain the RT bundle: series <- RTSS <- RTPLAN <- RTDOSE
            rtss_sop = plan_sop = None
            for path, ds in rt["RTSTRUCT"]:
                ref = _rtss_referenced_series_uid(ds)
                # fallback: exact-match against the SET of UIDs referenced
                # anywhere in the RTSS (substring matching on a serialized
                # dump was prefix-unsafe: '...1.1' matches '...1.10')
                if (ref == info["uid"] if ref is not None
                        else info["uid"] in _collect_uids(ds)):
                    shutil.copy(path, os.path.join(dest, "RTSS.dcm"))
                    rtss_sop = str(ds.get("SOPInstanceUID", ""))
            for path, ds in rt["RTPLAN"]:
                if rtss_sop and _first_ref_sop(
                        ds, "ReferencedStructureSetSequence") == rtss_sop:
                    shutil.copy(path, os.path.join(dest, "RTPLAN.dcm"))
                    plan_sop = str(ds.get("SOPInstanceUID", ""))
            for path, ds in rt["RTDOSE"]:
                if plan_sop and _first_ref_sop(
                        ds, "ReferencedRTPlanSequence") == plan_sop:
                    shutil.copy(path, os.path.join(dest, "RTDOSE.dcm"))
            if require_complete:
                missing = [n for n in ("RTSS.dcm", "RTPLAN.dcm", "RTDOSE.dcm")
                           if not os.path.exists(os.path.join(dest, n))]
                assert not missing, (
                    f"{case_dir} {tag}: not all required files found "
                    f"(missing {missing})")
            created.append(dest)
        if require_complete:
            assert sorted(by_tag) == ["t1", "t2"], (
                f"{case_dir}: expected one t1 and one t2 series, got "
                f"{sorted(by_tag)}")
    return created


def _collect_uids(node) -> set:
    uids = set()
    if isinstance(node, dict):
        for k, v in node.items():
            if k.endswith("UID") and isinstance(v, str):
                uids.add(v)
            else:
                uids |= _collect_uids(v)
    elif isinstance(node, list):
        for v in node:
            uids |= _collect_uids(v)
    return uids


def convert_case(case_dir: str, output_dir: str, dataset: str = "T1",
                 roi_pattern: str = r".*(vs|tv|tumor|schwannoma).*") -> Dict[str, str]:
    """DICOM case folder (IMG*.dcm + RTSS.dcm) -> reference NIFTI layout:
    vs_gk_<tag>_ref<DS>.nii.gz + vs_gk_seg_ref<DS>.nii.gz."""
    tag = dataset.lower()
    img_files = sorted(
        os.path.join(case_dir, f) for f in os.listdir(case_dir)
        if f.startswith("IMG") and f.endswith(".dcm"))
    volume, affine = load_series(img_files)
    os.makedirs(output_dir, exist_ok=True)
    out = {}
    img_path = os.path.join(output_dir, f"vs_gk_{tag}_ref{dataset}.nii.gz")
    nifti.save(nifti.NiftiImage(volume.astype(np.float32), affine), img_path)
    out["image"] = img_path

    rtss_path = os.path.join(case_dir, "RTSS.dcm")
    contours_json = os.path.join(case_dir, "contours.json")
    contours = None
    if os.path.exists(rtss_path):
        contours = extract_rtstruct_contours(read_dicom(rtss_path), roi_pattern)
    elif os.path.exists(contours_json):
        contours = load_contours_json(contours_json)
    if contours:
        seg = rasterize_contours(contours, affine, volume.shape)
        seg_path = os.path.join(output_dir, f"vs_gk_seg_ref{dataset}.nii.gz")
        nifti.save(nifti.NiftiImage(seg, affine), seg_path)
        out["label"] = seg_path
    return out
