"""BIDS dataset builder (replaces reference
preprocessing/createBIDSdataset/data_conversion_BIDS.py, which runs inside 3D
Slicer). Produces the same tree as the reference's shipped sample
(VS-SEG-BIDS-nonifti):

  <root>/README, dataset_description.json, participants.tsv
  <root>/sub-NNN/anat/sub-NNN_{T1w,T2w}.nii.gz (+ .json sidecars)
  <root>/sourcedata/contours/sub-NNN/anat/..._contours_space-individual_*.json
  <root>/sourcedata/registration_matrices/sub-NNN/anat/..._inv_*_LPS_to_*.tfm
  <root>/derivatives/manual_segmentation_masks_of_{T1w,T2w}/
        dataset_description.json + sub-NNN/anat/..._desc-tumor_mask.nii.gz
  <root>/derivatives/{T1w_registered_to_T2w,T2w_registered_to_T1w}/
        dataset_description.json + sub-NNN/anat/..._space-individual_*.nii.gz

Note the reference layout has NO ses- level (sample tree + createBIDSPath,
data_conversion_BIDS.py:306-382). Sidecar fields are extracted from DICOM
tags per the reference tag list (:1014-1089); its BIDS-only names that are
not DICOM attributes are skipped there too (pydicom raises, the except
swallows). Registration/resampling uses preprocessing/registration.py in
place of Slicer's BRAINSResample.
"""

from __future__ import annotations

import csv
import glob
import json
import os
import re
import shutil
from typing import Dict, List, Optional, Sequence

import numpy as np

from vs_seg.data import nifti
from vs_seg.preprocessing import convert
from vs_seg.preprocessing.dicom import read_dicom

# (sidecar key, parser attribute name) — the DICOM-attribute subset of the
# reference tag list (data_conversion_BIDS.py:1014-1089), with its renames.
SIDECAR_TAGS = [
    ("Manufacturer", "Manufacturer"),
    ("ManufacturersModelName", "ManufacturerModelName"),
    ("DeviceSerialNumber", "DeviceSerialNumber"),
    ("StationName", "StationName"),
    ("SoftwareVersions", "SoftwareVersions"),
    ("MagneticFieldStrength", "MagneticFieldStrength"),
    ("TransmitCoilName", "TransmitCoilName"),
    ("ReceiveCoilName", "ReceiveCoilName"),
    ("ScanningSequence", "ScanningSequence"),
    ("SequenceVariant", "SequenceVariant"),
    ("ScanOptions", "ScanOptions"),
    ("SequenceName", "SequenceName"),
    ("MRAcquisitionType", "MRAcquisitionType"),
    ("ParallelReductionFactorInPlane", "ParallelReductionFactorInPlane"),
    ("ParallelAcquisitionTechnique", "ParallelAcquisitionTechnique"),
    ("PartialFourier", "PartialFourier"),
    ("PartialFourierDirection", "PartialFourierDirection"),
    ("EchoTime", "EchoTime"),
    ("InversionTime", "InversionTime"),
    ("FlipAngle", "FlipAngle"),
    ("InstitutionName", "InstitutionName"),
    ("InstitutionAddress", "InstitutionAddress"),
    ("InstitutionalDepartmentName", "InstitutionalDepartmentName"),
    ("ContrastBolusIngredient", "ContrastBolusIngredient"),
    ("RepetitionTime", "RepetitionTime"),
    ("Modality", "Modality"),
    ("ImagingFrequency", "ImagingFrequency"),
    ("PatientPosition", "PatientPosition"),
    ("ProcedureStepDescription", "PerformedProcedureStepDescription"),
    ("SeriesDescription", "SeriesDescription"),
    ("ProtocolName", "ProtocolName"),
    ("ImageType", "ImageType"),
    ("SeriesNumber", "SeriesNumber"),
    ("AcquisitionTime", "AcquisitionTime"),
    ("AcquisitionNumber", "AcquisitionNumber"),
    ("SliceThickness", "SliceThickness"),
    ("SAR", "SAR"),
    ("PercentPhaseFOV", "PercentPhaseFieldOfView"),
    ("PercentSampling", "PercentSampling"),
    ("PhaseEncodingSteps", "NumberOfPhaseEncodingSteps"),
    ("PixelBandwidth", "PixelBandwidth"),
    ("InPlanePhaseEncodingDirectionDICOM", "InPlanePhaseEncodingDirection"),
]


def create_sidecar_dict(ds) -> Dict[str, str]:
    """Reference create_sidecar_dict semantics (data_conversion_BIDS.py:
    385-410): values stringified, multi-values joined with backslash, missing
    tags skipped, EchoTime converted ms -> s."""
    out: Dict[str, str] = {}
    for key, attr in SIDECAR_TAGS:
        if attr not in ds:
            continue
        v = ds[attr]
        if isinstance(v, (list, tuple)):
            out[key] = "\\".join(str(x) for x in v)
        else:
            out[key] = str(v)
        if key == "EchoTime":
            out[key] = str(float(out[key]) / 1000)
    return out


def bids_path(root: str, case: int, folder_id: str) -> str:
    """createBIDSPath equivalent (reference data_conversion_BIDS.py:306-382):
    maps a folderID to its path and creates the containing directories."""
    sub = f"sub-{int(case):03d}"
    d = {
        "raw": root,
        "raw_README": os.path.join(root, "README"),
        "raw_description_json": os.path.join(root, "dataset_description.json"),
        "participants_tsv": os.path.join(root, "participants.tsv"),
        "raw_sub_anat_T1w_nii": os.path.join(root, sub, "anat", f"{sub}_T1w.nii.gz"),
        "raw_sub_anat_T2w_nii": os.path.join(root, sub, "anat", f"{sub}_T2w.nii.gz"),
        "raw_sub_anat_T1w_json": os.path.join(root, sub, "anat", f"{sub}_T1w.json"),
        "raw_sub_anat_T2w_json": os.path.join(root, sub, "anat", f"{sub}_T2w.json"),
        "source": os.path.join(root, "sourcedata"),
        "source_contours_T1w_json": os.path.join(
            root, "sourcedata", "contours", sub, "anat",
            f"{sub}_contours_space-individual_T1w.json"),
        "source_contours_T2w_json": os.path.join(
            root, "sourcedata", "contours", sub, "anat",
            f"{sub}_contours_space-individual_T2w.json"),
        "source_regmat_T1wtoT2w_tfm": os.path.join(
            root, "sourcedata", "registration_matrices", sub, "anat",
            f"{sub}_inv_T1_LPS_to_T2_LPS.tfm"),
        "source_regmat_T2wtoT1w_tfm": os.path.join(
            root, "sourcedata", "registration_matrices", sub, "anat",
            f"{sub}_inv_T2_LPS_to_T1_LPS.tfm"),
        "derivatives": os.path.join(root, "derivatives"),
    }
    for mod, other in (("T1w", "T2w"), ("T2w", "T1w")):
        reg = f"{mod}_registered_to_{other}"
        masks = f"manual_segmentation_masks_of_{mod}"
        d[f"derivatives_{mod}Regto{other}_description_json"] = os.path.join(
            root, "derivatives", reg, "dataset_description.json")
        d[f"derivatives_{mod}Regto{other}_nii"] = os.path.join(
            root, "derivatives", reg, sub, "anat",
            f"{sub}_space-individual_{mod}.nii.gz")
        d[f"derivatives_{mod}Regto{other}_json"] = os.path.join(
            root, "derivatives", reg, sub, "anat",
            f"{sub}_space-individual_{mod}.json")
        d[f"derivatives_masks_{mod}_description_json"] = os.path.join(
            root, "derivatives", masks, "dataset_description.json")
        d[f"derivatives_masks_{mod}_nii"] = os.path.join(
            root, "derivatives", masks, sub, "anat",
            f"{sub}_space-individual_desc-tumor_mask.nii.gz")
        d[f"derivatives_masks_{mod}_json"] = os.path.join(
            root, "derivatives", masks, sub, "anat",
            f"{sub}_space-individual_desc-tumor_mask.json")
    if folder_id not in d:
        raise ValueError(f"folderID {folder_id} does not exist")
    path = d[folder_id]
    if any(path.endswith(ext) for ext in
           (".nii.gz", ".json", ".tfm", "README", ".tsv")):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    else:
        os.makedirs(path, exist_ok=True)
    return path


_DATASET_NAME = ("Segmentation of Vestibular Schwannoma from Magnetic "
                 "Resonance Imaging: An Open Annotated Dataset and Baseline "
                 "Algorithm (Vestibular-Schwannoma-SEG)")


def write_dataset_descriptions(root: str) -> None:
    """Root + four derivative dataset_description.json files, with the
    reference's structure (data_conversion_BIDS.py:770-930)."""
    with open(bids_path(root, -1, "raw_description_json"), "w") as f:
        json.dump({
            "Name": _DATASET_NAME,
            "BIDSVersion": "1.6.0",
            "DatasetType": "raw",
            "License": "TCIA Data Usage Policy and the Creative Commons "
                       "Attribution 4.0 International License",
            "ReferencesAndLinks": [
                "https://doi.org/10.7937/TCIA.9YTJ-5Q73",
                "https://doi.org/10.3171/2019.9.jns191949",
                "https://doi.org/10.1007/s10278-013-9622-7"],
            "DatasetDOI": "https://doi.org/10.7937/TCIA.9YTJ-5Q73",
        }, f, indent=4)
    for mod, other in (("T1w", "T2w"), ("T2w", "T1w")):
        with open(bids_path(root, -1,
                            f"derivatives_masks_{mod}_description_json"),
                  "w") as f:
            json.dump({
                "Name": f"manual_segmentation_masks_of_{mod}",
                "BIDSVersion": "1.6.0",
                "DatasetType": "derivative",
                "GeneratedBy": [
                    {"Name": "Manual",
                     "Description": "Manual segmentation of the Vestibular "
                                    "Schwannoma based on T1w and T2w image."},
                    {"Name": "vs_seg.preprocessing.bids",
                     "Description": f"Conversion from contour points in the "
                                    f"space of the {mod} image to nifti."}],
                "SourceDatasets": [{"URL": "file://../.."}],
            }, f, indent=4)
        with open(bids_path(root, -1,
                            f"derivatives_{mod}Regto{other}_description_json"),
                  "w") as f:
            json.dump({
                "Name": f"{mod}_registered_to_{other}",
                "BIDSVersion": "1.6.0",
                "DatasetType": "derivative",
                "GeneratedBy": [
                    {"Name": "vs_seg.preprocessing.bids",
                     "Description": f"{mod} images co-registered to their "
                                    f"corresponding {other} images and "
                                    f"resampled at the {other} grid points."}],
                "SourceDatasets": [{"URL": "file://../.."}],
            }, f, indent=4)


def write_readme(root: str) -> None:
    with open(bids_path(root, -1, "raw_README"), "w") as f:
        f.write(
            f"# {_DATASET_NAME}\n\n"
            "Contrast-enhanced T1-weighted and high-resolution T2-weighted "
            "MRI of patients with vestibular schwannoma undergoing Gamma "
            "Knife stereotactic radiosurgery, with manual tumour "
            "segmentations.\n\n"
            "Registration matrices: sourcedata/registration_matrices/ holds "
            "per-subject ITK .tfm affine transforms "
            "(sub-<case>_inv_T1_LPS_to_T2_LPS.tfm and inverse) that "
            "co-register the T1 image to the T2 image and vice versa.\n\n"
            "Contours: sourcedata/contours/ holds per-subject JSON files "
            "with the manually segmented structure contour points, mapped to "
            "the coordinate frames of the T1 and T2 images respectively. "
            "The derivative masks were rasterized from these contours onto "
            "each image grid.\n")


def _structures_from_contours_json(path: str) -> List[Dict]:
    """Reference contours.json layout (data_conversion.py:242-276): a list of
    {structure_name, LPS_contour_points: [[x,y,z,...], ...]} dicts. Falls back
    to the generic point-list walker for unstructured files."""
    with open(path) as f:
        payload = json.load(f)
    if isinstance(payload, list) and payload and isinstance(payload[0], dict) \
            and "LPS_contour_points" in payload[0]:
        out = []
        for struc in payload:
            regions = [np.asarray(r, dtype=np.float64).reshape(-1, 3)
                       for r in struc["LPS_contour_points"]]
            out.append({"structure_name": struc.get("structure_name", "tumour"),
                        "contours": regions})
        return out
    return [{"structure_name": "tumour",
             "contours": convert.load_contours_json(path)}]


def _case_contours(case_dir: str) -> Optional[List[np.ndarray]]:
    """Tumour contours (LPS) for a case folder: contours.json preferred
    (first structure = tumour, reference export_only_tumour_seg), RTSS.dcm
    fallback."""
    cj = os.path.join(case_dir, "contours.json")
    if os.path.exists(cj):
        structures = _structures_from_contours_json(cj)
        return structures[0]["contours"] if structures else None
    rtss = os.path.join(case_dir, "RTSS.dcm")
    if os.path.exists(rtss):
        return convert.extract_rtstruct_contours(read_dicom(rtss))
    return None


def build_bids_dataset(input_root, out_root: str,
                       dataset: Optional[str] = None) -> List[str]:
    """Build the full BIDS tree from vs_gk_<n>_{t1,t2} case folders
    (reference data_conversion_BIDS.py main, :413-1170). `input_root` may
    also be an explicit list of case folders. Returns written raw images."""
    if isinstance(input_root, (list, tuple)):
        patient_dirs = [str(p) for p in input_root]
    else:
        patient_dirs = sorted(glob.glob(os.path.join(input_root, "vs_gk_*")))
    pattern = re.compile(r"_([0-9]+)_t[1-2]$")
    cases: Dict[int, Dict[str, str]] = {}
    for p in patient_dirs:
        m = pattern.search(os.path.basename(p.rstrip("/")))
        if not m:
            continue
        case = int(m.group(1))
        tag = os.path.basename(p.rstrip("/"))[-2:]  # t1 | t2
        cases.setdefault(case, {})[tag] = p

    write_readme(out_root)
    write_dataset_descriptions(out_root)

    written: List[str] = []
    participants = []
    for case in sorted(cases):
        imgs: Dict[str, nifti.NiftiImage] = {}
        metas: Dict[str, dict] = {}
        for tag in ("t1", "t2"):
            case_dir = cases[case].get(tag)
            if case_dir is None:
                continue
            mod = "T1w" if tag == "t1" else "T2w"
            img_files = sorted(
                os.path.join(case_dir, f) for f in os.listdir(case_dir)
                if f.startswith("IMG") and f.endswith(".dcm"))
            if not img_files:
                continue
            volume, affine = convert.load_series(img_files)
            img = nifti.NiftiImage(volume.astype(np.float32), affine)
            imgs[tag] = img
            metas[tag] = read_dicom(img_files[0], headers_only=True)
            raw_nii = bids_path(out_root, case, f"raw_sub_anat_{mod}_nii")
            nifti.save(img, raw_nii)
            written.append(raw_nii)
            with open(bids_path(out_root, case, f"raw_sub_anat_{mod}_json"),
                      "w") as f:
                json.dump(create_sidecar_dict(metas[tag]), f, indent=4)

            # sourcedata copies (contours + registration matrices)
            cj = os.path.join(case_dir, "contours.json")
            if os.path.exists(cj):
                shutil.copy(cj, bids_path(
                    out_root, case, f"source_contours_{mod}_json"))
            tfm_name = ("inv_T1_LPS_to_T2_LPS.tfm" if tag == "t1"
                        else "inv_T2_LPS_to_T1_LPS.tfm")
            tfm = os.path.join(case_dir, tfm_name)
            if os.path.exists(tfm):
                shutil.copy(tfm, bids_path(
                    out_root, case,
                    f"source_regmat_{mod}to{'T2w' if tag == 't1' else 'T1w'}_tfm"))

            # tumour mask on this image's grid
            contours = _case_contours(case_dir)
            if contours:
                seg = convert.rasterize_contours(contours, affine, volume.shape)
                mask_nii = bids_path(out_root, case,
                                     f"derivatives_masks_{mod}_nii")
                nifti.save(nifti.NiftiImage(seg, affine), mask_nii)
                with open(bids_path(out_root, case,
                                    f"derivatives_masks_{mod}_json"),
                          "w") as f:
                    json.dump({
                        "Description": "Manually created mask of the "
                                       "Vestibular Schwannoma based on both "
                                       "T1w and T2w image. The binary mask "
                                       "was derived from contour points.",
                        "Manual": True,
                        "Sources": os.path.relpath(bids_path(
                            out_root, case, f"source_contours_{mod}_json"),
                            out_root),
                        "RawSources": [os.path.relpath(bids_path(
                            out_root, case, f"raw_sub_anat_{m}_nii"),
                            out_root) for m in ("T1w", "T2w")],
                        "SpatialReference": os.path.relpath(bids_path(
                            out_root, case, f"raw_sub_anat_{mod}_nii"),
                            out_root),
                    }, f, indent=4)

        # registered-space derivatives: resample each modality onto the
        # other's grid via the ITK .tfm (reference register_and_resample)
        for tag, other in (("t1", "t2"), ("t2", "t1")):
            if tag not in imgs or other not in imgs:
                continue
            mod = "T1w" if tag == "t1" else "T2w"
            omod = "T2w" if tag == "t1" else "T1w"
            tfm_path = bids_path(out_root, case,
                                 f"source_regmat_{mod}to{omod}_tfm")
            from vs_seg.preprocessing.registration import (
                read_itk_tfm, resample_to_reference)
            tfm_lps = (read_itk_tfm(tfm_path)
                       if os.path.exists(tfm_path) else None)
            reg = resample_to_reference(imgs[tag], imgs[other],
                                        tfm_lps=tfm_lps, order=1)
            reg_nii = bids_path(out_root, case,
                                f"derivatives_{mod}Regto{omod}_nii")
            nifti.save(reg, reg_nii)
            with open(bids_path(out_root, case,
                                f"derivatives_{mod}Regto{omod}_json"),
                      "w") as f:
                json.dump({
                    "Description": f"{mod} image after affine transformation "
                                   f"to the space of the corresponding "
                                   f"{omod} image.",
                    "Sources": os.path.relpath(tfm_path, out_root),
                    "RawSources": [os.path.relpath(bids_path(
                        out_root, case, f"raw_sub_anat_{m}_nii"), out_root)
                        for m in ("T1w", "T2w")],
                    "SpatialReference": os.path.relpath(bids_path(
                        out_root, case, f"raw_sub_anat_{omod}_nii"),
                        out_root),
                }, f, indent=4)

        meta = metas.get("t1") or metas.get("t2") or {}
        age = str(meta.get("PatientAge", "n/a"))
        m_age = re.match(r"0*(\d+)Y?", age)
        participants.append((case, m_age.group(1) if m_age else "n/a",
                             str(meta.get("PatientSex", "n/a")) or "n/a"))

    with open(bids_path(out_root, -1, "participants_tsv"), "w",
              newline="") as f:
        w = csv.writer(f, delimiter="\t")
        w.writerow(["participant", "age", "sex"])  # reference header, :524
        w.writerows(participants)
    return written
