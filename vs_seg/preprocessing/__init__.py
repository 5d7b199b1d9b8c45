from vs_seg.preprocessing.dicom import read_dicom, pixel_array
from vs_seg.preprocessing.convert import (
    load_series, rasterize_contours, extract_rtstruct_contours,
    restructure_tcia, convert_case, load_contours_json,
)
from vs_seg.preprocessing.registration import read_itk_tfm, resample_to_reference
from vs_seg.preprocessing.bids import build_bids_dataset, bids_path
