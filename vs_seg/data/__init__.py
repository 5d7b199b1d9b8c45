"""Data layer: NIFTI IO, MONAI-0.4-semantics transforms, cached loaders, and
the HBM-resident device pipeline (reference L5, SURVEY.md §1)."""

from vs_seg.data import nifti  # noqa: F401
from vs_seg.data.dataset import (CacheDataset, DataLoader,  # noqa: F401
                                 load_split_csv)
from vs_seg.data.transforms import Compose, get_transforms  # noqa: F401
