"""Configuration for training / inference.

Mirrors every hyperparameter and CLI flag of the reference `VSparams`
(reference: params/VSparams.py:38-112) as a structured dataclass, plus
knobs (mesh shape, dtypes, sliding-window batch size) that have no reference
counterpart.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from time import strftime
from typing import Optional, Sequence, Tuple


Shape3 = Tuple[int, int, int]


@dataclasses.dataclass
class Config:
    # --- CLI-exposed flags (reference params/VSparams.py:39-66) ---
    debug: bool = False
    split_csv: str = "./params/split_TCIA.csv"
    dataset: str = "T1"  # "T1" or "T2"
    train_batch_size: int = 1
    initial_learning_rate: float = 1e-4
    attention: bool = True
    hardness: bool = True
    results_folder_name: str = ""

    # --- hardcoded reference hyperparameters (params/VSparams.py:70-112) ---
    data_root: str = "./data/VS_defaced/"
    pad_crop_shape: Shape3 = (384, 384, 64)
    pad_crop_shape_test: Shape3 = (384, 384, 64)
    num_workers: int = 4
    epochs_with_const_lr: int = 100
    lr_divisor: float = 2.0
    weight_decay: float = 1e-7
    num_epochs: int = 300
    val_interval: int = 2
    model: str = "UNet2d5_spvPA"
    sliding_window_inferer_roi_size: Shape3 = (384, 384, 64)
    export_inferred_segmentations: bool = True

    # --- model architecture (reference params/VSparams.py:343-374) ---
    in_channels: int = 1
    out_channels: int = 2
    channels: Sequence[int] = (16, 32, 48, 64, 80, 96)
    strides: Sequence[Shape3] = ((2, 2, 1), (2, 2, 1), (2, 2, 2), (2, 2, 2), (2, 2, 2))
    kernel_sizes: Sequence[Shape3] = (
        (3, 3, 1), (3, 3, 1), (3, 3, 3), (3, 3, 3), (3, 3, 3), (3, 3, 3))
    sample_kernel_sizes: Sequence[Shape3] = (
        (3, 3, 1), (3, 3, 1), (3, 3, 3), (3, 3, 3), (3, 3, 3))
    num_res_units: int = 2
    dropout: float = 0.1

    # --- knobs with no reference counterpart ---
    seed: int = 0
    compute_dtype: str = "bfloat16"   # conv compute dtype; params stay float32
    infer_dtype: str = "bfloat16"     # sliding-window predictor dtype
    sw_batch_size: int = 8            # windows batched per device (ref: 1, serial)
    sw_overlap: float = 0.25          # MONAI 0.4 default overlap
    # Round padded whole-volume shapes up to multiples of this (H, W, D) so a
    # heterogeneous test set (reference protocol: whole volumes, no crop —
    # params/VSparams.py:552-574) compiles O(1) programs instead of one per
    # distinct shape. None disables bucketing.
    sw_bucket: Optional[Shape3] = (64, 64, 16)
    mesh_shape: Optional[Tuple[int, ...]] = None  # None -> (num_devices,)
    mesh_axes: Tuple[str, ...] = ("data",)
    prefetch_depth: int = 2
    remat: bool = False  # backward rematerialization; needed only for local batch > 2
    resume: bool = False
    sharded_inference: bool = False  # windows data-parallel across the mesh
    spatial_inference: bool = False  # ONE window's H sharded across the mesh
    device_cache: bool = False  # keep training set in HBM, augment on device
    profile_steps: int = 0  # capture a jax.profiler trace of N steady steps
    quantize_transfer: bool = False  # uint8 volume staging (2x less H2D)

    # --- derived paths (reference params/VSparams.py:104-109) ---
    @property
    def results_folder_path(self) -> str:
        name = "debug" if self.debug else (self.results_folder_name or "temp")
        return os.path.join(self.data_root, "results", name)

    @property
    def logs_path(self) -> str:
        return os.path.join(self.results_folder_path, "logs")

    @property
    def model_path(self) -> str:
        return os.path.join(self.results_folder_path, "model")

    @property
    def figures_path(self) -> str:
        return os.path.join(self.results_folder_path, "figures")

    def __post_init__(self):
        # Debug-mode overrides (reference params/VSparams.py:74-98).
        if self.debug:
            self.split_csv = "./params/split_debug.csv"
            self.pad_crop_shape = (128, 128, 32)
            self.pad_crop_shape_test = (128, 128, 32)
            self.epochs_with_const_lr = 3
            self.num_epochs = 10
            self.sliding_window_inferer_roi_size = (128, 128, 32)


def add_reference_cli_flags(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """CLI surface identical to the reference (params/VSparams.py:39-66)."""
    parser.add_argument("--debug", dest="debug", action="store_true",
                        help="activate debugging mode")
    parser.set_defaults(debug=False)
    parser.add_argument("--split", type=str, default="./params/split_TCIA.csv",
                        help="path to CSV file that defines training, validation"
                             " and test datasets")
    parser.add_argument("--dataset", type=str, default="T1",
                        help='(string) use "T1" or "T2" to select dataset')
    parser.add_argument("--train_batch_size", type=int, default=1,
                        help="batch size of the forward pass")
    parser.add_argument("--initial_learning_rate", type=float, default=1e-4,
                        help="learning rate at first epoch")
    parser.add_argument("--no_attention", dest="attention", action="store_false",
                        help="disables the attention module in the network and the"
                             " attention map weighting in the loss function")
    parser.set_defaults(attention=True)
    parser.add_argument("--no_hardness", dest="hardness", action="store_false",
                        help="disables the hardness weighting in the loss function")
    parser.set_defaults(hardness=True)
    parser.add_argument("--results_folder_name", type=str,
                        default="temp" + strftime("%Y%m%d%H%M%S"),
                        help="name of results folder")
    # Extras absent from the reference CLI.
    parser.add_argument("--data_root", type=str, default="./data/VS_defaced/",
                        help="path to data set root")
    parser.add_argument("--compute_dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--infer_dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--sw_batch_size", type=int, default=8,
                        help="sliding-window tiles evaluated per device step")
    parser.add_argument("--sw_bucket", type=str, default="64,64,16",
                        help="comma H,W,D multiples to round padded volume "
                             "shapes up to (bounds recompiles across a "
                             "heterogeneous test set); 'none' disables")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--remat", action="store_true",
                        help="rematerialize the top levels' activations in "
                             "the backward pass (less device memory for a "
                             "second forward of those blocks)")
    parser.add_argument("--resume", action="store_true",
                        help="resume full training state from "
                             "last_epoch_model.ckpt (the reference has no "
                             "mid-training restore)")
    parser.add_argument("--sharded_inference", action="store_true",
                        help="shard each volume's sliding windows across all "
                             "devices of the mesh")
    parser.add_argument("--spatial_inference", action="store_true",
                        help="shard each window's H spatially across the mesh "
                             "with conv halo exchange (for "
                             "windows-per-volume < devices; any kernel/stride "
                             "with MONAI transpose arithmetic; UNet2d5-family "
                             "topologies)")
    parser.add_argument("--device_cache", action="store_true",
                        help="cache the training set in HBM and run random "
                             "crop/flip on device (zero per-step host "
                             "transfers)")
    parser.add_argument("--profile_steps", type=int, default=0,
                        help="capture a jax.profiler trace of N steady-state "
                             "training steps into <results>/profile/ "
                             "(view in TensorBoard/Perfetto)")
    parser.add_argument("--quantize_transfer", action="store_true",
                        help="stage inference volumes as uint8 (half the "
                             "host->device bytes of bf16; max error one "
                             "256th of the volume range — comparable to the "
                             "bf16 compute precision)")
    return parser


def _parse_bucket(s) -> Optional[Shape3]:
    if s is None or (isinstance(s, str) and s.lower() in ("none", "0", "")):
        return None
    if isinstance(s, (tuple, list)):
        return tuple(int(v) for v in s)
    return tuple(int(v) for v in s.split(","))


def config_from_args(args: argparse.Namespace) -> Config:
    return Config(
        debug=args.debug,
        split_csv=args.split,
        dataset=args.dataset,
        train_batch_size=args.train_batch_size,
        initial_learning_rate=args.initial_learning_rate,
        attention=args.attention,
        hardness=args.hardness,
        results_folder_name=args.results_folder_name,
        data_root=getattr(args, "data_root", "./data/VS_defaced/"),
        compute_dtype=getattr(args, "compute_dtype", "bfloat16"),
        infer_dtype=getattr(args, "infer_dtype", "bfloat16"),
        sw_batch_size=getattr(args, "sw_batch_size", 8),
        sw_bucket=_parse_bucket(getattr(args, "sw_bucket", "64,64,16")),
        seed=getattr(args, "seed", 0),
        remat=getattr(args, "remat", False),
        resume=getattr(args, "resume", False),
        sharded_inference=getattr(args, "sharded_inference", False),
        spatial_inference=getattr(args, "spatial_inference", False),
        device_cache=getattr(args, "device_cache", False),
        profile_steps=getattr(args, "profile_steps", 0),
        quantize_transfer=getattr(args, "quantize_transfer", False),
    )


def parse_cli(argv=None) -> Config:
    parser = argparse.ArgumentParser()
    add_reference_cli_flags(parser)
    args = parser.parse_args(argv)
    return config_from_args(args)
