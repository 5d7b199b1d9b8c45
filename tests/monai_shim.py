"""Minimal MONAI-0.4 shim: just the symbols the REFERENCE's own model/loss
source imports (verified against the import sites in
reference params/networks/blocks/convolutions.py:18-19,
params/networks/nets/unet2d5_spvPA.py:17-20, params/losses/dice_spvPA.py:20-21),
so that source can be imported under plain torch and used as the golden oracle
for parity tests — eliminating the common-mode risk of validating only against
our hand-written replica (tests/torch_replica.py).

Factory semantics per MONAI 0.4: `Conv[Conv.CONV, dims]` / `Norm[name, dims]` /
`Dropout[name, dim]` / `Act[name]` return layer TYPES; `split_args` splits an
optional (name, kwargs) tuple.
"""

from __future__ import annotations

import sys
import types
from enum import Enum

import numpy as np
import torch
import torch.nn as nn


def same_padding(kernel_size, dilation=1):
    kernel_size = np.atleast_1d(kernel_size)
    dilation = np.atleast_1d(dilation)
    if np.any((kernel_size - 1) * dilation % 2 == 1):
        # real MONAI 0.4 raises here; silently floor-dividing would make the
        # oracle diverge from the real dependency on even kernels
        raise NotImplementedError(
            f"same padding not available for kernel_size={tuple(kernel_size)} "
            f"and dilation={tuple(dilation)}")
    padding = (kernel_size - 1) // 2 * dilation
    return tuple(int(p) for p in padding) if padding.size > 1 else int(padding)


def split_args(args):
    if isinstance(args, str):
        return args, {}
    name, name_args = args
    return name, name_args


class _Factory:
    def __init__(self, table):
        self._table = table

    def __getattr__(self, name):  # Conv.CONV -> "conv", Norm.BATCH -> "batch"
        if name.startswith("_"):
            # never intercept dunder/protocol lookups (__deepcopy__ etc.):
            # returning a string makes copy/pickle blow up far from here
            raise AttributeError(name)
        return name.lower()

    def __getitem__(self, key):
        if not isinstance(key, tuple):
            key = (key,)
        name, *rest = key
        return self._table[name.lower()](*rest)


Conv = _Factory({
    "conv": lambda d: {1: nn.Conv1d, 2: nn.Conv2d, 3: nn.Conv3d}[d],
    "convtrans": lambda d: {1: nn.ConvTranspose1d, 2: nn.ConvTranspose2d,
                            3: nn.ConvTranspose3d}[d],
})
Norm = _Factory({
    "batch": lambda d: {1: nn.BatchNorm1d, 2: nn.BatchNorm2d, 3: nn.BatchNorm3d}[d],
    "instance": lambda d: {1: nn.InstanceNorm1d, 2: nn.InstanceNorm2d,
                           3: nn.InstanceNorm3d}[d],
})
Act = _Factory({
    "prelu": lambda: nn.PReLU,
    "relu": lambda: nn.ReLU,
    "sigmoid": lambda: nn.Sigmoid,
})
Dropout = _Factory({
    "dropout": lambda d: {1: nn.Dropout, 2: nn.Dropout2d, 3: nn.Dropout3d}[d],
})
# Factory lookups call the table fn with the trailing key elements; Act takes
# none, so wrap the zero-arg lambdas to tolerate Act[name] (no dims).


class SkipConnection(nn.Module):
    """cat([x, submodule(x)], dim=1) — MONAI 0.4 simplelayers.SkipConnection."""

    def __init__(self, submodule, cat_dim: int = 1):
        super().__init__()
        self.submodule = submodule
        self.cat_dim = cat_dim

    def forward(self, x):
        return torch.cat([x, self.submodule(x)], self.cat_dim)


def one_hot(labels: torch.Tensor, num_classes: int, dtype=torch.float,
            dim: int = 1) -> torch.Tensor:
    shape = list(labels.shape)
    assert shape[dim] == 1
    shape[dim] = num_classes
    out = torch.zeros(shape, dtype=dtype, device=labels.device)
    return out.scatter_(dim, labels.long(), 1)


class LossReduction(Enum):
    NONE = "none"
    MEAN = "mean"
    SUM = "sum"


class Weight(Enum):
    SQUARE = "square"
    SIMPLE = "simple"
    UNIFORM = "uniform"


def export(module_name):
    return lambda cls: cls


def alias(*names):
    return lambda cls: cls


def install_shim(reference_root: str) -> None:
    """Register the fake `monai` package tree and put the reference repo on
    sys.path so `params.networks...` / `params.losses...` import from it."""
    if reference_root not in sys.path:
        sys.path.insert(0, reference_root)
    if "monai" in sys.modules and not getattr(sys.modules["monai"], "_vs_shim", False):
        return  # a real monai is present; don't clobber it

    def mod(name, **attrs):
        m = sys.modules.get(name) or types.ModuleType(name)
        for k, v in attrs.items():
            setattr(m, k, v)
        m._vs_shim = True
        sys.modules[name] = m
        return m

    monai = mod("monai")
    networks = mod("monai.networks", one_hot=one_hot)
    layers = mod("monai.networks.layers")
    mod("monai.networks.layers.factories", Conv=Conv, Norm=Norm, Act=Act,
        Dropout=Dropout, split_args=split_args)
    mod("monai.networks.layers.convutils", same_padding=same_padding)
    mod("monai.networks.layers.simplelayers", SkipConnection=SkipConnection)
    utils = mod("monai.utils", export=export, LossReduction=LossReduction,
                Weight=Weight)
    mod("monai.utils.aliases", alias=alias)
    utils.aliases = sys.modules["monai.utils.aliases"]
    monai.networks = networks
    monai.utils = utils
    networks.layers = layers
