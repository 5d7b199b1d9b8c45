"""tools/trace_sites.py: attribution of a kernel's op path to a model block."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import trace_sites  # noqa: E402


@pytest.mark.parametrize("path,block", [
    ("jit(_fused_window_loop)/while/body/closed_call/jit(predictor)/"
     "UNet2d5_spvPA/down_0/unit0/conv/conv_general_dilated", "fwd down_0"),
    ("jit(step)/transpose(jvp(UNet2d5_spvPA))/upsample_2/conv/"
     "conv_general_dilated", "bwd upsample_2"),
    ("jit(step)/jvp(UNet2d5_spvPA)/upatt_1/conv2/conv/add", "fwd upatt_1"),
    ("jit(_fused_window_loop)/while/body/blend/dynamic_update_slice",
     "fwd blend"),
    ("UNet2d5_spvPA/bottom_att/conv1/conv", "fwd bottom_att"),
    ("jit(_fused_window_loop)/while/body/closed_call/jit(predictor)",
     "fwd other"),
    ("", "fwd other"),
])
def test_block_of(path, block):
    assert trace_sites.block_of(path) == block


def test_groups_name_only_blocks_the_model_has():
    from vs_seg.models import UNet2d5_spvPA
    m = UNet2d5_spvPA()
    n = len(m.strides)
    blocks = {f"{p}_{i}" for p in ("down", "downsample", "upsample", "upatt",
                                   "up") for i in range(n)}
    blocks |= {"bottom", "bottom_att", "blend"}
    for members in trace_sites.GROUPS.values():
        for m in members:
            direction, block = m.split(" ")
            assert direction in ("fwd", "bwd") and block in blocks, m
