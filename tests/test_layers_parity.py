"""Numerical parity of NN primitives vs torch CPU (float32).

The reference's compute blocks are torch modules (conv/BN/PReLU/transpose-conv,
reference params/networks/blocks/convolutions.py); these tests pin our NDHWC
JAX implementations to identical math so reference checkpoints import exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vs_seg.nn.blocks import Convolution, ResidualUnit
from vs_seg.nn.layers import BatchNorm, Conv3d, ConvTranspose3d, PReLU, same_padding


def to_ndhwc(x_torch):
    return jnp.asarray(x_torch.detach().numpy().transpose(0, 4, 2, 3, 1))


def from_conv_weight(w_torch):
    # torch (out, in, kh, kw, kd) -> ours (kh, kw, kd, in, out)
    return jnp.asarray(w_torch.detach().numpy().transpose(2, 3, 4, 1, 0))


def from_convt_weight(w_torch):
    # torch (in, out, kh, kw, kd) -> ours (kh, kw, kd, in, out)
    return jnp.asarray(w_torch.detach().numpy().transpose(2, 3, 4, 0, 1))


@pytest.mark.parametrize("kernel,stride", [
    ((3, 3, 1), (1, 1, 1)),
    ((3, 3, 3), (2, 2, 2)),
    ((3, 3, 1), (2, 2, 1)),
    ((1, 1, 1), (1, 1, 1)),
])
def test_conv3d_matches_torch(kernel, stride, rng):
    tconv = torch.nn.Conv3d(3, 5, kernel, stride=stride,
                            padding=same_padding(kernel))
    x = torch.randn(2, 3, 12, 12, 8)
    ref = tconv(x).detach().numpy().transpose(0, 4, 2, 3, 1)

    mod = Conv3d(5, kernel, stride, dtype=jnp.float32)
    params = {"params": {"kernel": from_conv_weight(tconv.weight),
                         "bias": jnp.asarray(tconv.bias.detach().numpy())}}
    out = mod.apply(params, to_ndhwc(x))
    np.testing.assert_allclose(np.asarray(out), ref, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("kernel,stride", [
    ((3, 3, 1), (2, 2, 1)),
    ((3, 3, 3), (2, 2, 2)),
    ((3, 3, 3), (1, 1, 1)),
])
def test_conv_transpose3d_matches_torch(kernel, stride, rng):
    k = np.asarray(kernel)
    s = np.asarray(stride)
    p = np.asarray(same_padding(kernel))
    output_padding = tuple(int(v) for v in (s + 2 * p - (k - 1) - 1))
    tconv = torch.nn.ConvTranspose3d(4, 3, kernel, stride=stride,
                                     padding=tuple(int(v) for v in p),
                                     output_padding=output_padding)
    x = torch.randn(2, 4, 6, 6, 5)
    ref = tconv(x).detach().numpy().transpose(0, 4, 2, 3, 1)
    # exact upsample: (D, H, W) = input * stride
    assert ref.shape[1:4] == (5 * s[2], 6 * s[0], 6 * s[1])

    mod = ConvTranspose3d(3, kernel, stride, dtype=jnp.float32)
    params = {"params": {"kernel": from_convt_weight(tconv.weight),
                         "bias": jnp.asarray(tconv.bias.detach().numpy())}}
    out = mod.apply(params, to_ndhwc(x))
    assert out.shape == ref.shape
    np.testing.assert_allclose(np.asarray(out), ref, atol=2e-5, rtol=1e-5)


def test_batchnorm_train_and_eval_match_torch(rng):
    tbn = torch.nn.BatchNorm3d(4)
    with torch.no_grad():
        tbn.weight.copy_(torch.randn(4))
        tbn.bias.copy_(torch.randn(4))
        tbn.running_mean.copy_(torch.randn(4))
        tbn.running_var.copy_(torch.rand(4) + 0.5)

    params = {"params": {"scale": jnp.array(tbn.weight.detach().numpy().copy()),
                         "bias": jnp.array(tbn.bias.detach().numpy().copy())},
              "batch_stats": {"mean": jnp.array(tbn.running_mean.numpy().copy()),
                              "var": jnp.array(tbn.running_var.numpy().copy())}}
    mod = BatchNorm()
    x = torch.randn(2, 4, 5, 6, 7)

    # eval mode: use running stats
    tbn.eval()
    ref_eval = tbn(x).detach().numpy().transpose(0, 4, 2, 3, 1)
    out_eval = mod.apply(params, to_ndhwc(x), train=False)
    np.testing.assert_allclose(np.asarray(out_eval), ref_eval, atol=1e-5, rtol=1e-5)

    # train mode: normalize with batch stats, update running stats
    tbn.train()
    ref_train = tbn(x).detach().numpy().transpose(0, 4, 2, 3, 1)
    out_train, mutated = mod.apply(params, to_ndhwc(x), train=True,
                                   mutable=["batch_stats"])
    np.testing.assert_allclose(np.asarray(out_train), ref_train, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(mutated["batch_stats"]["mean"]),
                               tbn.running_mean.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(mutated["batch_stats"]["var"]),
                               tbn.running_var.numpy(), atol=1e-5, rtol=1e-5)


def test_prelu_matches_torch():
    tp = torch.nn.PReLU(num_parameters=1, init=0.25)
    with torch.no_grad():
        tp.weight.fill_(0.3)
    x = torch.randn(2, 3, 4)
    ref = tp(x).detach().numpy()
    out = PReLU().apply({"params": {"alpha": jnp.asarray([0.3])}}, jnp.asarray(x.numpy()))
    np.testing.assert_allclose(np.asarray(out), ref, atol=1e-6)


class TorchMonaiConvolution(torch.nn.Sequential):
    """Minimal torch replica of MONAI Convolution ordering:
    conv -> BN -> dropout -> PReLU (reference convolutions.py:148-156)."""

    def __init__(self, cin, cout, kernel, stride):
        super().__init__()
        self.add_module("conv", torch.nn.Conv3d(cin, cout, kernel, stride,
                                                padding=same_padding(kernel)))
        self.add_module("norm", torch.nn.BatchNorm3d(cout))
        self.add_module("dropout", torch.nn.Dropout(0.1))
        self.add_module("act", torch.nn.PReLU(num_parameters=1, init=0.25))


def _convolution_params(tmod):
    return {
        "params": {
            "conv": {"kernel": from_conv_weight(tmod.conv.weight),
                     "bias": jnp.asarray(tmod.conv.bias.detach().numpy())},
            "norm": {"scale": jnp.asarray(tmod.norm.weight.detach().numpy()),
                     "bias": jnp.asarray(tmod.norm.bias.detach().numpy())},
            "act": {"alpha": jnp.asarray(tmod.act.weight.detach().numpy())},
        },
        "batch_stats": {"norm": {"mean": jnp.asarray(tmod.norm.running_mean.numpy()),
                                 "var": jnp.asarray(tmod.norm.running_var.numpy())}},
    }


def test_convolution_block_matches_torch_eval(rng):
    tmod = TorchMonaiConvolution(2, 6, (3, 3, 1), (2, 2, 1))
    tmod.eval()
    x = torch.randn(1, 2, 10, 10, 6)
    ref = tmod(x).detach().numpy().transpose(0, 4, 2, 3, 1)
    mod = Convolution(6, (3, 3, 1), (2, 2, 1), dropout=0.1, dtype=jnp.float32)
    out = mod.apply(_convolution_params(tmod), to_ndhwc(x), train=False)
    np.testing.assert_allclose(np.asarray(out), ref, atol=1e-4, rtol=1e-4)


class TorchResidualUnit(torch.nn.Module):
    """Torch replica of MONAI ResidualUnit (reference convolutions.py:159-255),
    stride 1, channels change -> 1x1x1 residual conv."""

    def __init__(self, cin, cout, kernel, subunits=2, last_conv_only=False):
        super().__init__()
        self.conv = torch.nn.Sequential()
        ch = cin
        for su in range(subunits):
            conv_only = last_conv_only and su == subunits - 1
            if conv_only:
                unit = torch.nn.Sequential()
                unit.add_module("conv", torch.nn.Conv3d(ch, cout, kernel, 1,
                                                        padding=same_padding(kernel)))
            else:
                unit = TorchMonaiConvolution(ch, cout, kernel, 1)
            self.conv.add_module(f"unit{su}", unit)
            ch = cout
        self.residual = torch.nn.Conv3d(cin, cout, 1, 1, 0)

    def forward(self, x):
        return self.conv(x) + self.residual(x)


def test_residual_unit_matches_torch_eval(rng):
    tmod = TorchResidualUnit(3, 8, (3, 3, 3), subunits=2)
    tmod.eval()
    x = torch.randn(1, 3, 8, 8, 6)
    ref = tmod(x).detach().numpy().transpose(0, 4, 2, 3, 1)

    params = {"params": {}, "batch_stats": {}}
    for su in range(2):
        sub = _convolution_params(getattr(tmod.conv, f"unit{su}"))
        params["params"][f"unit{su}"] = sub["params"]
        params["batch_stats"][f"unit{su}"] = sub["batch_stats"]
    params["params"]["residual"] = {
        "kernel": from_conv_weight(tmod.residual.weight),
        "bias": jnp.asarray(tmod.residual.bias.detach().numpy())}

    mod = ResidualUnit(8, (3, 3, 3), subunits=2, dropout=0.1, dtype=jnp.float32)
    out = mod.apply(params, to_ndhwc(x), train=False)
    np.testing.assert_allclose(np.asarray(out), ref, atol=1e-4, rtol=1e-4)
