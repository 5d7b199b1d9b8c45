"""Every path of nn/layers.conv3d against a plain float32 3D convolution in
the reference's (B, H, W, D, C) order (vs_seg/reference.py): the folded-2D
path (kd == 1), the 3D path, the transpose (lhs-dilated) path, the
pair-split concat path, and the VS_D2C / VS_DOT11 rewrites."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vs_seg import reference
from vs_seg.nn.layers import Conv3d, ConvTranspose3d, conv3d, same_padding

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       # bf16 operands and outputs: ~3 significant digits
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _inputs(rng, kernel, cin=3, cout=5, shape=(2, 6, 12, 10)):
    b, d, h, w = shape
    x = rng.normal(size=(b, d, h, w, cin)).astype(np.float32)
    p = {"kernel": rng.normal(size=(*kernel, cin, cout)).astype(np.float32)
         / np.sqrt(cin * np.prod(kernel)),
         "bias": rng.normal(size=(cout,)).astype(np.float32)}
    return x, p


def _ref_conv(x, p, strides):
    xr = jnp.transpose(jnp.asarray(x), (0, 2, 3, 1, 4))
    y = reference._conv(xr, p, strides)
    return np.asarray(jnp.transpose(y, (0, 3, 1, 2, 4)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strides", [(1, 1, 1), (2, 2, 1), (2, 2, 2)])
@pytest.mark.parametrize("kernel", [(3, 3, 1), (3, 3, 3), (1, 1, 1),
                                    (1, 3, 3)])
def test_conv3d_matches_f32_reference(rng, kernel, strides, dtype):
    x, p = _inputs(rng, kernel)
    pads = [(q, q) for q in same_padding(kernel)]
    out = conv3d(jnp.asarray(x), jnp.asarray(p["kernel"]),
                 jnp.asarray(p["bias"]), strides, pads,
                 dtype=jnp.dtype(dtype))
    assert out.dtype == jnp.dtype(dtype)
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               _ref_conv(x, p, strides), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strides", [(2, 2, 1), (2, 2, 2), (1, 1, 1)])
@pytest.mark.parametrize("kernel", [(3, 3, 1), (3, 3, 3)])
def test_conv_transpose_matches_f32_adjoint_reference(rng, kernel, strides,
                                                      dtype):
    x, p = _inputs(rng, kernel, cin=4, cout=3, shape=(1, 3, 5, 4))
    mod = ConvTranspose3d(3, kernel, strides, dtype=jnp.dtype(dtype))
    out = mod.apply({"params": p}, jnp.asarray(x))
    xr = jnp.transpose(jnp.asarray(x), (0, 2, 3, 1, 4))
    ref = jnp.transpose(reference._conv_transpose(xr, p, strides),
                        (0, 3, 1, 2, 4))
    assert out.shape == (1, 3 * strides[2], 5 * strides[0], 4 * strides[1], 3)
    np.testing.assert_allclose(np.asarray(out, np.float32), np.asarray(ref),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", [(3, 3, 1), (3, 3, 3), (1, 1, 1)])
def test_pair_split_conv_equals_conv_of_concat(rng, kernel, dtype):
    """Conv3d on a pair (xa, xb) computes conv(concat([xa, xb])) with the
    same parameter tensor, without building the concat."""
    xa = rng.normal(size=(1, 4, 8, 6, 3)).astype(np.float32)
    xb = rng.normal(size=(1, 4, 8, 6, 5)).astype(np.float32)
    cat = np.concatenate([xa, xb], -1)
    mod = Conv3d(4, kernel, dtype=jnp.dtype(dtype))
    v = mod.init(jax.random.key(0), jnp.asarray(cat))
    pair = mod.apply(v, (jnp.asarray(xa), jnp.asarray(xb)))
    ref = _ref_conv(cat, v["params"], (1, 1, 1))
    np.testing.assert_allclose(np.asarray(pair, np.float32), ref,
                               **TOL[dtype])


def test_conv_affine_fold_equals_affine_after_conv(rng):
    """Conv3d(affine=(inv, shift)) == conv(x)*inv + shift (eval BN fold)."""
    x, p = _inputs(rng, (3, 3, 3))
    inv = rng.uniform(0.5, 2.0, size=5).astype(np.float32)
    shift = rng.normal(size=5).astype(np.float32)
    mod = Conv3d(5, (3, 3, 3), dtype=jnp.float32)
    folded = mod.apply({"params": p}, jnp.asarray(x),
                       affine=(jnp.asarray(inv), jnp.asarray(shift)))
    ref = _ref_conv(x, p, (1, 1, 1)) * inv + shift
    np.testing.assert_allclose(np.asarray(folded), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("knob,kernel", [("VS_D2C", (3, 3, 3)),
                                         ("VS_DOT11", (1, 1, 1))])
def test_conv_rewrite_knobs_keep_values(rng, monkeypatch, knob, kernel):
    """The default-off rewrites compute the same conv as the default path."""
    x, p = _inputs(rng, kernel)
    pads = [(q, q) for q in same_padding(kernel)]
    args = (jnp.asarray(x), jnp.asarray(p["kernel"]), jnp.asarray(p["bias"]),
            (1, 1, 1), pads)
    monkeypatch.setenv(knob, "0")
    ref = conv3d(*args, dtype=jnp.float32)
    monkeypatch.setenv(knob, "1")
    out = conv3d(*args, dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_conv3d_flop_trace_counts_macs(rng):
    """With _FLOP_TRACE set, conv3d records 2 * out_elems * kh*kw*kd * Cin."""
    from vs_seg.nn import layers
    x, p = _inputs(rng, (3, 3, 1))
    layers._FLOP_TRACE = trace = []
    try:
        y = conv3d(jnp.asarray(x), jnp.asarray(p["kernel"]), None, (2, 2, 1),
                   [(1, 1), (1, 1), (0, 0)], dtype=jnp.float32)
    finally:
        layers._FLOP_TRACE = None
    assert trace == [2 * int(np.prod(y.shape)) * 3 * 3 * 1 * 3]
