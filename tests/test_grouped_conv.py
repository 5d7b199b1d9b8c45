import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vs_seg.ops.experimental.grouped_conv import build_block_toeplitz, grouped_conv2d


@pytest.mark.parametrize("c,co,g", [(16, 16, 8), (4, 8, 4), (32, 32, 4)])
def test_grouped_conv_matches_lax_conv(rng, c, co, g):
    x = jnp.asarray(rng.normal(size=(2, 16, 32, c)).astype(np.float32))
    w = jnp.asarray(rng.normal(size=(3, 3, c, co)).astype(np.float32) * 0.1)
    ref = jax.lax.conv_general_dilated(
        x, w, (1, 1), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = grouped_conv2d(x, w, group=g)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               atol=1e-4, rtol=1e-4)


def test_block_toeplitz_structure():
    w = jnp.arange(3 * 3 * 2 * 2, dtype=jnp.float32).reshape(3, 3, 2, 2)
    wb = build_block_toeplitz(w, group=4)
    assert wb.shape == (3 * 6 * 2, 4 * 2)
    wb5 = wb.reshape(3, 6, 2, 4, 2)
    # output j reads input column r with tap dw = r - j (valid 0..2)
    np.testing.assert_array_equal(np.asarray(wb5[:, 2, :, 1, :]),
                                  np.asarray(w[:, 1]))  # r=2, j=1 -> dw=1
    np.testing.assert_array_equal(np.asarray(wb5[:, 0, :, 2, :]), 0.0)  # dw=-2
