import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vs_seg.ops.experimental.widthpack import conv2d_widthpacked


def _ref_conv(x, w):
    kh = w.shape[0]
    return jax.lax.conv_general_dilated(
        x, w, (1, 1), [((kh - 1) // 2, (kh - 1) // 2), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("cin,cout,kh", [(16, 16, 3), (16, 16, 1), (8, 4, 3),
                                         (1, 16, 3), (32, 2, 3)])
def test_widthpack_exact(rng, p, cin, cout, kh):
    x = jnp.asarray(rng.normal(size=(2, 8, 32, cin)), jnp.float32)
    w = jnp.asarray(rng.normal(size=(kh, 3, cin, cout)), jnp.float32)
    ref = _ref_conv(x, w)
    out = conv2d_widthpacked(x, w, p, precision=jax.lax.Precision.HIGHEST)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-4, rtol=1e-4)


def test_widthpack_edge_content(rng):
    """Edge columns (where packed same-padding covers a full packed col of
    zeros) must match the original 1-px zero padding exactly."""
    x = jnp.asarray(rng.normal(size=(1, 4, 16, 4)), jnp.float32)
    w = jnp.asarray(rng.normal(size=(3, 3, 4, 4)), jnp.float32)
    ref = _ref_conv(x, w)
    out = conv2d_widthpacked(x, w, 8, precision=jax.lax.Precision.HIGHEST)
    np.testing.assert_allclose(np.asarray(out)[:, :, [0, 1, 14, 15]],
                               np.asarray(ref)[:, :, [0, 1, 14, 15]],
                               atol=2e-4, rtol=1e-4)
