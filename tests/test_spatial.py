"""Spatial sharding with halo exchange (SURVEY §5): one window split over the
mesh must reproduce the single-device forward exactly. Runs on the 8-device
virtual CPU mesh (conftest)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_model import SMALL
from vs_seg.models import UNet2d5_spvPA
from vs_seg.ops.halo import halo_conv3d
from vs_seg.parallel.mesh import make_mesh


@pytest.mark.parametrize("kernel", [(3, 3, 1), (3, 3, 3), (1, 3, 3)])
def test_halo_conv3d_matches_dense(rng, kernel):
    from vs_seg.nn.layers import conv3d, same_padding
    mesh = make_mesh()
    n = mesh.devices.size
    kh, kw, kd = kernel
    x = jnp.asarray(rng.normal(size=(1, 6, 8 * n, 16, 4)), jnp.float32)
    w = jnp.asarray(rng.normal(size=(kh, kw, kd, 4, 8)) * 0.2, jnp.float32)
    b = jnp.asarray(rng.normal(size=(8,)), jnp.float32)
    pad = same_padding(kernel)
    ref = conv3d(x, w, b, (1, 1, 1), [(p, p) for p in pad], dtype=jnp.float32)
    out = halo_conv3d(x, w, b, mesh, dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)


def test_spatial_predictor_matches_single_device(rng):
    """GSPMD spatially-sharded forward (H over 8 devices) == dense forward."""
    from vs_seg.infer.engine import make_predictor
    from vs_seg.infer.spatial import make_spatial_predictor

    mesh = make_mesh()
    model = UNet2d5_spvPA(out_channels=2, num_res_units=2, dropout=0.1,
                          attention_module=True, dtype=jnp.float32, **SMALL)
    x = jnp.zeros((1, 8, 32, 32, 1))
    variables = model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        x, train=False)
    params = variables["params"]
    stats = variables.get("batch_stats", {})

    wins = jnp.asarray(rng.normal(size=(1, 8, 32, 32, 1)), jnp.float32)
    ref = make_predictor(model, params, stats, dtype=jnp.float32)(wins)
    out = make_spatial_predictor(model, params, stats, mesh,
                                 dtype=jnp.float32)(wins)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)


def test_spatial_predictor_in_sliding_window(rng):
    """End-to-end: sliding-window inference with the spatially sharded
    predictor equals the unsharded engine output."""
    from vs_seg.infer.engine import make_predictor
    from vs_seg.infer.sliding_window import sliding_window_inference
    from vs_seg.infer.spatial import make_spatial_predictor

    mesh = make_mesh()
    model = UNet2d5_spvPA(out_channels=2, num_res_units=2, dropout=0.1,
                          attention_module=True, dtype=jnp.float32, **SMALL)
    x0 = jnp.zeros((1, 8, 32, 32, 1))
    variables = model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        x0, train=False)
    params, stats = variables["params"], variables.get("batch_stats", {})

    volume = rng.normal(size=(40, 36, 10, 1)).astype(np.float32)  # (H, W, D, C)
    roi = (32, 32, 8)
    ref = sliding_window_inference(
        volume, roi, make_predictor(model, params, stats, dtype=jnp.float32),
        sw_batch_size=1, predictor_layout="dfirst")
    out = sliding_window_inference(
        volume, roi,
        make_spatial_predictor(model, params, stats, mesh, dtype=jnp.float32),
        sw_batch_size=1, predictor_layout="dfirst")
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kh,sh", [(3, 2), (5, 2), (3, 3), (2, 2), (4, 2),
                                   (7, 4)])
def test_spatial_transpose_conv_matches_dense(rng, kh, sh):
    """H-sharded transpose convs of ANY (kernel, stride) with MONAI's
    output_padding arithmetic must equal the dense transpose conv — the
    general halo/repad derivation in nn/layers.py:conv3d, not just the
    flagship (kh=3, stride 2) pattern."""
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vs_seg.nn.layers import ConvTranspose3d, spatial_sharding

    mesh = make_mesh()
    n = mesh.devices.size
    hl = 4
    x = jnp.asarray(rng.normal(size=(1, 3, hl * n, 8, 4)), jnp.float32)
    tc = ConvTranspose3d(6, (kh, 3, 3), (sh, 2, 1), dtype=jnp.float32)
    variables = tc.init(jax.random.key(0), x)
    ref = tc.apply(variables, x)

    def local(xs):
        with spatial_sharding("data", n):
            return tc.apply(variables, xs)

    sharded = shard_map(local, mesh=mesh,
                        in_specs=P(None, None, "data"),
                        out_specs=P(None, None, "data"))
    out = jax.jit(sharded)(x)
    assert out.shape == ref.shape
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)
