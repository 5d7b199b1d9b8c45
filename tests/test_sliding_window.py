import jax
import jax.numpy as jnp
import numpy as np

from vs_seg.infer.sliding_window import (
    dense_patch_starts, gaussian_importance_map, sliding_window_inference,
)
from vs_seg.reference import numpy_blend as _numpy_sliding_window


def test_dense_patch_starts_monai_formula():
    # image 20, roi 8, overlap 0.25 -> interval 6, scan_num ceil(20/6)=4,
    # starts 0,6,12(clamped from 12: 12+8-20=0),12(from 18 clamped) -> [0,6,12,12]
    starts = dense_patch_starts((20, 8, 8), (8, 8, 8), 0.25)
    s0 = sorted(set(s[0] for s in starts))
    assert s0 == [0, 6, 12]
    assert len(starts) == 4  # duplicate clamped start preserved
    # dim == roi -> single start 0
    assert all(s[1] == 0 and s[2] == 0 for s in starts)


def test_gaussian_importance_map_properties():
    imp = gaussian_importance_map((16, 16, 8))
    assert imp.shape == (16, 16, 8)
    assert imp.max() == 1.0
    assert imp[8, 8, 4] == 1.0  # center = dim//2
    assert (imp > 0).all()
    # separable gaussian: imp[x,c,c] = exp(-0.5((x-8)/2)^2)
    np.testing.assert_allclose(imp[6, 8, 4], np.exp(-0.5 * (2 / 2.0) ** 2), rtol=1e-5)


def _toy_predictor(wins):
    # nonlinear, content-dependent 2-channel output
    a = wins * 2.0 + 1.0
    b = jnp.cumsum(wins, axis=1) * 0.1
    return jnp.concatenate([a, b], axis=-1)


def _toy_predictor_np(wins):
    a = wins * 2.0 + 1.0
    b = np.cumsum(wins, axis=1) * 0.1
    return np.concatenate([a, b], axis=-1)


def test_blend_matches_numpy_reference(rng):
    volume = rng.normal(size=(20, 14, 12, 1)).astype(np.float32)
    roi = (8, 8, 8)
    ref = _numpy_sliding_window(volume, roi, 0.25, _toy_predictor_np)
    for sw_batch in (1, 3, 8):
        out = sliding_window_inference(volume, roi, _toy_predictor,
                                       overlap=0.25, sw_batch_size=sw_batch)
        np.testing.assert_allclose(np.asarray(out), ref, atol=1e-5, rtol=1e-5)


def test_volume_smaller_than_roi_pads_and_crops(rng):
    volume = rng.normal(size=(5, 6, 4, 1)).astype(np.float32)
    roi = (8, 8, 8)
    ref = _numpy_sliding_window(volume, roi, 0.25, _toy_predictor_np)
    out = sliding_window_inference(volume, roi, _toy_predictor)
    assert out.shape == (5, 6, 4, 2)
    np.testing.assert_allclose(np.asarray(out), ref, atol=1e-5, rtol=1e-5)


def test_roi_equals_volume_single_window(rng):
    volume = rng.normal(size=(8, 8, 8, 1)).astype(np.float32)
    out = sliding_window_inference(volume, (8, 8, 8), _toy_predictor)
    ref = np.asarray(_toy_predictor(jnp.asarray(volume[None])))[0]
    np.testing.assert_allclose(np.asarray(out), ref, atol=1e-5, rtol=1e-5)


def test_constant_blend_mode(rng):
    volume = rng.normal(size=(12, 10, 9, 1)).astype(np.float32)
    ref = _numpy_sliding_window(volume, (8, 8, 8), 0.25, _toy_predictor_np,
                                mode="constant")
    out = sliding_window_inference(volume, (8, 8, 8), _toy_predictor,
                                   mode="constant")
    np.testing.assert_allclose(np.asarray(out), ref, atol=1e-5, rtol=1e-5)


def test_bucketing_keeps_shape(rng):
    volume = rng.normal(size=(21, 13, 11, 1)).astype(np.float32)
    out = sliding_window_inference(volume, (8, 8, 8), _toy_predictor,
                                   bucket=(16, 16, 16))
    assert out.shape == (21, 13, 11, 2)


def test_dfirst_layout_equivalence(rng):
    """D-first internal engine must match the HWDC path exactly."""
    volume = rng.normal(size=(20, 14, 12, 1)).astype(np.float32)
    roi = (8, 8, 8)
    ref = sliding_window_inference(volume, roi, _toy_predictor,
                                   sw_batch_size=3)

    def toy_dfirst(wins):
        # wins (N, D, H, W, C) -> run the HWDC toy on the transposed view
        w = jnp.transpose(wins, (0, 2, 3, 1, 4))
        return jnp.transpose(_toy_predictor(w), (0, 3, 1, 2, 4))

    out = sliding_window_inference(volume, roi, toy_dfirst, sw_batch_size=3,
                                   predictor_layout="dfirst")
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)


def test_bucketing_bounds_compilations(rng):
    """4+ distinct whole-volume shapes with a bucket policy must compile O(1)
    programs (the reference test protocol feeds heterogeneous whole volumes,
    params/VSparams.py:552-574) and keep exact numerics vs unbucketed."""
    from vs_seg.infer import sliding_window as sw

    traces = []

    @jax.jit
    def counting_predictor(wins):
        traces.append(wins.shape)  # appends once per trace (compile), not per call
        return _toy_predictor(wins)

    shapes = [(20, 14, 12), (24, 11, 14), (17, 9, 13), (23, 15, 10), (16, 16, 16)]
    roi, bucket = (8, 8, 8), (16, 16, 16)
    gather0 = sw._gather_windows._cache_size()
    scatter0 = sw._scatter_accumulate._cache_size()
    padded_shapes = set()
    for shp in shapes:
        volume = rng.normal(size=(*shp, 1)).astype(np.float32)
        staged = sw.stage_volume(volume, roi, overlap=0.25, sw_batch_size=4,
                                 bucket=bucket)
        padded_shapes.add(staged.vol_dev.shape)
        out = sliding_window_inference(staged, roi, counting_predictor,
                                       sw_batch_size=4)
        ref = _numpy_sliding_window(volume, roi, 0.25, _toy_predictor_np)
        # bucketed numerics: windows beyond the unbucketed padded extent see
        # zeros but blend only into the cropped-away margin -> exact equality
        np.testing.assert_allclose(np.asarray(out), ref, atol=1e-5, rtol=1e-5)
    assert len(padded_shapes) <= 2, padded_shapes
    assert len(traces) == 1, traces  # one predictor compilation total
    assert sw._gather_windows._cache_size() - gather0 <= 2
    assert sw._scatter_accumulate._cache_size() - scatter0 <= 2


def test_fused_matches_unfused(rng):
    """The single-dispatch fused window loop must equal the per-batch path."""
    volume = rng.normal(size=(20, 14, 12, 1)).astype(np.float32)
    roi = (8, 8, 8)
    a = sliding_window_inference(volume, roi, _toy_predictor, sw_batch_size=3,
                                 fused=True)
    b = sliding_window_inference(volume, roi, _toy_predictor, sw_batch_size=3,
                                 fused=False)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_quantized_pad_margin_is_zero(rng):
    """Pad-to-roi margins must dequantize to ~0.0 even when the volume's own
    range excludes 0 (regression: uint8 pads decoded to the volume MINIMUM)."""
    from vs_seg.infer.sliding_window import stage_volume
    volume = (rng.random((5, 6, 4, 1)) + 5.0).astype(np.float32)  # all >= 5
    roi = (8, 8, 8)
    ref = sliding_window_inference(volume, roi, _toy_predictor,
                                   overlap=0.25, sw_batch_size=4)
    staged = stage_volume(volume, roi, overlap=0.25, sw_batch_size=4,
                          quantize=True)
    out = sliding_window_inference(staged, roi, _toy_predictor,
                                   overlap=0.25, sw_batch_size=4)
    # quantization step of the 0-extended range; predictor scales inputs ~2x
    step = float(volume.max()) / 255.0
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=4 * step)
