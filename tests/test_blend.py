"""The XLA window blend (`_scatter_accumulate`, inside the fused window loop
and the per-batch loop) against the numpy MONAI 0.4 transcription in
vs_seg/reference.py, over volume shapes, overlaps and window batch sizes."""

import jax.numpy as jnp
import numpy as np
import pytest

from vs_seg.infer.sliding_window import (_scatter_accumulate,
                                         dense_patch_starts,
                                         gaussian_importance_map,
                                         sliding_window_inference)
from vs_seg.reference import numpy_blend, numpy_scatter_accumulate


def _toy(wins):
    # nonlinear, content-dependent 2-channel output
    return jnp.concatenate([wins * 2.0 + 1.0,
                            jnp.cumsum(wins, axis=1) * 0.1], axis=-1)


def _toy_np(wins):
    return np.concatenate([wins * 2.0 + 1.0,
                           np.cumsum(wins, axis=1) * 0.1], axis=-1)


@pytest.mark.parametrize("sw_batch", [1, 3, 8])
@pytest.mark.parametrize("overlap", [0.25, 0.5])
@pytest.mark.parametrize("shape", [(20, 14, 12), (9, 9, 9), (33, 17, 8)])
def test_blend_matches_numpy_monai(rng, shape, overlap, sw_batch):
    volume = rng.normal(size=(*shape, 1)).astype(np.float32)
    roi = (8, 8, 8)
    ref = numpy_blend(volume, roi, overlap, _toy_np)
    out = sliding_window_inference(volume, roi, _toy, overlap=overlap,
                                   sw_batch_size=sw_batch)
    np.testing.assert_allclose(np.asarray(out), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("fused", [True, False])
def test_blend_dfirst_matches_numpy_monai(rng, fused):
    volume = rng.normal(size=(21, 13, 10, 1)).astype(np.float32)
    roi = (8, 8, 6)
    ref = numpy_blend(volume, roi, 0.25, _toy_np)

    def toy_dfirst(wins):  # (N, D, H, W, C) tiles
        w = jnp.transpose(wins, (0, 2, 3, 1, 4))
        return jnp.transpose(_toy(w), (0, 3, 1, 2, 4))

    out = sliding_window_inference(volume, roi, toy_dfirst, sw_batch_size=4,
                                   predictor_layout="dfirst", fused=fused)
    np.testing.assert_allclose(np.asarray(out), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n_real", [1, 5, 8])
def test_scatter_accumulate_matches_numpy_with_masked_windows(rng, n_real):
    """Windows past n_real are padding (mask 0): they add nothing."""
    shape, roi = (24, 20, 12), (8, 8, 6)
    starts = dense_patch_starts(shape, roi, 0.25)[:8]
    mask = (np.arange(8) < n_real).astype(np.float32)
    imp = gaussian_importance_map(roi)
    preds = rng.normal(size=(8, *roi, 2)).astype(np.float32)
    out_acc = rng.normal(size=(*shape, 2)).astype(np.float32)
    w_acc = rng.uniform(size=(*shape, 1)).astype(np.float32)
    ref_o, ref_w = numpy_scatter_accumulate(out_acc, w_acc, preds, starts,
                                            mask, imp)
    got_o, got_w = _scatter_accumulate(
        jnp.asarray(out_acc), jnp.asarray(w_acc), jnp.asarray(preds),
        jnp.asarray(starts), jnp.asarray(mask), jnp.asarray(imp))
    np.testing.assert_allclose(np.asarray(got_o), ref_o, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got_w), ref_w, rtol=1e-6, atol=1e-6)


def test_scatter_accumulate_accepts_bf16_predictions(rng):
    shape, roi = (16, 16, 8), (8, 8, 8)
    starts = dense_patch_starts(shape, roi, 0.25)
    preds = jnp.asarray(rng.normal(size=(len(starts), *roi, 2)), jnp.bfloat16)
    mask = np.ones(len(starts), np.float32)
    imp = gaussian_importance_map(roi)
    got_o, _ = _scatter_accumulate(
        jnp.zeros((*shape, 2), jnp.float32), jnp.zeros((*shape, 1)), preds,
        jnp.asarray(starts), jnp.asarray(mask), jnp.asarray(imp))
    ref_o, _ = numpy_scatter_accumulate(
        np.zeros((*shape, 2)), np.zeros((*shape, 1)),
        np.asarray(preds.astype(jnp.float32)), starts, mask, imp)
    assert got_o.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(got_o), ref_o, rtol=1e-6, atol=1e-6)
