"""Multi-chip (8 virtual CPU devices) sharding tests: data-parallel training
must be numerically equivalent to the single-device computation (GSPMD inserts
the collectives; BatchNorm still sees the global batch)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vs_seg.core.config import Config
from vs_seg.models import build_model
from vs_seg.parallel.mesh import batch_sharding, make_mesh, shard_batch
from vs_seg.train.trainer import Trainer

CFG = dict(
    pad_crop_shape=(16, 16, 8),
    channels=(4, 8, 12),
    strides=((2, 2, 1), (2, 2, 2)),
    kernel_sizes=((3, 3, 1), (3, 3, 3), (3, 3, 3)),
    sample_kernel_sizes=((3, 3, 1), (3, 3, 3)),
    compute_dtype="float32",
)


def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.devices.size == 8
    assert mesh.axis_names == ("data",)


def test_dp_train_step_matches_single_device(rng):
    cfg = Config(train_batch_size=8, **CFG)
    model = build_model(cfg)
    mesh = make_mesh()
    trainer = Trainer(cfg, model, mesh=mesh)
    state = trainer.init_state()

    image = rng.normal(size=(8, 8, 16, 16, 1)).astype(np.float32)
    label = (rng.random((8, 8, 16, 16, 1)) > 0.7).astype(np.float32)

    sharding = batch_sharding(mesh, 5)
    img_s = jax.device_put(image, sharding)
    lbl_s = jax.device_put(label, sharding)
    p1, bs1, os1, _, loss_sharded = trainer.train_step(
        state["params"], state["batch_stats"], state["opt_state"],
        jax.random.key(7), img_s, lbl_s)

    # fresh state, replicated batch, same dropout key
    state2 = trainer.init_state()
    p2, bs2, os2, _, loss_single = trainer.train_step(
        state2["params"], state2["batch_stats"], state2["opt_state"],
        jax.random.key(7), jnp.asarray(image), jnp.asarray(label))

    np.testing.assert_allclose(float(loss_sharded), float(loss_single),
                               rtol=1e-5, atol=1e-6)
    # One Adam step ~= +-lr per param; cross-sharding reduction-order noise can
    # flip near-zero gradient signs, so allow update-scale (lr=1e-4) deviations.
    lr = cfg.initial_learning_rate
    for (k1, a), (k2, b) in zip(
            jax.tree_util.tree_flatten_with_path(p1)[0],
            jax.tree_util.tree_flatten_with_path(p2)[0]):
        assert k1 == k2
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=3 * lr)
    # batch stats (global batch mean) must agree tightly
    for (k1, a), (k2, b) in zip(
            jax.tree_util.tree_flatten_with_path(bs1)[0],
            jax.tree_util.tree_flatten_with_path(bs2)[0]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-3, atol=1e-4)


def test_shard_batch_places_on_all_devices(rng):
    mesh = make_mesh()
    batch = {"image": rng.normal(size=(8, 4, 4, 2, 1)).astype(np.float32)}
    sharded = shard_batch(mesh, batch)
    assert len(sharded["image"].sharding.device_set) == 8


def test_graft_dryrun_multichip():
    import __graft_entry__
    __graft_entry__.dryrun_multichip(8)


def test_sharded_sliding_window_matches_single_device(rng):
    from vs_seg.infer.sharded import sliding_window_inference_sharded
    from vs_seg.infer.sliding_window import sliding_window_inference

    def toy(wins):
        a = wins * 2.0 + 1.0
        b = jnp.cumsum(wins, axis=1) * 0.1
        return jnp.concatenate([a, b], axis=-1)

    volume = rng.normal(size=(20, 14, 12, 1)).astype(np.float32)
    roi = (8, 8, 8)
    ref = sliding_window_inference(volume, roi, toy, sw_batch_size=2)
    mesh = make_mesh()
    out = sliding_window_inference_sharded(volume, roi, toy, mesh,
                                           sw_batch_size=1)
    assert out.shape == ref.shape
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)


def test_sharded_sliding_window_dfirst(rng):
    from vs_seg.infer.sharded import sliding_window_inference_sharded
    from vs_seg.infer.sliding_window import sliding_window_inference

    def toy_hwdc(wins):
        return jnp.concatenate([wins * 3.0, wins - 1.0], axis=-1)

    volume = rng.normal(size=(18, 13, 10, 1)).astype(np.float32)
    roi = (8, 8, 8)
    ref = sliding_window_inference(volume, roi, toy_hwdc, sw_batch_size=2)
    mesh = make_mesh()
    out = sliding_window_inference_sharded(
        volume, roi, toy_hwdc, mesh, sw_batch_size=1,
        predictor_layout="dfirst")  # elementwise toy is layout-agnostic
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)


def test_sharded_program_cache_releases_dropped_predictors(rng):
    """The sharded window-program cache must not pin predictors (and their
    captured params) after the caller drops them (ADVICE r2)."""
    import gc
    from vs_seg.infer import sharded
    from vs_seg.infer.sharded import sliding_window_inference_sharded

    volume = rng.normal(size=(12, 10, 8, 1)).astype(np.float32)
    mesh = make_mesh()

    def run_once():
        def toy(wins):
            return wins * 2.0
        sliding_window_inference_sharded(volume, (8, 8, 8), toy, mesh,
                                         sw_batch_size=1)
        return toy

    before = len(sharded._PROGRAMS)
    toy = run_once()
    assert len(sharded._PROGRAMS) == before + 1
    # same predictor again: cache hit, no new entry
    sliding_window_inference_sharded(volume, (8, 8, 8), toy, mesh,
                                     sw_batch_size=1)
    assert len(sharded._PROGRAMS) == before + 1
    del toy
    gc.collect()
    assert len(sharded._PROGRAMS) == before


def test_train_step_compiles_once_on_a_one_device_mesh(rng):
    """init_state places the state with the sharding train_step returns, so
    the second step reuses the first step's executable (before, a mesh-
    sharded batch made the second step compile the whole step again)."""
    from vs_seg.train.trainer import to_device_batch, wrap_rng_data
    cfg = Config(**CFG)
    trainer = Trainer(cfg, build_model(cfg),
                      mesh=make_mesh(devices=jax.devices()[:1]))
    state = trainer.init_state()
    p, bs, opt = state["params"], state["batch_stats"], state["opt_state"]
    key = wrap_rng_data(state["rng"])
    batch = {"image": rng.normal(size=(1, 1, 16, 16, 8)).astype(np.float32),
             "label": (rng.random((1, 1, 16, 16, 8)) > 0.7).astype(
                 np.float32)}
    for _ in range(3):
        image, label = to_device_batch(batch, trainer.mesh)
        p, bs, opt, key, loss = trainer.train_step(p, bs, opt, key, image,
                                                   label)
    assert np.isfinite(float(loss))
    assert trainer.train_step._cache_size() == 1

