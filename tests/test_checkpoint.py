"""Checkpoint round trips through the npz container (train/checkpoint.py):
nested params and batch stats, the flattened optax state, PRNG key data of
both implementations, scalars, and the failure modes."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vs_seg.train.checkpoint import (flatten_state, load_checkpoint,
                                     restore_into, save_checkpoint)
from vs_seg.train.trainer import make_optimizer, wrap_rng_data


def _params():
    return {"down_0": {"unit0": {"conv": {"kernel": np.arange(6.0).reshape(
        1, 1, 1, 2, 3), "bias": np.ones(3)}}},
        "up_0": {"residual": {"kernel": np.full((1, 1, 1, 3, 2), 0.5)}}}


def test_nested_params_round_trip(tmp_path):
    path = str(tmp_path / "m.ckpt")
    save_checkpoint(path, {"params": _params(), "batch_stats": {
        "down_0": {"unit0": {"norm": {"mean": np.zeros(3),
                                      "var": np.ones(3)}}}}})
    got = load_checkpoint(path)
    jax.tree.map(np.testing.assert_array_equal, got["params"], _params())
    np.testing.assert_array_equal(
        got["batch_stats"]["down_0"]["unit0"]["norm"]["var"], np.ones(3))


def test_entry_names_are_slash_joined_key_paths():
    flat = flatten_state({"params": _params(), "epoch": 3})
    assert sorted(flat) == ["epoch", "params/down_0/unit0/conv/bias",
                            "params/down_0/unit0/conv/kernel",
                            "params/up_0/residual/kernel"]


def test_scalars_round_trip_with_their_values(tmp_path):
    path = str(tmp_path / "s.ckpt")
    save_checkpoint(path, {"epoch": 7, "best_metric": 0.625,
                           "best_metric_epoch": 6})
    got = load_checkpoint(path)
    assert int(got["epoch"]) == 7 and got["epoch"].shape == ()
    assert float(got["best_metric"]) == 0.625
    assert int(got["best_metric_epoch"]) == 6


def test_optimizer_state_restores_into_its_template(tmp_path):
    """The flattened Adam state (with injected hyperparameters) comes back
    with the structure optimizer.init(params) gives and the saved values."""
    params = jax.tree.map(jnp.asarray, _params())
    opt = make_optimizer(1e-3, 1e-7)
    state = opt.init(params)
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.1), params)
    _, state = opt.update(grads, state, params)
    path = str(tmp_path / "o.ckpt")
    save_checkpoint(path, {"opt_state": state})
    restored = restore_into(opt.init(params), load_checkpoint(path)["opt_state"])
    assert (jax.tree_util.tree_structure(restored)
            == jax.tree_util.tree_structure(state))
    for a, b in zip(jax.tree_util.tree_leaves(restored),
                    jax.tree_util.tree_leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # and the restored state drives another update
    updates, _ = opt.update(grads, restored, params)
    assert all(np.isfinite(np.asarray(u)).all()
               for u in jax.tree_util.tree_leaves(updates))


def test_restore_into_rejects_a_shape_mismatch():
    opt = make_optimizer(1e-3, 0.0)
    params = {"w": jnp.zeros((3,))}
    saved = jax.device_get(opt.init({"w": jnp.zeros((4,))}))
    nested = {}
    for name, v in flatten_state(saved).items():
        node = nested
        *parents, leaf = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    with pytest.raises(ValueError, match="shape"):
        restore_into(opt.init(params), nested)


@pytest.mark.parametrize("impl,words", [("rbg", 4), ("threefry2x32", 2)])
def test_prng_key_data_round_trips_and_stays_usable(tmp_path, impl, words):
    key = jax.random.key(7, impl=impl)
    path = str(tmp_path / f"{impl}.ckpt")
    save_checkpoint(path, {"rng": jax.random.key_data(key)})
    data = load_checkpoint(path)["rng"]
    assert data.shape == (words,) and data.dtype == np.uint32
    back = wrap_rng_data(data)
    np.testing.assert_array_equal(
        jax.random.bits(back, (8,)), jax.random.bits(key, (8,)))


def test_save_is_atomic_and_leaves_no_temp_file(tmp_path):
    path = str(tmp_path / "sub" / "a.ckpt")
    save_checkpoint(path, {"x": np.ones(2)})
    save_checkpoint(path, {"x": np.zeros(2)})
    assert sorted(os.listdir(tmp_path / "sub")) == ["a.ckpt"]
    np.testing.assert_array_equal(load_checkpoint(path)["x"], np.zeros(2))


def test_keys_containing_the_separator_are_refused(tmp_path):
    with pytest.raises(ValueError, match="contains"):
        save_checkpoint(str(tmp_path / "b.ckpt"), {"a/b": np.ones(1)})


def test_checkpoint_holds_no_pickled_objects(tmp_path):
    path = str(tmp_path / "c.ckpt")
    save_checkpoint(path, {"params": _params(), "epoch": 1})
    with np.load(path, allow_pickle=False) as data:
        assert all(data[k].dtype != object for k in data.files)


def test_trainer_save_and_restore_state_round_trip(tmp_path):
    """Trainer._save -> restore_state gives back params, batch stats, the
    optimizer state, the rbg key and the counters, and a step runs on it."""
    from vs_seg.core.config import Config
    from vs_seg.models import build_model
    from vs_seg.train.trainer import Trainer
    cfg = Config(compute_dtype="float32", channels=(4, 8, 12),
                 strides=((2, 2, 1), (2, 2, 2)),
                 kernel_sizes=((3, 3, 1), (3, 3, 3), (3, 3, 3)),
                 sample_kernel_sizes=((3, 3, 1), (3, 3, 3)),
                 data_root=str(tmp_path), results_folder_name="ck")
    trainer = Trainer(cfg, build_model(cfg))
    state = trainer.init_state()
    rng = wrap_rng_data(state["rng"])
    trainer._save(state["params"], state["batch_stats"], state["opt_state"],
                  rng, 4, 0.5, 3, "last.ckpt")
    got = trainer.restore_state(os.path.join(cfg.model_path, "last.ckpt"))
    assert (got["epoch"], got["best_metric"], got["best_metric_epoch"]) == (
        5, 0.5, 3)
    for a, b in zip(jax.tree_util.tree_leaves(
            (got["params"], got["batch_stats"], got["opt_state"])),
            jax.tree_util.tree_leaves(
                (state["params"], state["batch_stats"], state["opt_state"]))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(got["rng"], jax.random.key_data(rng))
    image = np.zeros((1, 4, 16, 16, 1), np.float32)
    *_, loss = trainer.train_step(got["params"], got["batch_stats"],
                                  got["opt_state"], wrap_rng_data(got["rng"]),
                                  image, image)
    assert np.isfinite(float(loss))
