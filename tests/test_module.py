"""The module system (vs_seg/nn/module.py) and the layers built on it:
parameter names, shapes and init bounds, BatchNorm train/eval/fold, Dropout,
remat, and the init/apply contract."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vs_seg.nn.blocks import AttentionBlock1, Convolution, ResidualUnit
from vs_seg.nn.layers import BatchNorm, Conv3d, ConvTranspose3d, Dropout, PReLU
from vs_seg.nn.module import Module, remat


def shapes(tree):
    return {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


X = jnp.ones((2, 4, 8, 8, 3), jnp.float32)  # (B, D, H, W, C)


@pytest.mark.parametrize("module,args,params,stats", [
    (Conv3d(5, (3, 3, 1)), (X,),
     {"['bias']": (5,), "['kernel']": (3, 3, 1, 3, 5)}, {}),
    (Conv3d(5, (1, 1, 1), use_bias=False), (X,),
     {"['kernel']": (1, 1, 1, 3, 5)}, {}),
    (ConvTranspose3d(4, (3, 3, 3), (2, 2, 2)), (X,),
     {"['bias']": (4,), "['kernel']": (3, 3, 3, 3, 4)}, {}),
    (BatchNorm(), (X, True),
     {"['bias']": (3,), "['scale']": (3,)},
     {"['mean']": (3,), "['var']": (3,)}),
    (PReLU(), (X,), {"['alpha']": (1,)}, {}),
    (Convolution(6, (3, 3, 3), dropout=0.1), (X, True),
     {"['act']['alpha']": (1,), "['conv']['bias']": (6,),
      "['conv']['kernel']": (3, 3, 3, 3, 6), "['norm']['bias']": (6,),
      "['norm']['scale']": (6,)},
     {"['norm']['mean']": (6,), "['norm']['var']": (6,)}),
    (ResidualUnit(6, (3, 3, 1), subunits=2), (X, False),
     {"['residual']['bias']": (6,), "['residual']['kernel']": (1, 1, 1, 3, 6),
      "['unit0']['act']['alpha']": (1,), "['unit0']['conv']['bias']": (6,),
      "['unit0']['conv']['kernel']": (3, 3, 1, 3, 6),
      "['unit0']['norm']['bias']": (6,), "['unit0']['norm']['scale']": (6,),
      "['unit1']['act']['alpha']": (1,), "['unit1']['conv']['bias']": (6,),
      "['unit1']['conv']['kernel']": (3, 3, 1, 6, 6),
      "['unit1']['norm']['bias']": (6,), "['unit1']['norm']['scale']": (6,)},
     {"['unit0']['norm']['mean']": (6,), "['unit0']['norm']['var']": (6,),
      "['unit1']['norm']['mean']": (6,), "['unit1']['norm']['var']": (6,)}),
    (AttentionBlock1((3, 3, 3)), (jnp.ones((1, 4, 8, 8, 6)),),
     {"['conv1']['conv']['bias']": (3,),
      "['conv1']['conv']['kernel']": (3, 3, 3, 6, 3),
      "['conv2']['conv']['bias']": (1,),
      "['conv2']['conv']['kernel']": (3, 3, 3, 3, 1)}, {}),
], ids=["conv3d", "conv3d_nobias", "convtranspose3d", "batchnorm", "prelu",
        "convolution", "residual_unit", "attention_block"])
def test_parameter_names_and_shapes(module, args, params, stats):
    variables = module.init({"params": jax.random.key(0),
                             "dropout": jax.random.key(1)}, *args)
    assert shapes(variables.get("params", {})) == params
    assert shapes(variables.get("batch_stats", {})) == stats


@pytest.mark.parametrize("kernel,cin,cout", [
    ((3, 3, 1), 1, 16), ((3, 3, 3), 48, 64), ((1, 1, 1), 32, 2)])
def test_conv_init_bound_is_torch_default(kernel, cin, cout):
    """torch Conv3d init: U(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in =
    Cin * prod(kernel), for kernel and bias alike."""
    x = jnp.ones((1, 3, 6, 6, cin))
    p = Conv3d(cout, kernel).init(jax.random.key(3), x)["params"]
    bound = 1.0 / np.sqrt(cin * np.prod(kernel))
    for v in (p["kernel"], p["bias"]):
        v = np.asarray(v)
        assert np.all(np.abs(v) <= bound)
    assert np.max(np.abs(np.asarray(p["kernel"]))) > 0.5 * bound


@pytest.mark.parametrize("kernel,cout", [((3, 3, 1), 16), ((3, 3, 3), 8)])
def test_conv_transpose_init_bound_uses_output_fan_in(kernel, cout):
    """torch ConvTranspose3d init: fan_in = Cout * prod(kernel)."""
    x = jnp.ones((1, 2, 4, 4, 5))
    p = ConvTranspose3d(cout, kernel, (2, 2, 1)).init(
        jax.random.key(4), x)["params"]
    bound = 1.0 / np.sqrt(cout * np.prod(kernel))
    k = np.asarray(p["kernel"])
    assert np.all(np.abs(k) <= bound) and np.max(np.abs(k)) > 0.5 * bound


def test_batchnorm_and_prelu_init_values():
    v = BatchNorm().init(jax.random.key(0), X, True)
    np.testing.assert_array_equal(v["params"]["scale"], np.ones(3))
    np.testing.assert_array_equal(v["params"]["bias"], np.zeros(3))
    np.testing.assert_array_equal(v["batch_stats"]["mean"], np.zeros(3))
    np.testing.assert_array_equal(v["batch_stats"]["var"], np.ones(3))
    a = PReLU().init(jax.random.key(0), X)["params"]["alpha"]
    np.testing.assert_array_equal(a, [0.25])


def test_batchnorm_train_normalizes_and_updates_running_stats(rng):
    x = jnp.asarray(rng.normal(2.0, 3.0, size=(2, 3, 4, 5, 4)), jnp.float32)
    bn = BatchNorm()
    v = bn.init(jax.random.key(0), x, True)
    y, mut = bn.apply(v, x, True, mutable=["batch_stats"])
    xf = np.asarray(x).reshape(-1, 4)
    mean, var = xf.mean(0), xf.var(0)
    np.testing.assert_allclose(np.asarray(y).reshape(-1, 4),
                               (xf - mean) / np.sqrt(var + 1e-5),
                               rtol=1e-4, atol=1e-4)
    n = xf.shape[0]
    np.testing.assert_allclose(mut["batch_stats"]["mean"], 0.1 * mean,
                               rtol=1e-5)
    np.testing.assert_allclose(mut["batch_stats"]["var"],
                               0.9 + 0.1 * var * n / (n - 1), rtol=1e-5)


def test_batchnorm_eval_uses_running_stats(rng):
    x = jnp.asarray(rng.normal(size=(1, 2, 3, 3, 2)), jnp.float32)
    v = {"params": {"scale": jnp.array([2.0, 0.5]), "bias": jnp.array([1., -1.])},
         "batch_stats": {"mean": jnp.array([0.3, -0.2]),
                         "var": jnp.array([4.0, 0.25])}}
    y = BatchNorm().apply(v, x, False)
    ref = ((np.asarray(x) - [0.3, -0.2]) / np.sqrt(np.array([4.0, 0.25]) + 1e-5)
           * [2.0, 0.5] + [1.0, -1.0])
    np.testing.assert_allclose(np.asarray(y), ref, rtol=1e-5, atol=1e-6)


def test_batchnorm_fold_equals_applied_affine(rng):
    x = jnp.asarray(rng.normal(size=(1, 2, 3, 3, 2)), jnp.float32)
    v = {"params": {"scale": jnp.array([2.0, 0.5]), "bias": jnp.array([1., -1.])},
         "batch_stats": {"mean": jnp.array([0.3, -0.2]),
                         "var": jnp.array([4.0, 0.25])}}
    inv, shift = BatchNorm(features=2).apply(v, None, False, fold=True)
    np.testing.assert_allclose(np.asarray(x * inv + shift),
                               np.asarray(BatchNorm().apply(v, x, False)),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="eval-only"):
        BatchNorm(features=2).apply(v, None, True, fold=True)


def test_batchnorm_train_without_mutable_collection_raises():
    v = BatchNorm().init(jax.random.key(0), X, True)
    with pytest.raises(ValueError, match="immutable"):
        BatchNorm().apply(v, X, True)


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.8])
def test_dropout_keep_rate_and_scaling(rate):
    x = jnp.ones((200, 100), jnp.float32)
    y = np.asarray(Dropout(rate).apply({}, x, True,
                                       rngs={"dropout": jax.random.key(2)}))
    kept = y != 0
    assert abs(1.0 - kept.mean() - rate) < 0.02
    keep = round((1.0 - rate) * 65536) / 65536
    np.testing.assert_allclose(y[kept], 1.0 / keep, rtol=1e-6)


def test_dropout_is_identity_in_eval_and_at_rate_zero():
    x = jnp.arange(12.0).reshape(3, 4)
    np.testing.assert_array_equal(Dropout(0.5).apply({}, x, False), x)
    np.testing.assert_array_equal(
        Dropout(0.0).apply({}, x, True, rngs={"dropout": jax.random.key(0)}), x)


def test_dropout_masks_follow_the_key_and_the_module_path():
    x = jnp.ones((64, 64))
    run = lambda k: np.asarray(Dropout(0.5).apply(  # noqa: E731
        {}, x, True, rngs={"dropout": jax.random.key(k)}))
    np.testing.assert_array_equal(run(1), run(1))
    assert not np.array_equal(run(1), run(2))

    class Two(Module):
        def __call__(self, x):
            return (Dropout(0.5, name="a")(x, True),
                    Dropout(0.5, name="b")(x, True))

    a, b = Two().apply({}, x, rngs={"dropout": jax.random.key(1)})
    assert not np.array_equal(np.asarray(a), np.asarray(b))


def test_dropout_without_rng_stream_raises():
    with pytest.raises(KeyError, match="dropout"):
        Dropout(0.5).apply({}, jnp.ones(4), True)


def test_remat_changes_neither_outputs_nor_gradients(rng):
    """remat(cls) recomputes the block in the backward pass with the same
    parameters, batch stats and dropout keys: same loss, same gradients,
    same batch-stat updates."""
    from vs_seg.models import UNet2d5_spvPA
    cfg = dict(channels=(4, 8, 12), strides=((2, 2, 1), (2, 2, 2)),
               kernel_sizes=((3, 3, 1), (3, 3, 3), (3, 3, 3)),
               sample_kernel_sizes=((3, 3, 1), (3, 3, 3)), dropout=0.1,
               dtype=jnp.float32)
    x = jnp.asarray(rng.normal(size=(1, 4, 16, 16, 1)), jnp.float32)
    plain, rematted = UNet2d5_spvPA(**cfg), UNet2d5_spvPA(remat=True, **cfg)
    v = plain.init(jax.random.key(0), x, train=False)

    def loss(model, params):
        (logits, atts), mut = model.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, x,
            train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.key(5)})
        return jnp.sum(logits ** 2) + sum(jnp.sum(a) for a in atts), mut

    (l0, m0), g0 = jax.value_and_grad(lambda p: loss(plain, p),
                                      has_aux=True)(v["params"])
    (l1, m1), g1 = jax.value_and_grad(lambda p: loss(rematted, p),
                                      has_aux=True)(v["params"])
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves((g1, m1)),
                    jax.tree_util.tree_leaves((g0, m0))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)


def test_remat_class_keeps_the_dataclass_and_the_name():
    cls = remat(Convolution)
    m = cls(8, (3, 3, 1), name="down")
    assert issubclass(cls, Convolution) and cls.__name__ == "Convolution"
    assert (m.features, m.kernel_size, m.name) == (8, (3, 3, 1), "down")


def test_init_is_deterministic_and_depends_on_the_path():
    a = Conv3d(4, (3, 3, 1)).init(jax.random.key(0), X)
    b = Conv3d(4, (3, 3, 1)).init(jax.random.key(0), X)
    c = Conv3d(4, (3, 3, 1)).init(jax.random.key(1), X)
    np.testing.assert_array_equal(a["params"]["kernel"], b["params"]["kernel"])
    assert not np.array_equal(a["params"]["kernel"], c["params"]["kernel"])

    class Pair(Module):
        def __call__(self, x):
            return (Conv3d(4, (3, 3, 1), name="p")(x),
                    Conv3d(4, (3, 3, 1), name="q")(x))

    p = Pair().init(jax.random.key(0), X)["params"]
    assert not np.array_equal(p["p"]["kernel"], p["q"]["kernel"])


def test_unnamed_submodules_are_numbered_per_class():
    class Net(Module):
        def __call__(self, x):
            return PReLU()(Conv3d(3, (1, 1, 1))(Conv3d(3, (1, 1, 1))(x)))

    p = Net().init(jax.random.key(0), X)["params"]
    assert sorted(p) == ["Conv3d_0", "Conv3d_1", "PReLU_0"]


def test_duplicate_submodule_names_raise():
    class Net(Module):
        def __call__(self, x):
            return Conv3d(3, (1, 1, 1), name="c")(Conv3d(3, (1, 1, 1),
                                                         name="c")(x))

    with pytest.raises(ValueError, match="two submodules named 'c'"):
        Net().init(jax.random.key(0), X)


def test_calling_a_module_outside_init_or_apply_raises():
    with pytest.raises(RuntimeError, match="init/apply"):
        PReLU()(X)


def test_apply_with_missing_parameter_raises():
    with pytest.raises(KeyError, match="kernel"):
        Conv3d(4, (1, 1, 1)).apply({"params": {}}, X)


def test_apply_does_not_mutate_the_variables_passed_in(rng):
    x = jnp.asarray(rng.normal(size=(2, 2, 3, 3, 3)), jnp.float32)
    v = BatchNorm().init(jax.random.key(0), x, True)
    before = {k: np.asarray(a) for k, a in v["batch_stats"].items()}
    _, mut = BatchNorm().apply(v, x, True, mutable="batch_stats")
    for k, a in before.items():
        np.testing.assert_array_equal(v["batch_stats"][k], a)
    assert not np.array_equal(mut["batch_stats"]["mean"], before["mean"])


def test_apply_mutable_true_returns_every_collection():
    v = Convolution(4, (3, 3, 1)).init(jax.random.key(0), X, True)
    _, mut = Convolution(4, (3, 3, 1)).apply(v, X, True, mutable=True)
    assert set(mut) == {"params", "batch_stats"}


def test_variables_property_is_the_module_subtree():
    seen = {}

    class Probe(Module):
        def __call__(self, x):
            y = Conv3d(2, (1, 1, 1), name="c")(x)
            seen.update(self.variables["params"])
            return y

    Probe().init(jax.random.key(0), X)
    assert list(seen) == ["c"] and set(seen["c"]) == {"kernel", "bias"}


def test_modules_are_dataclasses_with_a_trailing_name_field():
    m = ResidualUnit(8, (3, 3, 3), (2, 2, 2), 3, name="down_1")
    assert (m.features, m.strides, m.subunits, m.name) == (
        8, (2, 2, 2), 3, "down_1")
    assert Conv3d(4, (1, 1, 1)).name is None
