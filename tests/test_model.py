import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.torch_replica import TorchUNet2d5_spvPA
from vs_seg.compat.torch_import import import_unet2d5_spvpa
from vs_seg.models import UNet2d5_spvPA

SMALL = dict(
    channels=(4, 8, 12, 16),
    strides=((2, 2, 1), (2, 2, 2), (2, 2, 2)),
    kernel_sizes=((3, 3, 1), (3, 3, 3), (3, 3, 3), (3, 3, 3)),
    sample_kernel_sizes=((3, 3, 1), (3, 3, 3), (3, 3, 3)),
)


def test_model_shapes_and_attmap_pyramid():
    model = UNet2d5_spvPA(out_channels=2, num_res_units=2, dropout=0.1,
                          attention_module=True, dtype=jnp.float32, **SMALL)
    x = jnp.zeros((1, 8, 16, 16, 1))  # (B, D, H, W, C)
    variables = model.init({"params": jax.random.key(0), "dropout": jax.random.key(1)},
                           x, train=False)
    logits, att_maps = model.apply(variables, x, train=False)
    assert logits.shape == (1, 8, 16, 16, 2)
    assert len(att_maps) == len(SMALL["channels"])
    # coarsest -> finest, each a single-channel (B, D, H, W, 1) map;
    # strides (2,2,1),(2,2,2),(2,2,2) in (H,W,D) order
    expected = [(1, 2, 2, 2, 1), (1, 4, 4, 4, 1), (1, 8, 8, 8, 1), (1, 8, 16, 16, 1)]
    assert [tuple(a.shape) for a in att_maps] == expected


def test_model_matches_torch_replica_eval():
    """Golden end-to-end parity: random torch reference-replica weights ->
    converter -> our model; logits and all attention maps must match."""
    torch.manual_seed(0)
    tmodel = TorchUNet2d5_spvPA(1, 2, SMALL["channels"], SMALL["strides"],
                                SMALL["kernel_sizes"], SMALL["sample_kernel_sizes"],
                                num_res_units=2, dropout=0.1, attention=True)
    tmodel.eval()
    x = torch.randn(2, 1, 16, 16, 8)
    with torch.no_grad():
        ref_logits, ref_atts = tmodel(x)

    params, stats = import_unet2d5_spvpa(
        {k: v.clone() for k, v in tmodel.state_dict().items()},
        channels=SMALL["channels"], num_res_units=2, attention=True)

    model = UNet2d5_spvPA(out_channels=2, num_res_units=2, dropout=0.1,
                          attention_module=True, dtype=jnp.float32, **SMALL)
    variables = {"params": params, "batch_stats": stats}
    xj = jnp.asarray(x.numpy().transpose(0, 4, 2, 3, 1).copy())
    logits, att_maps = model.apply(variables, xj, train=False)

    np.testing.assert_allclose(
        np.asarray(logits), ref_logits.numpy().transpose(0, 4, 2, 3, 1),
        atol=5e-4, rtol=1e-3)
    assert len(att_maps) == len(ref_atts)
    for ours, ref in zip(att_maps, ref_atts):
        np.testing.assert_allclose(
            np.asarray(ours), ref.numpy().transpose(0, 4, 2, 3, 1),
            atol=5e-4, rtol=1e-3)


def test_converted_tree_structure_matches_init():
    """Converter output must exactly match the model init tree (no orphans)."""
    torch.manual_seed(1)
    tmodel = TorchUNet2d5_spvPA(1, 2, SMALL["channels"], SMALL["strides"],
                                SMALL["kernel_sizes"], SMALL["sample_kernel_sizes"])
    params, stats = import_unet2d5_spvpa(tmodel.state_dict(),
                                         channels=SMALL["channels"])
    model = UNet2d5_spvPA(out_channels=2, dtype=jnp.float32, **SMALL)
    variables = model.init({"params": jax.random.key(0), "dropout": jax.random.key(1)},
                           jnp.zeros((1, 8, 16, 16, 1)), train=False)

    def paths(tree):
        return {jax.tree_util.keystr(p): v.shape
                for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    assert paths(variables["params"]) == paths(params)
    assert paths(variables["batch_stats"]) == paths(stats)


def test_no_attention_variant():
    model = UNet2d5_spvPA(out_channels=2, attention_module=False,
                          dtype=jnp.float32, **SMALL)
    x = jnp.zeros((1, 8, 16, 16, 1))
    variables = model.init({"params": jax.random.key(0), "dropout": jax.random.key(1)},
                           x, train=False)
    logits, att_maps = model.apply(variables, x, train=False)
    assert logits.shape == (1, 8, 16, 16, 2)
    assert att_maps == ()


def test_converter_full_default_architecture(tmp_path):
    """Full 6-level default config (reference params/VSparams.py:343-374):
    converter tree must exactly match the model init, and the .pth file path in
    VS_inference.load_model_state must work."""
    torch.manual_seed(3)
    full = dict(
        channels=(16, 32, 48, 64, 80, 96),
        strides=((2, 2, 1), (2, 2, 1), (2, 2, 2), (2, 2, 2), (2, 2, 2)),
        kernel_sizes=((3, 3, 1), (3, 3, 1), (3, 3, 3), (3, 3, 3), (3, 3, 3), (3, 3, 3)),
        sample_kernel_sizes=((3, 3, 1), (3, 3, 1), (3, 3, 3), (3, 3, 3), (3, 3, 3)),
    )
    tmodel = TorchUNet2d5_spvPA(1, 2, full["channels"], full["strides"],
                                full["kernel_sizes"], full["sample_kernel_sizes"],
                                num_res_units=2, dropout=0.1, attention=True)
    pth = str(tmp_path / "best_metric_model.pth")
    torch.save(tmodel.state_dict(), pth)

    from vs_seg.compat.torch_import import import_unet2d5_spvpa, load_pth
    params, stats = import_unet2d5_spvpa(load_pth(pth))

    from vs_seg.train.trainer import init_model
    model = UNet2d5_spvPA(out_channels=2, num_res_units=2, dropout=0.1,
                          attention_module=True, dtype=jnp.float32, **full)
    variables = init_model(model, 0)

    def paths(tree):
        return {jax.tree_util.keystr(p): v.shape
                for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    assert paths(variables["params"]) == paths(params)
    assert paths(variables["batch_stats"]) == paths(stats)
    # param count sanity: must match the torch model exactly
    n_torch = sum(v.numel() for v in tmodel.state_dict().values()
                  if "running_" not in str(v.shape) or True) - \
        sum(v.numel() for k, v in tmodel.state_dict().items()
            if "running_" in k or "num_batches" in k)
    import numpy as _np
    n_ours = sum(_np.prod(v.shape) for v in
                 jax.tree_util.tree_leaves(params))
    assert int(n_ours) == int(n_torch)


def test_convert_checkpoint_cli(tmp_path):
    torch.manual_seed(4)
    full = dict(
        channels=(16, 32, 48, 64, 80, 96),
        strides=((2, 2, 1), (2, 2, 1), (2, 2, 2), (2, 2, 2), (2, 2, 2)),
        kernel_sizes=((3, 3, 1), (3, 3, 1), (3, 3, 3), (3, 3, 3), (3, 3, 3), (3, 3, 3)),
        sample_kernel_sizes=((3, 3, 1), (3, 3, 1), (3, 3, 3), (3, 3, 3), (3, 3, 3)),
    )
    tmodel = TorchUNet2d5_spvPA(1, 2, full["channels"], full["strides"],
                                full["kernel_sizes"], full["sample_kernel_sizes"])
    pth = str(tmp_path / "m.pth")
    torch.save(tmodel.state_dict(), pth)
    dst = str(tmp_path / "m.ckpt")
    from vs_seg.compat.convert_checkpoint import main as convert_main
    convert_main([pth, dst])
    from vs_seg.train.checkpoint import load_checkpoint
    state = load_checkpoint(dst)
    assert "params" in state and "batch_stats" in state


def test_build_model_factory_variants():
    """All three shipped model classes are reachable from config."""
    from vs_seg.core.config import Config
    from vs_seg.models import build_model
    from vs_seg.models.unet import UNet
    from vs_seg.models.unet2d5 import UNet2d5
    from vs_seg.models.unet2d5_spvpa import UNet2d5_spvPA
    import pytest
    base = dict(channels=(4, 8, 12), strides=((2, 2, 1), (2, 2, 2)),
                kernel_sizes=((3, 3, 1), (3, 3, 3), (3, 3, 3)),
                sample_kernel_sizes=((3, 3, 1), (3, 3, 3)))
    assert isinstance(build_model(Config(**base)), UNet2d5_spvPA)
    assert isinstance(build_model(Config(model="UNet2d5", **base)), UNet2d5)
    assert isinstance(build_model(Config(model="UNet", **base)), UNet)
    with pytest.raises(ValueError, match="unknown cfg.model"):
        build_model(Config(model="nope", **base))


def test_alt_models_train_one_step(rng):
    """UNet2d5 and UNet (non-tuple outputs) run a full train step."""
    import jax.numpy as jnp
    import jax.random as jrandom
    from vs_seg.core.config import Config
    from vs_seg.models import build_model
    from vs_seg.train.trainer import Trainer, wrap_rng_data
    for name in ("UNet2d5", "UNet"):
        cfg = Config(model=name, compute_dtype="float32", attention=False,
                     channels=(4, 8, 12), strides=((2, 2, 1), (2, 2, 2)),
                     kernel_sizes=((3, 3, 1), (3, 3, 3), (3, 3, 3)),
                     sample_kernel_sizes=((3, 3, 1), (3, 3, 3)))
        model = build_model(cfg)
        if name == "UNet":
            # per-dim stride tuples must pass through unchanged (coercing to
            # s[0] would silently change the depth downsampling, ADVICE r2)
            assert model.strides == ((2, 2, 1), (2, 2, 2))
        trainer = Trainer(cfg, model)
        state = trainer.init_state()
        image = jnp.asarray(rng.normal(size=(1, 4, 16, 16, 1)), jnp.float32)
        label = jnp.asarray((rng.random((1, 4, 16, 16, 1)) > 0.7), jnp.float32)
        p, bs, o, k, loss = trainer.train_step(
            state["params"], state["batch_stats"], state["opt_state"],
            wrap_rng_data(state["rng"]), image, label)
        assert jnp.isfinite(loss), (name, loss)


def test_resfold_matches_reference(monkeypatch):
    """The eval 1x1-residual fold (nn/blocks.py:_resfold_apply, VS_RESFOLD)
    must reproduce the traced reference chain exactly: the residual is the
    center tap of a zero-embedded (3,3,1) kernel concatenated onto unit0's
    conv, so the conv computes identical per-channel f32-accumulated sums.
    The (3,3,1) level-0/1 blocks of this config fold (incl. the pair-input
    decoder block); (3,3,3) levels are untouched."""
    cfg = dict(channels=(8, 16, 32), strides=((2, 2, 1), (2, 2, 2)),
               kernel_sizes=((3, 3, 1), (3, 3, 1), (3, 3, 3)),
               sample_kernel_sizes=((3, 3, 1), (3, 3, 3)))
    model = UNet2d5_spvPA(out_channels=2, num_res_units=2, dropout=None,
                          attention_module=True, dtype=jnp.float32, **cfg)
    x = jnp.asarray(np.random.default_rng(11).normal(size=(1, 8, 32, 32, 1)),
                    jnp.float32)
    variables = model.init({"params": jax.random.key(0)}, x, train=False)
    variables = jax.tree.map(
        lambda v: v + 0.1 if v.ndim == 1 else v, variables)

    monkeypatch.setenv("VS_RESFOLD", "0")
    logits_ref, atts_ref = model.apply(variables, x, train=False)
    monkeypatch.setenv("VS_RESFOLD", "1")
    logits, atts = model.apply(variables, x, train=False)

    np.testing.assert_allclose(np.asarray(logits), np.asarray(logits_ref),
                               atol=2e-5, rtol=2e-5)
    for a, r in zip(atts, atts_ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(r),
                                   atol=2e-5, rtol=2e-5)


def test_headfold_matches_reference(monkeypatch):
    """The conv-only logit head fold (nn/blocks.py:_headfold_apply,
    VS_HEADFOLD, default ON): with no norm/act in the up_0 head,
    conv0(x) + b0 + conv1x1(x) + br folds exactly into ONE conv with the
    residual center-embedded into unit0's kernel and the biases summed —
    same cin/cout/kernel, so no emitter-flip surface (unlike VS_RESFOLD).
    Reference semantics: convolutions.py:159-255 with last_conv_only at
    unet2d5_spvPA.py:174-202's top level."""
    cfg = dict(channels=(8, 16, 32), strides=((2, 2, 1), (2, 2, 2)),
               kernel_sizes=((3, 3, 1), (3, 3, 3), (3, 3, 3)),
               sample_kernel_sizes=((3, 3, 1), (3, 3, 3)))
    model = UNet2d5_spvPA(out_channels=2, num_res_units=2, dropout=None,
                          attention_module=True, dtype=jnp.float32, **cfg)
    x = jnp.asarray(np.random.default_rng(13).normal(size=(1, 8, 32, 32, 1)),
                    jnp.float32)
    variables = model.init({"params": jax.random.key(0)}, x, train=False)
    variables = jax.tree.map(
        lambda v: v + 0.1 if v.ndim == 1 else v, variables)

    monkeypatch.setenv("VS_HEADFOLD", "0")
    logits_ref, atts_ref = model.apply(variables, x, train=False)
    monkeypatch.setenv("VS_HEADFOLD", "1")
    logits, atts = model.apply(variables, x, train=False)

    np.testing.assert_allclose(np.asarray(logits), np.asarray(logits_ref),
                               atol=2e-5, rtol=2e-5)
    for a, r in zip(atts, atts_ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(r),
                                   atol=2e-5, rtol=2e-5)


def test_res331_matches_reference(monkeypatch):
    """The pair-input 1x1-residual-as-(3,3,1) rewrite (VS_RES331): wr
    center-embedded in a zero kernel computes identical values through the
    fast conv emitter (reference semantics convolutions.py:241-250)."""
    cfg = dict(channels=(8, 16, 32), strides=((2, 2, 1), (2, 2, 2)),
               kernel_sizes=((3, 3, 1), (3, 3, 1), (3, 3, 3)),
               sample_kernel_sizes=((3, 3, 1), (3, 3, 3)))
    model = UNet2d5_spvPA(out_channels=2, num_res_units=2, dropout=None,
                          attention_module=True, dtype=jnp.float32, **cfg)
    x = jnp.asarray(np.random.default_rng(17).normal(size=(1, 8, 32, 32, 1)),
                    jnp.float32)
    variables = model.init({"params": jax.random.key(0)}, x, train=False)
    variables = jax.tree.map(
        lambda v: v + 0.1 if v.ndim == 1 else v, variables)

    monkeypatch.setenv("VS_RES331", "0")
    logits_ref, atts_ref = model.apply(variables, x, train=False)
    monkeypatch.setenv("VS_RES331", "1")
    logits, atts = model.apply(variables, x, train=False)

    np.testing.assert_allclose(np.asarray(logits), np.asarray(logits_ref),
                               atol=2e-5, rtol=2e-5)
    for a, r in zip(atts, atts_ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(r),
                                   atol=2e-5, rtol=2e-5)
