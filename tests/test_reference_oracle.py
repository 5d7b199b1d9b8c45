"""Golden parity against the REFERENCE'S OWN source.

Imports params/networks/nets/unet2d5_spvPA.py and params/losses/dice_spvPA.py
of a reference checkout (the `reference_src` fixture; skipped without one) under the MONAI-0.4 shim (tests/monai_shim.py) and
pins our JAX model + converter + loss against them. This closes the
common-mode-risk gap of validating only against the hand-written replica
(tests/torch_replica.py): if both the replica and the JAX port misread the
reference recursion (unet2d5_spvPA.py:56-93), these tests still fail.
"""

import jax

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_model import SMALL
from tests.torch_replica import TorchUNet2d5_spvPA
from vs_seg.compat.torch_import import import_unet2d5_spvpa
from vs_seg.losses.dice import dice_spvpa_loss
from vs_seg.models import UNet2d5_spvPA

RefDiceSpvPA = RefUNet2d5_spvPA = None


@pytest.fixture(autouse=True, scope="module")
def _reference_classes(reference_src):
    global RefDiceSpvPA, RefUNet2d5_spvPA
    from params.losses.dice_spvPA import Dice_spvPA as RefDiceSpvPA
    from params.networks.nets.unet2d5_spvPA import (
        UNet2d5_spvPA as RefUNet2d5_spvPA,
    )


def _build_reference_model(attention=True):
    torch.manual_seed(0)
    model = RefUNet2d5_spvPA(
        dimensions=3, in_channels=1, out_channels=2,
        channels=SMALL["channels"], strides=SMALL["strides"],
        kernel_sizes=SMALL["kernel_sizes"],
        sample_kernel_sizes=SMALL["sample_kernel_sizes"],
        num_res_units=2, norm="batch", dropout=0.1,
        attention_module=attention)
    model.eval()
    return model


def test_reference_state_dict_names_match_replica():
    """The replica must produce byte-identical parameter naming/shapes to the
    reference network — otherwise every converter test was self-referential."""
    ref = _build_reference_model()
    rep = TorchUNet2d5_spvPA(1, 2, SMALL["channels"], SMALL["strides"],
                             SMALL["kernel_sizes"], SMALL["sample_kernel_sizes"],
                             num_res_units=2, dropout=0.1, attention=True)
    ref_sd = ref.state_dict()
    rep_sd = rep.state_dict()
    assert list(ref_sd.keys()) == list(rep_sd.keys())
    for k in ref_sd:
        assert tuple(ref_sd[k].shape) == tuple(rep_sd[k].shape), k


def test_jax_model_matches_reference_source():
    """Reference-source weights -> converter -> our model: logits and all
    attention maps must match the reference's own forward pass."""
    ref = _build_reference_model()
    x = torch.randn(2, 1, 16, 16, 8)
    with torch.no_grad():
        ref_logits, ref_atts = ref(x)

    params, stats = import_unet2d5_spvpa(
        {k: v.clone() for k, v in ref.state_dict().items()},
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
    for ours, theirs in zip(att_maps, ref_atts):
        np.testing.assert_allclose(
            np.asarray(ours), theirs.detach().numpy().transpose(0, 4, 2, 3, 1),
            atol=5e-4, rtol=1e-3)


def test_loss_matches_reference_source():
    """Our composite spvPA loss vs the reference's own Dice_spvPA on the
    reference model's outputs (supervised attention + non-detached hardness)."""
    ref = _build_reference_model()
    x = torch.randn(2, 1, 16, 16, 8)
    g = torch.Generator().manual_seed(1)
    target = (torch.rand(2, 1, 16, 16, 8, generator=g) > 0.7).float()
    with torch.no_grad():
        logits, atts = ref(x)
        ref_loss = RefDiceSpvPA(to_onehot_y=True, softmax=True,
                                supervised_attention=True,
                                hardness_weighting=True)((logits, atts), target)

    ours = dice_spvpa_loss(
        jnp.asarray(logits.numpy().transpose(0, 4, 2, 3, 1)),
        tuple(jnp.asarray(a.detach().numpy().transpose(0, 4, 2, 3, 1))
              for a in atts),
        jnp.asarray(target.numpy().transpose(0, 4, 2, 3, 1)),
        supervised_attention=True, hardness_weighting=True)
    np.testing.assert_allclose(float(ours), float(ref_loss), atol=2e-5, rtol=1e-5)


def test_loss_matches_reference_source_flag_combos():
    ref = _build_reference_model()
    x = torch.randn(1, 1, 16, 16, 8)
    g = torch.Generator().manual_seed(2)
    target = (torch.rand(1, 1, 16, 16, 8, generator=g) > 0.6).float()
    with torch.no_grad():
        logits, atts = ref(x)
    for att, hard in [(True, False), (False, True), (False, False)]:
        with torch.no_grad():
            ref_loss = RefDiceSpvPA(to_onehot_y=True, softmax=True,
                                    supervised_attention=att,
                                    hardness_weighting=hard)((logits, atts), target)
        ours = dice_spvpa_loss(
            jnp.asarray(logits.numpy().transpose(0, 4, 2, 3, 1)),
            tuple(jnp.asarray(a.detach().numpy().transpose(0, 4, 2, 3, 1))
                  for a in atts),
            jnp.asarray(target.numpy().transpose(0, 4, 2, 3, 1)),
            supervised_attention=att, hardness_weighting=hard)
        np.testing.assert_allclose(float(ours), float(ref_loss),
                                   atol=2e-5, rtol=1e-5, err_msg=f"{att=} {hard=}")


def test_loss_gradients_match_reference_source():
    """d(loss)/d(logits) and d(loss)/d(att_maps) vs torch autograd through the
    REFERENCE'S OWN Dice_spvPA. This is the only test that can catch a wrong
    detach: the hardness weight w = 0.6|softmax(x) - onehot(y)| + 0.4 is NOT
    detached in the reference (dice_spvPA.py:279-283) — gradients flow
    through it, which loss-VALUE parity can never observe."""
    ref = _build_reference_model()
    x = torch.randn(1, 1, 16, 16, 8)
    g = torch.Generator().manual_seed(3)
    target = (torch.rand(1, 1, 16, 16, 8, generator=g) > 0.7).float()
    with torch.no_grad():
        logits0, atts0 = ref(x)

    logits_t = logits0.clone().requires_grad_(True)
    atts_t = [a.detach().clone().requires_grad_(True) for a in atts0]
    loss_t = RefDiceSpvPA(to_onehot_y=True, softmax=True,
                          supervised_attention=True,
                          hardness_weighting=True)((logits_t, atts_t), target)
    loss_t.backward()

    def ours(logits_j, atts_j):
        return dice_spvpa_loss(logits_j, tuple(atts_j),
                               jnp.asarray(target.numpy().transpose(0, 4, 2, 3, 1)),
                               supervised_attention=True,
                               hardness_weighting=True)

    glogits, gatts = jax.grad(ours, argnums=(0, 1))(
        jnp.asarray(logits0.numpy().transpose(0, 4, 2, 3, 1)),
        [jnp.asarray(a.detach().numpy().transpose(0, 4, 2, 3, 1))
         for a in atts0])

    np.testing.assert_allclose(
        np.asarray(glogits), logits_t.grad.numpy().transpose(0, 4, 2, 3, 1),
        atol=2e-6, rtol=1e-4)
    for k, (gj, at) in enumerate(zip(gatts, atts_t)):
        np.testing.assert_allclose(
            np.asarray(gj), at.grad.numpy().transpose(0, 4, 2, 3, 1),
            atol=2e-6, rtol=1e-4, err_msg=f"att map {k}")


def test_training_gradients_match_reference_source():
    """FULL-NETWORK training-mode gradient parity: d(loss)/d(params) of our
    jitted train semantics vs torch autograd through the reference's own
    model+loss source (train-mode BatchNorm, attention hooks, residuals,
    transpose convs — dropout 0 for determinism). The torch gradients are
    mapped through the same converter as the weights, so every parameter is
    compared in our tree layout."""
    torch.manual_seed(0)
    ref = RefUNet2d5_spvPA(
        dimensions=3, in_channels=1, out_channels=2,
        channels=SMALL["channels"], strides=SMALL["strides"],
        kernel_sizes=SMALL["kernel_sizes"],
        sample_kernel_sizes=SMALL["sample_kernel_sizes"],
        num_res_units=2, norm="batch", dropout=0.0, attention_module=True)
    ref.train()
    x = torch.randn(2, 1, 16, 16, 8)
    g = torch.Generator().manual_seed(4)
    target = (torch.rand(2, 1, 16, 16, 8, generator=g) > 0.7).float()

    params_np, stats_np = import_unet2d5_spvpa(
        {k: v.detach().clone() for k, v in ref.state_dict().items()},
        channels=SMALL["channels"], num_res_units=2, attention=True)

    out = ref(x)
    loss_t = RefDiceSpvPA(to_onehot_y=True, softmax=True,
                          supervised_attention=True,
                          hardness_weighting=True)(out, target)
    loss_t.backward()

    # run the torch GRADIENTS through the same (linear) mapping as weights;
    # buffers (running stats) pass through as themselves and are ignored
    named = dict(ref.named_parameters())
    grad_like = {k: (named[k].grad if k in named and named[k].grad is not None
                     else v)
                 for k, v in ref.state_dict().items()}
    gref, _ = import_unet2d5_spvpa(grad_like, channels=SMALL["channels"],
                                   num_res_units=2, attention=True)

    model = UNet2d5_spvPA(
        out_channels=2, channels=SMALL["channels"], strides=SMALL["strides"],
        kernel_sizes=SMALL["kernel_sizes"],
        sample_kernel_sizes=SMALL["sample_kernel_sizes"],
        num_res_units=2, dropout=0.0, attention_module=True,
        dtype=jnp.float32)
    xj = jnp.asarray(x.numpy().transpose(0, 4, 2, 3, 1))
    tj = jnp.asarray(target.numpy().transpose(0, 4, 2, 3, 1))

    def loss_fn(p):
        outj, _ = model.apply({"params": p, "batch_stats": stats_np}, xj,
                              train=True, mutable=["batch_stats"],
                              rngs={"dropout": jax.random.key(0)})
        logits, atts = outj
        return dice_spvpa_loss(logits, atts, tj, supervised_attention=True,
                               hardness_weighting=True)

    gours = jax.grad(loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, params_np))

    paths_ref, _ = jax.tree_util.tree_flatten_with_path(gref)
    paths_ours, _ = jax.tree_util.tree_flatten_with_path(gours)
    assert len(paths_ref) == len(paths_ours)
    ref_map = {jax.tree_util.keystr(p): np.asarray(v) for p, v in paths_ref}
    for p, v in paths_ours:
        key = jax.tree_util.keystr(p)
        rv = ref_map[key]
        # conv biases directly followed by train-mode BN have EXACTLY zero
        # gradient (BN subtracts the mean); both sides produce ~1e-8 float
        # noise there, so the absolute floor must sit above it
        scale = max(float(np.abs(rv).max()), 1e-8)
        np.testing.assert_allclose(np.asarray(v), rv, atol=2e-5 * scale + 1e-6,
                                   rtol=2e-4, err_msg=key)
