"""The production models against the plain float32 reference forward
(vs_seg/reference.py): every model variant and attention flag, in float32
(tight) and in bfloat16 (the production dtype, loose)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vs_seg.models import UNet, UNet2d5, UNet2d5_spvPA
from vs_seg.reference import reference_forward

SMALL = dict(channels=(4, 8, 12, 16), strides=((2, 2, 1), (2, 2, 2), (2, 2, 2)),
             kernel_sizes=((3, 3, 1), (3, 3, 3), (3, 3, 3), (3, 3, 3)),
             sample_kernel_sizes=((3, 3, 1), (3, 3, 3), (3, 3, 3)))

MODELS = {
    "spvpa_attention": lambda dt: UNet2d5_spvPA(dtype=dt, **SMALL),
    "spvpa_no_attention": lambda dt: UNet2d5_spvPA(
        dtype=dt, attention_module=False, **SMALL),
    "spvpa_one_res_unit": lambda dt: UNet2d5_spvPA(
        dtype=dt, num_res_units=1, **SMALL),
    "unet2d5": lambda dt: UNet2d5(dtype=dt, **SMALL),
    "unet_res2": lambda dt: UNet(out_channels=2, channels=(4, 8, 12),
                                 strides=((2, 2, 1), (2, 2, 2)),
                                 num_res_units=2, dtype=dt),
    "unet_res0": lambda dt: UNet(out_channels=2, channels=(4, 8, 12),
                                 strides=(2, 2), num_res_units=0, dtype=dt),
}


def _outputs(out):
    return (out[0], *out[1]) if isinstance(out, tuple) else (out,)


def _variables(model, x):
    v = model.init(jax.random.key(0), x, train=False)
    # BN statistics off (0, 1) so the production BN folding is exercised
    return jax.tree.map(lambda a: a + 0.1 if a.ndim == 1 else a, v)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_f32_model_matches_reference(rng, name):
    model = MODELS[name](jnp.float32)
    x = jnp.asarray(rng.normal(size=(2, 8, 16, 16, 1)), jnp.float32)
    v = _variables(model, x)
    got = _outputs(model.apply(v, x, train=False))
    ref = _outputs(reference_forward(model, v, x))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bf16_model_is_close_to_f32_reference(rng, name):
    """bf16 keeps 8 significant bits; over this ~20-conv chain the logits
    stay within 2% in relative L2."""
    model = MODELS[name](jnp.bfloat16)
    x = jnp.asarray(rng.normal(size=(1, 8, 16, 16, 1)), jnp.float32)
    v = _variables(model, x)
    got = _outputs(model.apply(v, x, train=False))[0].astype(jnp.float32)
    ref = _outputs(reference_forward(model, v, x))[0]
    err = float(jnp.linalg.norm(got - ref) / jnp.linalg.norm(ref))
    assert err < 2e-2, err


@pytest.mark.parametrize("knob", ["VS_HEADFOLD", "VS_RES331", "VS_RESFOLD",
                                  "VS_WIDE_ATT"])
@pytest.mark.parametrize("value", ["0", "1"])
def test_eval_rewrites_match_reference(rng, monkeypatch, knob, value):
    """Every eval-time rewrite gate, on and off, computes the reference
    forward (kd=1 levels 0-1 so the (3,3,1)-only rewrites apply)."""
    cfg = dict(channels=(8, 16, 32), strides=((2, 2, 1), (2, 2, 2)),
               kernel_sizes=((3, 3, 1), (3, 3, 1), (3, 3, 3)),
               sample_kernel_sizes=((3, 3, 1), (3, 3, 3)))
    model = UNet2d5_spvPA(dtype=jnp.float32, **cfg)
    x = jnp.asarray(rng.normal(size=(1, 4, 16, 16, 1)), jnp.float32)
    v = _variables(model, x)
    monkeypatch.setenv(knob, value)
    got = _outputs(model.apply(v, x, train=False))
    ref = _outputs(reference_forward(model, v, x))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-5, atol=2e-5)


def test_reference_rejects_unknown_models():
    with pytest.raises(TypeError, match="no reference forward"):
        reference_forward(object(), {"params": {}}, np.zeros((1, 1, 1, 1, 1)))
