from vs_seg.models.unet2d5_spvpa import UNet2d5_spvPA
from vs_seg.models.unet2d5 import UNet2d5
from vs_seg.models.unet import UNet


def build_model(cfg):
    """Model factory (reference params/VSparams.py:337-379)."""
    import jax.numpy as jnp
    dtype = jnp.bfloat16 if cfg.compute_dtype == "bfloat16" else jnp.float32
    if cfg.model == "UNet2d5_spvPA":
        return UNet2d5_spvPA(
            out_channels=cfg.out_channels, channels=tuple(cfg.channels),
            strides=tuple(cfg.strides), kernel_sizes=tuple(cfg.kernel_sizes),
            sample_kernel_sizes=tuple(cfg.sample_kernel_sizes),
            num_res_units=cfg.num_res_units, dropout=cfg.dropout,
            attention_module=cfg.attention, dtype=dtype,
            remat=getattr(cfg, "remat", False),
        )
    if cfg.model == "UNet2d5":
        return UNet2d5(
            out_channels=cfg.out_channels, channels=tuple(cfg.channels),
            strides=tuple(cfg.strides), kernel_sizes=tuple(cfg.kernel_sizes),
            sample_kernel_sizes=tuple(cfg.sample_kernel_sizes),
            num_res_units=cfg.num_res_units, dropout=cfg.dropout, dtype=dtype,
        )
    if cfg.model == "UNet":
        # per-dim stride tuples pass through unchanged (UNet._triple handles
        # both forms); coercing to s[0] would silently change the depth
        # downsampling of anisotropic configs
        return UNet(
            out_channels=cfg.out_channels, channels=tuple(cfg.channels),
            strides=tuple(tuple(s) if isinstance(s, (tuple, list)) else s
                          for s in cfg.strides),
            num_res_units=cfg.num_res_units, dropout=cfg.dropout, dtype=dtype,
        )
    raise ValueError(
        f"unknown cfg.model {cfg.model!r}; supported: UNet2d5_spvPA, "
        "UNet2d5, UNet")
