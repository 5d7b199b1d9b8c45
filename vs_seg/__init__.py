"""vs_seg — a JAX framework for vestibular schwannoma segmentation with the
full capabilities of the reference KCL-BMEIS/VS_Seg pipeline.

Layer map (mirrors the reference layers):
  core/        config dataclasses, results layout, logging, PRNG utilities
  parallel/    device mesh + sharding rules (data/spatial parallelism)
  data/        NIFTI IO (pure numpy), MONAI-0.4-semantics transforms, cached loader
  nn/          module system + conv / residual / attention blocks (NDHWC)
  models/      UNet2d5_spvPA and variants (pure functional: (logits, att_maps))
  losses/      hardness-weighted Dice + supervised-attention pyramid loss
  train/       jitted train step (Adam + coupled L2), loop, checkpointing
  infer/       batched sliding-window inference with Gaussian blending
  eval/        Dice metric, figures, FLOP count
  ops/         halo exchange for spatially sharded convs
  compat/      reference .pth checkpoint import
  preprocessing/  DICOM -> NIFTI toolchain (no 3D Slicer dependency)
"""

import os as _os

import jax as _jax

__version__ = "0.1.0"

# Persistent XLA compilation cache. JAX reads JAX_COMPILATION_CACHE_DIR on its
# own; only where it is unset does the cache go to a fixed directory inside
# the checkout (git-ignored), so reruns from the same checkout hit it.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache"))
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
