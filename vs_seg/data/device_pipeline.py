"""Device-resident training pipeline: cache the (padded) training set on device
and run the random augmentations (crop + L-R flip) inside one jitted program.

Replaces the per-step host path — random crop/flip on CPU then an H2D copy
each step (reference DataLoader + .to(device), params/VSparams.py:311-318,
456) — with zero steady-state host<->device traffic: volumes upload once (in
bf16, 2x smaller), and each step's batch is gathered/cropped/flipped on the
device from the cached arrays. Semantics match the host transforms
(RandSpatialCrop random_center + RandFlipd axis 0 = H; tests pin equivalence).

Heterogeneous volume shapes (SpatialPad only enforces a LOWER bound) are
stacked by end-padding every volume to the elementwise max shape; crop starts
are drawn within each volume's true extent, so padding is never sampled. The
flip is applied to the cropped window — for a uniform crop start this is
distributionally identical to the host order (flip volume, then crop).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class DeviceCachedDataset:
    """Samples ((C, H, W, D) host dicts, e.g. CacheDataset.cache after the
    deterministic pad prefix) stacked into HBM as (N, D, H, W, C) — the
    model's global layout (nn/layers.py). `crop_shape` is reference-order
    (H, W, D) like pad_crop_shape (params/VSparams.py:77).

    `augment=False` disables the random L-R flip (validation uses the random
    crop but, like the reference val pipeline, never flips)."""

    def __init__(self, samples: Sequence[dict],
                 crop_shape: Tuple[int, int, int], image_dtype=None,
                 augment: bool = True):
        import ml_dtypes
        if image_dtype is None:
            image_dtype = ml_dtypes.bfloat16
        imgs = [np.transpose(np.asarray(s["image"], np.float32), (3, 1, 2, 0))
                for s in samples]
        lbls = [np.transpose(np.asarray(s["label"]), (3, 1, 2, 0))
                for s in samples]
        extents = np.asarray([im.shape[:3] for im in imgs], np.int32)
        max_shape = extents.max(axis=0)

        def pad_to(a):
            pad = [(0, int(m) - s) for m, s in zip(max_shape, a.shape[:3])]
            return np.pad(a, pad + [(0, 0)])

        self.images = jnp.asarray(np.stack([pad_to(a) for a in imgs])
                                  .astype(image_dtype))
        self.labels = jnp.asarray(np.stack([pad_to(a) for a in lbls])
                                  .astype(np.uint8))
        self.extents = jnp.asarray(extents)  # per-volume true (D, H, W)
        ch, cw, cd = (int(v) for v in crop_shape)
        self.crop_dhw = (cd, ch, cw)
        self.augment = bool(augment)
        for i, (D, H, W) in enumerate(extents):
            assert D >= cd and H >= ch and W >= cw, (
                f"volume {i} extent {(D, H, W)} smaller than crop "
                f"{self.crop_dhw} — SpatialPad should have padded it")

    def __len__(self) -> int:
        return int(self.images.shape[0])

    @partial(jax.jit, static_argnums=0)
    def _gather(self, images, labels, extents, idx, keys):
        cd, ch, cw = self.crop_dhw
        C = images.shape[-1]

        def one(i, key):
            kd, kh, kw, kf = jax.random.split(key, 4)
            img = images[i]
            lbl = labels[i]
            D, H, W = extents[i, 0], extents[i, 1], extents[i, 2]
            d0 = jax.random.randint(kd, (), 0, D - cd + 1)
            h0 = jax.random.randint(kh, (), 0, H - ch + 1)
            w0 = jax.random.randint(kw, (), 0, W - cw + 1)
            win = jax.lax.dynamic_slice(img, (d0, h0, w0, 0), (cd, ch, cw, C))
            lwin = jax.lax.dynamic_slice(lbl, (d0, h0, w0, 0),
                                         (cd, ch, cw, lbl.shape[-1]))
            if self.augment:
                flip = jax.random.bernoulli(kf)
                win = jax.lax.cond(flip, lambda a: jnp.flip(a, 1),
                                   lambda a: a, win)
                lwin = jax.lax.cond(flip, lambda a: jnp.flip(a, 1),
                                    lambda a: a, lwin)
            return win, lwin

        return jax.vmap(one)(idx, keys)

    def sample(self, index, key):
        """index: int or int array -> ((B, cd, ch, cw, C) image, label)."""
        idx = jnp.atleast_1d(jnp.asarray(index, jnp.int32))
        keys = jax.random.split(key, idx.shape[0])
        return self._gather(self.images, self.labels, self.extents, idx, keys)


class DeviceLoader:
    """Epoch iterable over a DeviceCachedDataset: yields (image, label)
    device tuples; every epoch draws fresh crop/flip randomness (folded
    epoch counter) and a fresh shuffle order. The final partial batch is
    yielded (torch DataLoader drop_last=False semantics); it compiles one
    extra program for its size."""

    def __init__(self, dataset: DeviceCachedDataset, batch_size: int = 1,
                 shuffle: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self):
        epoch = self._epoch
        self._epoch += 1
        n = len(self.dataset)
        order = (np.random.default_rng([self.seed, epoch]).permutation(n)
                 if self.shuffle else np.arange(n))
        key = jax.random.fold_in(jax.random.key(self.seed), epoch)
        for b in range(len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            key, sub = jax.random.split(key)
            yield self.dataset.sample(idx, sub)
