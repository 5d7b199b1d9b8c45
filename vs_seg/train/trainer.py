"""Training loop: jitted train/eval steps + the reference loop semantics.

Replaces reference run_training_algorithm (params/VSparams.py:410-528):
  - per-step forward+loss+backward+Adam as ONE jitted XLA program (the
    reference re-launches separate cuDNN kernels per op)
  - Adam with torch-style coupled L2 weight decay (reference VSparams.py:390:
    torch.optim.Adam(weight_decay=1e-7)) = add_decayed_weights before adam
  - validation every `val_interval` epochs with loss + hard Dice
  - best-on-validation checkpoint + last-epoch checkpoint (full state)
  - LR divided by `lr_divisor` every `epochs_with_const_lr` epochs
  - first-epochs wall-clock ETA log, TB scalars, loss/Dice curves

Data parallel: batches are sharded over the mesh `data` axis; jit/GSPMD insert
the gradient reductions (the reference is single-GPU, SURVEY.md §2.4).
"""

from __future__ import annotations

import logging
import os
import time

from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from vs_seg.eval.metrics import dice_score
from vs_seg.losses import dice_spvpa_loss
from vs_seg.parallel.mesh import batch_sharding, make_mesh, replicated_sharding
from vs_seg.train.checkpoint import save_checkpoint


# PRNG for the training loop (dropout masks). "rbg" draws bits with XLA's
# RngBitGenerator instead of threefry hashing: same Bernoulli distribution,
# not bit-identical streams. Which is faster on the GPU has not been
# measured. Parameter INITIALIZATION keeps the default threefry keys
# (init_model).
RNG_IMPL = "rbg"


def wrap_rng_data(data):
    """Inverse of jax.random.key_data, inferring the impl from the data shape
    (old checkpoints stored 2-word threefry keys; rbg keys are 4 words)."""
    data = jnp.asarray(data)
    impl = "rbg" if data.shape[-1] == 4 else "threefry2x32"
    return jax.random.wrap_key_data(data, impl=impl)


def make_optimizer(learning_rate: float, weight_decay: float):
    """torch.optim.Adam(lr, weight_decay) semantics: coupled L2 (decay added to
    the gradient before the Adam moments), eps=1e-8, betas=(0.9, 0.999).

    optax.flatten runs the elementwise update on one concatenated vector:
    numerically identical, with one fused update instead of one per
    parameter tensor (~190 at reference scale)."""
    return optax.flatten(optax.inject_hyperparams(
        lambda learning_rate: optax.chain(
            optax.add_decayed_weights(weight_decay),
            optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8),
            optax.scale(-1.0),
            optax.scale(learning_rate),
        ))(learning_rate=learning_rate))


def minimal_input_shape(model, in_channels: int = 1):
    """Smallest spatial shape the model accepts (product of per-dim strides).

    Parameter shapes are independent of spatial extent, so initializing at
    this size avoids tracing/compiling the full-volume forward just to get
    params.
    """
    import numpy as np
    strides = np.asarray([list(s) if isinstance(s, (tuple, list)) else [s] * 3
                          for s in model.strides])  # UNet uses scalar strides
    h, w, d = (int(v) for v in np.prod(strides, axis=0))  # strides are (H, W, D)
    return (1, d, h, w, in_channels)  # model layout is (B, D, H, W, C)


def init_model(model, rng, input_shape=None) -> Dict[str, Any]:
    p_key, d_key = jax.random.split(jax.random.key(rng) if isinstance(rng, int) else rng)
    if input_shape is None:
        input_shape = minimal_input_shape(model)
    return jax.jit(model.init, static_argnames=("train",))(
        {"params": p_key, "dropout": d_key},
        jnp.zeros(input_shape, jnp.float32), train=False)


def make_train_step(model, optimizer, *, supervised_attention: bool,
                    hardness: bool):
    """Returns jitted (params, batch_stats, opt_state, rng, image, label) ->
    (params, batch_stats, opt_state, rng, loss)."""

    def loss_from_output(output, label):
        logits, atts = output if isinstance(output, tuple) else (output, ())
        return dice_spvpa_loss(logits, atts, label,
                               supervised_attention=supervised_attention,
                               hardness_weighting=hardness)

    def step(params, batch_stats, opt_state, rng, image, label):
        label = label.astype(jnp.float32)  # may arrive uint8 (H2D-compact)
        rng, dropout_key = jax.random.split(rng)

        def loss_fn(p):
            output, mutated = model.apply(
                {"params": p, "batch_stats": batch_stats}, image, train=True,
                mutable=["batch_stats"], rngs={"dropout": dropout_key})
            return loss_from_output(output, label), mutated["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, new_stats, opt_state, rng, loss

    return jax.jit(step, donate_argnums=(0, 1, 2, 3))


def make_eval_step(model, *, supervised_attention: bool, hardness: bool):
    """Jitted (params, batch_stats, image, label) -> (loss, dice)."""

    def step(params, batch_stats, image, label):
        label = label.astype(jnp.float32)  # may arrive uint8 (H2D-compact)
        output = model.apply({"params": params, "batch_stats": batch_stats},
                             image, train=False)
        logits, atts = output if isinstance(output, tuple) else (output, ())
        loss = dice_spvpa_loss(logits, atts, label,
                               supervised_attention=supervised_attention,
                               hardness_weighting=hardness)
        return loss, dice_score(logits.astype(jnp.float32), label)

    return jax.jit(step)


def to_device_batch(batch, mesh=None, image_dtype=None):
    """(B, C, H, W, D) host batch -> (B, D, H, W, C) device arrays (the
    model's layout, see nn/layers.py), sharded over the mesh data axis when
    divisible (replicated otherwise).

    H2D traffic reduction: images transfer in `image_dtype` (bf16 when the
    model computes bf16 anyway); binary labels transfer as uint8 (lossless,
    4x smaller) and are cast back to f32 on device by the step functions.
    """
    image = np.ascontiguousarray(np.transpose(batch["image"], (0, 4, 2, 3, 1)))
    label = np.ascontiguousarray(np.transpose(batch["label"], (0, 4, 2, 3, 1)))
    if image_dtype is not None:
        image = image.astype(image_dtype)
    if label.dtype != np.uint8:
        # uint8 round-trip check (2 host passes, vs 5 for a mod/min/max scan
        # — this runs on the critical host thread every step)
        cast = label.astype(np.uint8)
        if np.array_equal(cast, label):
            label = cast
    if mesh is not None and jax.process_count() > 1:
        # multi-host: `batch` is this process's LOCAL slice of the global
        # batch (dataset sharded per host); assemble the global jax.Array
        from vs_seg.parallel.distributed import make_global_batch
        if image.shape[0] % jax.local_device_count() != 0:
            # NEVER fall through: each host would train on process-local
            # arrays jit treats as replicated — no gradient reduction,
            # silent cross-host parameter divergence
            raise ValueError(
                f"multi-host per-process batch {image.shape[0]} must be a "
                f"multiple of the local device count "
                f"{jax.local_device_count()} (pad or drop the final batch)")
        return make_global_batch(mesh, (image, label))
    if mesh is not None and image.shape[0] % mesh.devices.size == 0:
        sharding = batch_sharding(mesh, image.ndim)
        return (jax.device_put(image, sharding), jax.device_put(label, sharding))
    return jnp.asarray(image), jnp.asarray(label)


class Trainer:
    def __init__(self, cfg, model, logger: Optional[logging.Logger] = None,
                 mesh=None, tb_writer=None):
        self.cfg = cfg
        self.model = model
        self.logger = logger or logging.getLogger()
        self.mesh = mesh if mesh is not None else make_mesh()
        self.optimizer = make_optimizer(cfg.initial_learning_rate, cfg.weight_decay)
        self.train_step = make_train_step(
            model, self.optimizer, supervised_attention=cfg.attention,
            hardness=cfg.hardness)
        self.eval_step = make_eval_step(
            model, supervised_attention=cfg.attention, hardness=cfg.hardness)
        self.tb_writer = tb_writer
        import ml_dtypes  # noqa: F401  (registers bfloat16 with numpy)
        self._transfer_dtype = (jnp.bfloat16
                                if cfg.compute_dtype == "bfloat16" else None)

    def init_state(self, seed: Optional[int] = None) -> Dict[str, Any]:
        cfg = self.cfg
        variables = init_model(self.model, seed if seed is not None else cfg.seed)
        params = variables["params"]
        return self._replicate({
            "params": params,
            "batch_stats": variables.get("batch_stats", {}),
            "opt_state": self.optimizer.init(params),
            "rng": jax.random.key_data(jax.random.key(cfg.seed, impl=RNG_IMPL)),
            "epoch": 0,
            "best_metric": -1.0,
            "best_metric_epoch": -1,
        })

    def _replicate(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """Place the state's arrays replicated over the mesh: the sharding
        train_step gives its outputs, so the second step reuses the first
        step's executable instead of compiling the step again."""
        if self.mesh is None:
            return state
        out = dict(state)
        for k in ("params", "batch_stats", "opt_state", "rng"):
            out[k] = jax.device_put(state[k], replicated_sharding(self.mesh))
        return out

    def _reshard_device_batch(self, batch):
        """Shard an already-on-device (image, label) pair over the mesh data
        axis (device-to-device copy; no-op on one chip or indivisible
        batches, which run replicated)."""
        image, label = batch
        if (self.mesh is None or self.mesh.devices.size <= 1
                or image.shape[0] % self.mesh.devices.size != 0):
            return image, label
        sharding = batch_sharding(self.mesh, image.ndim)
        return (jax.device_put(image, sharding),
                jax.device_put(label, sharding))

    def _set_lr(self, opt_state, lr: float):
        opt_state.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        return opt_state

    def fit(self, state: Dict[str, Any], train_loader, val_loader
            ) -> Tuple[Dict[str, Any], list, list]:
        cfg, logger = self.cfg, self.logger
        logger.info("Running the training loop...")

        # debug-mode TB image grid of center-of-mass slices
        # (reference params/VSparams.py:417-426)
        if cfg.debug and self.tb_writer is not None:
            from vs_seg.core.observability import make_image_grid
            from vs_seg.eval.metrics import center_of_mass_slice
            images_for_grid = []
            for batch_data in train_loader:
                if not isinstance(batch_data, dict):
                    break  # device pipeline: grid imagery lives on device
                for image, label in zip(batch_data["image"], batch_data["label"]):
                    s = center_of_mass_slice(np.squeeze(label[0]))
                    images_for_grid.append(image[0, :, :, s])
                    images_for_grid.append(label[0, :, :, s])
            grid = make_image_grid(images_for_grid)
            self.tb_writer.add_image("images", grid[None], 0)
        params, batch_stats = state["params"], state["batch_stats"]
        opt_state = state["opt_state"]
        rng = wrap_rng_data(state["rng"])
        best_metric = float(state.get("best_metric", -1.0))
        best_metric_epoch = int(state.get("best_metric_epoch", -1))
        start_epoch = int(state.get("epoch", 0))

        epoch_loss_values, metric_values = [], []
        start = time.perf_counter()
        for epoch in range(start_epoch, cfg.num_epochs):
            logger.info("-" * 10)
            logger.info("Epoch %d/%d", epoch + 1, cfg.num_epochs)
            if epoch - start_epoch == cfg.val_interval:
                elapsed = time.perf_counter() - start
                logger.info(
                    "Average duration of first %d epochs = %.2f s. "
                    "Expected total training time = %.2f h",
                    cfg.val_interval, elapsed / cfg.val_interval,
                    elapsed * cfg.num_epochs / cfg.val_interval / 3600)

            # learning-rate schedule (reference VSparams.py:517-523)
            lr = cfg.initial_learning_rate / (
                cfg.lr_divisor ** (epoch // cfg.epochs_with_const_lr))
            opt_state = self._set_lr(opt_state, lr)

            # --profile_steps N: trace steady-state steps (skipping the
            # compile + first dispatch) of the first epoch into
            # <results>/profile/ — TensorBoard/Perfetto-compatible
            profile_steps = int(getattr(cfg, "profile_steps", 0) or 0)
            profiling = False

            step_losses, step_count = [], 0
            for batch in train_loader:
                if isinstance(batch, tuple):
                    # device pipeline (device-cached crops): reshard over the
                    # mesh data axis — the gather jit commits its outputs to
                    # one device, which would silently idle the others
                    image, label = self._reshard_device_batch(batch)
                else:
                    image, label = to_device_batch(
                        batch, self.mesh, image_dtype=self._transfer_dtype)
                if (profile_steps and epoch == start_epoch
                        and step_count == 1 and not profiling):
                    profile_dir = os.path.join(cfg.results_folder_path,
                                               "profile")
                    logger.info("profiling %d steps -> %s", profile_steps,
                                profile_dir)
                    jax.profiler.start_trace(profile_dir)
                    profiling = True
                params, batch_stats, opt_state, rng, loss = self.train_step(
                    params, batch_stats, opt_state, rng, image, label)
                # keep losses on device; syncing per step would serialize
                # host dispatch with device compute
                step_losses.append(loss)
                step_count += 1
                if profiling and step_count >= 1 + profile_steps:
                    float(loss)  # sync so the trace captures the full step
                    jax.profiler.stop_trace()
                    profiling = False
                    profile_steps = 0
                if epoch == start_epoch:
                    logger.info("%d/%d, train_loss: %.4f", step_count,
                                len(train_loader), float(loss))
            if profiling:  # epoch shorter than the requested window
                jax.profiler.stop_trace()
                profiling = False
                profile_steps = 0
            epoch_loss = (float(jnp.mean(jnp.stack(step_losses)))
                          if step_losses else 0.0)
            epoch_loss_values.append(epoch_loss)
            logger.info("epoch %d average loss: %.4f", epoch + 1, epoch_loss)

            if (epoch + 1) % cfg.val_interval == 0:
                metric_sum, metric_count, val_loss, val_steps = 0.0, 0, 0.0, 0
                for val_batch in val_loader:
                    if isinstance(val_batch, tuple):
                        image, label = self._reshard_device_batch(val_batch)
                    else:
                        # multi-host: the val set is replicated per host (only
                        # TRAIN files shard per process, VS_train.py:47), so
                        # every host evaluates the identical data locally —
                        # same metrics, consistent best-checkpoint decisions,
                        # and no global-batch divisibility requirement
                        val_mesh = (None if jax.process_count() > 1
                                    else self.mesh)
                        image, label = to_device_batch(
                            val_batch, val_mesh,
                            image_dtype=self._transfer_dtype)
                    loss, dice = self.eval_step(params, batch_stats, image, label)
                    metric_sum += float(dice)
                    metric_count += 1
                    val_loss += float(loss)
                    val_steps += 1
                metric = metric_sum / max(metric_count, 1)
                metric_values.append(metric)
                val_loss /= max(val_steps, 1)
                if self.tb_writer is not None:
                    self.tb_writer.add_scalars(
                        "Loss Train/Val", {"train": epoch_loss, "val": val_loss}, epoch)
                    self.tb_writer.add_scalar("Dice Score Val", metric, epoch)
                if metric > best_metric:
                    best_metric = metric
                    best_metric_epoch = epoch + 1
                    self._save(params, batch_stats, opt_state, rng, epoch,
                               best_metric, best_metric_epoch,
                               "best_metric_model.ckpt")
                    logger.info("saved new best metric model")
                logger.info(
                    "current epoch %d current mean dice: %.4f "
                    "best mean dice: %.4f at epoch %d",
                    epoch + 1, metric, best_metric, best_metric_epoch)

        logger.info("Train completed, best_metric: %.4f  at epoch: %d",
                    best_metric, best_metric_epoch)
        self._save(params, batch_stats, opt_state, rng, cfg.num_epochs - 1,
                   best_metric, best_metric_epoch, "last_epoch_model.ckpt")
        logger.info("Saved model of the last epoch at: %s",
                    os.path.join(cfg.model_path, "last_epoch_model.ckpt"))
        state = {"params": params, "batch_stats": batch_stats,
                 "opt_state": opt_state, "rng": jax.random.key_data(rng),
                 "epoch": cfg.num_epochs, "best_metric": best_metric,
                 "best_metric_epoch": best_metric_epoch}
        return state, epoch_loss_values, metric_values

    def _save(self, params, batch_stats, opt_state, rng, epoch, best_metric,
              best_metric_epoch, name):
        if jax.process_index() != 0:
            # multi-host: params are replicated; concurrent writes to the
            # same path on a shared filesystem would interleave and corrupt
            # the checkpoint
            return
        save_checkpoint(os.path.join(self.cfg.model_path, name), {
            "params": params, "batch_stats": batch_stats,
            "opt_state": opt_state,
            "rng": jax.random.key_data(rng), "epoch": epoch + 1,
            "best_metric": best_metric, "best_metric_epoch": best_metric_epoch,
        })

    def restore_state(self, path: str) -> Dict[str, Any]:
        """Load a checkpoint into a usable training state (true resume,
        which the reference cannot do — SURVEY.md §5). The optimizer state
        is rebuilt in the structure `optimizer.init(params)` gives."""
        from vs_seg.train.checkpoint import load_checkpoint, restore_into
        raw = load_checkpoint(path)
        template = jax.eval_shape(self.optimizer.init, raw["params"])
        return self._replicate({
            "params": raw["params"],
            "batch_stats": raw.get("batch_stats", {}),
            "opt_state": restore_into(template, raw["opt_state"]),
            "rng": raw["rng"],
            "epoch": int(raw["epoch"]),
            "best_metric": float(raw["best_metric"]),
            "best_metric_epoch": int(raw["best_metric_epoch"])})
