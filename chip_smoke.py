#!/usr/bin/env python3
"""Smoke run of the flagship train and inference path on one NVIDIA GPU.

    python chip_smoke.py                  # phases 1-5 on one GPU
    python chip_smoke.py --four-cards     # the 4-GPU checks only
    python chip_smoke.py --trace DIR      # also profile one train step and
                                          # one volume into DIR

Phases (one process; the CLIs are called in-process):
  1. device check: fails at once unless JAX's first device is a GPU; prints
     the card's name and power limit, device kind, JAX version, XLA_FLAGS
  2. CLI path: VS_train.main(--debug) then VS_inference.main(--debug) on a
     seeded synthetic dataset; checkpoint, NIFTI segmentations and Dice log
     must exist and the epoch losses be finite
  3. full-width train: UNet2d5_spvPA (channels 16..96) on 384x384x64 crops,
     batch 1, bf16, spvPA loss + Adam through Trainer.train_step and the
     data loaders; compile s, median step ms, memory analysis, peak bytes
  4. full-width inference: engine.run_inference on 448x448x80 volumes, ROI
     384x384x64, overlap 0.25, Gaussian blending, sw_batch 8, bf16
  5. correctness on the card against the plain references of
     vs_seg/reference.py, each printed with its bound and precision

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
Any failed phase makes the exit code non-zero. `--cpu-rehearsal` runs the
same phases on the CPU backend at small spatial sizes, to rehearse the
control flow where no GPU is present; it is never a measurement.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import statistics
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

# Bounds of the correctness checks (phase 5 and --four-cards).
#   f32 GPU vs f32 CPU, same function and parameters, HIGHEST precision:
#     only summation order differs.
F32_DEVICE_MAX_REL = 1e-3
#   bf16 production forward vs the f32 reference on the card: bf16 keeps 8
#     significant bits (relative step 2^-8 = 3.9e-3) and rounds every
#     activation of a ~40-conv chain.
BF16_REL_L2 = 2e-2
#   first f32 train-step loss, GPU vs CPU.
LOSS_REL = 1e-4
#   the blend: identical per-voxel f32 sums in the same window order;
#   fused multiply-adds may differ in the last bit.
BLEND_MAX_REL = 1e-5
#   4-card vs 1-card in f32: partial sums merged in another order.
MULTI_MAX_REL = 1e-4


class SmokeFailure(Exception):
    """A phase's output failed one of its checks."""


def max_rel(out, ref) -> float:
    """max|out - ref| / max|ref| over all elements (float64)."""
    import numpy as np
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    if out.shape != ref.shape:
        raise SmokeFailure(f"shape {out.shape} != reference {ref.shape}")
    scale = float(np.max(np.abs(ref)))
    return float(np.max(np.abs(out - ref))) / (scale if scale > 0 else 1.0)


def rel_l2(out, ref) -> float:
    """||out - ref||_2 / ||ref||_2 (float64)."""
    import numpy as np
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    if out.shape != ref.shape:
        raise SmokeFailure(f"shape {out.shape} != reference {ref.shape}")
    norm = float(np.linalg.norm(ref))
    return float(np.linalg.norm(out - ref)) / (norm if norm > 0 else 1.0)


class Checks:
    """Records each comparison with its value, bound and precision."""

    def __init__(self):
        self.rows = []

    def check(self, name: str, metric: str, value: float, bound: float,
              precision: str) -> bool:
        ok = math.isfinite(value) and value <= bound
        self.rows.append({"name": name, "metric": metric, "value": value,
                          "bound": bound, "precision": precision, "ok": ok})
        print(f"  check {name}: {metric} = {value:.3e} (bound {bound:.1e}, "
              f"{precision}) {'ok' if ok else 'FAILED'}", flush=True)
        return ok

    def failed(self):
        return [r["name"] for r in self.rows if not r["ok"]]


def result_line(ok: bool, devices, extra=None) -> str:
    """The final stdout line: {"ok": ..., "device": {platform, kind, count}}."""
    line = {"ok": bool(ok),
            "device": {"platform": devices[0].platform,
                       "kind": devices[0].device_kind,
                       "count": len(devices)}}
    if extra:
        line.update(extra)
    return json.dumps(line)


def _sizes(rehearsal: bool) -> dict:
    if rehearsal:
        return dict(crop=(64, 64, 16), volume=(96, 96, 24), roi=(64, 64, 16),
                    reduced=(32, 32, 16), cli_volume=(144, 144, 40),
                    steps=3, volumes=2, four_volume=(48, 48, 20),
                    four_roi=(32, 32, 16))
    return dict(crop=(384, 384, 64), volume=(448, 448, 80),
                roi=(384, 384, 64), reduced=(128, 128, 32),
                cli_volume=(144, 144, 40), steps=8, volumes=3,
                four_volume=(160, 160, 36), four_roi=(128, 128, 32))


def _traced(trace_dir: str, name: str, fn) -> None:
    """Run fn() under jax.profiler into trace_dir/name. A profiler failure
    is reported and does not fail the phase: the trace is a diagnostic."""
    import jax
    try:
        with jax.profiler.trace(os.path.join(trace_dir, name)):
            jax.block_until_ready(fn())
        print(f"  traced into {os.path.join(trace_dir, name)}")
    except Exception:  # the profiler is optional; the phase's checks stand
        traceback.print_exc()
        print(f"  trace {name} FAILED (phase result unaffected)")


def _peak_bytes(device):
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _print_memory_analysis(compiled):
    ma = compiled.memory_analysis()
    if ma is None:
        print("  memory_analysis: unavailable")
        return {}
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "alias_size_in_bytes",
              "generated_code_size_in_bytes")
    out = {f: int(getattr(ma, f)) for f in fields if hasattr(ma, f)}
    print("  memory_analysis: " + ", ".join(f"{k}={v}" for k, v in out.items()))
    return out


# --- phase 2 ---------------------------------------------------------------

def phase_cli(work: str, sizes: dict) -> dict:
    import numpy as np

    import VS_inference
    import VS_train
    from vs_seg.data.synthetic import generate_dataset

    root = os.path.join(work, "cli_data")
    generate_dataset(root, n_train=2, n_val=2, n_test=2,
                     shape=sizes["cli_volume"], seed=0)
    args = ["--debug", "--data_root", root]
    t0 = time.perf_counter()
    VS_train.main(args)
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dice_scores, _ = VS_inference.main(args)
    infer_s = time.perf_counter() - t0

    results = os.path.join(root, "results", "debug")
    ckpt = os.path.join(results, "model", "best_metric_model.ckpt")
    if not os.path.exists(ckpt):
        raise SmokeFailure(f"no checkpoint at {ckpt}")
    seg_dir = os.path.join(results, "inferred_segmentations_nifti")
    segs = [os.path.join(d, f) for d, _, fs in os.walk(seg_dir) for f in fs
            if f.endswith(".nii.gz")]
    if len(segs) != 2:
        raise SmokeFailure(f"expected 2 NIFTI segmentations, found {segs}")
    with open(os.path.join(results, "logs", "training_log.txt")) as f:
        losses = [float(v) for v in
                  re.findall(r"average loss: (\S+)", f.read())]
    with open(os.path.join(results, "logs", "test_log.txt")) as f:
        if "mean_dice_score" not in f.read():
            raise SmokeFailure("test log has no mean_dice_score line")
    if not losses or not all(math.isfinite(v) for v in losses):
        raise SmokeFailure(f"epoch losses not finite: {losses}")
    print(f"  train_s={train_s:.1f} infer_s={infer_s:.1f} "
          f"epoch_losses={[round(v, 4) for v in losses]} "
          f"dice={np.round(dice_scores, 4).tolist()}")
    return {"train_s": train_s, "infer_s": infer_s, "epoch_losses": losses,
            "dice": [float(d) for d in dice_scores]}


# --- phases 3 and 4 ----------------------------------------------------------

def _flagship_config(root: str, sizes: dict, **kw):
    from vs_seg.core.config import Config
    return Config(data_root=root,
                  split_csv=os.path.join(root, "split_synthetic.csv"),
                  results_folder_name="chip_smoke",
                  pad_crop_shape=sizes["crop"],
                  pad_crop_shape_test=sizes["crop"],
                  sliding_window_inferer_roi_size=sizes["roi"],
                  sw_batch_size=8, sw_overlap=0.25, **kw)


def phase_train(work: str, sizes: dict, trace_dir=None) -> dict:
    import jax

    from vs_seg.data.dataset import CacheDataset, DataLoader, load_split_csv
    from vs_seg.data.transforms import get_transforms
    from vs_seg.models import build_model
    from vs_seg.train.trainer import Trainer, to_device_batch, wrap_rng_data

    root = os.path.join(work, "full_data")
    cfg = _flagship_config(root, sizes, compute_dtype="bfloat16",
                           train_batch_size=1)
    train_files, _, _ = load_split_csv(cfg.split_csv, cfg.dataset, root)
    train_t, _, _ = get_transforms(cfg.pad_crop_shape)
    loader = DataLoader(CacheDataset(train_files, train_t, num_workers=4),
                        batch_size=1, shuffle=True, seed=0, prefetch=2)
    model = build_model(cfg)
    trainer = Trainer(cfg, model)
    state = trainer.init_state()
    params, stats, opt = (state["params"], state["batch_stats"],
                          state["opt_state"])
    rng = wrap_rng_data(state["rng"])

    def batches():
        while True:
            yield from loader

    it = batches()
    image, label = to_device_batch(next(it), trainer.mesh,
                                   image_dtype=trainer._transfer_dtype)
    t0 = time.perf_counter()
    compiled = trainer.train_step.lower(params, stats, opt, rng, image,
                                        label).compile()
    compile_s = time.perf_counter() - t0
    print(f"  compile_s={compile_s:.1f}")
    mem = _print_memory_analysis(compiled)

    # Each step: host staging (transpose, bf16 cast, upload) timed apart
    # from the step itself, which runs from dispatch to block_until_ready.
    step_ms, stage_ms, losses = [], [], []
    for step in range(sizes["steps"]):
        if step:
            batch = next(it)
            t0 = time.perf_counter()
            image, label = jax.block_until_ready(to_device_batch(
                batch, trainer.mesh, image_dtype=trainer._transfer_dtype))
            stage_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        params, stats, opt, rng, loss = trainer.train_step(
            params, stats, opt, rng, image, label)
        jax.block_until_ready(loss)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    if not all(math.isfinite(v) for v in losses):
        raise SmokeFailure(f"train losses not finite: {losses}")
    median_ms = statistics.median(step_ms[1:])
    median_stage = statistics.median(stage_ms)
    peak = _peak_bytes(jax.devices()[0])
    print(f"  step_ms={[round(v, 2) for v in step_ms]} "
          f"median_step_ms={median_ms:.2f} (steps 2..{len(step_ms)})")
    print(f"  host staging per step: median {median_stage:.2f} ms")
    print(f"  losses={[round(v, 4) for v in losses]} "
          f"peak_bytes_in_use={peak}")
    if trace_dir:
        image, label = to_device_batch(next(it), trainer.mesh,
                                       image_dtype=trainer._transfer_dtype)
        _traced(trace_dir, "train_step", lambda: trainer.train_step(
            params, stats, opt, rng, image, label))
    return {"compile_s": compile_s, "step_ms": step_ms,
            "median_step_ms": median_ms, "stage_ms": stage_ms,
            "median_stage_ms": median_stage, "losses": losses,
            "memory_analysis": mem, "peak_bytes_in_use": peak}


def phase_infer(work: str, sizes: dict, trace_dir=None) -> dict:
    import jax

    from vs_seg.data.dataset import CacheDataset, DataLoader, load_split_csv
    from vs_seg.data.transforms import get_transforms
    from vs_seg.infer.engine import make_predictor, run_inference
    from vs_seg.infer.sliding_window import (sliding_window_inference,
                                             stage_volume)
    from vs_seg.models import build_model
    from vs_seg.train.trainer import init_model

    root = os.path.join(work, "full_data")
    cfg = _flagship_config(root, sizes, infer_dtype="bfloat16",
                           export_inferred_segmentations=False)
    _, _, test_files = load_split_csv(cfg.split_csv, cfg.dataset, root)
    _, _, test_t = get_transforms(cfg.pad_crop_shape_test)
    test_loader = DataLoader(CacheDataset(test_files, test_t, num_workers=4),
                             batch_size=1)
    model = build_model(cfg)
    variables = init_model(model, 0)
    dice, times = run_inference(cfg, model, variables["params"],
                                variables["batch_stats"], test_loader,
                                make_figures=False, export=False)
    steady = times[1:]
    per_volume_s = statistics.median(steady)
    compile_s = times[0] - per_volume_s
    peak = _peak_bytes(jax.devices()[0])
    print(f"  volume_s={[round(t, 4) for t in times]} "
          f"per_volume_s={per_volume_s:.4f} (volumes 2..{len(times)}) "
          f"first_minus_steady_s={compile_s:.1f} peak_bytes_in_use={peak}")
    if trace_dir:
        predictor = make_predictor(model, variables["params"],
                                   variables["batch_stats"])
        data = next(iter(test_loader))
        import numpy as np
        image = np.transpose(data["image"][0], (1, 2, 3, 0))
        staged = stage_volume(image, cfg.sliding_window_inferer_roi_size,
                              overlap=cfg.sw_overlap,
                              sw_batch_size=cfg.sw_batch_size,
                              transfer_dtype=jax.numpy.bfloat16,
                              predictor_layout="dfirst")
        run = lambda: sliding_window_inference(  # noqa: E731
            staged, cfg.sliding_window_inferer_roi_size, predictor,
            overlap=cfg.sw_overlap, sw_batch_size=cfg.sw_batch_size,
            predictor_layout="dfirst")
        jax.block_until_ready(run())
        _traced(trace_dir, "infer_volume", run)
    return {"volume_s": times, "per_volume_s": per_volume_s,
            "first_minus_steady_s": compile_s,
            "dice": [float(d) for d in dice], "peak_bytes_in_use": peak}


# --- phase 5 -----------------------------------------------------------------

def _perturbed_variables(model, seed: int = 0):
    """Initial variables with BatchNorm statistics moved off (0, 1), so the
    BN folding of the production path is exercised."""
    import jax
    import jax.numpy as jnp

    from vs_seg.train.trainer import init_model
    variables = init_model(model, seed)
    leaves, treedef = jax.tree_util.tree_flatten(variables["batch_stats"])
    keys = jax.random.split(jax.random.key(seed + 1), len(leaves))
    moved = [v + 0.2 * jax.random.uniform(k, v.shape, jnp.float32)
             for v, k in zip(leaves, keys)]
    return {"params": variables["params"],
            "batch_stats": jax.tree_util.tree_unflatten(treedef, moved)}


def phase_correctness(sizes: dict, checks: Checks) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from vs_seg.core.config import Config
    from vs_seg.infer.sliding_window import (_scatter_accumulate,
                                             dense_patch_starts,
                                             gaussian_importance_map)
    from vs_seg.models import UNet2d5_spvPA, build_model
    from vs_seg.reference import numpy_scatter_accumulate, reference_forward
    from vs_seg.train.trainer import Trainer, wrap_rng_data

    dev = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    out = {}
    model32 = UNet2d5_spvPA(dtype=jnp.float32)
    variables = _perturbed_variables(model32)
    ref_fn = jax.jit(lambda v, x: reference_forward(model32, v, x))

    # 5a: f32 reference, card vs CPU, full width on a reduced window
    h, w, d = sizes["reduced"]
    x_small = np.random.default_rng(1).normal(size=(1, d, h, w, 1)).astype(
        np.float32)
    with jax.default_matmul_precision("highest"):
        gpu = ref_fn(jax.device_put(variables, dev),
                     jax.device_put(x_small, dev))
        host = ref_fn(jax.device_put(variables, cpu),
                      jax.device_put(x_small, cpu))
    gpu_l, host_l = np.asarray(gpu[0]), np.asarray(host[0])
    v = max([max_rel(gpu_l, host_l)]
            + [max_rel(a, b) for a, b in zip(gpu[1], host[1])])
    checks.check("f32_reference_gpu_vs_cpu", "max|d|/max|ref|", v,
                 F32_DEVICE_MAX_REL, "float32, matmul precision highest")
    out["f32_reference_gpu_vs_cpu_max_rel"] = v

    # 5b: production bf16 forward vs the f32 reference, full window
    model16 = UNet2d5_spvPA(dtype=jnp.bfloat16)
    h, w, d = sizes["roi"]
    x_full = jax.device_put(np.random.default_rng(2).normal(
        size=(1, d, h, w, 1)).astype(np.float32), dev)
    vars_dev = jax.device_put(variables, dev)
    prod = jax.jit(lambda v, x: model16.apply(v, x, train=False))(
        vars_dev, x_full)
    with jax.default_matmul_precision("highest"):
        ref = ref_fn(vars_dev, x_full)
    prod_l = np.asarray(prod[0].astype(jnp.float32))
    ref_l = np.asarray(ref[0])
    l2 = rel_l2(prod_l, ref_l)
    mr = max_rel(prod_l, ref_l)
    agree = float(np.mean(np.argmax(prod_l, -1) == np.argmax(ref_l, -1)))
    checks.check("bf16_forward_vs_f32_reference", "||d||2/||ref||2", l2,
                 BF16_REL_L2, "bfloat16 production vs float32 highest")
    print(f"  bf16 vs f32 full window: max|d|/max|ref| = {mr:.3e}, "
          f"argmax agreement = {agree:.6f}")
    out.update(bf16_rel_l2=l2, bf16_max_rel=mr, bf16_argmax_agreement=agree)
    del prod, ref, x_full

    # 5c: first f32 train-step loss, card vs CPU, reduced crop
    cfg = Config(compute_dtype="float32", pad_crop_shape=sizes["reduced"])
    trainer = Trainer(cfg, build_model(cfg))
    state = trainer.init_state()
    # host copies: the step donates its inputs, so each device gets its own
    host_state = jax.device_get(
        (state["params"], state["batch_stats"], state["opt_state"]))
    h, w, d = sizes["reduced"]
    g = np.random.default_rng(3)
    image = g.normal(size=(1, d, h, w, 1)).astype(np.float32)
    label = (g.random((1, d, h, w, 1)) > 0.8).astype(np.float32)
    # threefry key data, as host numpy: the same bits on every backend, and
    # a fresh device buffer per run (the step donates its rng argument)
    key = np.asarray(jax.random.key_data(jax.random.key(5)))
    losses = {}
    for name, device in (("gpu", dev), ("cpu", cpu)):
        args = jax.device_put(host_state, device)
        with jax.default_matmul_precision("highest"):
            *_, loss = trainer.train_step(
                *args, jax.device_put(wrap_rng_data(key), device),
                jax.device_put(image, device), jax.device_put(label, device))
        losses[name] = float(loss)
    v = abs(losses["gpu"] - losses["cpu"]) / abs(losses["cpu"])
    print(f"  train-step loss gpu={losses['gpu']!r} cpu={losses['cpu']!r}")
    checks.check("f32_train_loss_gpu_vs_cpu", "|d|/|ref|", v, LOSS_REL,
                 "float32, matmul precision highest")
    out.update(train_loss=losses, train_loss_rel=v)

    # 5d: the plain XLA blend vs the numpy MONAI transcription, real sizes
    vol_h, vol_w, vol_d = sizes["volume"]
    roi_h, roi_w, roi_d = sizes["roi"]
    shape = (vol_d, vol_h, vol_w)           # the engine's D-first order
    roi = (roi_d, roi_h, roi_w)
    starts = dense_patch_starts(shape, roi, 0.25)
    imp = gaussian_importance_map(roi)
    preds = jax.random.normal(jax.random.key(9), (len(starts), *roi, 2),
                              jnp.bfloat16)
    mask = np.ones(len(starts), np.float32)
    acc = _scatter_accumulate(jnp.zeros((*shape, 2), jnp.float32),
                              jnp.zeros((*shape, 1), jnp.float32), preds,
                              jnp.asarray(starts), jnp.asarray(mask),
                              jnp.asarray(imp))
    ref_o, ref_w = numpy_scatter_accumulate(
        np.zeros((*shape, 2), np.float32), np.zeros((*shape, 1), np.float32),
        np.asarray(preds.astype(jnp.float32)), starts, mask, imp)
    v = max(max_rel(acc[0], ref_o), max_rel(acc[1], ref_w))
    checks.check("blend_vs_numpy", "max|d|/max|ref|", v, BLEND_MAX_REL,
                 f"float32 accumulators, {len(starts)} windows")
    out["blend_max_rel"] = v
    return out


# --- --four-cards ------------------------------------------------------------

def four_cards(sizes: dict, checks: Checks) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from vs_seg.core.config import Config
    from vs_seg.infer.engine import make_predictor
    from vs_seg.infer.sharded import sliding_window_inference_sharded
    from vs_seg.infer.sliding_window import sliding_window_inference
    from vs_seg.infer.spatial import make_spatial_predictor
    from vs_seg.models import build_model
    from vs_seg.parallel.mesh import make_mesh
    from vs_seg.train.trainer import Trainer, to_device_batch, wrap_rng_data

    devices = jax.devices()
    if len(devices) < 4:
        raise SmokeFailure(f"--four-cards needs 4 devices, found {len(devices)}")
    mesh4 = make_mesh(devices=devices[:4])
    mesh1 = make_mesh(devices=devices[:1])
    out = {}
    precision = "float32, matmul precision highest"

    # data-parallel train step: 4 cards vs the same global batch on 1
    cfg = Config(compute_dtype="float32", pad_crop_shape=sizes["reduced"],
                 train_batch_size=4)
    model = build_model(cfg)
    h, w, d = sizes["reduced"]
    g = np.random.default_rng(4)
    batch = {"image": g.normal(size=(4, 1, h, w, d)).astype(np.float32),
             "label": (g.random((4, 1, h, w, d)) > 0.8).astype(np.float32)}
    key = np.asarray(jax.random.key_data(jax.random.key(11)))
    results = {}
    for name, mesh in (("dp4", mesh4), ("single", mesh1)):
        trainer = Trainer(cfg, model, mesh=mesh)
        state = trainer.init_state()
        image, label = to_device_batch(batch, mesh)
        if name == "dp4":
            spread = sorted(len(s.data) for s in image.addressable_shards)
            devs = {s.device for s in image.addressable_shards}
            print(f"  dp4 image shards: {len(devs)} devices, "
                  f"per-device batch {spread}")
            if len(devs) != 4 or spread != [1, 1, 1, 1]:
                raise SmokeFailure("the data mesh did not spread the batch "
                                   "over 4 devices")
        state_dev = jax.device_put(
            (state["params"], state["batch_stats"], state["opt_state"]),
            jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()))
        with jax.default_matmul_precision("highest"):
            p, bs, _, _, loss = trainer.train_step(
                *state_dev, wrap_rng_data(key), image, label)
            jax.block_until_ready(loss)
        if name == "dp4":
            in_use = [(dv.memory_stats() or {}).get("bytes_in_use")
                      for dv in devices[:4]]
            print(f"  dp4 bytes_in_use per device after the step: {in_use}")
            if any(b is not None and b <= 0 for b in in_use):
                raise SmokeFailure("a device of the 4-card mesh holds nothing")
        results[name] = (float(loss), jax.device_get(p), jax.device_get(bs))
    v = abs(results["dp4"][0] - results["single"][0]) / abs(
        results["single"][0])
    checks.check("dp4_train_loss_vs_single", "|d|/|ref|", v, MULTI_MAX_REL,
                 precision)
    lr = cfg.initial_learning_rate
    p_diff = max(float(np.max(np.abs(a - b))) for a, b in zip(
        jax.tree_util.tree_leaves(results["dp4"][1]),
        jax.tree_util.tree_leaves(results["single"][1])))
    # one Adam step moves each parameter by ~lr; reduction-order noise can
    # flip the sign of a near-zero gradient, so the bound is update-scale
    checks.check("dp4_params_vs_single", "max|d| (one Adam step)", p_diff,
                 3 * lr, precision)
    bs_diff = max(max_rel(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(results["dp4"][2]),
        jax.tree_util.tree_leaves(results["single"][2])))
    checks.check("dp4_batch_stats_vs_single", "max|d|/max|ref|", bs_diff,
                 MULTI_MAX_REL, precision)
    out.update(dp4_loss_rel=v, dp4_param_max_abs=p_diff,
               dp4_batch_stats_max_rel=bs_diff)

    # window-sharded and spatially sharded inference vs one device
    model32 = build_model(Config(compute_dtype="float32"))
    variables = _perturbed_variables(model32)
    params, stats = variables["params"], variables["batch_stats"]
    predictor = make_predictor(model32, params, stats, dtype=jnp.float32)
    vol = np.random.default_rng(6).normal(
        size=(*sizes["four_volume"], 1)).astype(np.float32)
    roi = sizes["four_roi"]
    with jax.default_matmul_precision("highest"):
        single = sliding_window_inference(
            vol, roi, predictor, sw_batch_size=8, transfer_dtype=np.float32,
            predictor_layout="dfirst")
        sharded = sliding_window_inference_sharded(
            vol, roi, predictor, mesh4, sw_batch_size=2,
            transfer_dtype=np.float32, predictor_layout="dfirst")
    v = max_rel(sharded, single)
    checks.check("window_sharded_vs_single", "max|d|/max|ref|", v,
                 MULTI_MAX_REL, precision)
    out["window_sharded_max_rel"] = v

    h, w, d = roi
    win = np.random.default_rng(7).normal(size=(1, d, h, w, 1)).astype(
        np.float32)
    with jax.default_matmul_precision("highest"):
        dense = predictor(win)
        spatial = make_spatial_predictor(model32, params, stats, mesh4,
                                         dtype=jnp.float32)(win)
    v = max_rel(spatial, dense)
    checks.check("spatial_halo_vs_dense", "max|d|/max|ref|", v,
                 MULTI_MAX_REL, precision)
    out["spatial_max_rel"] = v
    return out


# --- main --------------------------------------------------------------------

def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the 4-GPU checks")
    parser.add_argument("--trace", metavar="DIR",
                        help="profile one train step and one volume into DIR")
    parser.add_argument("--out", metavar="FILE",
                        help="write every measured number to FILE as JSON")
    parser.add_argument("--cpu-rehearsal", action="store_true",
                        help="run on the CPU backend at small sizes "
                             "(control-flow rehearsal, not a measurement)")
    args = parser.parse_args(argv)
    os.chdir(HERE)  # the debug CLI reads ./params/split_debug.csv
    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms and "cpu" not in platforms.split(","):
        # phase 5 compares with the CPU backend of this same process
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"

    import jax

    from vs_seg.core.device import NotAGPU, nvidia_smi, require_gpu

    devices = jax.devices()
    try:
        require_gpu(devices, allow_cpu=args.cpu_rehearsal)
    except NotAGPU as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2

    sizes = _sizes(args.cpu_rehearsal)
    print("[phase 1] device")
    print(f"  nvidia-smi: {nvidia_smi()}")
    print(f"  device_kind={devices[0].device_kind} count={len(devices)} "
          f"jax={jax.__version__} XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}",
          flush=True)

    work = os.path.join(HERE, "runs", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    checks = Checks()
    report = {"device_kind": devices[0].device_kind, "count": len(devices),
              "nvidia_smi": nvidia_smi(), "jax": jax.__version__,
              "xla_flags": os.environ.get("XLA_FLAGS", "")}
    failed = []

    def run(name, fn, *a):
        print(f"[{name}]", flush=True)
        t0 = time.perf_counter()
        try:
            report[name] = fn(*a)
        except Exception:  # a failed phase is reported, the others still run
            traceback.print_exc()
            failed.append(name)
        print(f"  {name} took {time.perf_counter() - t0:.1f} s", flush=True)

    if args.four_cards:
        run("four_cards", four_cards, sizes, checks)
    else:
        from vs_seg.data.synthetic import generate_dataset
        run("phase 2 cli", phase_cli, work, sizes)
        generate_dataset(os.path.join(work, "full_data"), n_train=2, n_val=0,
                         n_test=sizes["volumes"], shape=sizes["volume"],
                         seed=1)
        run("phase 3 train", phase_train, work, sizes, args.trace)
        run("phase 4 inference", phase_infer, work, sizes, args.trace)
        run("phase 5 correctness", phase_correctness, sizes, checks)
    failed += [f"check {n}" for n in checks.failed()]
    report["checks"] = checks.rows
    report["failed"] = failed
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, default=str)
    if failed:
        print(f"chip_smoke: failed: {failed}", file=sys.stderr)
        print(result_line(False, devices, {"failed": failed}))
        return 1
    print(result_line(True, devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
