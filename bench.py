#!/usr/bin/env python3
"""Benchmark: sliding-window whole-volume inference of the flagship model on
one GPU (the reference inference protocol, params/VSparams.py:568-574).

UNet2d5_spvPA at reference widths over synthetic 448x448x80 volumes (a
typical TCIA T2 volume after RAS reorientation): ROI 384x384x64, overlap
0.25 -> 2x2x2 = 8 windows, Gaussian blending, 8 windows per batch, bf16.
Volumes are staged on the device before timing; each volume's time runs from
dispatch to `block_until_ready`. Prints the card's name and power limit, then
ONE JSON line with the median and quartiles over the timed volumes, the
first-call (compile) time, peak device memory and the achieved conv TFLOP/s
(shape-derived FLOPs over the median time). Fails without a GPU.
"""

import json
import os
import statistics
import sys
import time

VOLUME_SHAPE = (448, 448, 80)
ROI = (384, 384, 64)
OVERLAP = 0.25
SW_BATCH = 8
ITERS = 10


def main() -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from vs_seg.core.device import NotAGPU, nvidia_smi, require_gpu
    from vs_seg.eval.flops import forward_conv_flops
    from vs_seg.infer.engine import make_predictor
    from vs_seg.infer.sliding_window import (count_windows,
                                             sliding_window_inference,
                                             stage_volume)
    from vs_seg.models.unet2d5_spvpa import UNet2d5_spvPA
    from vs_seg.train.trainer import init_model

    devices = jax.devices()
    try:
        require_gpu(devices)
    except NotAGPU as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    print(f"nvidia-smi: {nvidia_smi()}")

    model = UNet2d5_spvPA(dtype=jnp.bfloat16)
    variables = init_model(model, 0)
    predictor = make_predictor(model, variables["params"],
                               variables["batch_stats"], dtype=jnp.bfloat16)
    rng = np.random.default_rng(0)
    staged = [stage_volume(rng.normal(size=(*VOLUME_SHAPE, 1)).astype(
        np.float32), ROI, overlap=OVERLAP, sw_batch_size=SW_BATCH,
        transfer_dtype=jnp.bfloat16, predictor_layout="dfirst")
        for _ in range(ITERS)]

    def run(s):
        return sliding_window_inference(s, ROI, predictor, overlap=OVERLAP,
                                        sw_batch_size=SW_BATCH,
                                        mode="gaussian",
                                        predictor_layout="dfirst")

    t0 = time.perf_counter()
    out = jax.block_until_ready(run(staged[0]))
    first_s = time.perf_counter() - t0
    if not bool(jnp.all(jnp.isfinite(out))):
        print("bench: non-finite blended logits", file=sys.stderr)
        return 1
    times = []
    for s in staged:
        t0 = time.perf_counter()
        jax.block_until_ready(run(s))
        times.append(time.perf_counter() - t0)
    q1, median, q3 = statistics.quantiles(times, n=4)

    n_windows = count_windows(VOLUME_SHAPE, ROI, OVERLAP)
    roi_d = (ROI[2], ROI[0], ROI[1])
    flops = forward_conv_flops(model, variables, (1, *roi_d, 1)) * n_windows
    print(json.dumps({
        "metric": "sliding_window_seconds_per_volume",
        "median_s": median, "q1_s": q1, "q3_s": q3,
        "volumes_per_s": 1.0 / median,
        "times_s": times,
        "first_call_s": first_s,
        "n_windows": n_windows,
        "achieved_conv_tflops": flops / median / 1e12,
        "peak_bytes_in_use": (devices[0].memory_stats() or {}).get(
            "peak_bytes_in_use"),
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind, "count": len(devices)},
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
