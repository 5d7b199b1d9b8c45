#!/usr/bin/env python3
"""Device time of a jax.profiler trace, summed by model block.

    python tools/trace_sites.py TRACE_DIR [--json FILE]

Reads every `*.xplane.pb` under TRACE_DIR (as written by
`chip_smoke.py --trace`). On each GPU plane, every kernel event is
attributed to the module block in its op path (the `name` stat carries the
`jax.named_scope` path, e.g. `.../UNet2d5_spvPA/down_0/unit0/conv/...`):
`down_i`, `downsample_i`, `bottom_att`, `bottom`, `upsample_i`,
`upatt_i`, `up_i`, or `blend`; the backward pass (`transpose(` in the path)
is counted apart from the forward. Events whose path names no block (XLA
fusions that lost it, the optimizer, the loss) are `other`. Prints, per
trace: the window (first kernel start to last kernel end), the busy time
(union of kernel intervals), the idle share, and each block's kernel time
and share of the summed kernel time; then the groups of blocks that the
removed hand-written kernels used to cover.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from collections import defaultdict

_BLOCK = re.compile(r"(?:^|/)(downsample_\d+|upsample_\d+|upatt_\d+|up_\d+|"
                    r"down_\d+|bottom_att|bottom|blend)(?:/|$)")

# The sites of the removed hand-written kernels, as groups of blocks.
GROUPS = {
    "blend (pallas_blend)": ["fwd blend"],
    "L2-L4 decoder blocks (pallas_l2block)":
        [f"fwd {b}_{i}" for b in ("upatt", "up") for i in (2, 3, 4)],
    "L2-L4 encoder blocks (pallas_rublock)":
        [f"fwd down_{i}" for i in (2, 3, 4)],
    "L2-L4 strided downsamples (pallas_dsconv)":
        [f"fwd downsample_{i}" for i in (2, 3, 4)],
    "L0-L1 blocks (pallas_block2d / pallas_tail2d)":
        [f"fwd {b}_{i}" for b in ("down", "upatt", "up") for i in (0, 1)],
    "attention blocks (pallas_att)":
        [f"fwd upatt_{i}" for i in range(5)] + ["fwd bottom_att"],
    "backward of L2-L4 blocks (pallas_train)":
        [f"bwd {b}_{i}" for b in ("down", "upatt", "up") for i in (2, 3, 4)],
}


def block_of(path: str) -> str:
    direction = "bwd" if "transpose(" in path else "fwd"
    m = _BLOCK.search(path)
    return f"{direction} {m.group(1) if m else 'other'}"


def reduce_trace(path: str) -> dict:
    from jax.profiler import ProfileData
    data = ProfileData.from_file(path)
    per_block = defaultdict(float)
    intervals = []
    n = 0
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                if ev.name.startswith(("Memcpy", "Memset")):
                    continue
                stats = dict(ev.stats)
                dur = float(ev.duration_ns)
                per_block[block_of(str(stats.get("name", "")))] += dur
                intervals.append((float(ev.start_ns), float(ev.start_ns) + dur))
                n += 1
    if not intervals:
        raise ValueError(f"{path}: no GPU kernel events")
    intervals.sort()
    busy, cur_s, cur_e = 0.0, intervals[0][0], intervals[0][1]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = intervals[-1][1] - intervals[0][0]
    total = sum(per_block.values())
    return {"trace": path, "kernels": n, "window_ms": window / 1e6,
            "busy_ms": busy / 1e6, "idle_share": 1.0 - busy / window,
            "kernel_ms": total / 1e6,
            "blocks_ms": {k: v / 1e6 for k, v in sorted(per_block.items())},
            "groups_share": {g: sum(per_block.get(b, 0.0) for b in bs) / total
                             for g, bs in GROUPS.items()}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("trace_dir")
    parser.add_argument("--json", help="also write the reductions here")
    args = parser.parse_args(argv)
    paths = sorted(glob.glob(os.path.join(args.trace_dir, "**",
                                          "*.xplane.pb"), recursive=True))
    if not paths:
        print(f"no *.xplane.pb under {args.trace_dir}", file=sys.stderr)
        return 1
    results = [reduce_trace(p) for p in paths]
    for r in results:
        print(f"{r['trace']}\n  {r['kernels']} kernels, window "
              f"{r['window_ms']:.3f} ms, busy {r['busy_ms']:.3f} ms, idle "
              f"share {r['idle_share']:.4f}, kernel time {r['kernel_ms']:.3f} ms")
        for block, ms in sorted(r["blocks_ms"].items(), key=lambda kv: -kv[1]):
            print(f"  {block:22s} {ms:10.3f} ms {ms / r['kernel_ms']:7.2%}")
        for group, share in r["groups_share"].items():
            print(f"  [{group}] {share:.2%}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
