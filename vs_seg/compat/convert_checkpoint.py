"""CLI: convert a reference .pth state_dict into a vs_seg checkpoint.

  python -m vs_seg.compat.convert_checkpoint best_metric_model.pth \
      best_metric_model.ckpt [--no_attention]

The output loads directly via VS_inference.py (which also accepts raw .pth —
this tool just materializes the converted form, e.g. to drop the torch
dependency at serving time).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("src", help="reference .pth state_dict")
    parser.add_argument("dst", help="output .ckpt path")
    parser.add_argument("--no_attention", dest="attention", action="store_false")
    parser.set_defaults(attention=True)
    args = parser.parse_args(argv)

    from vs_seg.compat.torch_import import import_unet2d5_spvpa, load_pth
    from vs_seg.train.checkpoint import save_checkpoint

    params, stats = import_unet2d5_spvpa(load_pth(args.src),
                                         attention=args.attention)
    save_checkpoint(args.dst, {
        "params": params, "batch_stats": stats,
        "epoch": -1, "best_metric": -1.0, "best_metric_epoch": -1,
    })
    print(f"converted {args.src} -> {args.dst}")


if __name__ == "__main__":
    main()
