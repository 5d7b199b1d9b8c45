"""The accelerator a measurement runs on: refuse anything but a GPU, and
name the card as nvidia-smi reports it."""

from __future__ import annotations

import subprocess


class NotAGPU(RuntimeError):
    pass


def require_gpu(devices, allow_cpu: bool = False) -> None:
    """Raise NotAGPU unless JAX's first device is a GPU (or, with
    allow_cpu, the CPU backend of an explicit rehearsal). No fallback."""
    platform = devices[0].platform
    if platform != "gpu" and not (allow_cpu and platform == "cpu"):
        raise NotAGPU(
            f"JAX's first device is {platform!r} ({devices[0].device_kind}); "
            "a GPU is required")


def nvidia_smi() -> str:
    """`name, power.limit` of the cards, as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=False)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return (out.stdout.strip() or out.stderr.strip()
            or f"nvidia-smi exit {out.returncode}")
