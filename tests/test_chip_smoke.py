"""What of chip_smoke.py and bench.py runs without a GPU: the device check,
the result line, the tolerance helpers, the size table, and the refusal to
run on the CPU backend or without the rest of the repository."""

import json
import math
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke
from vs_seg.core.device import NotAGPU, require_gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Dev:
    def __init__(self, platform, kind):
        self.platform, self.device_kind = platform, kind


def test_require_gpu_refuses_the_cpu_backend():
    with pytest.raises(NotAGPU, match="'cpu'"):
        require_gpu(jax.devices())
    require_gpu(jax.devices(), allow_cpu=True)  # explicit rehearsal only
    require_gpu([_Dev("gpu", "NVIDIA H100 80GB HBM3")])
    with pytest.raises(NotAGPU):
        require_gpu([_Dev("metal", "x")], allow_cpu=True)


def test_main_exits_nonzero_without_a_result_on_cpu(capsys, monkeypatch):
    monkeypatch.chdir(REPO)  # main() changes to the script's directory
    assert chip_smoke.main([]) == 2
    out = capsys.readouterr()
    assert out.out == ""
    assert "GPU" in out.err


def test_result_line_is_the_contract_json():
    line = chip_smoke.result_line(True, [_Dev("gpu", "NVIDIA H100 80GB HBM3")] * 4)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
    bad = json.loads(chip_smoke.result_line(False, jax.devices(),
                                            {"failed": ["phase 3 train"]}))
    assert bad["ok"] is False and bad["failed"] == ["phase 3 train"]


def test_max_rel_and_rel_l2():
    ref = np.array([1.0, -4.0, 2.0])
    out = np.array([1.0, -4.0, 2.5])
    assert chip_smoke.max_rel(out, ref) == pytest.approx(0.5 / 4.0)
    assert chip_smoke.rel_l2(out, ref) == pytest.approx(0.5 / math.sqrt(21.0))
    assert chip_smoke.max_rel(ref, ref) == 0.0
    assert chip_smoke.max_rel(np.zeros(2), np.zeros(2)) == 0.0
    with pytest.raises(chip_smoke.SmokeFailure, match="shape"):
        chip_smoke.rel_l2(np.zeros(3), np.zeros(4))


def test_checks_record_bound_and_reject_nan(capsys):
    checks = chip_smoke.Checks()
    assert checks.check("a", "m", 1e-4, 1e-3, "float32")
    assert not checks.check("b", "m", 2e-3, 1e-3, "float32")
    assert not checks.check("c", "m", float("nan"), 1.0, "bfloat16")
    assert checks.failed() == ["b", "c"]
    assert checks.rows[0] == {"name": "a", "metric": "m", "value": 1e-4,
                              "bound": 1e-3, "precision": "float32",
                              "ok": True}
    printed = capsys.readouterr().out
    assert "bound 1.0e-03" in printed and "FAILED" in printed


def test_bounds_are_ordered_by_what_they_compare():
    # same-precision comparisons are tighter than the bf16 one
    assert chip_smoke.BLEND_MAX_REL < chip_smoke.F32_DEVICE_MAX_REL
    assert chip_smoke.MULTI_MAX_REL <= chip_smoke.F32_DEVICE_MAX_REL
    assert chip_smoke.F32_DEVICE_MAX_REL < chip_smoke.BF16_REL_L2


@pytest.mark.parametrize("rehearsal", [False, True])
def test_sizes_fit_the_flagship_strides(rehearsal):
    """Every window the phases build divides by the flagship's stride
    products (H, W: 2^5; D: 2^3) and fits inside its volume."""
    s = chip_smoke._sizes(rehearsal)
    for key in ("crop", "roi", "reduced", "four_roi"):
        h, w, d = s[key]
        assert h % 32 == 0 and w % 32 == 0 and d % 8 == 0, (key, s[key])
    assert all(v >= r for v, r in zip(s["volume"], s["roi"]))
    assert all(v >= r for v, r in zip(s["four_volume"], s["four_roi"]))
    assert s["steps"] >= 2 and s["volumes"] >= 2  # a median after warm-up
    if not rehearsal:
        assert s["crop"] == s["roi"] == (384, 384, 64)
        assert s["volume"] == (448, 448, 80)


def test_script_alone_in_a_directory_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_bench_refuses_the_cpu_backend(capsys):
    import bench
    assert bench.main() == 2
    assert "GPU" in capsys.readouterr().err


@pytest.mark.gpu
def test_reference_forward_agrees_on_gpu_and_cpu(gpu_device):
    """On a GPU: the f32 reference forward agrees with the CPU backend's."""
    import jax.numpy as jnp

    from vs_seg.models import UNet2d5_spvPA
    from vs_seg.reference import reference_forward
    model = UNet2d5_spvPA(dtype=jnp.float32)
    v = chip_smoke._perturbed_variables(model)
    x = np.random.default_rng(0).normal(size=(1, 16, 64, 64, 1)).astype(
        np.float32)
    fn = jax.jit(lambda v, x: reference_forward(model, v, x)[0])
    with jax.default_matmul_precision("highest"):
        gpu = fn(jax.device_put(v, gpu_device), jax.device_put(x, gpu_device))
        cpu_dev = jax.devices("cpu")[0]
        cpu = fn(jax.device_put(v, cpu_dev), jax.device_put(x, cpu_dev))
    assert chip_smoke.max_rel(gpu, cpu) <= chip_smoke.F32_DEVICE_MAX_REL
