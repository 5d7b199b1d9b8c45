"""Process-level behaviour: where the compilation cache goes, and that
matplotlib stays optional."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = ("import vs_seg, jax; "
         "print(jax.config.jax_compilation_cache_dir)")


def _run(code, env_update, drop=()):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **env_update)
    for k in drop:
        env.pop(k, None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip().splitlines()[-1]


def test_compile_cache_follows_the_environment_variable(tmp_path):
    want = str(tmp_path / "cache")
    assert _run(PROBE, {"JAX_COMPILATION_CACHE_DIR": want}) == want


def test_compile_cache_defaults_to_a_fixed_dir_in_the_checkout():
    got = _run(PROBE, {}, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert got == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "/.jax_cache/" in f.read().split()


def test_main_path_imports_neither_matplotlib_nor_flax():
    code = ("import sys, VS_train, VS_inference, chip_smoke; "
            "print(sorted(m for m in ('matplotlib', 'flax') "
            "if m in sys.modules))")
    assert _run(code, {}) == "[]"


def test_figures_are_skipped_without_matplotlib(tmp_path, monkeypatch, caplog):
    from vs_seg.eval import figures
    monkeypatch.setattr(figures, "_pyplot", lambda: None)
    with caplog.at_level("INFO"):
        figures.save_dice_histogram(np.array([0.5, 0.7]), str(tmp_path))
    assert os.listdir(tmp_path) == []
    assert "skipped figure save_dice_histogram" in caplog.text


def test_figures_are_written_with_matplotlib(tmp_path):
    pytest.importorskip("matplotlib")
    from vs_seg.eval import figures
    figures.save_dice_histogram(np.array([0.5, 0.7]), str(tmp_path))
    assert os.listdir(tmp_path) == [
        "best_model_output_dice_score_histogram.png"]
