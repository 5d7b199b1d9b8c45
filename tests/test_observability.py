import logging
import time

import numpy as np

from vs_seg.core.observability import StepTimer, make_image_grid, profile_trace


def test_step_timer_eta():
    t = StepTimer(total_steps=10)
    for _ in range(3):
        t.start()
        time.sleep(0.01)
        t.stop()
    assert t.count == 3
    assert t.avg >= 0.01
    assert t.steps_per_sec > 0
    eta = t.eta_seconds()
    assert eta is not None and eta > 0
    t.log(logging.getLogger(), prefix="test ")


def test_make_image_grid_layout(rng):
    imgs = [rng.normal(size=(8, 6)) for _ in range(5)]
    grid = make_image_grid(imgs, ncols=2, pad=1)
    # 3 rows x 2 cols of 8x6 tiles with 1px padding
    assert grid.shape == (3 * 9 + 1, 2 * 7 + 1)
    assert grid.min() >= 0.0 and grid.max() <= 1.0
    # per-image normalization: each tile spans [0, 1]
    tile = grid[1:9, 1:7]
    assert np.isclose(tile.max(), 1.0) and np.isclose(tile.min(), 0.0)


def test_profile_trace_disabled_noop(tmp_path):
    with profile_trace(str(tmp_path), enabled=False):
        pass  # must not touch the profiler when disabled
