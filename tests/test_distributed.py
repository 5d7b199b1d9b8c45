"""Multi-host DCN scaffolding (SURVEY §2.5): a REAL 2-process x 4-device CPU
run of one data-parallel train step over the ("dcn", "data") mesh, compared
against the same step computed single-process. Gradient reduction rides the
mesh axes (GSPMD-inserted psum: ICI within a host, DCN across hosts)."""

import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_dp_train_step_matches_single_process():
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = "/root/repo:" + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, "tests/dcn_worker.py", str(pid), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd="/root/repo")
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=900)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    losses = [float(re.search(r"DCN_LOSS ([0-9.]+)", o).group(1)) for o in outs]
    assert losses[0] == losses[1]

    # single-process reference on the 8-virtual-device mesh (conftest env)
    import jax
    import jax.random as jrandom
    from vs_seg.core.config import Config
    from vs_seg.models import build_model
    from vs_seg.parallel.distributed import make_global_batch
    from vs_seg.parallel.mesh import make_mesh
    from vs_seg.train.trainer import Trainer

    cfg = Config(pad_crop_shape=(32, 32, 8), compute_dtype="float32",
                 train_batch_size=8,
                 channels=(2, 4, 6, 8),
                 strides=((2, 2, 1), (2, 2, 2), (2, 2, 2)),
                 kernel_sizes=((3, 3, 1), (3, 3, 3), (3, 3, 3), (3, 3, 3)),
                 sample_kernel_sizes=((3, 3, 1), (3, 3, 3), (3, 3, 3)))
    model = build_model(cfg)
    mesh = make_mesh()
    trainer = Trainer(cfg, model, mesh=mesh)
    state = trainer.init_state()
    rng = np.random.default_rng(0)
    image = rng.normal(size=(8, 8, 32, 32, 1)).astype(np.float32)
    label = (rng.random((8, 8, 32, 32, 1)) > 0.8).astype(np.float32)
    im, lb = make_global_batch(mesh, (image, label))
    _, _, _, _, loss = trainer.train_step(
        state["params"], state["batch_stats"], state["opt_state"],
        jrandom.key(0), im, lb)
    np.testing.assert_allclose(losses[0], float(loss), atol=2e-6)


def test_shard_files_equal_counts_and_coverage():
    """Every host must get the SAME case count (unequal counts deadlock the
    gradient psum); the tail wraps around, and all files stay covered."""
    from vs_seg.parallel.distributed import shard_files_for_process
    for n_files, n_hosts in [(10, 3), (8, 4), (7, 2), (3, 8)]:
        files = list(range(n_files))
        shards = [shard_files_for_process(files, pid, n_hosts)
                  for pid in range(n_hosts)]
        assert len({len(s) for s in shards}) == 1, (n_files, n_hosts)
        covered = set().union(*[set(s) for s in shards])
        assert covered == set(files), (n_files, n_hosts)
