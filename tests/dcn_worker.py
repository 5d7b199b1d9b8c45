"""Worker for tests/test_distributed.py: one process of a 2-process x
4-virtual-CPU-device data-parallel train step over a ("dcn", "data") mesh.

Run: python tests/dcn_worker.py <process_id> <num_processes> <port>
Prints "DCN_LOSS <loss>" on success.
"""

import os
import sys

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=4").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# go through the production wrapper (regression: it used to touch
# jax.process_count() first, initializing the backend and making
# distributed init raise on every real multi-host launch)
from vs_seg.parallel.distributed import initialize  # noqa: E402

initialize(coordinator_address=f"127.0.0.1:{port}",
           num_processes=nproc, process_id=pid)
assert jax.distributed.is_initialized()

import numpy as np  # noqa: E402
import jax.random as jrandom  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from vs_seg.core.config import Config  # noqa: E402
from vs_seg.models import build_model  # noqa: E402
from vs_seg.parallel.distributed import (  # noqa: E402
    make_global_batch, make_global_mesh, shard_files_for_process,
)
from vs_seg.train.trainer import Trainer  # noqa: E402

assert jax.process_count() == nproc
assert len(jax.devices()) == 4 * nproc, jax.devices()

mesh = make_global_mesh()
assert dict(mesh.shape) == {"dcn": nproc, "data": 4}

# cheap collective first: establishes the Gloo contexts and synchronizes the
# processes so the heavy train-step compile starts simultaneously on both
# (otherwise compile skew can exceed Gloo's 30 s connect timeout)
from jax.experimental import multihost_utils  # noqa: E402

multihost_utils.sync_global_devices("dcn_worker_precompile")

# per-process dataset sharding sanity (SURVEY §2.5)
files = [f"case_{i}" for i in range(10)]
mine = shard_files_for_process(files)
assert mine == files[pid::nproc]

cfg = Config(pad_crop_shape=(32, 32, 8), compute_dtype="float32",
             train_batch_size=4 * nproc,
             channels=(2, 4, 6, 8),
             strides=((2, 2, 1), (2, 2, 2), (2, 2, 2)),
             kernel_sizes=((3, 3, 1), (3, 3, 3), (3, 3, 3), (3, 3, 3)),
             sample_kernel_sizes=((3, 3, 1), (3, 3, 3), (3, 3, 3)))
model = build_model(cfg)
trainer = Trainer(cfg, model, mesh=mesh)
state = trainer.init_state()

rng = np.random.default_rng(0)
n = 4 * nproc
image_g = rng.normal(size=(n, 8, 32, 32, 1)).astype(np.float32)
label_g = (rng.random((n, 8, 32, 32, 1)) > 0.8).astype(np.float32)
# each host only materializes ITS slice of the global batch (DCN data path)
local = slice(pid * 4, (pid + 1) * 4)
image, label = make_global_batch(mesh, (image_g[local], label_g[local]))

from vs_seg.parallel.distributed import replicate_tree  # noqa: E402

params = replicate_tree(mesh, state["params"])
batch_stats = replicate_tree(mesh, state["batch_stats"])
opt_state = replicate_tree(mesh, state["opt_state"])
key = jax.random.wrap_key_data(
    replicate_tree(mesh, jax.random.key_data(jrandom.key(0))))

# AOT-compile locally (no cross-process dependency), THEN barrier, THEN
# execute: both processes reach the collective within the barrier skew, so
# Gloo context init (30 s connect timeout) cannot expire on compile skew.
compiled = trainer.train_step.lower(
    params, batch_stats, opt_state, key, image, label).compile()
multihost_utils.sync_global_devices("dcn_worker_postcompile")
params, batch_stats, opt_state, _, loss = compiled(
    params, batch_stats, opt_state, key, image, label)
print(f"DCN_LOSS {float(loss):.8f}", flush=True)
