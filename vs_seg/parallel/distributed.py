"""Multi-host (DCN) scaffolding.

SURVEY §2.5: the reference is single-process/single-GPU; here collectives
run among the devices of a host and across hosts ("dcn"). This module adds
the across-hosts half: `jax.distributed` initialization, a
("dcn", "data") hybrid mesh (processes x local devices), per-process dataset
sharding, and global-batch assembly from process-local host arrays.

Data-parallel training shards the batch over BOTH axes (gradient psum runs
within a host and across hosts, inserted by GSPMD from the sharding
annotations). Verified by a real 2-process x 4-virtual-CPU-device test
(tests/test_distributed.py) whose loss matches the single-process 8-device
run exactly.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None) -> None:
    """jax.distributed.initialize wrapper (no-op if already initialized or
    single-process with no coordinator given).

    Must not touch any backend-initializing jax API (jax.devices,
    jax.process_count, ...) before jax.distributed.initialize — doing so
    initializes the local XLA backend and makes distributed init raise."""
    if coordinator_address is None and num_processes in (None, 1):
        return
    if jax.distributed.is_initialized():
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)


def make_global_mesh(axes: Tuple[str, str] = ("dcn", "data")) -> Mesh:
    """(num_processes, devices_per_process) mesh: axis 0 spans hosts (DCN),
    axis 1 spans each host's local devices."""
    n_proc = jax.process_count()
    devices = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    per_proc = len(devices) // n_proc
    dev_array = np.asarray(devices).reshape(n_proc, per_proc)
    return Mesh(dev_array, axes)


def shard_files_for_process(files: Sequence, process_id: Optional[int] = None,
                            num_processes: Optional[int] = None) -> list:
    """Strided per-host dataset partition (each host loads only its cases).

    Every host must see the SAME number of cases — a host with one extra
    batch would enter a gradient psum the others never reach (distributed
    hang) and break make_global_batch's equal-local-shape requirement. When
    the case count doesn't divide, the tail wraps around (standard DP sample
    duplication)."""
    pid = jax.process_index() if process_id is None else process_id
    n = jax.process_count() if num_processes is None else num_processes
    files = list(files)
    if not files or n <= 1:
        return files
    per_host = -(-len(files) // n)  # ceil
    return [files[(pid + n * i) % len(files)] for i in range(per_host)]


def global_batch_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Leading dim sharded over every mesh axis (dcn x data)."""
    spec = [None] * ndim
    axes = tuple(mesh.axis_names)
    spec[0] = axes if len(axes) > 1 else axes[0]
    return NamedSharding(mesh, P(*spec))


def replicate_tree(mesh: Mesh, tree):
    """Fully replicate a pytree of (identical-across-hosts) host arrays over
    a possibly multi-process mesh."""
    rep = NamedSharding(mesh, P())
    if jax.process_count() == 1:
        return jax.tree_util.tree_map(lambda x: jax.device_put(x, rep), tree)
    return jax.tree_util.tree_map(
        lambda x: jax.make_array_from_process_local_data(rep, np.asarray(x)),
        tree)


def make_global_batch(mesh: Mesh, local_tree):
    """Assemble a global jax.Array batch from each process's LOCAL host
    arrays (leading dim = local batch). Single-process: plain device_put."""
    sharding_of = lambda x: global_batch_sharding(mesh, np.ndim(x))
    if jax.process_count() == 1:
        return jax.tree_util.tree_map(
            lambda x: jax.device_put(x, sharding_of(x)), local_tree)
    return jax.tree_util.tree_map(
        lambda x: jax.make_array_from_process_local_data(sharding_of(x), x),
        local_tree)
