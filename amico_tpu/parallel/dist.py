"""Multi-host execution layer.

The reference is strictly single-node (SURVEY.md section 2.4: threads over
shared memory, no inter-process code).  Pod-scale runs here follow the
standard JAX multi-controller model:

* every host runs the same program and calls :func:`initialize` (a thin
  wrapper over ``jax.distributed.initialize``) -- afterwards
  ``jax.devices()`` spans the whole slice;
* the voxel axis is split into per-host contiguous **slabs**
  (:func:`host_slab`): each host loads/fits only its slab, so bulk voxel
  data never crosses DCN (the inter-host analog of the reference's
  per-thread voxel chunks, models.pyx:204-211);
* small results (parameter maps) are exchanged with
  :func:`allgather_rows`; file writes happen on process 0 only.

Works on any backend -- multi-process CPU (used by tests/test_dist.py via
two local processes + gloo collectives), single-process multi-device, and
clusters whose launcher wires the coordinator automatically.
"""
from __future__ import annotations

import os

import numpy as np


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids=None) -> None:
    """Join (or create) the distributed runtime.

    All arguments optional: on SLURM/OMPI launchers JAX
    auto-detects them; pass them explicitly for hand-rolled multi-process
    runs (e.g. two local CPU processes).  Safe to call when already
    initialized (no-op) and in single-process runs (num_processes=1 no-op).
    """
    if num_processes == 1:
        return
    import jax
    if jax.distributed.is_initialized():
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)


def process_count() -> int:
    import jax
    return jax.process_count()


def process_index() -> int:
    import jax
    return jax.process_index()


def is_coordinator() -> bool:
    return process_index() == 0


def host_slab(n_items: int, index: int | None = None,
              count: int | None = None) -> slice:
    """Balanced contiguous slab of ``n_items`` for this host.

    The first ``n_items % count`` hosts take one extra item, so slab sizes
    differ by at most one and concatenating all slabs in process order
    reconstructs the original axis.
    """
    count = process_count() if count is None else count
    index = process_index() if index is None else index
    base, extra = divmod(n_items, count)
    start = index * base + min(index, extra)
    stop = start + base + (1 if index < extra else 0)
    return slice(start, stop)


def allgather_rows(local_rows: np.ndarray, n_total: int) -> np.ndarray:
    """Concatenate per-host row slabs (host i contributed
    ``host_slab(n_total, i)``) into the full (n_total, ...) array on every
    host.

    Slabs may differ by one row, so each is zero-padded to the maximum slab
    size before the all-gather and trimmed after (collectives need equal
    shapes per participant).
    """
    import jax
    from jax.experimental import multihost_utils

    count = process_count()
    if count == 1:
        return np.asarray(local_rows)
    max_rows = -(-n_total // count)
    local = np.asarray(local_rows)
    pad = max_rows - local.shape[0]
    if pad:
        local = np.concatenate(
            [local, np.zeros((pad,) + local.shape[1:], local.dtype)])
    gathered = np.asarray(multihost_utils.process_allgather(local))
    # gathered: (count, max_rows, ...) in process order
    parts = [gathered[i][:host_slab(n_total, i, count).stop
                         - host_slab(n_total, i, count).start]
             for i in range(count)]
    return np.concatenate(parts, axis=0)


def broadcast_scalar(value) -> int:
    """The coordinator's value of an int scalar, on every host.

    For decisions that must be collective (e.g. skip-subject in a sweep):
    per-host filesystems can disagree about what exists -- only process 0
    writes results -- so each host deciding from its own disk desyncs the
    subsequent collectives.  Single-process: identity.
    """
    if process_count() == 1:
        return int(value)
    from jax.experimental import multihost_utils
    return int(multihost_utils.broadcast_one_to_all(
        np.asarray(value, np.int64)))


def barrier(name: str = 'amico_tpu') -> None:
    from jax.experimental import multihost_utils
    if process_count() > 1:
        multihost_utils.sync_global_devices(name)
