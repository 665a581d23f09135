"""Device-mesh voxel data parallelism.

The reference's only parallelism is voxel-chunking over host threads
(/root/reference/amico/models.pyx:204-211,529-541).  The analog here
(SURVEY.md sections 2.4, 5.8) is a 1-D ``('data',)`` mesh over the local
devices: voxel *tiles* (see models.engine) are sharded across chips; every
dictionary/kernel tensor is replicated (they are small); no collectives are
needed in the solve itself -- the problem is embarrassingly parallel -- and
``psum``-style reductions are used only for global statistics (the
reference's whole-volume reductions, core.py:213,223).

Multi-host: ``jax.distributed.initialize`` + per-host voxel slabs at load
time; this module only assumes ``jax.devices()`` reflects the slice.
"""
from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = 'data'


def make_mesh(n_devices: int | None = None, axis_name: str = DATA_AXIS) -> Mesh:
    """1-D mesh over (the first n of) this process's devices.

    Host-LOCAL on purpose: under ``jax.distributed`` each host fits its own
    voxel slab on its own chips (docs/DISTRIBUTED.md), so the mesh must not
    span other hosts' non-addressable devices -- ``jax.devices()`` does
    after ``initialize()``, which would make ``device_put`` of slab tiles
    fail.  In a single process the two device lists are identical.
    """
    devs = jax.local_devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))


def tile_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (tile) axis across the data axis; trailing axes
    replicated."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_tiles(mesh: Mesh, *arrays):
    """device_put tile-major arrays with the data-parallel sharding."""
    sh = tile_sharding(mesh)
    out = tuple(jax.device_put(a, sh) for a in arrays)
    return out if len(out) > 1 else out[0]


def masked_mean(values, valid):
    """Global mean of per-voxel statistics over valid voxels.

    Works on sharded tile arrays: implemented with jnp reductions so XLA
    inserts the cross-chip collectives (psum over ICI) automatically under
    jit; the explicit shard_map variant is in tests/test_sharding.py.
    """
    import jax.numpy as jnp
    v = jnp.asarray(values)
    m = jnp.asarray(valid, v.dtype)
    return jnp.sum(v * m) / jnp.maximum(jnp.sum(m), 1.0)
