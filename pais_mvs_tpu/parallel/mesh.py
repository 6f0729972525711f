"""Device mesh construction and sharding helpers.

The scaling model (SURVEY.md §5.8, §7): the patch batch is the data-parallel
axis ("patch") — PSO swarms are embarrassingly parallel — and the camera
axis ("view") shards the image pyramids, with psum-composed photoconsistency
across view shards. The reference has no distributed story at all (OpenMP
only, TMVS C11); this is new design, scaled by XLA collectives between
devices.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

PATCH_AXIS = "patch"
VIEW_AXIS = "view"


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Create a (patch, view) mesh. Default: all devices on the patch axis
    (view replication), the right choice while pyramids fit per device."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if shape is None:
        shape = (n, 1)
    assert shape[0] * shape[1] == n, (shape, n)
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, (PATCH_AXIS, VIEW_AXIS))


def patch_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Leading axis over the patch mesh axis, rest replicated."""
    return NamedSharding(mesh, P(PATCH_AXIS, *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_patch_batch(pb, mesh: Mesh):
    """Place a PatchBatch with its leading (patch) axis sharded."""
    return jax.tree.map(
        lambda x: jax.device_put(x, patch_sharding(mesh, x.ndim)), pb)


def replicate_scene(scene, mesh: Mesh):
    return jax.tree.map(lambda x: jax.device_put(x, replicated(mesh)), scene)


def scene_view_specs(scene):
    """PartitionSpec pytree for a Scene under view sharding: the four big
    per-camera atlases (images/edges/var/rgb) shard over the view axis
    (camera axis 0); the small leaves (rig, dims, yoff) replicate. Matches
    the layout every ops/view_fitness consumer expects."""
    pyr = scene.pyramids
    pyr_spec = type(pyr)(images=P(VIEW_AXIS), edges=P(VIEW_AXIS),
                         dims=P(), rgb=P(VIEW_AXIS), var=P(VIEW_AXIS),
                         yoff=P())
    return type(scene)(rig=jax.tree.map(lambda _: P(), scene.rig),
                       pyramids=pyr_spec)
