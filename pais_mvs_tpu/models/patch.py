"""Patch state as a fixed-capacity struct-of-arrays batch.

The reference's central data structure is a heap-allocated ``Patch`` object
per point, stored in a ``map<int, Patch>`` (TMVS/mvs/abstractpatch.h:20-53).
Here a batch of patches is one pytree of ``[B, ...]`` arrays with a validity
mask — every lifecycle op is a masked tensor program, so thousands of
patches refine in lockstep on the device.

Per-patch visible cameras are a dense boolean mask over the (small) camera
axis instead of a ragged index list.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import jax.numpy as jnp

from pais_mvs_tpu.models import pytree_dataclass


@pytree_dataclass
class PatchBatch:
    """A batch of B patches against a C-camera rig."""

    center: Any        # [B, 3] f32 world position
    normal_sph: Any    # [B, 2] f32 (theta, phi)
    cam_mask: Any      # [B, C] bool visibility
    ref_cam: Any       # [B] int32 reference camera index
    depth: Any         # [B] f32 distance from reference camera
    ray: Any           # [B, 3] f32 unit ray from reference camera
    depth_range: Any   # [B, 2] f32 (lo, hi) PSO depth bounds
    lod: Any           # [B] int32 pyramid level
    fitness: Any       # [B] f32 (lower = better)
    correlation: Any   # [B] f32 mean pairwise NCC
    priority: Any      # [B] f32 (lower = better)
    color: Any         # [B, 3] f32 RGB 0..255
    img_point: Any     # [B, C, 2] f32 level-0 projections (valid where cam_mask)
    valid: Any         # [B] bool alive flag (not dropped)
    expanded: Any      # [B] bool already used as expansion parent
    is_seed: Any       # [B] bool seed (vs expansion) patch

    @property
    def capacity(self) -> int:
        return self.center.shape[0]

    @property
    def num_cameras(self) -> int:
        return self.cam_mask.shape[1]

    def normal(self):
        from pais_mvs_tpu.ops import geometry
        return geometry.spherical_to_normal(self.normal_sph)

    def cam_count(self):
        return jnp.sum(self.cam_mask, axis=-1).astype(jnp.int32)


def empty_batch(capacity: int, num_cams: int) -> PatchBatch:
    # HOST numpy arrays: batches are assembled at ragged sizes on the host
    # and only become device arrays at the fixed-shape refine boundary —
    # jnp ops here would trigger one XLA compile per novel shape
    z = lambda *s: np.zeros(s, dtype=np.float32)
    return PatchBatch(
        center=z(capacity, 3), normal_sph=z(capacity, 2),
        cam_mask=np.zeros((capacity, num_cams), dtype=bool),
        ref_cam=np.zeros(capacity, dtype=np.int32),
        depth=z(capacity), ray=z(capacity, 3), depth_range=z(capacity, 2),
        lod=np.zeros(capacity, dtype=np.int32),
        fitness=z(capacity), correlation=z(capacity), priority=z(capacity),
        color=z(capacity, 3), img_point=z(capacity, num_cams, 2),
        valid=np.zeros(capacity, dtype=bool),
        expanded=np.zeros(capacity, dtype=bool),
        is_seed=np.zeros(capacity, dtype=bool),
    )


def from_seeds(centers: np.ndarray, cam_masks: np.ndarray,
               img_points: np.ndarray | None = None,
               colors: np.ndarray | None = None) -> PatchBatch:
    """Build a seed batch from triangulated points.

    Args:
      centers: [B, 3]; cam_masks: [B, C] bool;
      img_points: [B, C, 2] measured pixel positions (level 0) or None;
      colors: [B, 3] RGB or None.
    """
    B, C = cam_masks.shape
    pb = empty_batch(B, C)
    return pb.replace(
        center=np.asarray(centers, dtype=np.float32),
        cam_mask=np.asarray(cam_masks, dtype=bool),
        img_point=(np.asarray(img_points, dtype=np.float32)
                   if img_points is not None else pb.img_point),
        color=(np.asarray(colors, dtype=np.float32)
               if colors is not None else pb.color),
        valid=np.ones(B, dtype=bool),
        is_seed=np.ones(B, dtype=bool),
    )


def concat(a: PatchBatch, b: PatchBatch) -> PatchBatch:
    import jax
    return jax.tree.map(
        lambda x, y: np.concatenate([np.asarray(x), np.asarray(y)], axis=0),
        a, b)


def take(pb: PatchBatch, idx) -> PatchBatch:
    import jax
    return jax.tree.map(lambda x: np.asarray(x)[idx], pb)
