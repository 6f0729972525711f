"""SPMD patch refinement: patch-sharded swarms x view-sharded pyramids.

One ``shard_map`` over a ("patch", "view") mesh runs the whole PSO
optimization step: every device owns a slice of the patch batch and a slice
of the camera pyramids. Cross-view photoconsistency terms (per-pixel mean,
SAD, validity, reference-window lookups) compose with ``psum`` over the
view axis, so the fitness each swarm sees is exactly the single-device
value. PSO state stays view-replicated by construction (same PRNG key on
every view shard).

This is the multi-chip execution path of the hot kernel; the reference has
no equivalent (its only parallelism is OpenMP within one swarm,
TMVS/pso/psosolver.cpp:113-122). The per-shard fitness is
ops/view_fitness.fitness_view_jnp.
"""

from __future__ import annotations

import functools

import jax
from jax.sharding import Mesh, PartitionSpec as P

from pais_mvs_tpu.config import MvsConfig
from pais_mvs_tpu.models.camera import CameraRig
from pais_mvs_tpu.ops import view_fitness as VF
from pais_mvs_tpu.ops.pso import gln_pso, PsoResult
from pais_mvs_tpu.parallel.mesh import PATCH_AXIS, VIEW_AXIS


@functools.partial(jax.jit, static_argnames=("cfg", "mesh", "particle_num",
                                             "max_iteration"))
def sharded_pso_refine(rig: CameraRig, images, edges, dims_glob, yoff,
                       cfg: MvsConfig, ref_cam, cam_mask, lod, ray,
                       lo, hi, init, key, mesh: Mesh,
                       particle_num: int, max_iteration: int) -> PsoResult:
    """Run the batched GLN-PSO patch optimization SPMD over the mesh.

    Shapes (global): images/edges [C, L, H, W] (C divisible by the view
    axis), ref_cam/lod [B], cam_mask [B, C], ray [B, 3], lo/hi/init [B, 3]
    (B divisible by the patch axis). Returns a PsoResult with [B, ...]
    outputs sharded over the patch axis.
    """
    vp = mesh.shape[VIEW_AXIS]
    C = images.shape[0]
    assert C % vp == 0, (C, vp)
    c_local = C // vp

    def body(rig_r, images_loc, edges_loc, dims_g, yoff_r, ref_cam,
             cam_mask, lod, ray, lo, hi, init, key):
        pk = jax.random.fold_in(key, jax.lax.axis_index(PATCH_AXIS))
        fit_fn = lambda pos: VF.fitness_view_jnp(
            rig_r, images_loc, edges_loc, dims_g, yoff_r, cfg, c_local,
            ref_cam, cam_mask, lod, ray, pos, VIEW_AXIS)
        return gln_pso(fit_fn, lo, hi, init, pk,
                       particle_num=particle_num,
                       max_iteration=max_iteration)

    f = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(VIEW_AXIS), P(VIEW_AXIS), P(), P(),
                  P(PATCH_AXIS), P(PATCH_AXIS), P(PATCH_AXIS),
                  P(PATCH_AXIS), P(PATCH_AXIS), P(PATCH_AXIS),
                  P(PATCH_AXIS), P()),
        out_specs=PsoResult(P(PATCH_AXIS), P(PATCH_AXIS), P(PATCH_AXIS)),
        check_vma=False)
    return f(rig, images, edges, dims_glob, yoff, ref_cam, cam_mask, lod,
             ray, lo, hi, init, key)
