"""Batched patch lifecycle: everything ``Patch::refine`` does, as masked
tensor programs over a whole batch.

The reference refines one patch at a time through a stateful method chain
(TMVS/mvs/patch.cpp:114-176): pick reference camera, derive depth/ray,
bound the depth search, pick a pyramid level, run PSO, drop invisible
cameras, repeat until the camera set stabilizes. Here each step is a pure
function over ``[B, ...]`` arrays; the stabilization loop becomes a fixed
number of re-optimization rounds (seeds) with per-patch drop masks.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from pais_mvs_tpu.config import MvsConfig
from pais_mvs_tpu.models.camera import Scene
from pais_mvs_tpu.models.patch import PatchBatch
from pais_mvs_tpu.ops import fitness as F
from pais_mvs_tpu.ops import geometry as geom
from pais_mvs_tpu.ops.pso import gln_pso


# ---------------------------------------------------------------------------
# per-step primitives
# ---------------------------------------------------------------------------

def set_reference_camera(scene: Scene, normal, cam_mask):
    """argmax over visible cameras of normal . (-optical axis).
    Ref: Patch::setReferenceCameraIndex (patch.cpp:415-445)."""
    corr = -jnp.einsum("bk,ck->bc", normal, scene.rig.optical)
    corr = jnp.where(cam_mask, corr, -jnp.inf)
    return jnp.argmax(corr, axis=-1).astype(jnp.int32)


def set_depth_and_ray(scene: Scene, center, ref_cam):
    """Ref: Patch::setDepthAndRay (patch.cpp:447-461)."""
    ray = center - scene.rig.center[ref_cam]
    depth = jnp.linalg.norm(ray, axis=-1)
    ray = ray / jnp.where(depth > 0, depth, 1.0)[..., None]
    return depth, ray


def set_depth_range(scene: Scene, cfg: MvsConfig, center, ray, depth,
                    ref_cam, cam_mask, neighbor_radius):
    """Depth bounds from the 1-pixel-displacement sensitivity of the other
    views (patch.cpp:463-509). Views whose image displacement is < 0.01 px
    are skipped; a patch with no usable view is dropped.

    Returns (depth_range [B, 2], drop [B])."""
    rig = scene.rig
    B = center.shape[0]
    C = rig.num_cameras
    c2 = ray * (depth + 1.0)[..., None] + rig.center[ref_cam]

    def proj_all(X):
        # project [B, 3] into every camera -> [B, C, 2]
        return jax.vmap(
            lambda Rc, Tc, fc, pc: geom.project(X, Rc, Tc, fc, pc, 1.0)[0],
            in_axes=(0, 0, 0, 0), out_axes=1)(
            rig.R, rig.T, rig.focal, rig.principal)

    p1 = proj_all(center)
    p2 = proj_all(c2)
    img_dist = jnp.linalg.norm(p1 - p2, axis=-1)              # [B, C]
    is_ref = jnp.arange(C)[None, :] == ref_cam[:, None]
    usable = cam_mask & ~is_ref & (img_dist >= 0.01)
    world_dist = 1.0 / jnp.where(img_dist > 0, img_dist, 1.0)
    world_dist = jnp.where(usable, world_dist, -jnp.inf)
    max_wd = jnp.max(world_dist, axis=-1)
    drop = ~jnp.any(usable, axis=-1)
    max_wd = jnp.where(drop, 0.0, max_wd)
    lo = jnp.maximum(depth - max_wd * cfg.depth_range_scalar, 0.0)
    hi = depth + jnp.minimum(max_wd * cfg.depth_range_scalar,
                             neighbor_radius * 100.0)
    return jnp.stack([lo, hi], axis=-1), drop


def set_lod(scene: Scene, cfg: MvsConfig, center, ref_cam,
            view_axis: str | None = None):
    """Climb the pyramid until the window's intensity variance reaches
    textureVariation (patch.cpp:511-610).

    Reference control flow per level l (starting at minLOD):
      * l >= camera maxLOD        -> use maxLOD, stop;
      * projection / window OOB   -> use max(l-1, 0), stop;
      * variance >= threshold     -> use l, stop;
      * else                      -> l+1.
    Vectorized: evaluate validity/variance at every level (L is small and
    static), then resolve the first stopping level per patch.
    """
    rig, pyrs = scene.rig, scene.pyramids
    B = center.shape[0]
    L = pyrs.num_levels

    if view_axis is not None:
        # view-sharded variance atlas: the lookup lives on the shard
        # owning ref_cam; psum replicates it (the -1 OOB sentinel survives
        # the one-hot masked sum exactly)
        from pais_mvs_tpu.ops.view_fitness import own_psum
        c_local = pyrs.var.shape[0]
        offset = jax.lax.axis_index(view_axis) * c_local
        own = (ref_cam >= offset) & (ref_cam < offset + c_local)
        ref_q = jnp.clip(ref_cam - offset, 0, c_local - 1)
    else:
        own, ref_q = None, ref_cam

    # window variance at every level via the precomputed maps (one lookup
    # per level instead of a (2r+1)^2 gather; see pyramid.window_variance_map)
    valid = []
    vars = []
    for l in range(L):
        s = jnp.float32(cfg.lod_ratio ** l)
        def _proj(Xb, c):
            return geom.project(Xb, rig.R[c], rig.T[c], rig.focal[c],
                                rig.principal[c], s)
        pt, z = jax.vmap(_proj)(center, ref_cam)              # [B, 2]
        dims = pyrs.dims[ref_cam, l].astype(jnp.float32)      # [B, 2] (h, w)
        pin = ((pt[:, 0] >= 0) & (pt[:, 0] < dims[:, 1]) &
               (pt[:, 1] >= 0) & (pt[:, 1] < dims[:, 0]) & (z > 0) &
               jnp.all(jnp.isfinite(pt), axis=-1))
        lod_b = jnp.full((B,), l, dtype=jnp.int32)
        # OOB projections feed NaN/huge coords into the gather's clip —
        # sanitize so the non-owner shards' masked rows stay finite
        pt_s = jnp.where(jnp.isfinite(pt), pt, 0.0)
        var = F.nearest_gather(pyrs.var, pyrs.yoff, ref_q, lod_b, pt_s)
        if view_axis is not None:
            from pais_mvs_tpu.ops.view_fitness import own_psum
            var = own_psum(var, own, view_axis)
        valid.append(pin & (var >= 0))
        vars.append(var)
    valid = jnp.stack(valid, axis=1)                          # [B, L]
    vars = jnp.stack(vars, axis=1)

    max_lod = rig.max_lod[ref_cam]                            # [B]
    lvl = jnp.arange(L)[None, :]
    at_cap = lvl >= max_lod[:, None]
    textured = vars >= cfg.texture_variation
    considered = lvl >= cfg.min_lod

    # first stopping level per patch
    stop_cap = at_cap & considered
    stop_oob = ~valid & ~at_cap & considered
    stop_tex = valid & textured & ~at_cap & considered
    any_stop = stop_cap | stop_oob | stop_tex
    first = jnp.argmax(any_stop, axis=1)                      # [B]
    hit = jnp.take_along_axis(any_stop, first[:, None], 1)[:, 0]
    first = jnp.where(hit, first, max_lod)                    # exhausted -> cap
    oob_first = jnp.take_along_axis(stop_oob, first[:, None], 1)[:, 0]
    lod = jnp.where(oob_first, jnp.maximum(first - 1, 0),
                    jnp.minimum(first, max_lod))
    return lod.astype(jnp.int32)


def remove_invisible_cameras(scene: Scene, cfg: MvsConfig,
                             center, normal, ref_cam, cam_mask, lod,
                             view_axis: str | None = None):
    """Ref: Patch::removeInvisibleCamera (patch.cpp:655-721).

    Returns (new_cam_mask, correlation, drop). ``correlation`` is computed
    over the PRE-removal camera set, as in the reference. With
    ``view_axis`` the warped vectors come from the view-sharded warp +
    all_gather (ops/view_fitness.py); everything downstream is rig-only
    (replicated) math.
    """
    rig = scene.rig
    B = center.shape[0]
    C = rig.num_cameras
    if view_axis is not None:
        from pais_mvs_tpu.ops import view_fitness as VF
        vecs, corr_table, correlation, ok = VF.warped_vectors_view(
            scene, cfg, center, normal, ref_cam, cam_mask, lod, view_axis)
    else:
        vecs, corr_table, correlation, ok = F.warped_patch_vectors(
            scene, cfg, center, normal, ref_cam, cam_mask, lod)

    corr_sum = jnp.sum(corr_table, axis=-1)                   # [B, C]
    corr_sum = jnp.where(cam_mask, corr_sum, -jnp.inf)
    # reference scans i = 0..camNum with >=, so ties pick the LAST index
    rev = corr_sum[:, ::-1]
    max_idx = (C - 1 - jnp.argmax(rev, axis=-1)).astype(jnp.int32)

    lod_scale = jnp.power(jnp.float32(cfg.lod_ratio), lod.astype(jnp.float32))
    H, _ = F._per_camera_homographies(scene, center, normal, ref_cam, lod_scale)

    def _proj(Xb, c, s):
        return geom.project(Xb, rig.R[c], rig.T[c], rig.focal[c],
                            rig.principal[c], s)[0]
    pt = jax.vmap(_proj)(center, ref_cam, lod_scale)          # [B, 2]

    ratio = geom.homography_region_ratio(H, pt[:, None, :])   # [B, C]
    facing = -jnp.einsum("bk,ck->bc", normal, rig.optical)    # [B, C]
    best_corr = jnp.take_along_axis(corr_table, max_idx[:, None, None],
                                    axis=1)[:, 0, :]          # [B, C]
    is_best = jnp.arange(C)[None, :] == max_idx[:, None]

    remove = (ratio < cfg.min_region_ratio) | (facing < 0) | \
             (~is_best & (best_corr < cfg.min_correlation))
    new_mask = cam_mask & ~remove
    drop = (~ok) | (jnp.sum(new_mask, axis=-1) < cfg.min_cam_num)
    return new_mask, correlation, drop


def set_priority(scene: Scene, fitness, correlation, cam_mask, lod):
    """priority = fitness * exp(-correlation - camNum/totalCams) * (LOD+1)
    (patch.cpp:612-625); lower is better."""
    total = scene.rig.num_cameras
    cam_ratio = jnp.sum(cam_mask, axis=-1).astype(fitness.dtype) / total
    return fitness * jnp.exp(-correlation - cam_ratio) * \
        (lod.astype(fitness.dtype) + 1.0)


def set_image_points_and_color(scene: Scene, center, ref_cam,
                               view_axis: str | None = None):
    """Level-0 projections into every camera + RGB color from the reference
    view (patch.cpp:627-653). Returns (img_point [B, C, 2], color [B, 3]).
    With ``view_axis`` the rgb atlas is a camera block; the color lookup
    runs on the owning shard and psum-replicates."""
    rig, pyrs = scene.rig, scene.pyramids
    B = center.shape[0]
    C = rig.num_cameras

    def per_cam(Rc, Tc, fc, pc):
        return geom.project(center, Rc, Tc, fc, pc, 1.0)[0]
    ipts = jax.vmap(per_cam, in_axes=(0, 0, 0, 0), out_axes=1)(
        rig.R, rig.T, rig.focal, rig.principal)               # [B, C, 2]

    ref_pt = jnp.take_along_axis(
        ipts, ref_cam[:, None, None].astype(jnp.int32).repeat(2, -1),
        axis=1)[:, 0, :]
    ref_pt = jnp.where(jnp.isfinite(ref_pt), ref_pt, 0.0)
    Hp, Wp = pyrs.rgb.shape[1:3]
    xi = jnp.clip(jnp.round(ref_pt[:, 0]).astype(jnp.int32), 0, Wp - 1)
    yi = jnp.clip(jnp.round(ref_pt[:, 1]).astype(jnp.int32), 0, Hp - 1)
    if view_axis is None:
        color = pyrs.rgb[ref_cam, yi, xi].astype(jnp.float32)  # [B, 3]
    else:
        from pais_mvs_tpu.ops.view_fitness import own_psum
        c_local = pyrs.rgb.shape[0]
        offset = jax.lax.axis_index(view_axis) * c_local
        own = (ref_cam >= offset) & (ref_cam < offset + c_local)
        ref_q = jnp.clip(ref_cam - offset, 0, c_local - 1)
        color = own_psum(pyrs.rgb[ref_q, yi, xi].astype(jnp.float32),
                         own[:, None], view_axis)
    return ipts, color


def runtime_filter_static(scene: Scene, cfg: MvsConfig, pb: PatchBatch,
                          view_axis: str | None = None):
    """Device-side part of MVS::runtimeFiltering (mvs.cpp:838-875): drop,
    camera count, fitness/priority/correlation gates, NaNs, background or
    out-of-frame in ANY camera, front-facing camera count. The cell-map
    density clause (mvs.cpp:877-895) lives with the host cell grid.

    Returns keep [B] bool.
    """
    rig, pyrs = scene.rig, scene.pyramids
    B = pb.capacity
    C = rig.num_cameras
    keep = pb.valid
    keep &= pb.cam_count() >= cfg.min_cam_num
    keep &= pb.fitness <= cfg.max_fitness
    keep &= pb.fitness != 0.0
    keep &= pb.priority <= 10000.0
    keep &= jnp.isfinite(pb.fitness) & jnp.isfinite(pb.priority) & \
        jnp.isfinite(pb.correlation)
    keep &= pb.correlation >= cfg.min_correlation

    # center must project inside EVERY camera, onto non-background pixels
    def per_cam(Rc, Tc, fc, pc):
        return geom.project(pb.center, Rc, Tc, fc, pc, 1.0)
    xy, z = jax.vmap(per_cam, in_axes=(0, 0, 0, 0), out_axes=1)(
        rig.R, rig.T, rig.focal, rig.principal)               # [B, C, 2], [B, C]
    dims = pyrs.dims[:, 0].astype(jnp.float32)                # [C, 2]
    inside = ((xy[..., 0] >= 0) & (xy[..., 0] < dims[None, :, 1]) &
              (xy[..., 1] >= 0) & (xy[..., 1] < dims[None, :, 0]) &
              (z > 0) & jnp.all(jnp.isfinite(xy), axis=-1))
    xy_s = jnp.where(jnp.isfinite(xy), xy, 0.0)
    if view_axis is None:
        cam_b = jnp.broadcast_to(jnp.arange(C, dtype=jnp.int32), (B, C))
        lod0 = jnp.zeros((B, C), dtype=jnp.int32)
        inten = F.nearest_gather(pyrs.images, pyrs.yoff, cam_b, lod0, xy_s)
        keep &= jnp.all(inside & (inten != 0), axis=-1)
    else:
        # local camera block + psum composition: all(inside & inten!=0)
        # over global cams == all(inside) AND zero background hits anywhere
        # (when any camera is out of frame, keep is already false and the
        # intensity term is irrelevant)
        c_local = pyrs.images.shape[0]
        offset = jax.lax.axis_index(view_axis) * c_local
        xy_loc = jax.lax.dynamic_slice_in_dim(xy_s, offset, c_local, 1)
        cam_b = jnp.broadcast_to(jnp.arange(c_local, dtype=jnp.int32),
                                 (B, c_local))
        lod0 = jnp.zeros((B, c_local), dtype=jnp.int32)
        inten = F.nearest_gather(pyrs.images, pyrs.yoff, cam_b, lod0,
                                 xy_loc)
        nz = jax.lax.psum(jnp.sum((inten == 0).astype(jnp.int32), -1),
                          view_axis)
        keep &= jnp.all(inside, axis=-1) & (nz == 0)

    facing = -jnp.einsum("bk,ck->bc", pb.normal(), rig.optical)
    front = jnp.sum((facing > 0) & pb.cam_mask, axis=-1)
    keep &= front >= cfg.min_cam_num
    return keep


# ---------------------------------------------------------------------------
# the refine driver
# ---------------------------------------------------------------------------

class RefineResult(NamedTuple):
    batch: PatchBatch
    iterations: jnp.ndarray     # [B] PSO iterations of the last round


@functools.partial(jax.jit, static_argnames=("cfg", "is_seed", "rounds",
                                             "final_filter", "view_axis"))
def refine_batch(scene: Scene, cfg: MvsConfig, pb: PatchBatch, key,
                 neighbor_radius, is_seed: bool, rounds: int,
                 final_filter: bool = True,
                 view_axis: str | None = None) -> RefineResult:
    """Batched Patch::refine (patch.cpp:114-176) + the follow-up
    removeInvisibleCamera its callers perform (mvs.cpp:215, 574).

    Seeds: full normal range, 2x particles & iterations, ``rounds``
    re-optimization rounds. Expansion: narrowed normal range
    (+-pi/reduceNormalRange), 1 round.

    ``final_filter=False`` skips the trailing MVS::runtimeFiltering gate —
    callers driving the re-optimization loop from the host pass it for the
    intermediate rounds, because the reference applies runtimeFiltering
    ONCE after the whole refine loop (mvs.cpp:217), and a seed that fails
    e.g. the minCorrelation clause mid-loop may still recover.

    ``view_axis``: set when tracing INSIDE a shard_map whose in_specs put
    the pyramid atlases (images/edges/var/rgb) on that mesh axis — every
    pyramids consumer (fitness, NCC vectors, LOD variance, color, runtime
    filter) then composes over the view shards (ops/view_fitness.py);
    rig/dims/yoff must be replicated. This is the production multi-chip
    memory-scaling path (SURVEY §5.8): per-device pyramid memory drops by
    the view-axis size.
    """
    rig = scene.rig
    B = pb.capacity
    neighbor_radius = jnp.asarray(neighbor_radius, dtype=jnp.float32)

    valid = pb.valid & (pb.cam_count() >= cfg.min_cam_num)
    center = pb.center
    normal_sph = pb.normal_sph
    cam_mask = pb.cam_mask
    fitness = pb.fitness
    correlation = pb.correlation
    iters = jnp.zeros(B, dtype=jnp.int32)

    particle_num = cfg.particle_num * (2 if is_seed else 1)
    max_iteration = cfg.max_iteration * (2 if is_seed else 1)

    lod = pb.lod
    ref_cam = pb.ref_cam
    depth = pb.depth
    ray = pb.ray
    depth_range = pb.depth_range

    fitness_fn = F.patch_fitness
    if view_axis is not None:
        from pais_mvs_tpu.ops import view_fitness as VF
        fitness_fn = functools.partial(VF.patch_fitness_view, axis=view_axis)

    for rnd in range(rounds):
        normal = geom.spherical_to_normal(normal_sph)
        ref_cam = set_reference_camera(scene, normal, cam_mask)
        depth, ray = set_depth_and_ray(scene, center, ref_cam)
        depth_range, drop_dr = set_depth_range(
            scene, cfg, center, ray, depth, ref_cam, cam_mask, neighbor_radius)
        valid &= ~drop_dr
        lod = set_lod(scene, cfg, center, ref_cam, view_axis)

        # PSO bounds (patch.cpp:183-200)
        if is_seed:
            lo_t = jnp.zeros(B)
            hi_t = jnp.full(B, jnp.pi)
        else:
            shrink = jnp.float32(jnp.pi / cfg.reduce_normal_range)
            lo_t = jnp.maximum(0.0, normal_sph[:, 0] - shrink)
            hi_t = jnp.minimum(jnp.pi, normal_sph[:, 0] + shrink)
        span_p = jnp.float32(jnp.pi / (cfg.reduce_normal_range if not is_seed
                                       else 2.0))
        lo = jnp.stack([lo_t, normal_sph[:, 1] - span_p, depth_range[:, 0]], -1)
        hi = jnp.stack([hi_t, normal_sph[:, 1] + span_p, depth_range[:, 1]], -1)
        init = jnp.stack([normal_sph[:, 0], normal_sph[:, 1], depth], -1)

        fit_fn = lambda pos: fitness_fn(
            scene, cfg, ref_cam, cam_mask, lod, ray, pos)
        res = gln_pso(fit_fn, lo.astype(jnp.float32), hi.astype(jnp.float32),
                      init.astype(jnp.float32),
                      jax.random.fold_in(key, rnd),
                      particle_num=particle_num, max_iteration=max_iteration,
                      active0=valid, exit_chunk=cfg.pso_exit_chunk)
        iters = res.iterations

        new_sph = res.gbest[:, :2]
        new_depth = res.gbest[:, 2]
        new_center = ray * new_depth[:, None] + rig.center[ref_cam]
        # only live patches move
        m1 = valid[:, None]
        normal_sph = jnp.where(m1, new_sph, normal_sph)
        depth = jnp.where(valid, new_depth, depth)
        center = jnp.where(m1, new_center, center)
        fitness = jnp.where(valid, res.gbest_fit, fitness)
        valid &= fitness <= cfg.max_fitness

        normal = geom.spherical_to_normal(normal_sph)
        new_mask, corr, drop_inv = remove_invisible_cameras(
            scene, cfg, center, normal, ref_cam, cam_mask, lod, view_axis)
        cam_mask = jnp.where(valid[:, None], new_mask, cam_mask)
        correlation = jnp.where(valid, corr, correlation)
        valid &= ~drop_inv

    # final bookkeeping (patch.cpp:174-175) with the post-PSO camera set
    normal = geom.spherical_to_normal(normal_sph)
    ref_cam = set_reference_camera(scene, normal, cam_mask)
    depth, ray = set_depth_and_ray(scene, center, ref_cam)
    depth_range, drop_dr = set_depth_range(
        scene, cfg, center, ray, depth, ref_cam, cam_mask, neighbor_radius)
    valid &= ~drop_dr
    lod = set_lod(scene, cfg, center, ref_cam, view_axis)
    priority = set_priority(scene, fitness, correlation, cam_mask, lod)
    img_point, color = set_image_points_and_color(scene, center, ref_cam,
                                                  view_axis)

    out = pb.replace(
        center=center, normal_sph=normal_sph, cam_mask=cam_mask,
        ref_cam=ref_cam, depth=depth, ray=ray, depth_range=depth_range,
        lod=lod, fitness=fitness, correlation=correlation, priority=priority,
        img_point=img_point,
        color=jnp.where(valid[:, None], color, pb.color),
        valid=valid)
    if final_filter:
        out = out.replace(valid=runtime_filter_static(scene, cfg, out,
                                                       view_axis))
    return RefineResult(out, iters)


@functools.partial(jax.jit, static_argnames=("cfg",))
def apply_runtime_filter(scene: Scene, cfg: MvsConfig,
                         pb: PatchBatch) -> PatchBatch:
    """Standalone MVS::runtimeFiltering gate (for host-driven round loops
    that defer it to the end, matching mvs.cpp:217)."""
    return pb.replace(valid=runtime_filter_static(scene, cfg, pb))


@functools.partial(jax.jit, static_argnames=("cfg",))
def rehydrate_batch(scene: Scene, cfg: MvsConfig, pb: PatchBatch,
                    neighbor_radius) -> PatchBatch:
    """Recompute all derived state from (center, spherical normal, camera
    set, fitness, correlation) — the reference's loader constructor
    (patch.cpp:45-59): refCam, depth/ray, depthRange, LOD, priority, image
    points, color."""
    valid = pb.valid & (pb.cam_count() >= cfg.min_cam_num)
    normal = geom.spherical_to_normal(pb.normal_sph)
    ref_cam = set_reference_camera(scene, normal, pb.cam_mask)
    depth, ray = set_depth_and_ray(scene, pb.center, ref_cam)
    depth_range, drop_dr = set_depth_range(
        scene, cfg, pb.center, ray, depth, ref_cam, pb.cam_mask,
        jnp.asarray(neighbor_radius, dtype=jnp.float32))
    valid &= ~drop_dr
    lod = set_lod(scene, cfg, pb.center, ref_cam)
    priority = set_priority(scene, pb.fitness, pb.correlation, pb.cam_mask,
                            lod)
    img_point, color = set_image_points_and_color(scene, pb.center, ref_cam)
    return pb.replace(ref_cam=ref_cam, depth=depth, ray=ray,
                      depth_range=depth_range, lod=lod, priority=priority,
                      img_point=img_point, color=color, valid=valid)


@functools.partial(jax.jit, static_argnames=("cfg",))
def prepare_seeds(scene: Scene, cfg: MvsConfig, pb: PatchBatch) -> PatchBatch:
    """Seed initialization after NVM load: re-triangulate from the measured
    image points and set the estimated normal (MVS::reCentering,
    mvs.cpp:135-145 + patch.cpp:67-112, 390-413)."""
    rig = scene.rig
    B = pb.capacity
    C = rig.num_cameras

    def one(ipts, mask):
        def cam_dir(c):
            return geom.pixel_to_world_dir(ipts[c], rig.R[c], rig.center[c],
                                           rig.focal[c], rig.principal[c])
        dirs = jax.vmap(cam_dir)(jnp.arange(C))
        return geom.triangulate_rays(rig.center, dirs, mask)
    centers = jax.vmap(one)(pb.img_point, pb.cam_mask)
    # keep original center if triangulation blew up
    ok = jnp.all(jnp.isfinite(centers), axis=-1)
    centers = jnp.where(ok[:, None], centers, pb.center)

    normal = geom.estimated_normal(centers, rig.center[None], pb.cam_mask)
    sph = geom.normal_to_spherical(normal)
    valid = pb.valid & (pb.cam_count() >= cfg.min_cam_num)
    return pb.replace(center=centers, normal_sph=sph, valid=valid)
