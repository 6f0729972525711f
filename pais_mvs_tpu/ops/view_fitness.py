"""View-sharded photoconsistency: the production fitness/NCC paths on a
camera-block shard of the pyramids, composed with collectives over a mesh
"view" axis.

This is the memory-scaling half of the SPMD design (SURVEY.md §5.8): the
patch axis shards swarms, the VIEW axis shards the per-camera mip-atlases —
at 4096x3072 x 8 cams the replicated atlases (bf16 images, edges and
variance plus uint8 color) take about 3 GiB per device and grow linearly
with the camera count, so large rigs need the pyramids split. Every
function here runs INSIDE a ``shard_map`` whose in_specs place
``scene.pyramids.{images,edges,var,rgb}`` on the view axis (camera axis 0)
and replicate the small leaves (rig, dims, yoff).

Cross-view composition facts (reference semantics being composed,
TMVS/mvs/patch.cpp:914-1047: every cross-camera term is a sum or mean):

  * the per-pixel mean / SAD / validity compose with ``psum`` over the
    view axis — the fitness each swarm sees equals the single-device value
    to f32 reassociation (exactly, when the view axis has size 1);
  * reference-camera lookups (foreground / edge-weight windows, LOD
    variance, patch color) live on the shard owning ``ref_cam`` — a
    one-hot ownership mask + psum replicates them;
  * the NCC correlation table is pairwise across ALL cameras, so the
    locally-warped window vectors are ``all_gather``'d before the (tiny)
    [C, C] table math.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pais_mvs_tpu.config import MvsConfig
from pais_mvs_tpu.models.camera import CameraRig, Scene
from pais_mvs_tpu.ops import fitness as F
from pais_mvs_tpu.ops import geometry as geom
from pais_mvs_tpu.ops.geometry import BIG


def _local_slices(rig: CameraRig, dims, c_local: int, axis: str):
    """Per-shard camera-block offsets and parameter slices."""
    vi = jax.lax.axis_index(axis)
    offset = vi * c_local
    sl = lambda a: jax.lax.dynamic_slice_in_dim(a, offset, c_local, 0)
    return offset, sl(rig.R), sl(rig.T), sl(rig.focal), sl(rig.principal), \
        sl(dims)


def own_psum(x, own, axis: str):
    """psum of ``x`` masked to the owning shard (``own`` broadcastable
    bool). ``where`` (not multiply) so non-owner garbage/NaN cannot leak."""
    return jax.lax.psum(jnp.where(own, x, jnp.zeros((), x.dtype)), axis)


def _local_homographies(rig, dims, c_local, axis, center, normal,
                        ref_cam, lod_scale):
    """Plane homographies ref -> each LOCAL camera, identity pinned on the
    reference camera's own entry (patch.cpp:316-319). ``center``/``normal``
    [..., 3] broadcast over leading dims; ref_cam/lod_scale match leading
    dims. Returns (H [..., c_local, 3, 3], hok [..., c_local], offset)."""
    offset, R_loc, T_loc, f_loc, pp_loc, dims_loc = _local_slices(
        rig, dims, c_local, axis)
    H, hok = geom.plane_homography(
        center[..., None, :], normal[..., None, :],
        rig.R[ref_cam][..., None, :, :], rig.T[ref_cam][..., None, :],
        rig.focal[ref_cam][..., None, :],
        rig.principal[ref_cam][..., None, :],
        R_loc, T_loc, f_loc, pp_loc, lod_scale[..., None])
    glob_idx = offset + jnp.arange(c_local)
    shape = (1,) * (H.ndim - 3) + (c_local,)
    is_ref = glob_idx.reshape(shape) == ref_cam[..., None]
    H = jnp.where(is_ref[..., None, None], jnp.eye(3, dtype=H.dtype), H)
    hok = hok | is_ref
    return H, hok, offset, dims_loc


# ---------------------------------------------------------------------------
# fitness
# ---------------------------------------------------------------------------

def fitness_view_jnp(rig: CameraRig, images_loc, edges_loc, dims_glob, yoff,
                     cfg: MvsConfig, c_local: int, ref_cam, cam_mask, lod,
                     ray, pos, axis: str):
    """Per-shard jnp gather fitness over the local camera block,
    psum-composed over the view axis. Mirrors ops.fitness.patch_fitness
    (same reference semantics, TMVS/mvs/patch.cpp:914-1047)."""
    B, Pn, _ = pos.shape

    normal = geom.spherical_to_normal(pos[..., :2])
    ref_center = rig.center[ref_cam]
    center = ray[:, None, :] * pos[..., 2:3] + ref_center[:, None, :]
    facing_bad = jnp.einsum("bpk,bk->bp", normal, rig.optical[ref_cam]) > 0
    lod_scale = jnp.power(jnp.float32(cfg.lod_ratio), lod.astype(jnp.float32))

    ref_cam_bp = jnp.broadcast_to(ref_cam[:, None], (B, Pn))
    ls_bp = jnp.broadcast_to(lod_scale[:, None], (B, Pn))
    H, hok, offset, dims_loc = _local_homographies(
        rig, dims_glob, c_local, axis, center, normal, ref_cam_bp,
        ls_bp)
    cam_mask_loc = jax.lax.dynamic_slice_in_dim(cam_mask, offset, c_local, 1)

    def _proj(Xbp, c, s):
        return geom.project(Xbp, rig.R[c], rig.T[c], rig.focal[c],
                            rig.principal[c], s)[0]
    pt = jax.vmap(jax.vmap(_proj, in_axes=(0, None, None)))(
        center, ref_cam, lod_scale)                            # [B, P, 2]

    r = cfg.patch_radius
    ref_dims = dims_glob[ref_cam, lod].astype(jnp.float32)     # replicated
    in_ref = ((pt[..., 0] - r >= 2) & (pt[..., 0] + r < ref_dims[:, None, 1] - 3) &
              (pt[..., 1] - r >= 2) & (pt[..., 1] + r < ref_dims[:, None, 0] - 3))

    offs = jnp.asarray(F.window_offsets(r))
    W2 = offs.shape[0]
    win = pt[:, :, None, :] + offs[None, None, :, :]           # [B, P, W2, 2]

    # reference-image lookups live on the shard owning ref_cam -> psum
    own = (ref_cam >= offset) & (ref_cam < offset + c_local)   # [B]
    ref_loc = jnp.clip(ref_cam - offset, 0, c_local - 1)
    ref_b = jnp.broadcast_to(ref_loc[:, None, None], (B, Pn, W2))
    lod_b = jnp.broadcast_to(lod[:, None, None], (B, Pn, W2))
    ownb = own[:, None, None]
    ref_int = own_psum(
        F.nearest_gather(images_loc, yoff, ref_b, lod_b, win), ownb, axis)
    fg = ref_int != 0

    # warp into local cameras
    x = win[..., 0][..., None]
    y = win[..., 1][..., None]
    Hc = H[:, :, None, :, :, :]
    w = Hc[..., 2, 0] * x + Hc[..., 2, 1] * y + Hc[..., 2, 2]
    sw = jnp.where(w == 0, 1.0, w)
    u = (Hc[..., 0, 0] * x + Hc[..., 0, 1] * y + Hc[..., 0, 2]) / sw
    v = (Hc[..., 1, 0] * x + Hc[..., 1, 1] * y + Hc[..., 1, 2]) / sw
    uv = jnp.stack([u, v], axis=-1)                            # [B,P,W2,c,2]

    cam_idx = jnp.broadcast_to(jnp.arange(c_local, dtype=jnp.int32),
                               (B, Pn, W2, c_local))
    lod_b4 = jnp.broadcast_to(lod[:, None, None, None], (B, Pn, W2, c_local))
    vals, vok = F.bilinear_gather(images_loc, yoff, cam_idx, lod_b4, uv,
                                  dims_loc, 2.0, 3.0)
    vok = vok & (w != 0)

    m = cam_mask_loc[:, None, None, :]
    mf = m.astype(vals.dtype)
    cam_num = jnp.sum(cam_mask, axis=-1).astype(vals.dtype)    # global count
    cn = cam_num[:, None, None]
    sum_v = jax.lax.psum(jnp.sum(vals * mf, axis=-1), axis)
    mean = sum_v / cn
    sad = jax.lax.psum(jnp.sum(jnp.abs(vals - mean[..., None]) * mf, axis=-1),
                       axis) / cn

    bad = jax.lax.psum(
        jnp.sum((~vok & m).astype(jnp.int32), axis=-1), axis)
    pix_ok = bad == 0
    hbad = jax.lax.psum(
        jnp.sum((~hok & cam_mask_loc[:, None, :]).astype(jnp.int32), axis=-1),
        axis)
    cand_ok = jnp.all(pix_ok | ~fg, axis=-1) & (hbad == 0) & in_ref & \
        ~facing_bad

    weight = jnp.ones_like(sad)
    if cfg.adaptive_distance_enable:
        weight = weight * jnp.asarray(F.dist_weight_table(cfg))[None, None, :]
    if cfg.adaptive_difference_enable:
        weight = weight * jnp.exp(-sad * sad / jnp.float32(cfg.diff_weighting))
    if cfg.adaptive_gradient_enable:
        edge = own_psum(
            F.nearest_gather(edges_loc, yoff, ref_b, lod_b, win), ownb, axis)
        safe_edge = jnp.maximum(edge * jnp.float32(cfg.gradient_weighting),
                                1e-20)
        weight = weight * jnp.exp(-1.0 / safe_edge)

    wfg = weight * fg.astype(weight.dtype)
    sum_w = jnp.sum(wfg, axis=-1)
    fit = jnp.sum(wfg * sad, axis=-1) / jnp.where(sum_w > 0, sum_w, 1.0)
    return jnp.where(cand_ok & (sum_w > 0), fit, BIG)


def patch_fitness_view(scene: Scene, cfg: MvsConfig, ref_cam, cam_mask, lod,
                       ray, pos, axis: str):
    """View-sharded drop-in for ``ops.fitness.patch_fitness``: ``scene``
    holds a LOCAL camera block of the big atlases (in_specs put them on
    ``axis``) with rig/dims/yoff replicated."""
    pyrs = scene.pyramids
    return fitness_view_jnp(
        scene.rig, pyrs.images, pyrs.edges, pyrs.dims, pyrs.yoff, cfg,
        pyrs.images.shape[0], ref_cam, cam_mask, lod, ray, pos, axis)


# ---------------------------------------------------------------------------
# NCC correlation vectors (removeInvisibleCamera's input)
# ---------------------------------------------------------------------------

def warped_vectors_view(scene: Scene, cfg: MvsConfig, center, normal,
                        ref_cam, cam_mask, lod, axis: str):
    """View-sharded ops.fitness.warped_patch_vectors (patch.cpp:221-267,
    332-386): each shard warps+samples its camera block ([B, c, W2]), the
    blocks are all_gather'd over the view axis (the pairwise NCC table
    needs every pair), and the table math runs replicated (it is [C, C]
    tiny). Same (vecs, corr, correlation, ok) contract."""
    rig, pyrs = scene.rig, scene.pyramids
    B = center.shape[0]
    c_local = pyrs.images.shape[0]
    lod_scale = jnp.power(jnp.float32(cfg.lod_ratio), lod.astype(jnp.float32))
    H, hok, offset, dims_loc = _local_homographies(
        rig, pyrs.dims, c_local, axis, center, normal, ref_cam,
        lod_scale)                                             # [B, c, 3, 3]
    cam_mask_loc = jax.lax.dynamic_slice_in_dim(cam_mask, offset, c_local, 1)

    def _proj(Xb, c, s):
        return geom.project(Xb, rig.R[c], rig.T[c], rig.focal[c],
                            rig.principal[c], s)[0]
    pt = jax.vmap(_proj)(center, ref_cam, lod_scale)           # [B, 2]

    offs = jnp.asarray(F.window_offsets(cfg.patch_radius))
    win = pt[:, None, :] + offs[None, :, :]                    # [B, W2, 2]
    x = win[..., 0][..., None]
    y = win[..., 1][..., None]
    Hc = H[:, None, :, :, :]
    w = Hc[..., 2, 0] * x + Hc[..., 2, 1] * y + Hc[..., 2, 2]
    sw = jnp.where(w == 0, 1.0, w)
    u = (Hc[..., 0, 0] * x + Hc[..., 0, 1] * y + Hc[..., 0, 2]) / sw
    v = (Hc[..., 1, 0] * x + Hc[..., 1, 1] * y + Hc[..., 1, 2]) / sw
    uv = jnp.stack([u, v], axis=-1)                            # [B, W2, c, 2]
    W2 = offs.shape[0]
    cam_idx = jnp.broadcast_to(jnp.arange(c_local, dtype=jnp.int32),
                               (B, W2, c_local))
    lod_b = jnp.broadcast_to(lod[:, None, None], (B, W2, c_local))
    vals, vok_bwc = F.bilinear_gather(pyrs.images, pyrs.yoff, cam_idx,
                                      lod_b, uv, dims_loc, 0.0, 1.0)
    vok_bwc = vok_bwc & (w != 0)
    vecs_loc = jnp.swapaxes(vals, 1, 2)                        # [B, c, W2]

    m = cam_mask_loc[:, None, :]
    ok_loc = jnp.all(jnp.all(vok_bwc | ~m, axis=1)
                     & (hok | ~cam_mask_loc), axis=-1)
    ok = jax.lax.psum((~ok_loc).astype(jnp.int32), axis) == 0

    # masked cams' rows are not part of the table — zero them
    vecs_loc = jnp.where(cam_mask_loc[:, :, None], vecs_loc, 0.0)
    vecs = jax.lax.all_gather(vecs_loc, axis, axis=1, tiled=True)  # [B,C,W2]
    return F.ncc_from_vectors(vecs, cam_mask, ok)
