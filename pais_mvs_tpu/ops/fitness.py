"""Batched adaptively-weighted photoconsistency scoring.

This is the hot kernel of the whole engine — the reference evaluates it one
candidate at a time inside each particle's OpenMP thread
(``PAIS::getFitness``, TMVS/mvs/patch.cpp:914-1047). Here it is one
tensor program over ``[B, P]`` (patches x particles) that XLA compiles for
every backend: plane homographies per (candidate, camera), every camera's
window warped and bilinearly sampled with one batched gather, and the
weighted SAD reduction over cameras and window pixels. It is both the
production path and the semantic reference (``oracle.fitness_np`` is the
independent NumPy cross-check).

Semantics matched to the reference:
  * candidate = (theta, phi, depth) against a fixed (ref cam, cam set, LOD);
  * normals facing away from the reference camera are rejected (patch.cpp:939);
  * window bound margins: reference image [2, dim-3), warped views [2, dim-3)
    (patch.cpp:957-962, 999);
  * per-pixel mean over visible cameras, avgSAD = mean |c_i - mean|;
  * weight = gaussian-distance x exp(-sad^2/diffW) x exp(-1/(edge*gradW)),
    each factor gated by its adaptive-enable flag (patch.cpp:1029-1038);
  * intensity-0 reference pixels are background and contribute nothing
    (patch.cpp:986);
  * any out-of-bounds warp or degenerate homography kills the candidate
    (returns BIG, the reference's DBL_MAX).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from pais_mvs_tpu.config import MvsConfig
from pais_mvs_tpu.models.camera import Scene
from pais_mvs_tpu.ops import geometry as geom
from pais_mvs_tpu.ops.geometry import BIG


def window_offsets(patch_radius: int) -> np.ndarray:
    """[W*W, 2] (dx, dy) offsets, x-major to mirror the reference's loop
    order (patch.cpp:979-980); the Gaussian weight table is symmetric so
    order only matters for documentation."""
    r = patch_radius
    ax = np.arange(-r, r + 1, dtype=np.float32)
    dx, dy = np.meshgrid(ax, ax, indexing="ij")
    return np.stack([dx.ravel(), dy.ravel()], axis=-1)


def dist_weight_table(cfg: MvsConfig) -> np.ndarray:
    """Normalized Gaussian distance weights, flattened x-major.
    Ref: MVS::initPatchDistanceWeighting (TMVS/mvs/mvs.cpp:97-114)."""
    r = cfg.patch_radius
    sigma = cfg.dist_weighting
    ax = np.arange(-r, r + 1, dtype=np.float64)
    dx, dy = np.meshgrid(ax, ax, indexing="ij")
    g = np.exp(-(dx ** 2 + dy ** 2) / (2.0 * sigma ** 2))
    g = g / (2.0 * np.pi * sigma ** 2)
    g = g / g.sum()
    return g.ravel().astype(np.float32)


def bilinear_gather(images, yoff, cam, lod, xy, dims, lo: float,
                    hi_margin: float):
    """Bilinear-sample the mip-atlas pyramids with bounds validity.

    Args:
      images: [C, Ha, Wa] packed mip-atlas.
      yoff: [L+1] int32 atlas band row offsets.
      cam, lod: int32 arrays broadcastable to xy[..., 0].
      xy: [..., 2] sample positions (LEVEL-LOCAL coordinates).
      dims: [C, L, 2] per-level (h, w).
      lo / hi_margin: valid iff lo <= p < dim - hi_margin (reference uses
        (2, 3) in the fitness kernel and (0, 1) in the NCC warp).

    Returns: (values [...], valid [...] bool).
    """
    C, Ha, Wa = images.shape
    flat = images.reshape(-1)
    h = dims[cam, lod, 0].astype(jnp.float32)
    w = dims[cam, lod, 1].astype(jnp.float32)
    ix, iy = xy[..., 0], xy[..., 1]
    valid = ((ix >= lo) & (ix < w - hi_margin) &
             (iy >= lo) & (iy < h - hi_margin) &
             jnp.isfinite(ix) & jnp.isfinite(iy))
    x0 = jnp.floor(ix)
    y0 = jnp.floor(iy)
    fx = ix - x0
    fy = iy - y0
    x0i = jnp.clip(x0.astype(jnp.int32), 0, Wa - 2)
    y0i = jnp.clip(y0.astype(jnp.int32) + yoff[lod], 0, Ha - 2)
    idx00 = cam * (Ha * Wa) + y0i * Wa + x0i
    v00 = jnp.take(flat, idx00)
    v01 = jnp.take(flat, idx00 + 1)
    v10 = jnp.take(flat, idx00 + Wa)
    v11 = jnp.take(flat, idx00 + Wa + 1)
    val = (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
           + v10 * (1 - fx) * fy + v11 * fx * fy)
    return val, valid


def nearest_gather(images, yoff, cam, lod, xy):
    """Round-to-nearest sample (for background/edge lookups, which the
    reference does with cvRound; in-bounds is the caller's invariant)."""
    C, Ha, Wa = images.shape
    flat = images.reshape(-1)
    xi = jnp.clip(jnp.round(xy[..., 0]).astype(jnp.int32), 0, Wa - 1)
    yi = jnp.clip(jnp.round(xy[..., 1]).astype(jnp.int32) + yoff[lod],
                  0, Ha - 1)
    idx = cam * (Ha * Wa) + yi * Wa + xi
    return jnp.take(flat, idx)


def _per_camera_homographies(scene: Scene, center, normal, ref_cam, lod_scale):
    """H[..., C, 3, 3] mapping ref-LOD pixels into each camera's LOD image.
    The reference camera's entry is pinned to exact identity
    (patch.cpp:316-319)."""
    rig = scene.rig
    C = rig.num_cameras
    H, ok = geom.plane_homography(
        center[..., None, :], normal[..., None, :],
        rig.R[ref_cam][..., None, :, :], rig.T[ref_cam][..., None, :],
        rig.focal[ref_cam][..., None, :], rig.principal[ref_cam][..., None, :],
        rig.R, rig.T, rig.focal, rig.principal,
        lod_scale[..., None])
    eye = jnp.eye(3, dtype=H.dtype)
    is_ref = (jnp.arange(C) == ref_cam[..., None])
    H = jnp.where(is_ref[..., None, None], eye, H)
    ok = ok | is_ref
    return H, ok


@functools.partial(jax.jit, static_argnames=("cfg",))
def patch_fitness(scene: Scene, cfg: MvsConfig,
                  ref_cam, cam_mask, lod, ray, pos):
    """Score candidate hypotheses.

    Args:
      scene: Scene (rig + pyramids).
      cfg: static MvsConfig.
      ref_cam: [B] int32; cam_mask: [B, C] bool; lod: [B] int32;
      ray: [B, 3] unit rays from the reference cameras;
      pos: [B, P, 3] (theta, phi, depth) hypotheses.

    Returns: [B, P] f32 fitness (lower better; BIG = rejected).
    """
    rig, pyrs = scene.rig, scene.pyramids
    B, P, _ = pos.shape
    C = rig.num_cameras

    normal = geom.spherical_to_normal(pos[..., :2])          # [B, P, 3]
    ref_center = rig.center[ref_cam]                          # [B, 3]
    center = ray[:, None, :] * pos[..., 2:3] + ref_center[:, None, :]

    # reject normals facing away from the reference camera (patch.cpp:939)
    facing_bad = jnp.einsum("bpk,bk->bp", normal, rig.optical[ref_cam]) > 0

    lod_scale = jnp.power(jnp.float32(cfg.lod_ratio), lod.astype(jnp.float32))
    ref_cam_bp = jnp.broadcast_to(ref_cam[:, None], (B, P))
    H, hok = _per_camera_homographies(
        scene, center, normal, ref_cam_bp, jnp.broadcast_to(lod_scale[:, None], (B, P)))
    # H: [B, P, C, 3, 3]; hok: [B, P, C]

    # project each candidate center into the reference image at its LOD
    def _proj(Xbp, c, s):
        return geom.project(Xbp, rig.R[c], rig.T[c], rig.focal[c],
                            rig.principal[c], s)[0]
    pt = jax.vmap(jax.vmap(_proj, in_axes=(0, None, None)))(
        center, ref_cam, lod_scale)                           # [B, P, 2]

    r = cfg.patch_radius
    ref_dims = pyrs.dims[ref_cam, lod].astype(jnp.float32)    # [B, 2] (h, w)
    in_ref = ((pt[..., 0] - r >= 2) & (pt[..., 0] + r < ref_dims[:, None, 1] - 3) &
              (pt[..., 1] - r >= 2) & (pt[..., 1] + r < ref_dims[:, None, 0] - 3))

    offs = jnp.asarray(window_offsets(r))                     # [W2, 2]
    W2 = offs.shape[0]
    win = pt[:, :, None, :] + offs[None, None, :, :]          # [B, P, W2, 2]

    # background skip: reference-image intensity at the rounded window pixel
    ref_cam_bpw = jnp.broadcast_to(ref_cam[:, None, None], (B, P, W2))
    lod_bpw = jnp.broadcast_to(lod[:, None, None], (B, P, W2))
    ref_int = nearest_gather(pyrs.images, pyrs.yoff, ref_cam_bpw, lod_bpw, win)
    fg = ref_int != 0                                         # [B, P, W2]

    # warp into every camera
    x = win[..., 0][..., None]                                # [B, P, W2, 1]
    y = win[..., 1][..., None]
    Hc = H[:, :, None, :, :, :]                               # [B, P, 1, C, 3, 3]
    w = Hc[..., 2, 0] * x + Hc[..., 2, 1] * y + Hc[..., 2, 2]
    sw = jnp.where(w == 0, 1.0, w)
    u = (Hc[..., 0, 0] * x + Hc[..., 0, 1] * y + Hc[..., 0, 2]) / sw
    v = (Hc[..., 1, 0] * x + Hc[..., 1, 1] * y + Hc[..., 1, 2]) / sw
    uv = jnp.stack([u, v], axis=-1)                           # [B, P, W2, C, 2]

    cam_idx = jnp.broadcast_to(jnp.arange(C, dtype=jnp.int32), (B, P, W2, C))
    lod_b = jnp.broadcast_to(lod[:, None, None, None], (B, P, W2, C))
    vals, vok = bilinear_gather(pyrs.images, pyrs.yoff, cam_idx, lod_b, uv,
                                pyrs.dims, 2.0, 3.0)
    vok = vok & (w != 0)

    m = cam_mask[:, None, None, :]                            # [B, 1, 1, C]
    mf = m.astype(vals.dtype)
    cam_num = jnp.sum(cam_mask, axis=-1).astype(vals.dtype)   # [B]
    cn = cam_num[:, None, None]
    mean = jnp.sum(vals * mf, axis=-1) / cn                   # [B, P, W2]
    sad = jnp.sum(jnp.abs(vals - mean[..., None]) * mf, axis=-1) / cn

    # any visible camera's warp out of bounds on a foreground pixel kills the
    # candidate (the reference returns DBL_MAX on the first overflow)
    pix_ok = jnp.all(vok | ~m, axis=-1)                       # [B, P, W2]
    cand_ok = jnp.all(pix_ok | ~fg, axis=-1)                  # [B, P]
    cand_ok &= jnp.all(hok | ~m[:, :, 0, :], axis=-1)
    cand_ok &= in_ref & ~facing_bad

    weight = jnp.ones_like(sad)
    if cfg.adaptive_distance_enable:
        weight = weight * jnp.asarray(dist_weight_table(cfg))[None, None, :]
    if cfg.adaptive_difference_enable:
        weight = weight * jnp.exp(-sad * sad / jnp.float32(cfg.diff_weighting))
    if cfg.adaptive_gradient_enable:
        edge = nearest_gather(pyrs.edges, pyrs.yoff, ref_cam_bpw, lod_bpw, win)
        safe_edge = jnp.maximum(edge * jnp.float32(cfg.gradient_weighting), 1e-20)
        weight = weight * jnp.exp(-1.0 / safe_edge)

    wfg = weight * fg.astype(weight.dtype)
    sum_w = jnp.sum(wfg, axis=-1)
    fit = jnp.sum(wfg * sad, axis=-1) / jnp.where(sum_w > 0, sum_w, 1.0)
    return jnp.where(cand_ok & (sum_w > 0), fit, BIG)


@functools.partial(jax.jit, static_argnames=("cfg",))
def warped_patch_vectors(scene: Scene, cfg: MvsConfig,
                         center, normal, ref_cam, cam_mask, lod):
    """L2-normalized warped window vectors for the correlation table.

    Ref: Patch::getHomographyPatch + setCorrelationTable
    (TMVS/mvs/patch.cpp:221-267, 332-386). Bounds are the looser [0, dim-1)
    of that path; an out-of-bounds warp in ANY visible camera marks the
    whole patch for dropping (the reference sets ``drop``).

    Args:
      center [B, 3], normal [B, 3], ref_cam [B], cam_mask [B, C], lod [B].

    Returns:
      vectors [B, C, W2] unit L2 rows, corr [B, C, C] NCC table,
      correlation [B] mean off-diagonal, ok [B] (False -> drop patch).
    """
    rig, pyrs = scene.rig, scene.pyramids
    B = center.shape[0]
    C = rig.num_cameras
    lod_scale = jnp.power(jnp.float32(cfg.lod_ratio), lod.astype(jnp.float32))
    H, hok = _per_camera_homographies(scene, center, normal, ref_cam, lod_scale)

    def _proj(Xb, c, s):
        return geom.project(Xb, rig.R[c], rig.T[c], rig.focal[c],
                            rig.principal[c], s)[0]
    pt = jax.vmap(_proj)(center, ref_cam, lod_scale)          # [B, 2]

    offs = jnp.asarray(window_offsets(cfg.patch_radius))
    W2 = offs.shape[0]
    win = pt[:, None, :] + offs[None, :, :]                   # [B, W2, 2]

    x = win[..., 0][..., None]
    y = win[..., 1][..., None]
    Hc = H[:, None, :, :, :]                                  # [B, 1, C, 3, 3]
    w = Hc[..., 2, 0] * x + Hc[..., 2, 1] * y + Hc[..., 2, 2]
    sw = jnp.where(w == 0, 1.0, w)
    u = (Hc[..., 0, 0] * x + Hc[..., 0, 1] * y + Hc[..., 0, 2]) / sw
    v = (Hc[..., 1, 0] * x + Hc[..., 1, 1] * y + Hc[..., 1, 2]) / sw
    uv = jnp.stack([u, v], axis=-1)                           # [B, W2, C, 2]

    cam_idx = jnp.broadcast_to(jnp.arange(C, dtype=jnp.int32), (B, W2, C))
    lod_b = jnp.broadcast_to(lod[:, None, None], (B, W2, C))
    vals, vok = bilinear_gather(pyrs.images, pyrs.yoff, cam_idx, lod_b, uv,
                                pyrs.dims, 0.0, 1.0)
    vok = vok & (w != 0)

    m = cam_mask[:, None, :]
    ok = jnp.all(jnp.all(vok | ~m, axis=1) & (hok | ~cam_mask), axis=-1)

    vecs = jnp.swapaxes(vals, 1, 2)                           # [B, C, W2]
    return ncc_from_vectors(vecs, cam_mask, ok)


def ncc_from_vectors(vecs, cam_mask, ok):
    """L2-normalize warped window vectors and build the pairwise NCC table
    + mean off-diagonal correlation (patch.cpp:249-266).

    vecs: [B, C, W2] raw warped intensities; ok: [B] validity.
    Returns (unit vecs, corr [B, C, C], correlation [B], ok).
    """
    C = vecs.shape[1]
    norm = jnp.sqrt(jnp.sum(vecs * vecs, axis=-1, keepdims=True))
    vecs = vecs / jnp.where(norm > 0, norm, 1.0)

    corr = jnp.einsum("bcw,bdw->bcd", vecs, vecs)
    pair_m = cam_mask[:, :, None] & cam_mask[:, None, :]
    pair_m &= ~jnp.eye(C, dtype=bool)[None]
    corr = corr * pair_m.astype(corr.dtype)
    n = jnp.sum(cam_mask, axis=-1).astype(corr.dtype)
    denom = n * n - n
    correlation = jnp.sum(corr, axis=(1, 2)) / jnp.where(denom > 0, denom, 1.0)
    correlation = jnp.where(ok, correlation, 0.0)
    return vecs, corr, correlation, ok
