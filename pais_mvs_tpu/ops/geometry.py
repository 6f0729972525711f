"""Core projective geometry, written as shape-polymorphic jnp functions.

Semantics match the reference TMVS primitives (cited per function) but are
batched/vmappable and run in f32 on device; host-side setup code may call
them with f64 numpy arrays (jnp preserves input dtype under x64 or when the
caller uses numpy directly — the functions only use ``jnp`` ops that work on
both).

Conventions
-----------
* World-to-camera: ``x_cam = R @ X + T`` with ``T = -R @ C`` (C = camera
  center), pixel ``u = f * x/z + pp`` (reference TMVS/mvs/camera.cpp:108-160).
* Patch normals are stored in spherical form (theta, phi) with
  ``n = (sin t cos p, sin t sin p, cos t)`` (TMVS/mvs/utility.h:17-29).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Large sentinel standing in for the reference's DBL_MAX rejections; kept
# finite so downstream min/exp arithmetic stays NaN-free in f32. A NumPy
# scalar, so that importing the package does not start a JAX backend
# (multi-process runs must call jax.distributed.initialize first).
BIG = np.float32(1e30)


# ---------------------------------------------------------------------------
# spherical normals
# ---------------------------------------------------------------------------

def spherical_to_normal(sph):
    """(theta, phi) -> unit normal. Ref: TMVS/mvs/utility.h:25-29."""
    t, p = sph[..., 0], sph[..., 1]
    st = jnp.sin(t)
    return jnp.stack([st * jnp.cos(p), st * jnp.sin(p), jnp.cos(t)], axis=-1)


def normal_to_spherical(n):
    """unit normal -> (theta in [0,pi], phi in [-pi,pi]). Ref: utility.h:17-22."""
    theta = jnp.arccos(jnp.clip(n[..., 2], -1.0, 1.0))
    phi = jnp.arctan2(n[..., 1], n[..., 0])
    return jnp.stack([theta, phi], axis=-1)


# ---------------------------------------------------------------------------
# rotations / projection
# ---------------------------------------------------------------------------

def quat_to_rotation(q):
    """Quaternion (w, x, y, z) -> 3x3 rotation, normalizing first.

    Same element formulas as the reference (TMVS/mvs/camera.cpp:6-34),
    including its fallback to identity for an all-zero quaternion.
    Batched over leading dims.
    """
    qq = jnp.linalg.norm(q, axis=-1, keepdims=True)
    unit = jnp.concatenate(
        [jnp.ones_like(q[..., :1]), jnp.zeros_like(q[..., 1:])], axis=-1)
    qn = jnp.where(qq > 0, q / jnp.where(qq > 0, qq, 1.0), unit)
    w, x, y, z = qn[..., 0], qn[..., 1], qn[..., 2], qn[..., 3]
    r = jnp.stack([
        w * w + x * x - y * y - z * z, 2 * (x * y - z * w), 2 * (y * w + z * x),
        2 * (x * y + w * z), y * y + w * w - z * z - x * x, 2 * (z * y - x * w),
        2 * (x * z - y * w), 2 * (y * z + w * x), z * z + w * w - y * y - x * x,
    ], axis=-1)
    return r.reshape(r.shape[:-1] + (3, 3))


def project(X, R, T, focal, principal, lod_scale=1.0, distortion=None):
    """Project world point(s) to pixel coords at a pyramid level.

    Ref: TMVS/mvs/camera.cpp:138-160 — pinhole + optional single radial
    distortion coefficient applied to *normalized* coords, and the final
    pixel coordinate scaled by ``lodRatio**LOD``.

    Args:
      X: [..., 3] world points.
      R: [3, 3], T: [3], focal: [2], principal: [2], distortion: scalar or None.
      lod_scale: scalar ``lodRatio**LOD``.

    Returns:
      (xy [..., 2], depth_z [...]) — z in camera frame (callers gate on z).
    """
    xc = jnp.einsum("ij,...j->...i", R, X) + T
    z = xc[..., 2]
    safe_z = jnp.where(z == 0, 1.0, z)
    xn = xc[..., 0] / safe_z
    yn = xc[..., 1] / safe_z
    if distortion is not None:
        rr = distortion * (xn * xn + yn * yn)
        scale = 1.0 + rr
        u = scale * focal[0] * xn + principal[0]
        v = scale * focal[1] * yn + principal[1]
    else:
        u = focal[0] * xn + principal[0]
        v = focal[1] * yn + principal[1]
    xy = jnp.stack([u, v], axis=-1) * lod_scale
    return xy, z


def pixel_to_world_dir(xy, R, C, focal, principal):
    """World-space unit ray direction through pixel ``xy`` (level-0 coords).

    Matches the reference's pixel back-projection (TMVS/mvs/patch.cpp:80-90,
    mvs.cpp:819-831): p3d = R^T((px-pp)/f, 1) + C, dir = normalize(p3d - C).
    """
    d = jnp.stack([
        (xy[..., 0] - principal[0]) / focal[0],
        (xy[..., 1] - principal[1]) / focal[1],
        jnp.ones_like(xy[..., 0]),
    ], axis=-1)
    w = jnp.einsum("ji,...j->...i", R, d)  # R^T @ d
    return w / jnp.linalg.norm(w, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# triangulation
# ---------------------------------------------------------------------------

def triangulate_rays(origins, dirs, mask):
    """Least-squares intersection point of masked 3D rays.

    Accumulates the normal equations sum(I - n n^T) x = sum((I - n n^T) o)
    over valid rays, solved with a pseudo-inverse — the reference's SVD
    triangulation (TMVS/mvs/patch.cpp:67-112).

    Args:
      origins: [K, 3] ray origins (camera centers).
      dirs: [K, 3] unit directions.
      mask: [K] bool validity.

    Returns: [3] point.
    """
    m = mask[..., None].astype(origins.dtype)
    eye = jnp.eye(3, dtype=origins.dtype)
    nnT = dirs[..., :, None] * dirs[..., None, :]
    P = (eye - nnT) * m[..., None]            # [K, 3, 3]
    A = jnp.sum(P, axis=-3)
    b = jnp.sum(jnp.einsum("...kij,...kj->...ki", P, origins), axis=-2)
    # pinv mirrors the reference's DECOMP_SVD solve and tolerates rank loss.
    return jnp.linalg.pinv(A) @ b


def estimated_normal(center, cam_centers, mask):
    """Initial patch normal = normalized sum of unit vectors to visible
    camera centers (TMVS/mvs/patch.cpp:390-413)."""
    d = cam_centers - center[..., None, :]
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    n = jnp.sum(d * mask[..., None], axis=-2)
    return n / jnp.linalg.norm(n, axis=-1, keepdims=True)


def ray_plane_intersect(origin, direction, plane_point, plane_normal):
    """Point where a ray meets the plane through ``plane_point`` with
    ``plane_normal`` (TMVS/mvs/mvs.cpp:809-836). ``direction`` need not be
    unit length (the reference uses pixel-at-depth-1 minus center)."""
    denom = jnp.sum(plane_normal * direction, axis=-1)
    u = jnp.sum(plane_normal * (plane_point - origin), axis=-1) / jnp.where(
        denom == 0, 1.0, denom)
    return origin + u[..., None] * direction


# ---------------------------------------------------------------------------
# plane-induced homographies
# ---------------------------------------------------------------------------

def plane_homography(center, normal, R_ref, T_ref, f_ref, pp_ref,
                     R_tgt, T_tgt, f_tgt, pp_tgt, lod_scale):
    """Plane-induced homography mapping reference-image pixels (at a given
    LOD scale) into a target view: for points X on the plane through
    ``center`` with unit ``normal``,  u_tgt ~ H @ u_ref.

    Mathematically identical to the reference's
    H = (d L K R_t - L K T_t n^T)(d L K R_r - L K T_r n^T)^-1
    (TMVS/mvs/patch.cpp:290-330), but reparameterized in the reference
    camera frame:  H = L K_t (R_rel + t_rel n_r^T / d_r)(L K_ref)^-1.
    The reference form is singular whenever the plane passes through the
    WORLD ORIGIN (its d = -center.normal vanishes) — a latent degeneracy in
    the original; this form only degenerates when the plane passes through
    the reference camera center (impossible for a visible patch), and the
    triangular (LK)^-1 is closed-form — no generic 3x3 inversion.

    All args broadcast over leading dims; returns (H [..., 3, 3], ok [...]).
    """
    # plane in the reference camera frame
    n_r = jnp.einsum("...ij,...j->...i", R_ref, normal)
    X_r = jnp.einsum("...ij,...j->...i", R_ref, center) + T_ref
    d_r = jnp.sum(n_r * X_r, axis=-1)                  # cam-to-plane distance
    ok = jnp.abs(d_r) > 1e-12

    # relative pose ref -> tgt
    R_rel = jnp.einsum("...ij,...kj->...ik", R_tgt, R_ref)   # R_t @ R_r^T
    t_rel = T_tgt - jnp.einsum("...ij,...j->...i", R_rel, T_ref)

    M = R_rel + (t_rel[..., :, None] * n_r[..., None, :]
                 ) / jnp.where(ok, d_r, 1.0)[..., None, None]

    # LK_tgt @ M
    s = lod_scale
    fx_t = s * f_tgt[..., 0]
    fy_t = s * f_tgt[..., 1]
    cx_t = s * pp_tgt[..., 0]
    cy_t = s * pp_tgt[..., 1]
    row0 = fx_t[..., None] * M[..., 0, :] + cx_t[..., None] * M[..., 2, :]
    row1 = fy_t[..., None] * M[..., 1, :] + cy_t[..., None] * M[..., 2, :]
    row2 = M[..., 2, :]
    KM = jnp.stack([row0, row1, row2], axis=-2)

    # ... @ (LK_ref)^-1 with the closed-form upper-triangular inverse
    inv_fx = 1.0 / (s * f_ref[..., 0])
    inv_fy = 1.0 / (s * f_ref[..., 1])
    ox = -pp_ref[..., 0] / f_ref[..., 0]
    oy = -pp_ref[..., 1] / f_ref[..., 1]
    col0 = KM[..., :, 0] * inv_fx[..., None]
    col1 = KM[..., :, 1] * inv_fy[..., None]
    col2 = (KM[..., :, 0] * ox[..., None] + KM[..., :, 1] * oy[..., None]
            + KM[..., :, 2])
    H = jnp.stack([col0, col1, col2], axis=-1)
    return H, ok


def homography_apply(H, xy):
    """Apply projective H to 2D points. xy: [..., 2] -> ([..., 2], w)."""
    x, y = xy[..., 0], xy[..., 1]
    w = H[..., 2, 0] * x + H[..., 2, 1] * y + H[..., 2, 2]
    sw = jnp.where(w == 0, 1.0, w)
    u = (H[..., 0, 0] * x + H[..., 0, 1] * y + H[..., 0, 2]) / sw
    v = (H[..., 1, 0] * x + H[..., 1, 1] * y + H[..., 1, 2]) / sw
    return jnp.stack([u, v], axis=-1), w


def homography_region_ratio(H, pt):
    """Anisotropy of the warped patch window: min/max singular value of the
    2x2 Jacobian of H at ``pt``.

    Design note: the reference warps 8 window-boundary points and fits an
    ellipse with OpenCV (TMVS/mvs/patch.cpp:269-288); the Jacobian singular
    values give the same axis ratio in closed form (exact in the limit, and
    the reference uses it only as a coarse < minRegionRatio gate).
    """
    x, y = pt[..., 0], pt[..., 1]
    w = H[..., 2, 0] * x + H[..., 2, 1] * y + H[..., 2, 2]
    u = H[..., 0, 0] * x + H[..., 0, 1] * y + H[..., 0, 2]
    v = H[..., 1, 0] * x + H[..., 1, 1] * y + H[..., 1, 2]
    sw = jnp.where(w == 0, 1.0, w)
    iw = 1.0 / sw
    # d(u/w)/dx = (u_x * w - u * w_x) / w^2, etc.
    j00 = (H[..., 0, 0] - u * iw * H[..., 2, 0]) * iw
    j01 = (H[..., 0, 1] - u * iw * H[..., 2, 1]) * iw
    j10 = (H[..., 1, 0] - v * iw * H[..., 2, 0]) * iw
    j11 = (H[..., 1, 1] - v * iw * H[..., 2, 1]) * iw
    # singular values of [[j00,j01],[j10,j11]] in closed form
    a = j00 * j00 + j01 * j01 + j10 * j10 + j11 * j11
    det = j00 * j11 - j01 * j10
    disc = jnp.sqrt(jnp.maximum(a * a - 4.0 * det * det, 0.0))
    smax2 = 0.5 * (a + disc)
    smin2 = 0.5 * (a - disc)
    ratio = jnp.sqrt(jnp.maximum(smin2, 0.0) / jnp.where(smax2 > 0, smax2, 1.0))
    return jnp.where((smax2 > 0) & (w != 0), ratio, 0.0)
