"""Camera rig and scene containers: struct-of-arrays pytrees.

The reference keeps a ``vector<Camera>`` of heavyweight objects, each owning
its own OpenCV matrices and pyramid (TMVS/mvs/camera.h). On the device we
want one stacked array per quantity so every batched op indexes cameras
with plain gathers. Host-side construction is done in float64 numpy, then
cast to f32 device arrays.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

import numpy as np
import jax.numpy as jnp

from pais_mvs_tpu.config import MvsConfig
from pais_mvs_tpu.models import pytree_dataclass
from pais_mvs_tpu.ops import pyramid as pyr


@dataclass
class CameraParams:
    """Host-side description of one camera (as parsed from NVM/MVS files).

    Mirrors the reference ctor inputs (TMVS/mvs/camera.cpp:45): focal may be
    anisotropic (NVM2), principal (-1,-1) means image center, quaternion is
    (w, x, y, z), center is the camera position in world coordinates.
    """

    file_name: str
    focal: np.ndarray          # [2]
    principal: np.ndarray      # [2]; (-1,-1) -> image center
    quaternion: np.ndarray     # [4] (w, x, y, z)
    center: np.ndarray         # [3]
    radial_distortion: float = 0.0


def _np_quat_to_rotation(q: np.ndarray) -> np.ndarray:
    qq = np.linalg.norm(q)
    if qq > 0:
        w, x, y, z = q / qq
    else:
        w, x, y, z = 1.0, 0.0, 0.0, 0.0
    return np.array([
        [w*w + x*x - y*y - z*z, 2*(x*y - z*w), 2*(y*w + z*x)],
        [2*(x*y + w*z), y*y + w*w - z*z - x*x, 2*(z*y - x*w)],
        [2*(x*z - y*w), 2*(y*z + w*x), z*z + w*w - y*y - x*x],
    ])


@pytree_dataclass
class CameraRig:
    """Stacked camera geometry; all arrays lead with the camera axis C."""

    R: Any          # [C, 3, 3] rotation (world -> camera)
    T: Any          # [C, 3] translation = -R @ center
    center: Any     # [C, 3]
    focal: Any      # [C, 2]
    principal: Any  # [C, 2]
    distortion: Any  # [C]
    KR: Any         # [C, 3, 3]
    KT: Any         # [C, 3]
    optical: Any    # [C, 3] optical axis in world (R^T e_z)
    quaternion: Any  # [C, 4]
    max_lod: Any    # [C] int32

    @property
    def num_cameras(self) -> int:
        return self.R.shape[0]


@pytree_dataclass
class PyramidSet:
    """Packed image pyramids for every camera, as a vertical mip-atlas:
    level ``l`` of camera ``c`` lives in ``images[c, yoff[l]:yoff[l]+h_l,
    :w_l]`` (bands are 8-row aligned; memory is sum of level heights, not
    L x level-0 height)."""

    images: Any     # [C, Ha, Wa] bf16, gray 0..255 (0 = background/pad;
                    # level-0 integer intensities are bf16-exact)
    edges: Any      # [C, Ha, Wa] bf16 in [0, 1]
    dims: Any       # [C, L, 2] int32 (h, w) per level; (0, 0) where absent
    rgb: Any        # [C, Hmax, Wmax, 3] uint8 level-0 color (one gather per
                    # accepted patch; f32 here would cost 4x the HBM — 1.15 GiB
                    # at 4K x 8 cams)
    var: Any        # [C, Ha, Wa] bf16 patch-window variance (-1 = OOB)
    yoff: Any       # [L+1] int32 atlas band row offsets (last = Ha)

    @property
    def num_levels(self) -> int:
        return self.dims.shape[1]


@pytree_dataclass
class Scene:
    rig: CameraRig
    pyramids: PyramidSet

    @property
    def num_cameras(self) -> int:
        return self.rig.num_cameras


def undistort_image(img: np.ndarray, focal, principal,
                    r_dist: float) -> np.ndarray:
    """Resample a radially-distorted image onto the pinhole model.

    The reference's distortion (TMVS/mvs/camera.cpp:148-155): a point with
    normalized coords n lands at pixel (1 + r*|n|^2) * f * n + pp. The
    undistorted (pinhole) image therefore samples the input at exactly
    that forward-mapped position — no iterative inversion needed.
    """
    h, w = img.shape[:2]
    f = np.asarray(focal, float)
    pp = np.asarray(principal, float)
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    nx = (xs - pp[0]) / f[0]
    ny = (ys - pp[1]) / f[1]
    s = 1.0 + r_dist * (nx * nx + ny * ny)
    u = np.clip(s * f[0] * nx + pp[0], 0, w - 1.001)
    v = np.clip(s * f[1] * ny + pp[1], 0, h - 1.001)
    x0 = np.floor(u).astype(int)
    y0 = np.floor(v).astype(int)
    fx = (u - x0)[..., None] if img.ndim == 3 else u - x0
    fy = (v - y0)[..., None] if img.ndim == 3 else v - y0
    out = (img[y0, x0] * (1 - fx) * (1 - fy)
           + img[y0, np.minimum(x0 + 1, w - 1)] * fx * (1 - fy)
           + img[np.minimum(y0 + 1, h - 1), x0] * (1 - fx) * fy
           + img[np.minimum(y0 + 1, h - 1), np.minimum(x0 + 1, w - 1)]
           * fx * fy)
    return out.astype(img.dtype)


def undistort_points(pts: np.ndarray, focal, principal,
                     r_dist: float, iters: int = 4) -> np.ndarray:
    """Map distorted-image pixel measurements to pinhole pixels (the
    inverse of the forward model above), via Newton on the radial scalar:
    rho_d = (1 + r t^2) t  for  t = |n_undistorted|."""
    f = np.asarray(focal, float)
    pp = np.asarray(principal, float)
    nd = (np.asarray(pts, float) - pp) / f
    rho = np.linalg.norm(nd, axis=-1)
    t = rho.copy()
    for _ in range(iters):
        g = t + r_dist * t ** 3 - rho
        dg = 1.0 + 3.0 * r_dist * t * t
        t = t - g / np.where(np.abs(dg) < 1e-9, 1.0, dg)
    scale = np.where(rho > 1e-12, t / np.where(rho > 0, rho, 1.0), 1.0)
    return nd * scale[..., None] * f + pp


def build_scene(params: Sequence[CameraParams],
                rgb_images: Sequence[np.ndarray],
                cfg: MvsConfig) -> Scene:
    """Assemble the device-side Scene from parsed cameras + decoded images.

    ``rgb_images[i]`` is a uint8 [H, W, 3] (or gray [H, W]) array for camera
    ``i``. Per-camera derived quantities follow TMVS/mvs/camera.cpp:45-136.

    When ``cfg.apply_distortion`` is set, images are UNDISTORTED here and
    the engine runs pure pinhole everywhere (the batched counterpart of
    the reference's optional per-projection distortion, camera.cpp:148-155
    — which no reference call site actually enables; measurements must be
    undistorted by the caller via ``undistort_points``).
    """
    C = len(params)
    assert C == len(rgb_images)
    if cfg.apply_distortion:
        rgb_images = [
            undistort_image(img, p.focal,
                            (np.array([img.shape[1] >> 1,
                                       img.shape[0] >> 1], float)
                             if p.principal[0] < 0 and p.principal[1] < 0
                             else p.principal),
                            float(p.radial_distortion))
            if abs(float(p.radial_distortion)) > 1e-12 else img
            for p, img in zip(params, rgb_images)]
    R = np.zeros((C, 3, 3)); T = np.zeros((C, 3)); centers = np.zeros((C, 3))
    focal = np.zeros((C, 2)); principal = np.zeros((C, 2))
    dist = np.zeros(C); KR = np.zeros((C, 3, 3)); KT = np.zeros((C, 3))
    optical = np.zeros((C, 3)); quat = np.zeros((C, 4))
    max_lods = np.zeros(C, dtype=np.int32)

    levels_all, edges_all, dims_all, vars_all = [], [], [], []
    hmax = max(img.shape[0] for img in rgb_images)
    wmax = max(img.shape[1] for img in rgb_images)
    rgb_packed = np.zeros((C, hmax, wmax, 3), dtype=np.uint8)

    for i, (p, img) in enumerate(zip(params, rgb_images)):
        h, w = img.shape[:2]
        gray = pyr.rgb_to_gray(img)
        ml = pyr.max_lod_for(w, h, cfg.lod_ratio, cfg.max_lod)
        max_lods[i] = ml
        lv, ed, dm = pyr.build_pyramid(gray, cfg.lod_ratio, ml)
        levels_all.append(lv); edges_all.append(ed); dims_all.append(dm)
        vars_all.append([pyr.window_variance_map(g, cfg.patch_radius)
                         for g in lv])
        if img.ndim == 3:
            rgb_packed[i, :h, :w] = img
        else:
            rgb_packed[i, :h, :w] = img[..., None]

        Ri = _np_quat_to_rotation(np.asarray(p.quaternion, dtype=np.float64))
        ci = np.asarray(p.center, dtype=np.float64)
        fi = np.asarray(p.focal, dtype=np.float64)
        pp = np.asarray(p.principal, dtype=np.float64)
        if pp[0] < 0 and pp[1] < 0:
            # image-center principal point uses integer halves (camera.cpp:101-106)
            pp = np.array([w >> 1, h >> 1], dtype=np.float64)
        K = np.array([[fi[0], 0, pp[0]], [0, fi[1], pp[1]], [0, 0, 1.0]])
        Ti = -Ri @ ci
        R[i], T[i], centers[i] = Ri, Ti, ci
        focal[i], principal[i], dist[i] = fi, pp, p.radial_distortion
        KR[i], KT[i] = K @ Ri, K @ Ti
        optical[i] = Ri.T @ np.array([0.0, 0.0, 1.0])
        quat[i] = np.asarray(p.quaternion, dtype=np.float64)

    L = int(max_lods.max()) + 1
    images, edges, dims, yoff = pyr.pack_pyramids(levels_all, edges_all,
                                                  dims_all, L)
    var_maps = pyr.pack_variance_maps(vars_all, dims_all, L)

    f32 = lambda a: jnp.asarray(a, dtype=jnp.float32)
    rig = CameraRig(
        R=f32(R), T=f32(T), center=f32(centers), focal=f32(focal),
        principal=f32(principal), distortion=f32(dist), KR=f32(KR),
        KT=f32(KT), optical=f32(optical), quaternion=f32(quat),
        max_lod=jnp.asarray(max_lods, dtype=jnp.int32),
    )
    # bf16 atlases: 0..255 level-0 intensities are bf16-exact (background
    # test preserved), deeper levels/edges/variance round at ~0.4% — far
    # below the photoconsistency contrast. Halves both the host->device
    # upload and the device footprint (the 4096x3072 x 8-cam atlases drop
    # from 5.5 to 2.75 GiB).
    pyrs = PyramidSet(images=jnp.asarray(images, jnp.bfloat16),
                      edges=jnp.asarray(edges, jnp.bfloat16),
                      dims=jnp.asarray(dims), rgb=jnp.asarray(rgb_packed),
                      var=jnp.asarray(var_maps, jnp.bfloat16),
                      yoff=jnp.asarray(yoff, dtype=jnp.int32))
    return Scene(rig=rig, pyramids=pyrs)
