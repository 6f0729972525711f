"""N-view track union + triangulation into seed patches.

Reference: FeatureManager::setSeedPatches (TMVS/mvs/featuremanager.cpp:5-116)
— pairwise matches merged into n-view tracks (:118-156 setNVMatch), tracks
with >= minCamNum views triangulated into seed patches (:84-98). The
union-find here runs on host (tiny, irregular); detection/description/
matching run on device.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import jax.numpy as jnp

from pais_mvs_tpu.config import MvsConfig
from pais_mvs_tpu.features import detect as det
from pais_mvs_tpu.features import describe as dsc
from pais_mvs_tpu.features import matching as mat
from pais_mvs_tpu.models.camera import CameraParams, _np_quat_to_rotation
from pais_mvs_tpu.ops import pyramid as pyr


class _UnionFind:
    def __init__(self, n: int):
        self.p = list(range(n))

    def find(self, a: int) -> int:
        while self.p[a] != a:
            self.p[a] = self.p[self.p[a]]
            a = self.p[a]
        return a

    def union(self, a: int, b: int):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[rb] = ra


def merge_tracks(pair_matches: Dict[Tuple[int, int],
                                    Tuple[np.ndarray, np.ndarray]],
                 num_cams: int, k_per_cam: int,
                 min_cam_num: int) -> List[Dict[int, int]]:
    """Union pairwise matches into n-view tracks.

    Returns a list of {cam: keypoint_idx} maps, one per consistent track
    with >= min_cam_num views. Tracks containing two DIFFERENT keypoints of
    the same camera are dropped (the reference's cross-match consistency,
    featuremanager.cpp:197-247).
    """
    uf = _UnionFind(num_cams * k_per_cam)
    for (i, j), (i1, i2) in pair_matches.items():
        for a, b in zip(i1.tolist(), i2.tolist()):
            uf.union(i * k_per_cam + a, j * k_per_cam + b)

    groups: Dict[int, Dict[int, set]] = {}
    seen = set()
    for (i, j), (i1, i2) in pair_matches.items():
        for a, b in zip(i1.tolist(), i2.tolist()):
            for cam, kp in ((i, a), (j, b)):
                node = cam * k_per_cam + kp
                if node in seen:
                    continue
                seen.add(node)
                root = uf.find(node)
                groups.setdefault(root, {}).setdefault(cam, set()).add(kp)

    tracks = []
    for views in groups.values():
        if len(views) < min_cam_num:
            continue
        if any(len(kps) > 1 for kps in views.values()):
            continue   # inconsistent: two keypoints of one camera merged
        tracks.append({cam: next(iter(kps)) for cam, kps in views.items()})
    return tracks


def generate_seed_patches(params: Sequence[CameraParams],
                          images: Sequence[np.ndarray],
                          cfg: MvsConfig,
                          max_epipolar_dist: float = 3.0,
                          k_per_octave: int = 192,
                          num_octaves: int = 4):
    """Full seeding pipeline: detect -> describe -> match -> tracks ->
    triangulate. Returns (centers [M,3], cam_masks [M,C], img_points
    [M,C,2], colors [M,3]) numpy arrays ready for Reconstructor.load_seeds.
    """
    C = len(params)
    descs, xys, masks, kps = [], [], [], []
    Rs, Ts, Ks, centers_np, focals, pps = [], [], [], [], [], []
    for p, img in zip(params, images):
        h, w = img.shape[:2]
        gray = pyr.rgb_to_gray(img).astype(np.float32)
        kp, gaussians = det.detect_keypoints(
            jnp.asarray(gray), num_octaves=num_octaves,
            k_per_octave=k_per_octave)
        # per-octave descriptor batches (static shapes inside each octave)
        k_tot = kp.xy.shape[0]
        desc = np.zeros((k_tot, 128), dtype=np.float32)
        oct_np = np.asarray(kp.octave)
        for o, g in enumerate(gaussians):
            sel = np.nonzero(oct_np == o)[0]
            if not len(sel):
                continue
            # every present octave contributes exactly k_per_octave rows
            # (detect_keypoints appends full fixed-size masked batches,
            # never ragged ones), so the describe batch shape is static —
            # one XLA compile total, not one per novel count
            assert len(sel) == k_per_octave, (o, len(sel))
            d = dsc.describe_octave(g, kp.xy_oct[sel], kp.sigma_oct[sel],
                                    kp.level[sel])
            desc[sel] = np.asarray(d)
        descs.append(jnp.asarray(desc))
        xys.append(kp.xy)
        masks.append(kp.mask)
        kps.append(np.asarray(kp.xy))

        R = _np_quat_to_rotation(np.asarray(p.quaternion, dtype=np.float64))
        c = np.asarray(p.center, dtype=np.float64)
        f = np.asarray(p.focal, dtype=np.float64)
        pp = np.asarray(p.principal, dtype=np.float64)
        if pp[0] < 0 and pp[1] < 0:
            pp = np.array([w >> 1, h >> 1], dtype=np.float64)
        K = np.array([[f[0], 0, pp[0]], [0, f[1], pp[1]], [0, 0, 1.0]])
        Rs.append(R); Ts.append(-R @ c); Ks.append(K)
        centers_np.append(c); focals.append(f); pps.append(pp)

    Fs = [[None] * C for _ in range(C)]
    for i in range(C):
        for j in range(C):
            if i != j:
                Fs[i][j] = mat.fundamental_from_rig(
                    Rs[i], Ts[i], Ks[i], Rs[j], Ts[j], Ks[j])

    pairs = mat.match_all_pairs(descs, xys, masks, Fs,
                                max_epipolar_dist=max_epipolar_dist)
    # cameras of different sizes yield different octave/keypoint counts —
    # size the union-find by the LARGEST so node ids never collide
    k_per_cam = max(int(x.shape[0]) for x in xys)
    tracks = merge_tracks(pairs, C, k_per_cam, cfg.min_cam_num)
    if not tracks:
        z = np.zeros
        return (z((0, 3)), z((0, C), dtype=bool), z((0, C, 2)), z((0, 3)))

    M = len(tracks)
    cam_masks = np.zeros((M, C), dtype=bool)
    img_points = np.zeros((M, C, 2))
    for t, views in enumerate(tracks):
        for cam, kpi in views.items():
            cam_masks[t, cam] = True
            img_points[t, cam] = kps[cam][kpi]

    # triangulate each track from pixel rays (reference uses
    # Patch::reCentering after seeding, featuremanager.cpp:84-98) —
    # vectorized normal equations sum(I - n n^T) x = sum((I - n n^T) o)
    cam_centers = np.stack(centers_np)                      # [C, 3]
    dirs = np.zeros((M, C, 3))
    for cam in range(C):
        uv = img_points[:, cam]
        d = np.stack([(uv[:, 0] - pps[cam][0]) / focals[cam][0],
                      (uv[:, 1] - pps[cam][1]) / focals[cam][1],
                      np.ones(M)], axis=-1) @ Rs[cam]       # R^T row-applied
        dirs[:, cam] = d / np.linalg.norm(d, axis=-1, keepdims=True)
    m = cam_masks[..., None].astype(np.float64)
    P = (np.eye(3)[None, None] - dirs[..., :, None] * dirs[..., None, :]) \
        * m[..., None]
    A = P.sum(axis=1)                                       # [M, 3, 3]
    b = np.einsum("mcij,cj->mi", P, cam_centers)
    centers = np.einsum("mij,mj->mi", np.linalg.pinv(A), b)
    good = np.all(np.isfinite(centers), axis=-1)

    colors = np.zeros((M, 3))
    for t in range(M):
        cam = int(np.nonzero(cam_masks[t])[0][0])
        u, v = img_points[t, cam]
        h, w = images[cam].shape[:2]
        ui = int(np.clip(round(u), 0, w - 1))
        vi = int(np.clip(round(v), 0, h - 1))
        px = images[cam][vi, ui]
        colors[t] = px if px.ndim else np.repeat(px, 3)

    return (centers[good], cam_masks[good], img_points[good], colors[good])
