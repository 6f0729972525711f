"""Sequential NumPy oracle of the reference pipeline's per-patch cost.

Two jobs:
  1. **Baseline measurement** — the reference publishes no numbers
     (SURVEY.md §6), so the CPU figure to beat is measured here: a faithful
     one-patch-at-a-time refine loop with TMVS semantics (one GLN-PSO swarm
     per patch, fitness vectorized over the particle set — the moral
     equivalent of the reference's OpenMP-over-particles C++,
     TMVS/pso/psosolver.cpp:113-122).
  2. **Semantic cross-check** — an independent implementation of the
     fitness kernel for parity tests against the JAX path.

Deliberately NumPy-only (plus one SciPy k-d tree for cloud agreement):
no jax imports, runs anywhere.
"""

from __future__ import annotations

import time
from typing import Tuple

import numpy as np

from pais_mvs_tpu.config import MvsConfig


class NpScene:
    """Minimal camera + pyramid container for the oracle."""

    def __init__(self, params, images, cfg: MvsConfig):
        from pais_mvs_tpu.ops import pyramid as pyr
        C = len(params)
        self.cfg = cfg
        self.R = np.zeros((C, 3, 3))
        self.T = np.zeros((C, 3))
        self.center = np.zeros((C, 3))
        self.focal = np.zeros((C, 2))
        self.principal = np.zeros((C, 2))
        self.optical = np.zeros((C, 3))
        self.levels = []
        self.edge_levels = []
        self.max_lod = np.zeros(C, dtype=int)
        for i, (p, img) in enumerate(zip(params, images)):
            h, w = img.shape[:2]
            from pais_mvs_tpu.models.camera import _np_quat_to_rotation
            R = _np_quat_to_rotation(np.asarray(p.quaternion, float))
            self.R[i] = R
            self.center[i] = p.center
            self.T[i] = -R @ np.asarray(p.center, float)
            self.focal[i] = p.focal
            pp = np.asarray(p.principal, float)
            if pp[0] < 0 and pp[1] < 0:
                pp = np.array([w >> 1, h >> 1], float)
            self.principal[i] = pp
            self.optical[i] = R.T @ np.array([0.0, 0.0, 1.0])
            gray = pyr.rgb_to_gray(img)
            ml = pyr.max_lod_for(w, h, cfg.lod_ratio, cfg.max_lod)
            self.max_lod[i] = ml
            lv, ed, _ = pyr.build_pyramid(gray, cfg.lod_ratio, ml)
            self.levels.append(lv)
            self.edge_levels.append(ed)

    def project(self, cam: int, X, lod_scale: float = 1.0):
        xc = X @ self.R[cam].T + self.T[cam]
        xy = (xc[..., :2] / xc[..., 2:3] * self.focal[cam]
              + self.principal[cam]) * lod_scale
        return xy, xc[..., 2]


def _dist_weight(cfg: MvsConfig) -> np.ndarray:
    r = cfg.patch_radius
    ax = np.arange(-r, r + 1, dtype=np.float64)
    dx, dy = np.meshgrid(ax, ax, indexing="ij")
    g = np.exp(-(dx ** 2 + dy ** 2) / (2 * cfg.dist_weighting ** 2))
    g /= (2 * np.pi * cfg.dist_weighting ** 2)
    return (g / g.sum()).ravel()


# Agreement of the device fitness (ops.fitness.patch_fitness) with
# fitness_np on candidates both score finitely:
#   |fit_device - fit_np| <= FITNESS_TOL * max(1, |fit_np|).
# The device samples bf16 intensity/edge atlases in float32, this oracle
# float64 pyramids; the bf16 edge weights dominate the difference.
FITNESS_TOL = 1e-3


def fitness_np(scene: NpScene, cfg: MvsConfig, ref_cam: int, cam_idx,
               lod: int, ray, pos) -> np.ndarray:
    """Vectorized-over-particles TMVS fitness (patch.cpp:914-1047).

    pos: [P, 3] (theta, phi, depth). Returns [P]."""
    P = pos.shape[0]
    big = 1e30
    out = np.full(P, big)
    st = np.sin(pos[:, 0])
    normal = np.stack([st * np.cos(pos[:, 1]), st * np.sin(pos[:, 1]),
                       np.cos(pos[:, 0])], -1)                  # [P, 3]
    ok = normal @ scene.optical[ref_cam] <= 0
    center = ray[None] * pos[:, 2:3] + scene.center[ref_cam]   # [P, 3]
    s = cfg.lod_ratio ** lod
    r = cfg.patch_radius

    # homography via the reference-camera-frame parameterization
    Rr = scene.R[ref_cam]
    n_r = normal @ Rr.T
    X_r = center @ Rr.T + scene.T[ref_cam]
    d_r = np.sum(n_r * X_r, -1)
    ok &= np.abs(d_r) > 1e-12

    pt, z = scene.project(ref_cam, center, s)                  # [P, 2]
    img_ref = scene.levels[ref_cam][lod]
    hh, ww = img_ref.shape
    ok &= (pt[:, 0] - r >= 2) & (pt[:, 0] + r < ww - 3) & \
          (pt[:, 1] - r >= 2) & (pt[:, 1] + r < hh - 3) & (z > 0)

    ax = np.arange(-r, r + 1, dtype=np.float64)
    dxg, dyg = np.meshgrid(ax, ax, indexing="ij")
    offs = np.stack([dxg.ravel(), dyg.ravel()], -1)            # [W2, 2]
    W2 = offs.shape[0]
    dw = _dist_weight(cfg)

    cams = list(cam_idx)
    K = len(cams)
    for p in range(P):
        if not ok[p]:
            continue
        win = pt[p][None] + offs                               # [W2, 2]
        ref_i = img_ref[np.round(win[:, 1]).astype(int),
                        np.round(win[:, 0]).astype(int)]
        fgm = ref_i != 0
        vals = np.zeros((W2, K))
        bad = False
        for k, cam in enumerate(cams):
            # one homography implementation for the whole oracle: the
            # fitness path and _remove_invisible's warp must never drift
            H = _homography(scene, None, n_r[p], d_r[p], ref_cam, cam, s)
            w = H[2, 0] * win[:, 0] + H[2, 1] * win[:, 1] + H[2, 2]
            u = (H[0, 0] * win[:, 0] + H[0, 1] * win[:, 1] + H[0, 2]) / w
            v = (H[1, 0] * win[:, 0] + H[1, 1] * win[:, 1] + H[1, 2]) / w
            img = scene.levels[cam][lod]
            ih, iw = img.shape
            inb = (u >= 2) & (u < iw - 3) & (v >= 2) & (v < ih - 3) & (w != 0)
            if not np.all(inb | ~fgm):
                bad = True
                break
            x0 = np.floor(u).astype(int)
            y0 = np.floor(v).astype(int)
            x0c = np.clip(x0, 0, iw - 2)
            y0c = np.clip(y0, 0, ih - 2)
            fx = u - x0
            fy = v - y0
            vals[:, k] = (img[y0c, x0c] * (1 - fx) * (1 - fy)
                          + img[y0c, x0c + 1] * fx * (1 - fy)
                          + img[y0c + 1, x0c] * (1 - fx) * fy
                          + img[y0c + 1, x0c + 1] * fx * fy)
        if bad:
            continue
        mean = vals.mean(axis=1)
        sad = np.abs(vals - mean[:, None]).mean(axis=1)
        weight = np.ones(W2)
        if cfg.adaptive_distance_enable:
            weight = weight * dw
        if cfg.adaptive_difference_enable:
            weight = weight * np.exp(-sad * sad / cfg.diff_weighting)
        if cfg.adaptive_gradient_enable:
            e = scene.edge_levels[ref_cam][lod][
                np.round(win[:, 1]).astype(int),
                np.round(win[:, 0]).astype(int)]
            weight = weight * np.exp(-1.0 / np.maximum(
                e * cfg.gradient_weighting, 1e-20))
        weight = weight * fgm
        sw = weight.sum()
        if sw > 0:
            out[p] = float((weight * sad).sum() / sw)
    return out


def pso_refine_one(scene: NpScene, cfg: MvsConfig, rng, ref_cam: int,
                   cam_idx, lod: int, ray, sph0, depth0, depth_range,
                   seed_patch: bool = True, theta_range=None,
                   phi_span: float | None = None
                   ) -> Tuple[np.ndarray, float, int]:
    """One patch's GLN-PSO run with reference hyper-parameters
    (psosolver.cpp; patch.cpp:180-219). Expansion patches narrow the
    normal search to +-pi/reduceNormalRange (patch.cpp:191-200).
    Returns (gbest, fitness, iters)."""
    P = cfg.particle_num * (2 if seed_patch else 1)
    iters = cfg.max_iteration * (2 if seed_patch else 1)
    if theta_range is None:
        theta_range = (0.0, np.pi)
    if phi_span is None:
        phi_span = np.pi / 2
    lo = np.array([theta_range[0], sph0[1] - phi_span, depth_range[0]])
    hi = np.array([theta_range[1], sph0[1] + phi_span, depth_range[1]])
    inter = hi - lo
    pos = lo + inter * rng.uniform(size=(P, 3))
    vel = inter * (2 * rng.uniform(size=(P, 3)) - 1)
    pos[0] = (sph0[0], sph0[1], depth0)
    fit = fitness_np(scene, cfg, ref_cam, cam_idx, lod, ray, pos)
    pbest = pos.copy()
    pfit = fit.copy()
    gi = int(np.argmin(pfit))
    gbest, gfit = pbest[gi].copy(), float(pfit[gi])
    iw = 0.8
    it = 0
    for it in range(iters):
        disp = np.mean(np.abs(pos - gbest))
        vidx = np.mean(np.abs(vel))
        if disp < 0.01 and vidx < 0.01:
            break
        # lBest / nBest (GLN)
        d2 = ((pbest[:, None, :] - pbest[None, :, :]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        lbest = np.zeros_like(pos)
        nbest = np.zeros_like(pos)
        for i in range(P):
            nn = np.argsort(d2[i])[:min(5, P)]
            lbest[i] = pbest[nn[np.argmin(pfit[nn])]]
            with np.errstate(divide="ignore", invalid="ignore"):
                fdr = (fit[i] - pfit[None, :]) / np.abs(
                    pos[i][:, None] - pbest.T)
            fdr[:, i] = -np.inf
            fdr = np.where(np.isnan(fdr), -np.inf, fdr)
            nbest[i] = pbest[np.argmax(fdr, axis=1), np.arange(3)]
        rp = 1.2 * rng.uniform(size=(P, 1))
        rg = 1.5 * rng.uniform(size=(P, 1))
        rl = 1.0 * rng.uniform(size=(P, 1))
        rn = 1.0 * rng.uniform(size=(P, 1))
        vel = iw * vel + rp * (pbest - pos) + rg * (gbest[None] - pos) \
            + rl * (lbest - pos) + rn * (nbest - pos)
        pos = np.clip(pos + vel, lo, hi)
        fit = fitness_np(scene, cfg, ref_cam, cam_idx, lod, ray, pos)
        upd = fit < pfit
        pbest[upd] = pos[upd]
        pfit[upd] = fit[upd]
        gi = int(np.argmin(pfit))
        if pfit[gi] < gfit:
            gbest, gfit = pbest[gi].copy(), float(pfit[gi])
        iw = max(iw - 1.0 / iters, 0.4)
    return gbest, gfit, it + 1


def measure_cpu_patches_per_sec(num_patches: int = 8, width: int = 640,
                                height: int = 480, seed: int = 0,
                                cfg: MvsConfig | None = None) -> dict:
    """Time the sequential per-patch refine on the pawn-shaped workload
    (README config.txt: radius 15, 15 particles, 30 iterations; seeds 2x)."""
    from pais_mvs_tpu.data.synthetic import make_scene
    cfg = cfg or MvsConfig(particle_num=15, max_iteration=30,
                           dist_weighting=5.0)
    sc = make_scene(num_cams=5, width=width, height=height,
                    num_seeds=num_patches + 8, seed=seed)
    scene = NpScene(sc.params, sc.images, cfg)
    rng = np.random.default_rng(seed)
    n_true = sc.plane_normal
    sph = np.array([np.arccos(n_true[2]), np.arctan2(n_true[1], n_true[0])])
    t0 = time.time()
    done = 0
    for m in range(num_patches):
        c = sc.seed_centers[m]
        ref = 2
        ray = c - scene.center[ref]
        depth = float(np.linalg.norm(ray))
        ray = ray / depth
        pso_refine_one(scene, cfg, rng, ref, list(range(5)), 0, ray,
                       sph + rng.normal(scale=0.2, size=2),
                       depth + rng.normal(scale=0.02),
                       (depth - 0.1, depth + 0.1), seed_patch=True)
        done += 1
    dt = time.time() - t0
    return {"patches": done, "seconds": dt, "patches_per_sec": done / dt}


# ---------------------------------------------------------------------------
# full serial reference pipeline: seed refine -> best-first expansion ->
# runtime filtering, one patch at a time (mvs.cpp:196-275, 529-601, 792-898)
# — the cloud-level oracle the engine is parity-checked against.
# ---------------------------------------------------------------------------

class OraclePatch:
    """Mutable per-patch state mirroring PAIS::Patch (mvs/abstractpatch.h)."""

    __slots__ = ("center", "sph", "cam_idx", "ref_cam", "depth", "ray",
                 "depth_range", "lod", "fitness", "correlation", "priority",
                 "img_pts", "drop", "expanded", "pid")

    def __init__(self, center, sph, cam_idx):
        self.center = np.asarray(center, float)
        self.sph = np.asarray(sph, float)
        self.cam_idx = list(cam_idx)
        self.ref_cam = -1
        self.depth = 0.0
        self.ray = np.zeros(3)
        self.depth_range = (0.0, 0.0)
        self.lod = 0
        self.fitness = np.inf
        self.correlation = 0.0
        self.priority = np.inf
        self.img_pts = None
        self.drop = False
        self.expanded = False
        self.pid = -1

    def normal(self):
        st = np.sin(self.sph[0])
        return np.array([st * np.cos(self.sph[1]), st * np.sin(self.sph[1]),
                         np.cos(self.sph[0])])


def _set_ref_cam(scene: NpScene, p: OraclePatch):
    """argmax over visible cams of normal . (-optical) (patch.cpp:415-445)."""
    n = p.normal()
    corr = [-n @ scene.optical[c] for c in p.cam_idx]
    p.ref_cam = p.cam_idx[int(np.argmax(corr))]


def _set_depth_and_ray(scene: NpScene, p: OraclePatch):
    ray = p.center - scene.center[p.ref_cam]
    p.depth = float(np.linalg.norm(ray))
    p.ray = ray / (p.depth if p.depth > 0 else 1.0)


def _set_depth_range(scene: NpScene, cfg: MvsConfig, p: OraclePatch,
                     neighbor_radius: float):
    """1-px displacement sensitivity of the other views (patch.cpp:463-509)."""
    c2 = p.ray * (p.depth + 1.0) + scene.center[p.ref_cam]
    max_wd = -np.inf
    for c in p.cam_idx:
        if c == p.ref_cam:
            continue
        p1, _ = scene.project(c, p.center[None])
        p2, _ = scene.project(c, c2[None])
        dd = float(np.linalg.norm(p1[0] - p2[0]))
        if dd < 0.01:
            continue
        max_wd = max(max_wd, 1.0 / dd)
    if not np.isfinite(max_wd):
        p.drop = True
        return
    lo = max(p.depth - max_wd * cfg.depth_range_scalar, 0.0)
    hi = p.depth + min(max_wd * cfg.depth_range_scalar,
                       neighbor_radius * 100.0)
    p.depth_range = (lo, hi)


def _set_lod(scene: NpScene, cfg: MvsConfig, p: OraclePatch):
    """Climb the pyramid until window variance >= textureVariation
    (patch.cpp:511-610)."""
    r = cfg.patch_radius
    ml = int(scene.max_lod[p.ref_cam])
    lod = cfg.min_lod
    while True:
        if lod >= ml:
            p.lod = ml
            return
        s = cfg.lod_ratio ** lod
        pt, z = scene.project(p.ref_cam, p.center[None], s)
        x, y = pt[0]
        img = scene.levels[p.ref_cam][lod]
        hh, ww = img.shape
        if not (np.isfinite(x) and np.isfinite(y) and z[0] > 0
                and r <= x < ww - r - 1 and r <= y < hh - r - 1):
            p.lod = max(lod - 1, 0)
            return
        xi, yi = int(round(x)), int(round(y))
        win = img[yi - r:yi + r + 1, xi - r:xi + r + 1]
        if float(win.var()) >= cfg.texture_variation:
            p.lod = lod
            return
        lod += 1


def _homography(scene: NpScene, p_center, n_r, d_r, ref_cam: int, cam: int,
                s: float):
    if cam == ref_cam:
        return np.eye(3)
    Rr = scene.R[ref_cam]
    R_rel = scene.R[cam] @ Rr.T
    t_rel = scene.T[cam] - R_rel @ scene.T[ref_cam]
    M = R_rel + np.outer(t_rel, n_r) / d_r
    f_t, pp_t = scene.focal[cam], scene.principal[cam]
    LK_t = np.array([[s * f_t[0], 0, s * pp_t[0]],
                     [0, s * f_t[1], s * pp_t[1]], [0, 0, 1.0]])
    f_r, pp_r = scene.focal[ref_cam], scene.principal[ref_cam]
    LK_r_inv = np.array([[1 / (s * f_r[0]), 0, -pp_r[0] / f_r[0]],
                         [0, 1 / (s * f_r[1]), -pp_r[1] / f_r[1]],
                         [0, 0, 1.0]])
    return LK_t @ M @ LK_r_inv


def _remove_invisible(scene: NpScene, cfg: MvsConfig, p: OraclePatch):
    """Patch::removeInvisibleCamera + setCorrelationTable
    (patch.cpp:221-288, 655-721). Mutates cam_idx/correlation/drop."""
    r = cfg.patch_radius
    s = cfg.lod_ratio ** p.lod
    n = p.normal()
    Rr = scene.R[p.ref_cam]
    n_r = Rr @ n
    X_r = Rr @ p.center + scene.T[p.ref_cam]
    d_r = float(n_r @ X_r)
    if abs(d_r) < 1e-12:
        p.drop = True
        return
    pt, _ = scene.project(p.ref_cam, p.center[None], s)
    ax = np.arange(-r, r + 1, dtype=np.float64)
    dxg, dyg = np.meshgrid(ax, ax, indexing="ij")
    win = pt[0][None] + np.stack([dxg.ravel(), dyg.ravel()], -1)
    K = len(p.cam_idx)
    vecs = np.zeros((K, win.shape[0]))
    ratios = np.zeros(K)
    for k, cam in enumerate(p.cam_idx):
        H = _homography(scene, p.center, n_r, d_r, p.ref_cam, cam, s)
        w = H[2, 0] * win[:, 0] + H[2, 1] * win[:, 1] + H[2, 2]
        u = (H[0, 0] * win[:, 0] + H[0, 1] * win[:, 1] + H[0, 2]) / w
        v = (H[1, 0] * win[:, 0] + H[1, 1] * win[:, 1] + H[1, 2]) / w
        img = scene.levels[cam][p.lod]
        ih, iw = img.shape
        if not np.all((u >= 0) & (u < iw - 1) & (v >= 0) & (v < ih - 1)
                      & (w != 0) & np.isfinite(u) & np.isfinite(v)):
            p.drop = True           # the reference sets drop on OOB warps
            return
        x0 = np.floor(u).astype(int)
        y0 = np.floor(v).astype(int)
        fx, fy = u - x0, v - y0
        vecs[k] = (img[y0, x0] * (1 - fx) * (1 - fy)
                   + img[y0, x0 + 1] * fx * (1 - fy)
                   + img[y0 + 1, x0] * (1 - fx) * fy
                   + img[y0 + 1, x0 + 1] * fx * fy)
        # region ratio: singular values of the homography Jacobian at pt
        x, y = pt[0]
        wc = H[2, 0] * x + H[2, 1] * y + H[2, 2]
        uc = H[0, 0] * x + H[0, 1] * y + H[0, 2]
        vc = H[1, 0] * x + H[1, 1] * y + H[1, 2]
        J = np.array([[H[0, 0] * wc - uc * H[2, 0],
                       H[0, 1] * wc - uc * H[2, 1]],
                      [H[1, 0] * wc - vc * H[2, 0],
                       H[1, 1] * wc - vc * H[2, 1]]]) / (wc * wc)
        sv = np.linalg.svd(J, compute_uv=False)
        ratios[k] = sv[1] / sv[0] if sv[0] > 0 else 0.0
    norms = np.linalg.norm(vecs, axis=1, keepdims=True)
    vecs = vecs / np.where(norms > 0, norms, 1.0)
    corr = vecs @ vecs.T
    np.fill_diagonal(corr, 0.0)
    denom = K * K - K
    p.correlation = float(corr.sum() / denom) if denom > 0 else 0.0
    # best view: max row-sum, ties pick the LAST index (reference >= scan)
    sums = corr.sum(axis=1)
    best = K - 1 - int(np.argmax(sums[::-1]))
    keep = []
    for k, cam in enumerate(p.cam_idx):
        facing = -p.normal() @ scene.optical[cam]
        if ratios[k] < cfg.min_region_ratio or facing < 0:
            continue
        if k != best and corr[best, k] < cfg.min_correlation:
            continue
        keep.append(cam)
    p.cam_idx = keep
    if len(keep) < cfg.min_cam_num:
        p.drop = True


def _set_priority(scene: NpScene, p: OraclePatch):
    total = len(scene.R)
    p.priority = p.fitness * np.exp(
        -p.correlation - len(p.cam_idx) / total) * (p.lod + 1.0)


def _set_image_points(scene: NpScene, p: OraclePatch):
    C = len(scene.R)
    p.img_pts = np.zeros((C, 2))
    for c in range(C):
        xy, _ = scene.project(c, p.center[None])
        p.img_pts[c] = xy[0]


def refine_oracle(scene: NpScene, cfg: MvsConfig, rng, p: OraclePatch,
                  neighbor_radius: float, seed_patch: bool) -> None:
    """Patch::refine (patch.cpp:114-176): the stabilization loop."""
    if len(p.cam_idx) < cfg.min_cam_num:
        p.drop = True
        return
    _set_ref_cam(scene, p)
    _set_depth_and_ray(scene, p)
    _set_depth_range(scene, cfg, p, neighbor_radius)
    if p.drop:
        return
    _set_lod(scene, cfg, p)
    # while (refCam or camNum changed) && count++ <= totalCamNum
    # (patch.cpp:140): up to totalCamNum+1 PSO rounds; TYPE_EXPAND breaks
    # AFTER the post-PSO state updates, and the updates (removeInvisible,
    # refCam, depth/ray/range, LOD) run after EVERY round including the
    # last — the priority's (LOD+1) factor sees the post-refine LOD
    max_rounds = len(p.cam_idx) + 1
    for _ in range(max_rounds):
        if len(p.cam_idx) < cfg.min_cam_num:
            p.drop = True
            return
        old_ref = p.ref_cam
        cams_before = len(p.cam_idx)      # the reference compares COUNTS
        if seed_patch:
            lo_t, hi_t = 0.0, np.pi
            span_p = np.pi / 2.0
        else:
            shrink = np.pi / cfg.reduce_normal_range
            lo_t = max(0.0, p.sph[0] - shrink)
            hi_t = min(np.pi, p.sph[0] + shrink)
            span_p = np.pi / cfg.reduce_normal_range
        gbest, gfit, _ = pso_refine_one(
            scene, cfg, rng, p.ref_cam, p.cam_idx, p.lod, p.ray,
            p.sph, p.depth, p.depth_range, seed_patch=seed_patch,
            theta_range=(lo_t, hi_t), phi_span=span_p)
        p.fitness = gfit
        p.sph = gbest[:2].copy()
        p.depth = float(gbest[2])
        p.center = p.ray * p.depth + scene.center[p.ref_cam]
        if p.fitness > cfg.max_fitness:
            p.drop = True                 # patch.cpp:157-160: early return
            return
        _remove_invisible(scene, cfg, p)
        if p.drop:
            break
        _set_ref_cam(scene, p)
        _set_depth_and_ray(scene, p)
        _set_depth_range(scene, cfg, p, neighbor_radius)
        if p.drop:
            break
        _set_lod(scene, cfg, p)
        if not seed_patch:                # TYPE_EXPAND (patch.cpp:168)
            break
        if p.ref_cam == old_ref and len(p.cam_idx) == cams_before:
            break
    _set_priority(scene, p)
    _set_image_points(scene, p)


def runtime_filter_oracle(scene: NpScene, cfg: MvsConfig, p: OraclePatch,
                          grids=None) -> bool:
    """MVS::runtimeFiltering (mvs.cpp:838-898). True = keep."""
    if p.drop or len(p.cam_idx) < cfg.min_cam_num:
        return False
    if not (np.isfinite(p.fitness) and np.isfinite(p.priority)
            and np.isfinite(p.correlation)):
        return False
    if p.fitness > cfg.max_fitness or p.fitness == 0.0:
        return False
    if p.priority > 10000.0:
        return False
    if p.correlation < cfg.min_correlation:
        return False
    C = len(scene.R)
    front = 0
    n = p.normal()
    for c in range(C):
        xy, z = scene.project(c, p.center[None])
        x, y = xy[0]
        img = scene.levels[c][0]
        hh, ww = img.shape
        if not (np.isfinite(x) and np.isfinite(y) and z[0] > 0
                and 0 <= x < ww and 0 <= y < hh):
            return False
        # cvRound of an in-bounds coordinate can land on dim (y=479.6 ->
        # 480): clip like the engine's nearest lookup (fitness.py
        # nearest_gather) and OpenCV's border handling
        if img[min(int(round(y)), hh - 1), min(int(round(x)), ww - 1)] == 0:
            return False
    for c in p.cam_idx:
        if -n @ scene.optical[c] > 0:
            front += 1
    if front < cfg.min_cam_num:
        return False
    if grids is not None:
        full = 0
        for c in p.cam_idx:
            cx = int(p.img_pts[c][0] / cfg.cell_size)
            cy = int(p.img_pts[c][1] / cfg.cell_size)
            cell = grids.cell(c, cx, cy)
            # reference (mvs.cpp:888-890): a patch found in one of its own
            # cells passes the clause outright — an already-inserted
            # parent re-checked at pop time is never cell-capped out
            if p.pid >= 0 and p.pid in cell:
                return True
            if len(cell) >= cfg.max_cell_patch_num:
                full += 1
        if full == len(p.cam_idx):
            return False
    return True


class OraclePipeline:
    """The reference's -r pipeline end to end, serial, NumPy-only:
    MVS::refineSeedPatches (mvs.cpp:196-231) + MVS::expansionPatches with
    the best-first queue (mvs.cpp:233-275, 632-693)."""

    def __init__(self, params, images, cfg: MvsConfig, seed: int = 0):
        from pais_mvs_tpu.engine.cellgrid import CellGrids
        self._CellGrids = CellGrids
        self.scene = NpScene(params, images, cfg)
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        self.patches: list[OraclePatch] = []
        self.neighbor_radius = 1e-3

    # -- seeding ------------------------------------------------------
    def load_seeds(self, centers, cam_masks, img_points):
        """reCentering triangulation + estimated normal
        (mvs.cpp:135-145, patch.cpp:67-112, 390-413)."""
        sc = self.scene
        for i in range(len(centers)):
            cams = [c for c in range(len(sc.R)) if cam_masks[i][c]]
            A = np.zeros((3, 3))
            b = np.zeros(3)
            for c in cams:
                xy = img_points[i][c]
                d = np.array([(xy[0] - sc.principal[c][0]) / sc.focal[c][0],
                              (xy[1] - sc.principal[c][1]) / sc.focal[c][1],
                              1.0])
                w = sc.R[c].T @ d
                w = w / np.linalg.norm(w)
                P = np.eye(3) - np.outer(w, w)
                A += P
                b += P @ sc.center[c]
            ctr = np.linalg.pinv(A) @ b
            if not np.all(np.isfinite(ctr)):
                ctr = np.asarray(centers[i], float)
            dirs = sc.center[cams] - ctr
            dirs = dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
            nrm = dirs.sum(axis=0)
            nrm = nrm / np.linalg.norm(nrm)
            sph = np.array([np.arccos(np.clip(nrm[2], -1, 1)),
                            np.arctan2(nrm[1], nrm[0])])
            self.patches.append(OraclePatch(ctr, sph, cams))
        self._update_neighbor_radius()

    def adopt_cloud(self, centers, normal_sph, cam_masks, correlations,
                    img_points, neighbor_radius=None):
        """Load an externally reconstructed cloud (e.g. the engine's
        arena) as the oracle's patch set — the reference's -f path, which
        filters whatever .mvs it is given (TMVS.cpp:124-136)."""
        self.patches = []
        for i in range(len(centers)):
            cams = [int(c) for c in np.nonzero(cam_masks[i])[0]]
            p = OraclePatch(centers[i], np.asarray(normal_sph[i], float),
                            cams)
            p.correlation = float(correlations[i])
            p.img_pts = np.asarray(img_points[i], float)
            p.pid = i
            self.patches.append(p)
        if neighbor_radius is not None:
            self.neighbor_radius = float(neighbor_radius)
        else:
            self._update_neighbor_radius()

    def _update_neighbor_radius(self):
        pts = np.array([p.center for p in self.patches
                        if not p.drop]) if self.patches else np.zeros((0, 3))
        if len(pts) == 0:
            return
        ext = pts.max(axis=0) - pts.min(axis=0)
        vol = abs(float(ext[0] * ext[1] * ext[2]))
        nr = vol ** (1.0 / 3.0) * self.cfg.neighbor_radius_scalar
        if nr > 0:
            self.neighbor_radius = nr

    # -- seed refinement (serial, mvs.cpp:196-231) --------------------
    def refine_seeds(self):
        for p in self.patches:
            refine_oracle(self.scene, self.cfg, self.rng, p,
                          self.neighbor_radius, seed_patch=True)
            # pth.refine(); pth.removeInvisibleCamera(); (mvs.cpp:214-215)
            # — the follow-up pass recomputes correlation at the final
            # state before runtimeFiltering sees it
            if not p.drop:
                _remove_invisible(self.scene, self.cfg, p)
            if not runtime_filter_oracle(self.scene, self.cfg, p):
                p.drop = True
        self.patches = [p for p in self.patches if not p.drop]
        for i, p in enumerate(self.patches):
            p.pid = i
        self._update_neighbor_radius()

    # -- expansion (mvs.cpp:233-275) ----------------------------------
    def _is_neighbor(self, p: OraclePatch, q: OraclePatch) -> bool:
        d = q.center - p.center
        dist = abs(d @ p.normal()) + abs(d @ q.normal())
        return dist <= self.neighbor_radius

    def _skip_neighbor_cell(self, grids, occupants, parent) -> bool:
        if len(occupants) >= self.cfg.max_cell_patch_num:
            return True
        for q in occupants:
            qp = self.patches[q]
            if qp.drop:
                continue
            if qp.correlation > self.cfg.min_correlation:
                return True
            if self._is_neighbor(parent, qp):
                return True
        return False

    def expand(self, max_patches: int = 100_000):
        sc, cfg = self.scene, self.cfg
        widths = [lv[0].shape[1] for lv in self.scene.levels]
        heights = [lv[0].shape[0] for lv in self.scene.levels]
        grids = self._CellGrids(widths, heights, cfg.cell_size)
        for p in self.patches:
            grids.insert_patch(p.pid, self._mask_of(p), p.img_pts)
        queue = [p.pid for p in self.patches]
        while queue and len(self.patches) < max_patches:
            # best-first: O(n) min-priority scan (mvs.cpp:656-693)
            k = int(np.argmin([self.patches[i].priority for i in queue]))
            pid = queue.pop(k)
            parent = self.patches[pid]
            parent.expanded = True
            if not runtime_filter_oracle(sc, cfg, parent, grids):
                continue
            # expandNeighborCell (mvs.cpp:529-564)
            for cam in parent.cam_idx:
                cx = int(parent.img_pts[cam][0] / cfg.cell_size)
                cy = int(parent.img_pts[cam][1] / cfg.cell_size)
                for nx, ny in ((cx - 1, cy), (cx, cy - 1),
                               (cx + 1, cy), (cx, cy + 1)):
                    if not grids.in_map(cam, nx, ny):
                        continue
                    occ = [q for q in grids.cell(cam, nx, ny)
                           if not self.patches[q].drop]
                    if self._skip_neighbor_cell(grids, occ, parent):
                        continue
                    child = self._expand_cell(cam, nx, ny, parent)
                    if child is None:
                        continue
                    refine_oracle(sc, cfg, self.rng, child,
                                  self.neighbor_radius, seed_patch=False)
                    # expPatch.refine(); expPatch.removeInvisibleCamera();
                    # (mvs.cpp:573-574) before insertPatch's filter
                    if not child.drop:
                        _remove_invisible(sc, cfg, child)
                    if not runtime_filter_oracle(sc, cfg, child, grids):
                        continue
                    child.pid = len(self.patches)
                    self.patches.append(child)
                    grids.insert_patch(child.pid, self._mask_of(child),
                                       child.img_pts)
                    queue.append(child.pid)
        self.patches = [p for p in self.patches if not p.drop]
        # expansionPatches ends with setNeighborRadius (mvs.cpp:273-274):
        # the post-filters run with the radius of the EXPANDED cloud
        for i, p in enumerate(self.patches):
            p.pid = i
        self._update_neighbor_radius()

    def _mask_of(self, p: OraclePatch):
        m = np.zeros(len(self.scene.R), dtype=bool)
        m[p.cam_idx] = True
        return m

    def _expand_cell(self, cam, cx, cy, parent: OraclePatch):
        """MVS::expandCell + getExpansionPatchCenter (mvs.cpp:566-577,
        809-836) + the expansion Patch ctor (patch.cpp:36-43, 723-761)."""
        sc, cfg = self.scene, self.cfg
        px = (cx + 0.5) * cfg.cell_size
        py = (cy + 0.5) * cfg.cell_size
        d = np.array([(px - sc.principal[cam][0]) / sc.focal[cam][0],
                      (py - sc.principal[cam][1]) / sc.focal[cam][1], 1.0])
        v = sc.R[cam].T @ d
        n = parent.normal()
        denom = float(n @ v)
        if denom == 0:
            return None
        u = float(n @ (parent.center - sc.center[cam])) / denom
        center = sc.center[cam] + u * v
        if not np.all(np.isfinite(center)):
            return None
        # expandVisibleCamera (patch.cpp:723-761)
        cams = [c for c in range(len(sc.R))
                if -n @ sc.optical[c] >= cfg.visible_correlation]
        if len(cams) < cfg.min_cam_num:
            extra = [c for c in parent.cam_idx
                     if -n @ sc.optical[c] >= cfg.visible_correlation / 2.0
                     and c not in cams]
            cams = sorted(cams + extra)
        if len(cams) < cfg.min_cam_num:
            return None
        return OraclePatch(center, parent.sph.copy(), cams)

    # -- post filters (the reference -f pipeline, serial NumPy:
    # MVS::cellFiltering / visibilityFiltering / neighborCellFiltering /
    # neighborPatchFiltering, mvs.cpp:279-525) -------------------------
    def _filter_grids(self):
        """Fresh cell grids over the live patches (setCellMaps). Re-pids
        patches by live index so grid ids stay valid."""
        widths = [lv[0].shape[1] for lv in self.scene.levels]
        heights = [lv[0].shape[0] for lv in self.scene.levels]
        grids = self._CellGrids(widths, heights, self.cfg.cell_size)
        for i, p in enumerate(self.patches):
            p.pid = i
            if not p.drop:
                grids.insert_patch(i, self._mask_of(p), p.img_pts)
        return grids

    def _filter_delete(self, grids, pid: int):
        """MVS::deletePatch (mvs.cpp:607-630): drop + remove from every
        visible view's cell."""
        p = self.patches[pid]
        p.drop = True
        grids.remove_patch(pid, self._mask_of(p), p.img_pts)

    def _grid_cells(self, grids, cam: int):
        """All (x, y) of one camera's map in the reference's x-outer,
        y-inner scan order (mvs.cpp:293-295)."""
        return ((x, y) for x in range(grids.width[cam])
                for y in range(grids.height[cam]))

    def cell_filtering(self, grids=None):
        """PMVS rule (mvs.cpp:279-325): in each cell, kill patch j when
        corr_j * camNum_j < sum of the other (live) cellmates'
        correlations. Kills apply after each cell's scan."""
        grids = grids or self._filter_grids()
        removed = 0
        C = len(self.scene.R)
        for cam in range(C):
            for x, y in self._grid_cells(grids, cam):
                cell = list(grids.cell(cam, x, y))
                kill = []
                for q in cell:
                    pq = self.patches[q]
                    if pq.drop:
                        continue
                    corr_sum = sum(self.patches[o].correlation
                                   for o in cell
                                   if o != q and not self.patches[o].drop)
                    if pq.correlation * len(pq.cam_idx) < corr_sum:
                        kill.append(q)
                for q in kill:
                    self._filter_delete(grids, q)
                    removed += 1
        return removed

    def visibility_filtering(self, grids=None):
        """Depth-ordering consistency (mvs.cpp:399-446): a view stops
        counting as visible when ANY cellmate in that view is closer to
        the camera; kill when fewer than minCamNum views survive.
        Patches scanned in id order, deletions immediate."""
        grids = grids or self._filter_grids()
        sc = self.scene
        removed = 0
        for p in self.patches:
            if p.drop:
                continue
            visible = len(p.cam_idx)
            for cam in p.cam_idx:
                depth = float(np.linalg.norm(p.center - sc.center[cam]))
                cx = int(p.img_pts[cam][0] / self.cfg.cell_size)
                cy = int(p.img_pts[cam][1] / self.cfg.cell_size)
                for q in grids.cell(cam, cx, cy):
                    if q == p.pid or self.patches[q].drop:
                        continue
                    nd = float(np.linalg.norm(self.patches[q].center
                                              - sc.center[cam]))
                    if depth > nd:
                        visible -= 1
                        break
            if visible < self.cfg.min_cam_num:
                self._filter_delete(grids, p.pid)
                removed += 1
        return removed

    def neighbor_cell_filtering(self, neighbor_ratio: float, grids=None):
        """3x3 neighbourhood support ratio (mvs.cpp:327-397): kill when
        the fraction of (live) patches in the 9 surrounding cells passing
        isNeighbor falls below the ratio. Kills apply after each cell."""
        grids = grids or self._filter_grids()
        removed = 0
        C = len(self.scene.R)
        for cam in range(C):
            for x, y in self._grid_cells(grids, cam):
                cell = list(grids.cell(cam, x, y))
                kill = []
                for q in cell:
                    pq = self.patches[q]
                    if pq.drop:
                        continue
                    nsum = 0
                    nnum = 0
                    for dx in (-1, 0, 1):
                        for dy in (-1, 0, 1):
                            nx, ny = x + dx, y + dy
                            if not grids.in_map(cam, nx, ny):
                                continue
                            ncell = [o for o in grids.cell(cam, nx, ny)
                                     if not self.patches[o].drop]
                            nsum += len(ncell)
                            nnum += sum(self._is_neighbor(pq,
                                                          self.patches[o])
                                        for o in ncell)
                    if nsum and nnum / nsum < neighbor_ratio:
                        kill.append(q)
                for q in kill:
                    self._filter_delete(grids, q)
                    removed += 1
        return removed

    def neighbor_patch_filtering(self, neighbor_ratio: float, grids=None):
        """PCMVS density rule (mvs.cpp:448-525): count Euclidean
        neighbours within neighborRadius (pre-filter state), kill patches
        below avg * ratio."""
        grids = grids or self._filter_grids()
        live = [p for p in self.patches if not p.drop]
        if not live:
            return 0
        pts = np.array([p.center for p in live])
        d = np.linalg.norm(pts[:, None, :] - pts[None, :, :], axis=-1)
        counts = (d <= self.neighbor_radius).sum(axis=1) - 1
        avg = counts.mean()
        removed = 0
        for p, c in zip(live, counts):
            if c < avg * neighbor_ratio:
                self._filter_delete(grids, p.pid)
                removed += 1
        return removed

    def run_filters(self, ratio: float = 0.25) -> dict:
        """The reference -f pipeline order (TMVS.cpp:124-172). Returns the
        per-pass kill counts; the kill SETS are recoverable from the
        patches' drop flags between calls."""
        grids = self._filter_grids()
        return {
            "cell": self.cell_filtering(grids),
            "visibility": self.visibility_filtering(grids),
            "neighbor_cell": self.neighbor_cell_filtering(ratio, grids),
            "neighbor_patch": self.neighbor_patch_filtering(ratio, grids),
        }

    # -- outputs ------------------------------------------------------
    def cloud(self) -> np.ndarray:
        return np.array([p.center for p in self.patches if not p.drop])


def cloud_agreement(engine_pts: np.ndarray, oracle_pts: np.ndarray,
                    tol: float) -> dict:
    """% of engine patches within ``tol`` of the nearest oracle patch and
    vice versa (the cloud-parity metric)."""
    from scipy.spatial import cKDTree

    def frac_within(a, b):
        if len(a) == 0 or len(b) == 0:
            return 0.0
        dmin, _ = cKDTree(np.asarray(b, np.float64)).query(
            np.asarray(a, np.float64), k=1)
        return float((dmin <= tol).mean())
    return {
        "engine_within_tol": frac_within(engine_pts, oracle_pts),
        "oracle_within_tol": frac_within(oracle_pts, engine_pts),
        "engine_count": int(len(engine_pts)),
        "oracle_count": int(len(oracle_pts)),
    }


if __name__ == "__main__":
    import json
    r = measure_cpu_patches_per_sec()
    print(json.dumps(r))
