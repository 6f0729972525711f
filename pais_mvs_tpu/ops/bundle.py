"""Pose-refinement bundle adjustment with a distributed Schur complement.

NEW SCOPE vs the reference: TMVS takes VisualSFM poses as fixed ground truth
(TMVS/io/fileloader.cpp:251-325 just parses them; there is no pose
optimization anywhere in the tree). The driver's north star adds a
pose-refinement BA stage, so this module implements it as batched device
math:

* residuals r_{m,c} = project(R_c (X_m - C_c)) - obs_{m,c} over n-view
  tracks (the same tracks the seeder produces);
* Levenberg-Marquardt normal equations with the POINT blocks eliminated by
  a Schur complement: S = U - W H_pp^-1 W^T over cameras, then
  back-substitution for the points;
* every per-track quantity (H_pp, W, b) is an independent reduction over
  tracks, so the track axis shards over the device mesh and the reduced
  [6C+, 6C] camera system assembles with one psum — a collective does the
  Schur reduction, the tiny dense solve is replicated.

Camera deltas are parameterized as (axis-angle w, center delta dc):
R <- exp([w]x) R,  C <- C + dc. Jacobians come from one vmapped closed-form
derivation (f32; the solve promotes to f64 on host via numpy when tiny).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P


class BaProblem(NamedTuple):
    """Inputs: C cameras, M tracks (fixed shapes, masked)."""
    R: jnp.ndarray           # [C, 3, 3]
    center: jnp.ndarray      # [C, 3]
    focal: jnp.ndarray       # [C, 2]
    principal: jnp.ndarray   # [C, 2]
    points: jnp.ndarray      # [M, 3]
    obs: jnp.ndarray         # [M, C, 2] observed pixels
    mask: jnp.ndarray        # [M, C] bool


class BaResult(NamedTuple):
    R: jnp.ndarray
    center: jnp.ndarray
    points: jnp.ndarray
    rms_history: jnp.ndarray  # [iters + 1] masked reprojection RMS (px)


def _exp_so3(w):
    """Rodrigues: axis-angle [..., 3] -> rotation [..., 3, 3]."""
    theta = jnp.linalg.norm(w, axis=-1, keepdims=True)
    safe = jnp.where(theta > 1e-12, theta, 1.0)
    k = w / safe
    K = jnp.zeros(w.shape[:-1] + (3, 3), w.dtype)
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    z = jnp.zeros_like(kx)
    K = jnp.stack([
        jnp.stack([z, -kz, ky], -1),
        jnp.stack([kz, z, -kx], -1),
        jnp.stack([-ky, kx, z], -1)], -2)
    s = jnp.sin(theta)[..., None]
    c = jnp.cos(theta)[..., None]
    eye = jnp.eye(3, dtype=w.dtype)
    Rr = eye + s * K + (1 - c) * (K @ K)
    return jnp.where((theta > 1e-12)[..., None], Rr, eye + K)


def _residual_and_jac(R, C0, f, pp, X, obs):
    """One (track, camera) residual [2] + Jacobians wrt (w[3], dc[3], X[3]).

    Closed form around delta=0: x = R(X - C), u = f x/z + pp;
    d x / d w = -[x]x (left-multiplied exp), d x / d dc = -R, d x / dX = R.
    """
    x = R @ (X - C0)
    z = jnp.where(x[2] == 0, 1.0, x[2])
    u = f * x[:2] / z + pp
    r = u - obs
    # d u / d x : [2, 3]
    du = jnp.stack([
        jnp.array([1.0, 0.0, 0.0]) * f[0] / z
        - jnp.array([0.0, 0.0, 1.0]) * f[0] * x[0] / (z * z),
        jnp.array([0.0, 1.0, 0.0]) * f[1] / z
        - jnp.array([0.0, 0.0, 1.0]) * f[1] * x[1] / (z * z)])
    xx = jnp.array([[0, -x[2], x[1]], [x[2], 0, -x[0]], [-x[1], x[0], 0.0]])
    Jw = du @ (-xx)          # [2, 3]
    Jc = du @ (-R)           # [2, 3]
    Jp = du @ R              # [2, 3]
    return r, jnp.concatenate([Jw, Jc], -1), Jp, x[2]


def _assemble(R, center, focal, principal, points, obs, mask, damping):
    """Per-shard: masked LM normal-equation pieces, reduced over tracks.

    Returns (S [C6, C6], rhs [C6], Hpp_inv [M,3,3], bp [M,3], W [M,C,6,3],
    sse, n_obs) where C6 = 6C. Everything except the M-indexed outputs is a
    plain sum over the local tracks — psum-able.
    """
    M, C = mask.shape

    def per_track(X, ob, mk):
        def per_cam(c):
            r, Jcam, Jp, z = _residual_and_jac(
                R[c], center[c], focal[c], principal[c], X, ob[c])
            ok = mk[c] & (z > 0)
            w = ok.astype(X.dtype)
            return r * w, Jcam * w, Jp * w
        r, Jcam, Jp = jax.vmap(per_cam)(jnp.arange(C))
        return r, Jcam, Jp

    r, Jcam, Jp = jax.vmap(per_track)(points, obs, mask)  # [M,C,2],[M,C,2,6],[M,C,2,3]

    Hpp = jnp.einsum("mcki,mckj->mij", Jp, Jp)            # [M, 3, 3]
    Hpp = Hpp + damping * jnp.eye(3)[None]
    bp = -jnp.einsum("mcki,mck->mi", Jp, r)               # [M, 3]
    W = jnp.einsum("mcki,mckj->mcij", Jcam, Jp)           # [M, C, 6, 3]
    U = jnp.einsum("mcki,mckj->cij", Jcam, Jcam)          # [C, 6, 6]
    bc = -jnp.einsum("mcki,mck->ci", Jcam, r)             # [C, 6]

    Hpp_inv = jnp.linalg.inv(Hpp)
    WHi = jnp.einsum("mcij,mjk->mcik", W, Hpp_inv)        # [M, C, 6, 3]
    S_red = jnp.einsum("mcik,mdjk->cidj", WHi, W)         # [C,6,C,6]
    rhs_red = jnp.einsum("mcik,mk->ci", WHi, bp)

    C6 = 6 * C
    S = -S_red.reshape(C6, C6)
    # add the block-diagonal U (C is static, unroll); the caller adds the
    # LM damping AFTER any cross-shard psum so it isn't multiplied by the
    # shard count
    Ubd = jax.scipy.linalg.block_diag(*[U[c] for c in range(C)])
    S = S + Ubd
    rhs = bc.reshape(C6) - rhs_red.reshape(C6)

    sse = jnp.sum(r * r)
    n_obs = jnp.sum(mask)
    return S, rhs, Hpp_inv, bp, W, sse, n_obs


def _pad_tracks(points, obs, mask, chunk):
    M = points.shape[0]
    pad = (-M) % chunk
    if pad:
        points = jnp.concatenate(
            [points, jnp.zeros((pad, 3), points.dtype)])
        obs = jnp.concatenate(
            [obs, jnp.zeros((pad,) + obs.shape[1:], obs.dtype)])
        mask = jnp.concatenate(
            [mask, jnp.zeros((pad,) + mask.shape[1:], bool)])
    return points, obs, mask, M


def _reduced_system(R, center, focal, principal, points, obs, mask,
                    damping, chunk: int):
    """Schur-reduced camera system accumulated over track CHUNKS: the
    per-track Jacobian blocks ([chunk, C, ...]) never materialize for the
    whole track set, so memory is O(chunk x C) instead of O(M x C)."""
    C = R.shape[0]
    C6 = 6 * C
    pts, ob, mk, M = _pad_tracks(points, obs, mask, chunk)
    n_chunks = pts.shape[0] // chunk

    def body(carry, xs):
        p, o, m = xs
        S, rhs, _, _, _, sse, n = _assemble(R, center, focal, principal,
                                            p, o, m, damping)
        cS, crhs, csse, cn = carry
        return (cS + S, crhs + rhs, csse + sse, cn + n), None

    init = (jnp.zeros((C6, C6)), jnp.zeros(C6), jnp.asarray(0.0),
            jnp.asarray(0, jnp.int32))
    xs = (pts.reshape(n_chunks, chunk, 3),
          ob.reshape(n_chunks, chunk, C, 2),
          mk.reshape(n_chunks, chunk, C))
    (S, rhs, sse, n), _ = jax.lax.scan(body, init, xs)
    return S, rhs, sse, n


def _point_updates(R, center, focal, principal, points, obs, mask,
                   damping, dc, chunk: int):
    """Back-substitution dp per track, chunked like _reduced_system."""
    C = R.shape[0]
    pts, ob, mk, M = _pad_tracks(points, obs, mask, chunk)
    n_chunks = pts.shape[0] // chunk

    def body(_, xs):
        p, o, m = xs
        _, _, Hpp_inv, bp, W, _, _ = _assemble(R, center, focal, principal,
                                               p, o, m, damping)
        dp = jnp.einsum("mij,mj->mi", Hpp_inv,
                        bp - jnp.einsum("mcij,ci->mj", W, dc))
        return None, dp

    xs = (pts.reshape(n_chunks, chunk, 3),
          ob.reshape(n_chunks, chunk, C, 2),
          mk.reshape(n_chunks, chunk, C))
    _, dps = jax.lax.scan(body, None, xs)
    return dps.reshape(-1, 3)[:M]


def _solve_preconditioned(S, rhs):
    """Jacobi-preconditioned dense solve: the Schur system mixes rotation
    and translation units, so D^-1/2 S D^-1/2 drops the condition number
    enough for a stable f32 solve."""
    d = jnp.sqrt(jnp.maximum(jnp.diag(S), 1e-12))
    Sp = S / (d[:, None] * d[None, :])
    y = jnp.linalg.solve(Sp, rhs / d)
    return y / d


def _apply_updates(R, center, points, dc, dp):
    w = dc[:, :3]
    dcen = dc[:, 3:]
    Rn = _exp_so3(w) @ R
    return Rn, center + dcen, points + dp


@functools.partial(jax.jit, static_argnames=("num_iters", "chunk"))
def bundle_adjust(problem: BaProblem, num_iters: int = 10,
                  damping: float = 1e-3,
                  fix_first_camera: bool = True,
                  chunk: int = 2048) -> BaResult:
    """Single-device LM bundle adjustment (fixed iteration count, jittable).

    ``fix_first_camera`` gauges the solution by pinning camera 0 (removes
    the 6-dof global gauge freedom; scale gauge is left to the damping).
    ``chunk`` bounds the per-step Jacobian memory to O(chunk x cameras).
    """
    R, center, points = problem.R, problem.center, problem.points
    C = R.shape[0]
    C6 = 6 * C
    chunk = max(1, min(chunk, points.shape[0]))

    def rms(R, center, points):
        def per_track(X, ob, mk):
            def per_cam(c):
                r, _, _, z = _residual_and_jac(
                    R[c], center[c], problem.focal[c], problem.principal[c],
                    X, ob[c])
                return jnp.sum(r * r) * (mk[c] & (z > 0)).astype(X.dtype)
            return jnp.sum(jax.vmap(per_cam)(jnp.arange(C)))
        sse = jnp.sum(jax.vmap(per_track)(points, problem.obs, problem.mask))
        n = jnp.maximum(jnp.sum(problem.mask), 1)
        return jnp.sqrt(sse / (2.0 * n))

    history = [rms(R, center, points)]
    gauge = jnp.ones((C6,))
    if fix_first_camera:
        gauge = gauge.at[:6].set(0.0)

    for _ in range(num_iters):
        S, rhs, _, _ = _reduced_system(
            R, center, problem.focal, problem.principal, points,
            problem.obs, problem.mask, damping, chunk)
        S = S + damping * jnp.eye(C6)
        # pin the gauge rows/cols
        S = S * gauge[:, None] * gauge[None, :] \
            + jnp.diag(1.0 - gauge)
        rhs = rhs * gauge
        dc = _solve_preconditioned(S, rhs).reshape(C, 6)
        dp = _point_updates(R, center, problem.focal, problem.principal,
                            points, problem.obs, problem.mask, damping,
                            dc, chunk)
        R, center, points = _apply_updates(R, center, points, dc, dp)
        history.append(rms(R, center, points))

    return BaResult(R, center, points, jnp.stack(history))


def bundle_adjust_sharded(problem: BaProblem, mesh: Mesh, axis: str,
                          num_iters: int = 10,
                          damping: float = 1e-3,
                          fix_first_camera: bool = True,
                          chunk: int = 2048) -> BaResult:
    """Track-sharded LM bundle adjustment over a device mesh.

    The track axis of (points, obs, mask) shards over ``axis``; each device
    assembles its local Schur pieces and one ``psum`` produces the
    replicated reduced camera system (the distributed Schur-complement
    reduction). Point back-substitution stays
    local to each shard.
    """
    C = problem.R.shape[0]
    C6 = 6 * C
    gauge = np.ones((C6,), np.float32)
    if fix_first_camera:
        gauge[:6] = 0.0
    gauge = jnp.asarray(gauge)

    def body(R, center, focal, principal, points, obs, mask):
        hist = []
        ck = max(1, min(chunk, points.shape[0]))

        def rms_only(R, center, points):
            # residual-only pass (same as the single-device rms): the full
            # _reduced_system assembles Hpp inverses + [6C,6C] Schur
            # einsums just to read sse/n — ~2x per-iteration device work
            def per_track(X, ob, mk):
                def per_cam(c):
                    r, _, _, z = _residual_and_jac(
                        R[c], center[c], focal[c], principal[c], X, ob[c])
                    return jnp.sum(r * r) * (mk[c] & (z > 0)).astype(X.dtype)
                return jnp.sum(jax.vmap(per_cam)(jnp.arange(C)))
            sse = jnp.sum(jax.vmap(per_track)(points, obs, mask))
            sse = jax.lax.psum(sse, axis)
            n = jax.lax.psum(jnp.sum(mask), axis)
            return jnp.sqrt(sse / (2.0 * jnp.maximum(n, 1)))

        hist.append(rms_only(R, center, points))
        for _ in range(num_iters):
            S, rhs, _, _ = _reduced_system(
                R, center, focal, principal, points, obs, mask, damping, ck)
            S = jax.lax.psum(S, axis) + damping * jnp.eye(C6)
            rhs = jax.lax.psum(rhs, axis)
            S = S * gauge[:, None] * gauge[None, :] + jnp.diag(1.0 - gauge)
            rhs = rhs * gauge
            dc = _solve_preconditioned(S, rhs).reshape(C, 6)
            dp = _point_updates(R, center, focal, principal, points, obs,
                                mask, damping, dc, ck)
            R, center, points = _apply_updates(R, center, points, dc, dp)
            hist.append(rms_only(R, center, points))
        return R, center, points, jnp.stack(hist)

    # jit the shard_map: eager shard_map dispatches op-by-op
    f = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(axis), P(axis), P(axis)),
        out_specs=(P(), P(), P(axis), P()),
        check_vma=False))
    R, center, points, hist = f(problem.R, problem.center, problem.focal,
                                problem.principal, problem.points,
                                problem.obs, problem.mask)
    return BaResult(R, center, points, hist)
