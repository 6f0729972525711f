"""DoG scale-space keypoint detection as a fixed-shape tensor program.

The reference relies on OpenCV's SIFT detector
(TMVS/mvs/featuremanager.cpp:19-26). Here the scale space is built with
separable Gaussian convolutions (static kernel sizes, XLA-fusable), extrema
are found by 3x3 max/min pooling across adjacent DoG levels, and a fixed
top-K per octave keeps every shape static for jit. Scores below threshold
are masked, never dropped, so the output is always [K, ...] + mask.
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class Keypoints(NamedTuple):
    xy: jnp.ndarray       # [K, 2] level-0 pixel coords (x, y)
    sigma: jnp.ndarray    # [K] scale (level-0 pixels)
    octave: jnp.ndarray   # [K] int32
    score: jnp.ndarray    # [K] |DoG| response
    mask: jnp.ndarray     # [K] bool
    xy_oct: jnp.ndarray   # [K, 2] octave-local pixel coords
    sigma_oct: jnp.ndarray  # [K] octave-local scale
    level: jnp.ndarray    # [K] int32 DoG level within octave (0..S-1)


def _gauss_kernel1d(sigma: float) -> np.ndarray:
    r = max(int(math.ceil(3.0 * sigma)), 1)
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _blur(img: jnp.ndarray, sigma: float) -> jnp.ndarray:
    """Separable Gaussian blur with edge-replicate padding. img: [H, W]."""
    k = jnp.asarray(_gauss_kernel1d(sigma))
    r = (k.shape[0] - 1) // 2
    x = jnp.pad(img, ((0, 0), (r, r)), mode="edge")
    # conv along W then H via conv_general_dilated
    x = jax.lax.conv_general_dilated(
        x[None, None, :, :], k[None, None, None, :], (1, 1), "VALID")[0, 0]
    x = jnp.pad(x, ((r, r), (0, 0)), mode="edge")
    x = jax.lax.conv_general_dilated(
        x[None, None, :, :], k[None, None, :, None], (1, 1), "VALID")[0, 0]
    return x


def _maxpool3(x: jnp.ndarray) -> jnp.ndarray:
    return jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (3, 3), (1, 1),
                                 "SAME")


def _minpool3(x: jnp.ndarray) -> jnp.ndarray:
    return jax.lax.reduce_window(x, jnp.inf, jax.lax.min, (3, 3), (1, 1),
                                 "SAME")


def _octave_extrema(dogs: List[jnp.ndarray], contrast_thresh: float,
                    edge_ratio: float) -> jnp.ndarray:
    """Per-level extrema score maps. dogs: list of [H, W]. Returns
    [S, H, W] where S = len(dogs) - 2; zero where not a keypoint."""
    out = []
    for l in range(1, len(dogs) - 1):
        d = dogs[l]
        trio_max = jnp.maximum(jnp.maximum(_maxpool3(dogs[l - 1]),
                                           _maxpool3(dogs[l + 1])),
                               _maxpool3(d))
        trio_min = jnp.minimum(jnp.minimum(_minpool3(dogs[l - 1]),
                                           _minpool3(dogs[l + 1])),
                               _minpool3(d))
        is_ext = (d >= trio_max) | (d <= trio_min)
        # 2x2 Hessian edge-response gate (Lowe's r-test)
        dxx = jnp.roll(d, -1, 1) + jnp.roll(d, 1, 1) - 2 * d
        dyy = jnp.roll(d, -1, 0) + jnp.roll(d, 1, 0) - 2 * d
        dxy = 0.25 * (jnp.roll(jnp.roll(d, -1, 0), -1, 1)
                      + jnp.roll(jnp.roll(d, 1, 0), 1, 1)
                      - jnp.roll(jnp.roll(d, -1, 0), 1, 1)
                      - jnp.roll(jnp.roll(d, 1, 0), -1, 1))
        tr = dxx + dyy
        det = dxx * dyy - dxy * dxy
        r = edge_ratio
        not_edge = (det > 0) & (tr * tr * r < (r + 1.0) ** 2 * det)
        score = jnp.abs(d)
        ok = is_ext & not_edge & (score > contrast_thresh)
        # keep a 8px interior margin (descriptor support must fit)
        H, W = d.shape
        ys = jnp.arange(H)[:, None]
        xs = jnp.arange(W)[None, :]
        ok &= (xs >= 8) & (xs < W - 8) & (ys >= 8) & (ys < H - 8)
        out.append(jnp.where(ok, score, 0.0))
    return jnp.stack(out, axis=0)


@functools.partial(jax.jit, static_argnames=("num_octaves", "scales",
                                             "k_per_octave"))
def detect_keypoints(img: jnp.ndarray, num_octaves: int = 4, scales: int = 3,
                     k_per_octave: int = 192,
                     contrast_thresh: float = 0.01,
                     edge_ratio: float = 10.0):
    """Detect DoG keypoints on a [H, W] image with values in [0, 255].

    Returns (Keypoints, gaussians) where ``gaussians`` is the list of
    per-octave blurred stacks [S+3, Ho, Wo] the descriptor stage samples.
    """
    sigma0 = 1.6
    k = 2.0 ** (1.0 / scales)
    img = img.astype(jnp.float32) / 255.0

    base = _blur(img, math.sqrt(max(sigma0 ** 2 - 0.25, 0.01)))
    all_xy, all_sig, all_oct, all_score, all_mask = [], [], [], [], []
    all_xy_oct, all_sig_oct, all_level = [], [], []
    gaussians = []
    for o in range(num_octaves):
        H, W = base.shape
        if o > 0 and (H < 32 or W < 32):
            break     # octave 0 always runs, even on tiny images
        gs = [base]
        for i in range(1, scales + 3):
            sp = sigma0 * (k ** (i - 1))
            sn = sigma0 * (k ** i)
            gs.append(_blur(gs[-1], math.sqrt(sn * sn - sp * sp)))
        gaussians.append(jnp.stack(gs, axis=0))
        dogs = [gs[i + 1] - gs[i] for i in range(scales + 2)]
        score = _octave_extrema(dogs, contrast_thresh, edge_ratio)  # [S,H,W]

        flat = score.reshape(-1)
        vals, idx = jax.lax.top_k(flat, k_per_octave)
        lvl = idx // (H * W)
        yy = (idx % (H * W)) // W
        xx = idx % W
        # quadratic sub-pixel offset from the per-level DoG maps. Index
        # (level, y, x) in ONE gather per tap: `dstack[lvl + 1]` with a
        # traced lvl would materialize a [K, H, W] plane-per-keypoint
        # intermediate (~7 GB at 4K) because the gather-of-gather does
        # not fuse.
        dstack = jnp.stack(dogs, 0)                      # [S+2, H, W]
        l1 = lvl + 1
        xp = jnp.clip(xx + 1, 0, W - 1)
        xm = jnp.clip(xx - 1, 0, W - 1)
        yp = jnp.clip(yy + 1, 0, H - 1)
        ym = jnp.clip(yy - 1, 0, H - 1)
        d_xp = dstack[l1, yy, xp]
        d_xm = dstack[l1, yy, xm]
        d_yp = dstack[l1, yp, xx]
        d_ym = dstack[l1, ym, xx]
        c = dstack[l1, yy, xx]
        gx = 0.5 * (d_xp - d_xm)
        gy = 0.5 * (d_yp - d_ym)
        hxx = d_xp + d_xm - 2 * c
        hyy = d_yp + d_ym - 2 * c
        ox = jnp.clip(-gx / jnp.where(jnp.abs(hxx) > 1e-8, hxx, 1.0),
                      -0.5, 0.5)
        oy = jnp.clip(-gy / jnp.where(jnp.abs(hyy) > 1e-8, hyy, 1.0),
                      -0.5, 0.5)

        scale_mult = float(2 ** o)
        xy_oct = jnp.stack([xx.astype(jnp.float32) + ox,
                            yy.astype(jnp.float32) + oy], -1)
        sig_oct = sigma0 * jnp.power(jnp.float32(k),
                                     (lvl + 1).astype(jnp.float32))
        all_xy.append(xy_oct * scale_mult)
        all_sig.append(sig_oct * scale_mult)
        all_oct.append(jnp.full(k_per_octave, o, dtype=jnp.int32))
        all_score.append(vals)
        all_mask.append(vals > 0)
        all_xy_oct.append(xy_oct)
        all_sig_oct.append(sig_oct)
        all_level.append(lvl.astype(jnp.int32))
        base = gs[scales][::2, ::2]

    kp = Keypoints(
        xy=jnp.concatenate(all_xy), sigma=jnp.concatenate(all_sig),
        octave=jnp.concatenate(all_oct), score=jnp.concatenate(all_score),
        mask=jnp.concatenate(all_mask), xy_oct=jnp.concatenate(all_xy_oct),
        sigma_oct=jnp.concatenate(all_sig_oct),
        level=jnp.concatenate(all_level))
    return kp, gaussians
