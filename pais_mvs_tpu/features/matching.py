"""Descriptor matching with epipolar gating.

Reference pipeline (TMVS/mvs/featuremanager.cpp): analytic fundamental
matrices for every ordered camera pair from the projection matrices
(:249-288), brute-force L2 cross-check matching (:30-52), epipolar-line
distance filter (:158-195), and pruning of weak pairs (< max/4 matches,
:197-247).

Batched: each pair's L2 distance table is ONE [K, K] matmul of unit
descriptors, mutual-nearest + Lowe ratio + epipolar gate are
elementwise reductions over it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


def fundamental_from_rig(R1, T1, K1, R2, T2, K2) -> np.ndarray:
    """F mapping view-1 points to epipolar lines in view 2.

    From relative pose (x2cam = R_rel x1cam + t_rel): E = [t]x R_rel,
    F = K2^-T E K1^-1. Equivalent to the reference's pseudo-inverse route
    F = [e']x P2 P1^+ (featuremanager.cpp:249-288) but closed-form.
    """
    R_rel = R2 @ R1.T
    t = T2 - R_rel @ T1
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0.0]])
    E = tx @ R_rel
    F = np.linalg.inv(K2).T @ E @ np.linalg.inv(K1)
    n = np.abs(F).max()
    return F / (n if n > 0 else 1.0)


class PairMatches(NamedTuple):
    idx2: jnp.ndarray     # [K] best view-2 keypoint per view-1 keypoint
    good: jnp.ndarray     # [K] bool: mutual + ratio + epipolar + masks


@functools.partial(jax.jit, static_argnames=())
def match_pair(desc1, desc2, xy1, xy2, mask1, mask2, F,
               max_epipolar_dist=3.0, ratio=0.85):
    """Match two descriptor sets. desc*: [K, D] unit vectors."""
    sim = desc1 @ desc2.T                                   # [K, K]
    sim = jnp.where(mask1[:, None] & mask2[None, :], sim, -2.0)
    # L2^2 = 2 - 2 sim for unit vectors; nearest = max sim
    best2 = jnp.argmax(sim, axis=1)                         # [K]
    # two iterative argmax extractions instead of lax.top_k, which lowers
    # to a row sort (same pattern as ops/pso.py::_local_best)
    s1 = jnp.take_along_axis(sim, best2[:, None], axis=1)[:, 0]
    sim2 = sim.at[jnp.arange(sim.shape[0]), best2].set(-2.0)
    s2 = jnp.max(sim2, axis=1)
    d1 = jnp.sqrt(jnp.maximum(2.0 - 2.0 * s1, 0.0))
    d2 = jnp.sqrt(jnp.maximum(2.0 - 2.0 * s2, 0.0))
    pass_ratio = d1 <= ratio * d2
    best1_of2 = jnp.argmax(sim, axis=0)                     # [K]
    mutual = best1_of2[best2] == jnp.arange(desc1.shape[0])

    p1h = jnp.concatenate([xy1, jnp.ones_like(xy1[:, :1])], -1)  # [K, 3]
    l2 = p1h @ F.T                                          # lines in view 2
    p2 = xy2[best2]
    num = jnp.abs(l2[:, 0] * p2[:, 0] + l2[:, 1] * p2[:, 1] + l2[:, 2])
    den = jnp.sqrt(l2[:, 0] ** 2 + l2[:, 1] ** 2)
    epi = num / jnp.where(den > 0, den, 1.0)
    good = (mask1 & mask2[best2] & mutual & pass_ratio &
            (epi <= max_epipolar_dist) & (s1 > -2.0))
    return PairMatches(idx2=best2.astype(jnp.int32), good=good)


def match_all_pairs(descs, xys, masks, Fs, max_epipolar_dist=3.0,
                    ratio=0.85, min_pair_frac=0.25):
    """All unordered camera pairs. descs: [C, K, D]; Fs[i][j]: F from i to j.

    Returns {(i, j): (idx1 [M], idx2 [M])} numpy index arrays, after
    dropping pairs with fewer than ``min_pair_frac * max_pair_count``
    matches (reference featuremanager.cpp:197-247).
    """
    C = len(descs)
    raw = {}
    counts = {}
    for i in range(C):
        for j in range(i + 1, C):
            pm = match_pair(descs[i], descs[j], xys[i], xys[j],
                            masks[i], masks[j], jnp.asarray(Fs[i][j],
                                                            jnp.float32),
                            max_epipolar_dist, ratio)
            good = np.asarray(pm.good)
            idx2 = np.asarray(pm.idx2)
            i1 = np.nonzero(good)[0]
            raw[(i, j)] = (i1, idx2[i1])
            counts[(i, j)] = len(i1)
    if not counts:
        return {}
    max_count = max(counts.values())
    return {k: v for k, v in raw.items()
            if counts[k] >= max_count * min_pair_frac}
