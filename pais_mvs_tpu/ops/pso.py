"""Batched GLN-PSO: B independent swarms advancing in lockstep.

The reference optimizer (TMVS/pso/psosolver.cpp) runs ONE swarm at a time
and parallelizes over its ~10-30 particles with OpenMP. That shape wastes an
accelerator, so the batch axis here is the *patch* axis: state is ``[B, P, D]`` and
a whole wavefront of patches optimizes per ``lax.scan`` step.

Semantics matched to the reference:
  * velocity update v <- iw*v + pw*r*(pBest-x) + gw*r*(gBest-x)
    [+ lw*r*(lBest-x) + nw*r*(nBest-x) in GLN mode], one random scalar per
    particle per term (psosolver.cpp:230-254), position clamped to bounds;
  * lBest = best pBest among the localK nearest pBests (Euclidean,
    psosolver.cpp:151-191); nBest = per-dimension fitness-distance-ratio
    argmax (psosolver.cpp:193-218);
  * early stop per swarm when both the dispersion index (mean |pos-gBest|)
    and velocity index (mean |vel|) drop below the threshold
    (psosolver.cpp:70-92, 295) — converged swarms freeze;
  * inertia decays linearly by 1/maxIteration to 0.4 (psosolver.cpp:304);
  * particle 0 can be seeded with the incumbent solution (setParticle).

Unlike the reference's ``srand(time(NULL))`` (irreproducible by design),
randomness is ``jax.random`` — deterministic per (seed, swarm).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class PsoResult(NamedTuple):
    gbest: jnp.ndarray        # [B, D]
    gbest_fit: jnp.ndarray    # [B]
    iterations: jnp.ndarray   # [B] int32 iterations actually run


def _local_best(pbest, pbest_fit, local_k: int):
    """lBest per particle: among the local_k nearest pBests (excluding
    self), the one with minimum pBest fitness. pbest: [B, P, D].

    K iterative argmin extractions instead of ``lax.top_k`` (a row sort);
    the unrolled extraction selects the same neighbour set (ties broken by
    index)."""
    # pairwise distances WITHOUT a [B, P, P, D] intermediate: the
    # Gram-matrix identity keeps everything [B, P, P]; only the RANKING of
    # dist2 is consumed, so the small cancellation error of the expanded
    # form cannot change more than argmin tie-breaks.
    n2 = jnp.sum(pbest * pbest, axis=-1)                     # [B, P]
    gram = jnp.einsum("bpd,bqd->bpq", pbest, pbest)
    dist2 = n2[:, :, None] + n2[:, None, :] - 2.0 * gram     # [B, P, P]
    P = pbest.shape[1]
    eye = jnp.eye(P, dtype=bool)
    dist2 = jnp.where(eye[None], jnp.inf, dist2)
    iota = jnp.arange(P)
    best_fit = jnp.full_like(pbest_fit, jnp.inf)
    best_idx = jnp.zeros(pbest_fit.shape, jnp.int32)
    for _ in range(local_k):
        j = jnp.argmin(dist2, axis=-1).astype(jnp.int32)     # [B, P]
        fitj = jnp.take_along_axis(pbest_fit, j, axis=1)
        upd = fitj < best_fit
        best_fit = jnp.where(upd, fitj, best_fit)
        best_idx = jnp.where(upd, j, best_idx)
        dist2 = jnp.where(iota[None, None, :] == j[:, :, None],
                          jnp.inf, dist2)
    return jnp.take_along_axis(pbest, best_idx[..., None], axis=1)


def _fdr_best(pos, fit, pbest, pbest_fit):
    """nBest per particle per dimension: argmax_j (fit_i - pbestFit_j) /
    |pos_i[d] - pbest_j[d]| over j != i (psosolver.cpp:193-218).
    Per-dimension loop: 3 contiguous [B, P, P] argmaxes beat one
    [B, P, P, D] argmax over a middle axis."""
    B, P, D = pos.shape
    num = fit[:, :, None] - pbest_fit[:, None, :]            # [B, P, P]
    eye = jnp.eye(P, dtype=bool)[None]
    cols = []
    for d in range(D):
        den = jnp.abs(pos[:, :, None, d] - pbest[:, None, :, d])
        fdr = num / den                                      # inf/-inf ok
        fdr = jnp.where(jnp.isnan(fdr) | eye, -jnp.inf, fdr)
        jbest = jnp.argmax(fdr, axis=2)                      # [B, P]
        cols.append(jnp.take_along_axis(pbest[..., d], jbest, axis=1))
    return jnp.stack(cols, axis=-1)


def gln_pso(fit_fn: Callable, range_l, range_u, init, key,
            particle_num: int, max_iteration: int,
            enable_gln: bool = True,
            convergence_threshold: float = 0.01,
            iw: float = 0.8, pw: float = 1.2, gw: float = 1.5,
            lw: float = 1.0, nw: float = 1.0, local_k: int = 5,
            min_iw: float = 0.4, active0=None,
            exit_chunk: int = 0) -> PsoResult:
    """Run B swarms of ``particle_num`` particles for <= max_iteration steps.

    Args:
      fit_fn: pos [B, P, D] -> fitness [B, P] (lower is better). Rows of
        swarms that are inactive this iteration are masked out afterwards.
      range_l / range_u: [B, D] per-swarm bounds.
      init: [B, D] incumbent seeded into particle 0 (pos and pBest), or None.
      key: jax PRNG key.
      active0: [B] bool or None — swarms to optimize at all (dead patches
        skip every evaluation).
      exit_chunk: > 0 runs the iteration scan in chunks of this size inside
        a ``lax.while_loop`` that exits once EVERY swarm has frozen (the
        batch analog of the reference's per-swarm early stop,
        psosolver.cpp:286-306, which the fixed-length scan can only honor
        per-swarm via the activity mask — every one of the 61 dispatches still
        launches). Bit-identical to the fixed scan by construction: frozen
        swarms never change state, so truncating all-frozen tail chunks
        cannot change any output (tests/test_pso.py). 0 = fixed scan.

    Returns: PsoResult.
    """
    B, D = range_l.shape
    P = particle_num
    # lBest draws from the localK nearest OTHER particles (psosolver.cpp:
    # 151-191); with small swarms K must stay below P or top_k would admit
    # the self entry (its distance is masked to inf but still selectable)
    K = min(local_k, max(P - 1, 1))
    inter = range_u - range_l
    if active0 is None:
        active0 = jnp.ones((B,), dtype=bool)

    k_pos, k_vel, key = jax.random.split(key, 3)
    pos = range_l[:, None] + inter[:, None] * jax.random.uniform(k_pos, (B, P, D))
    vel = inter[:, None] * (2.0 * jax.random.uniform(k_vel, (B, P, D)) - 1.0)
    if init is not None:
        pos = pos.at[:, 0, :].set(init)

    fit = fit_fn(pos)
    fit = jnp.where(active0[:, None], fit, jnp.inf)
    pbest = pos
    pbest_fit = fit
    gi = jnp.argmin(pbest_fit, axis=-1)
    gbest = jnp.take_along_axis(pbest, gi[:, None, None].repeat(D, -1), 1)[:, 0]
    gbest_fit = jnp.take_along_axis(pbest_fit, gi[:, None], 1)[:, 0]

    class Carry(NamedTuple):
        pos: jnp.ndarray
        vel: jnp.ndarray
        fit: jnp.ndarray
        pbest: jnp.ndarray
        pbest_fit: jnp.ndarray
        gbest: jnp.ndarray
        gbest_fit: jnp.ndarray
        iw: jnp.ndarray
        done: jnp.ndarray
        iters: jnp.ndarray

    def step(c: Carry, xs):
        it, r4 = xs
        # convergence indices (psosolver.cpp:70-92)
        disp = jnp.mean(jnp.abs(c.pos - c.gbest[:, None, :]), axis=(1, 2))
        velix = jnp.mean(jnp.abs(c.vel), axis=(1, 2))
        done = c.done | ((disp < convergence_threshold) &
                         (velix < convergence_threshold))
        # defensive invariant: no step index past max_iteration may move
        # state (the chunked path slices its/rand_all within bounds, so
        # this is always true today — kept so a future scheduling change
        # cannot silently run extra live steps)
        active = ~done & active0 & (it < max_iteration)

        rp = pw * r4[0][..., None]
        rg = gw * r4[1][..., None]

        dv = (rp * (c.pbest - c.pos) +
              rg * (c.gbest[:, None, :] - c.pos))
        if enable_gln:
            rl = lw * r4[2][..., None]
            rn = nw * r4[3][..., None]
            lbest = _local_best(c.pbest, c.pbest_fit, K)
            # FDR uses the particle's CURRENT fitness (psosolver.cpp:195)
            nbest = _fdr_best(c.pos, c.fit, c.pbest, c.pbest_fit)
            dv = dv + rl * (lbest - c.pos) + rn * (nbest - c.pos)

        vel_new = c.iw[:, None, None] * c.vel + dv
        pos_new = jnp.clip(c.pos + vel_new, range_l[:, None], range_u[:, None])

        a3 = active[:, None, None]
        pos2 = jnp.where(a3, pos_new, c.pos)
        vel2 = jnp.where(a3, vel_new, c.vel)

        f = fit_fn(pos2)
        better = (f < c.pbest_fit) & active[:, None]
        pbest2 = jnp.where(better[..., None], pos2, c.pbest)
        pbest_fit2 = jnp.where(better, f, c.pbest_fit)

        gi = jnp.argmin(pbest_fit2, axis=-1)
        gfit2 = jnp.take_along_axis(pbest_fit2, gi[:, None], 1)[:, 0]
        gb2 = jnp.take_along_axis(pbest2, gi[:, None, None].repeat(D, -1), 1)[:, 0]

        iw2 = jnp.maximum(c.iw - 1.0 / max_iteration, min_iw)
        iw2 = jnp.where(active, iw2, c.iw)

        fit2 = jnp.where(active[:, None], f, c.fit)
        return Carry(pos2, vel2, fit2, pbest2, pbest_fit2, gb2, gfit2, iw2,
                     done, c.iters + active.astype(jnp.int32)), None

    c0 = Carry(pos, vel, fit, pbest, pbest_fit, gbest, gbest_fit,
               jnp.full((B,), iw, dtype=pos.dtype),
               jnp.zeros((B,), dtype=bool),
               jnp.zeros((B,), dtype=jnp.int32))
    # all per-iteration uniforms in ONE threefry call instead of 4 tiny
    # per-step generations; no trailing [..., 1] axis — the broadcast
    # happens at the use sites.
    n_streams = 4 if enable_gln else 2
    rand_all = jax.random.uniform(
        jax.random.fold_in(key, 7), (max_iteration, n_streams, B, P))
    if exit_chunk and 0 < exit_chunk < max_iteration:
        # full chunks in a while_loop, then the non-dividing REMAINDER as
        # one short activity-gated scan — padding the last chunk would
        # launch full fitness dispatches with every swarm masked inactive
        # in exactly the non-convergent case the exit cannot help
        nch = max_iteration // exit_chunk
        rem = max_iteration - nch * exit_chunk
        its = jnp.arange(max_iteration)

        def chunk_cond(s):
            i, c = s
            return (i < nch) & jnp.any(~c.done & active0)

        def chunk_body(s):
            i, c = s
            sl = lambda a: jax.lax.dynamic_slice_in_dim(
                a, i * exit_chunk, exit_chunk)
            c2, _ = jax.lax.scan(step, c, (sl(its), sl(rand_all)))
            return i + jnp.int32(1), c2

        _, cf = jax.lax.while_loop(chunk_cond, chunk_body,
                                   (jnp.int32(0), c0))
        if rem:
            def run_rem(c):
                c2, _ = jax.lax.scan(
                    step, c, (its[nch * exit_chunk:],
                              rand_all[nch * exit_chunk:]))
                return c2

            cf = jax.lax.cond(jnp.any(~cf.done & active0), run_rem,
                              lambda c: c, cf)
    else:
        cf, _ = jax.lax.scan(step, c0,
                             (jnp.arange(max_iteration), rand_all))
    return PsoResult(cf.gbest, cf.gbest_fit, cf.iters)
