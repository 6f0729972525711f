"""Full-semantics SPMD wavefront expansion.

The round-2 distributed path (a ``ppermute`` ring-halo exchange, removed
in round 4) was a documented simplification: reference-view candidates
only, density-only dedupe, ring-limited routing. This module is the parity
rewrite — one shard_map step that reproduces the host engine's (and the
reference's) expansion semantics on a device mesh:

  * candidates come from EVERY visible view's cell grid, the reference's
    expandNeighborCell loop (TMVS/mvs/mvs.cpp:529-564 — the "reference
    camera only" restriction there is commented out at :537);
  * skipNeighborCell applies ALL THREE clauses (mvs.cpp:792-807): the
    density cap, the cellmate-correlation gate, and the geometric
    isNeighbor plane-distance test — which requires exchanging cellmate
    STATE (center, normal, correlation), not just counts: the occupancy is
    an [grid_w, C*grid_h] count grid plus a [grid_w, C*grid_h, cap, 7]
    state grid, both sharded over cell columns;
  * the serial ordering the reference gets from its priority queue
    (mvs.cpp:632-788, all four expansion strategies) is reproduced by an
    explicit per-parent ORDER RANK: the host assigns each frontier parent
    its position in the strategy order, and every device-side cell-budget
    decision (per-cell intra-round cap, refine-budget compaction,
    insert-time re-check) is taken in that order.

Routing: a candidate's owner is the shard holding its (camera, cell
column) slab. Because multi-view candidates land anywhere in any camera's
grid (a patch projects to very different pixels per view), the ring halo
exchange of the simplified path cannot carry them — candidates are
all_gather'ed and each shard filters the
rows it owns. Payloads are a few KB per shard per round.

The insert-time re-check is an EXACT mirror of the host's serial insert
loop: ``insert_fixpoint`` Jacobi-iterates the within-round cellmate join
until stable, which provably reproduces the serial verdicts (a
candidate's verdict depends only on strictly earlier-order verdicts, so
the serial answer is the join's unique fixpoint — see the function
docstring). Both live-grid clauses are mirrored: the all-views density
vote counts this round's earlier-order accepted inserts on top of the
pre-round occupancy, and the skipNeighborCell re-check tests the
correlation / isNeighbor clauses against those inserts' REFINED state
(pre-round occupants were already tested at candidate-generation time
against the same parent plane, and no occupant changes mid-round, so
generation-time testing is equivalent to the host's insert-time check
for them). tests/test_insert_fixpoint.py asserts bit-exact agreement
with a serial Python simulation on randomized scenarios; the cloud-level
evidence is tests/test_engine_distributed.py, including
test_expand_distributed_realistic_parity on the pawn-rig photo scene.

Candidates past the per-shard refine budget are NOT lost (the reference's
queue never drops, mvs.cpp:632-788): their parents are reported back in
``spilled_parents`` and the engine re-queues them — the parent regenerates
its candidates next round, where skipNeighborCell prunes the ones whose
cells filled meanwhile, exactly like a late queue pop against the live
grid. ``spilled`` is therefore only ever transiently nonzero, with one
bounded exception: the engine's stall guard (reconstructor.py) drops a
round's deferred candidates after two consecutive zero-insert spill
rounds, since unchanged occupancy means an identical frontier would
re-spill forever. Re-queueing is PARENT-granular, but refine-exactly-
once still holds: every round reports which (parent, cam, offset)
candidates consumed their refine (``refined_cands``), the engine feeds
the union back as ``cand_done`` for re-queued parents, and candidate
generation excludes them — a regenerated parent only refines the
candidates the budget actually deferred, exactly like the reference's
one-shot queue pops (mvs.cpp:632-788).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from pais_mvs_tpu.parallel.mesh import PATCH_AXIS, VIEW_AXIS, \
    scene_view_specs

OCC_STATE_F = 7            # center xyz, normal xyz, correlation


def _run_rank(sort_key_cells, order_idx):
    """Rank of each element within its (sorted) equal-cell run.

    sort_key_cells: [M] cell ids with inactive rows pushed to a sentinel;
    order_idx: [M] f32 serial-order key (lower = earlier). Returns rank
    [M] in ORIGINAL row order."""
    order = jnp.lexsort((order_idx, sort_key_cells))
    cid_s = sort_key_cells[order]
    idx = jnp.arange(cid_s.shape[0])
    same = jnp.concatenate([jnp.zeros(1, bool), cid_s[1:] == cid_s[:-1]])
    start = jnp.where(~same, idx, 0)
    start = jax.lax.associative_scan(jnp.maximum, start)
    rank_s = idx - start
    return jnp.zeros_like(rank_s).at[order].set(rank_s)


def _skip_clauses(occ, ost, lcol, comb, pcen, pnorm, nr, cap,
                  min_correlation):
    """MVS::skipNeighborCell (mvs.cpp:792-807) against the local occupancy
    state: returns (skip [M] bool, cnt [M] i32). Clause a: cell full;
    clause b: any cellmate correlation > minCorrelation; clause c: any
    cellmate within plane-to-plane neighbor distance of the parent."""
    cnt = occ[lcol, comb]                                     # [M]
    st = ost[lcol, comb]                                      # [M, cap, 7]
    slot_ok = (jnp.arange(cap)[None, :]
               < jnp.minimum(cnt, cap)[:, None])              # [M, cap]
    skip = cnt >= cap
    skip |= jnp.any(slot_ok & (st[..., 6] > min_correlation), axis=-1)
    d = st[..., 0:3] - pcen[:, None, :]
    dist = jnp.abs(jnp.sum(d * pnorm[:, None, :], -1)) + \
        jnp.abs(jnp.sum(d * st[..., 3:6], -1))
    skip |= jnp.any(slot_ok & (dist <= nr), axis=-1)
    return skip, cnt


def insert_fixpoint(a_acc, a_vis, a_cm, a_ord, a_st, a_ocell, a_cnt0,
                    a_pc, a_pn, a_cx, a_cy, cnt_vis, C, grid_h, cap,
                    min_correlation, nr):
    """EXACT replicated mirror of the host's serial insert loop
    (reconstructor.py:557-574: per-candidate live-grid
    ``_insert_time_cell_filter`` + ``_skip_neighbor_cell`` re-check, in
    strategy order, cells filling as earlier candidates insert).

    Inputs are per-candidate rows, replicated on every shard ([SR] unless
    noted): a_acc refine-acceptance, a_vis [SR, C] visible & in-frame per
    refined view, a_cm [SR, C] the refined cam_mask (the host's density
    denominator counts EVERY visible cam — out-of-frame cells read as
    empty, never full, cellgrid.py:49), a_ord unique f32 serial-order
    keys, a_st [SR, 7] refined (center, normal, correlation),
    a_ocell original candidate-cell ids, a_cnt0 pre-round occupant count
    of that cell, a_pc/a_pn [SR, 3] PARENT plane (the skip re-check runs
    against the parent, mvs.cpp:795), a_cx/a_cy [SR, C] refined cell
    coords, cnt_vis [SR, C] pre-round occupant counts of the refined
    cells. Returns the accepted mask [SR].

    The serial loop is the unique fixpoint of the synchronous re-check
    (a candidate's verdict depends only on STRICTLY earlier-order
    verdicts): Jacobi-iterating ``join_pass`` fixes every candidate at
    blocking-depth d permanently by iteration d, and any stable point
    equals the serial answer (induction on the minimal diverging order).
    The loop therefore runs until unchanged — at most SR+1 trips, in
    practice 2-3. Scanning only the first ``cap`` same-cell inserts is
    exact: a blocking insert beyond that prefix implies ``cap`` earlier
    inserts, which the density clause already rejects."""
    SR = a_ord.shape[0]
    E = SR * C
    TOT = E + SR + E
    BIGCELL = jnp.int32(2 ** 30)
    vis_cell = jnp.where(
        a_vis, (a_cx * C + jnp.arange(C)[None, :]) * grid_h + a_cy,
        BIGCELL)                                              # [SR, C]
    # entry table: [0:E) insert entries (keys masked by the acceptance
    # estimate inside the loop), [E:E+SR) candidate original-cell probes
    # (clauses b/c + live original-cell count), [E+SR:) candidate
    # visible-cell probes (live density counts).
    tag_all = jnp.concatenate([jnp.zeros(E, jnp.int32),
                               jnp.ones(SR + E, jnp.int32)])
    ord_ins = jnp.repeat(a_ord, C)
    ord_all = jnp.concatenate([ord_ins, a_ord, ord_ins])
    key_cand = jnp.concatenate([a_ocell, vis_cell.reshape(-1)])
    st_ins = jnp.repeat(a_st, C, axis=0)                      # [E, 7]
    cand_ord = jnp.concatenate([a_ord, ord_ins])
    pc_cand = jnp.concatenate([a_pc, jnp.repeat(a_pc, C, axis=0)])
    pn_cand = jnp.concatenate([a_pn, jnp.repeat(a_pn, C, axis=0)])
    nvis = jnp.sum(a_cm, -1)

    def join_pass(acc_est):
        ins_key = jnp.where((a_vis & acc_est[:, None]).reshape(-1),
                            vis_cell.reshape(-1), BIGCELL)
        key_all = jnp.concatenate([ins_key, key_cand])
        s_idx = jnp.lexsort((ord_all, tag_all, key_all))
        key_s = key_all[s_idx]
        idx = jnp.arange(TOT)
        same = jnp.concatenate([jnp.zeros(1, bool),
                                key_s[1:] == key_s[:-1]])
        start = jax.lax.associative_scan(
            jnp.maximum, jnp.where(~same, idx, 0))
        inv = jnp.zeros_like(s_idx).at[s_idx].set(idx)
        own_start = start[inv[E:]]                            # [SR + E]
        blocked = jnp.zeros(SR + E, bool)
        n_before = jnp.zeros(SR + E, jnp.int32)
        for j in range(cap):
            e = jnp.clip(own_start + j, 0, TOT - 1)
            se = s_idx[e]
            is_ins = (se < E) & (key_all[se] == key_cand) \
                & (ord_all[se] < cand_ord)
            n_before += is_ins.astype(jnp.int32)
            st_e = st_ins[jnp.clip(se, 0, E - 1)]
            corr_hit = st_e[:, 6] > min_correlation
            d = st_e[:, 0:3] - pc_cand
            nb_hit = (jnp.abs(jnp.sum(d * pn_cand, -1))
                      + jnp.abs(jnp.sum(d * st_e[:, 3:6], -1))) <= nr
            blocked |= is_ins & (corr_hit | nb_hit)
        # original-cell skip re-check: live count + clauses b/c
        bad = blocked[:SR] | (a_cnt0 + n_before[:SR] >= cap)
        # all-views density vote against the LIVE refined-cell counts
        n_vis_ins = n_before[SR:].reshape(SR, C)
        full = a_vis & (cnt_vis + n_vis_ins >= cap)
        dens_ok = (jnp.sum(full, -1) < nvis) | (nvis == 0)
        return a_acc & dens_ok & ~bad

    def fix_cond(carry):
        acc_est, changed, it = carry
        return changed & (it < SR + 1)

    def fix_body(carry):
        acc_est, _, it = carry
        nxt = join_pass(acc_est)
        return nxt, jnp.any(nxt != acc_est), it + jnp.int32(1)

    acc_all, _, _ = jax.lax.while_loop(
        fix_cond, fix_body, (a_acc, jnp.bool_(True), jnp.int32(0)))
    return acc_all


@functools.lru_cache(maxsize=32)
def _expand_step_fn(cfg, mesh, slab_cols, grid_w, grid_h, cap, cell_size,
                    C, R):
    """Build + cache the jitted shard_map for expand_step (a fresh closure
    per call would recompile every time)."""
    from pais_mvs_tpu.models import patch as patch_mod
    from pais_mvs_tpu.ops import geometry as geom
    from pais_mvs_tpu.ops import lifecycle as lc

    CGH = C * grid_h
    BIGCELL = np.int32(2 ** 30)
    # vp > 1: the scene's big atlases arrive view-sharded (camera blocks)
    # and refine_batch composes over the view axis (ops/view_fitness.py).
    # Everything OUTSIDE refine_batch in this body is rig/occupancy math —
    # view-replicated by construction (same inputs, same PRNG on every
    # view shard), so the patch-axis collectives stay exact.
    vp = mesh.shape[VIEW_AXIS]
    view_axis = VIEW_AXIS if vp > 1 else None

    def body(scene, pc, pn, orank, pval, pmask, pdone, occ, ost, cam_cells,
             nr, key):
        rig = scene.rig
        k = jax.lax.axis_index(PATCH_AXIS)
        S = jax.lax.axis_size(PATCH_AXIS)
        n = pc.shape[0]

        # ---- candidate generation: 4-neighbour cells in EVERY visible
        # view's grid (mvs.cpp:529-564) ----
        def proj_cam(Rc, Tc, fc, ppc):
            return geom.project(pc, Rc, Tc, fc, ppc, 1.0)[0]
        ipts = jax.vmap(proj_cam, in_axes=(0, 0, 0, 0), out_axes=1)(
            rig.R, rig.T, rig.focal, rig.principal)           # [n, C, 2]
        ipts = jnp.where(jnp.isfinite(ipts), ipts, -1e6)
        cx = jnp.floor(ipts[..., 0] / cell_size).astype(jnp.int32)
        cy = jnp.floor(ipts[..., 1] / cell_size).astype(jnp.int32)
        offs = jnp.asarray([[-1, 0], [0, -1], [1, 0], [0, 1]], jnp.int32)
        ncx = cx[:, :, None] + offs[None, None, :, 0]         # [n, C, 4]
        ncy = cy[:, :, None] + offs[None, None, :, 1]
        wcell = cam_cells[None, :, 0:1]                       # [1, C, 1]
        hcell = cam_cells[None, :, 1:2]
        ok = (pval[:, None, None] & pmask[:, :, None]
              & (ncx >= 0) & (ncx < wcell) & (ncy >= 0) & (ncy < hcell))
        # refine-exactly-once: candidates this parent already spent a
        # refine on (in a spilled earlier round) are consumed, like the
        # reference's one-shot queue pop (mvs.cpp:632-788)
        ok &= ~pdone.reshape(n, C, 4)

        m = n * C * 4
        cam = jnp.broadcast_to(jnp.arange(C)[None, :, None], (n, C, 4))
        par = jnp.broadcast_to(jnp.arange(n)[:, None, None], (n, C, 4))
        parf = par.reshape(-1)
        # candidate-granular serial order: parent strategy rank, then the
        # reference's cam-outer offset-inner generation order within the
        # parent (mvs.cpp:535-549) — a parent's FIRST inserted child must
        # be able to block its own later candidates, exactly as the serial
        # loop's immediate insert does
        sub = (cam * 4 + jnp.arange(4)[None, None, :]).astype(jnp.float32)
        cord = orank[parf] * (4 * C + 1) + sub.reshape(-1)
        payload = jnp.concatenate([
            pc[parf], pn[parf],                               # 0:3, 3:6
            cord[:, None],                                    # 6
            cam.reshape(-1, 1).astype(jnp.float32),           # 7
            pmask[parf].astype(jnp.float32),                  # 8:8+C
        ], axis=-1)                                           # [m, 8+C]

        # ---- route: all_gather, keep owned rows ----
        gather = lambda x: jax.lax.all_gather(x, PATCH_AXIS, axis=0,
                                              tiled=True)
        g_pay = gather(payload)                               # [S*m, 8+C]
        g_col = gather(ncx.reshape(-1))
        g_row = gather(ncy.reshape(-1))
        g_ok = gather(ok.reshape(-1))
        owner = jnp.clip(g_col // slab_cols, 0, S - 1)
        mine = g_ok & (owner == k)
        lcol = jnp.clip(g_col - k * slab_cols, 0, slab_cols - 1)
        camg = g_pay[:, 7].astype(jnp.int32)
        comb = jnp.clip(camg * grid_h + g_row, 0, CGH - 1)

        # ---- skipNeighborCell, all three clauses ----
        skip, cnt_g = _skip_clauses(occ, ost, lcol, comb,
                                    g_pay[:, 0:3], g_pay[:, 3:6], nr, cap,
                                    float(cfg.min_correlation))
        mine &= ~skip

        # ---- intra-round per-cell budget in strategy order (the serial
        # loop's cells fill as it pops parents; mvs.cpp:546-549 + 795) ----
        g_ord = g_pay[:, 6]
        cell_id = jnp.where(mine, lcol * CGH + comb, BIGCELL)
        rank = _run_rank(cell_id, g_ord)
        mine &= rank + cnt_g < cap

        # ---- compact to the per-shard refine budget, strategy order ----
        sel = jnp.argsort(jnp.where(mine, g_ord, jnp.inf), stable=True)[:R]
        keep = mine[sel]
        spilled = jax.lax.psum(jnp.sum(mine) - jnp.sum(keep), PATCH_AXIS)
        # parents of budget-dropped candidates are reported back so the
        # host re-queues them next round (the reference's queue never
        # drops a candidate, mvs.cpp:632-788): gathered row r belongs to
        # parent slot (r // m) * n + (r % m) // (4 * C). Each candidate
        # is owned by exactly one shard, so the psum is exact.
        kept_mask = jnp.zeros(g_ord.shape[0], bool).at[sel].set(keep)
        ridx = jnp.arange(g_ord.shape[0])
        gslot = (ridx // m) * n + (ridx % m) // (4 * C)
        sp_par = jnp.zeros((S * n,), jnp.int32).at[gslot].add(
            (mine & ~kept_mask).astype(jnp.int32))
        sp_par = jax.lax.psum(sp_par, PATCH_AXIS) > 0
        # which (parent, cam*4+off) candidates SPENT their refine this
        # round — the host feeds this back as ``pdone`` for re-queued
        # parents so a regenerated frontier never refines them again.
        # Each kept row is owned by exactly one shard, so psum is exact.
        subi = (ridx % m) % (4 * C)
        ref_cand = jnp.zeros((S * n * 4 * C,), jnp.int32).at[
            gslot * (4 * C) + subi].add(kept_mask.astype(jnp.int32))
        ref_cand = (jax.lax.psum(ref_cand, PATCH_AXIS) > 0).reshape(
            S * n, 4 * C)
        rpay = g_pay[sel]
        rcol = g_col[sel]
        rrow = g_row[sel]
        rcnt0 = cnt_g[sel]             # pre-round count at the target cell
        rcam = rpay[:, 7].astype(jnp.int32)

        # ---- candidate center: cell-center ray of the CANDIDATE'S view
        # meeting the parent plane (mvs.cpp:809-836) ----
        px = (rcol.astype(jnp.float32) + 0.5) * cell_size
        py = (rrow.astype(jnp.float32) + 0.5) * cell_size
        dirs = jax.vmap(lambda xy, c: geom.pixel_to_world_dir(
            xy, rig.R[c], rig.center[c], rig.focal[c], rig.principal[c]))(
            jnp.stack([px, py], -1), rcam)
        new_center = geom.ray_plane_intersect(
            rig.center[rcam], dirs, rpay[:, 0:3], rpay[:, 3:6])

        # ---- viewing-cone camera set with the parent-mask fallback
        # (patch.cpp:723-761) ----
        facing = -rpay[:, 3:6] @ rig.optical.T                # [R, C]
        mask = facing >= cfg.visible_correlation
        lacking = jnp.sum(mask, -1) < cfg.min_cam_num
        fallback = (rpay[:, 8:8 + C] > 0.5) & \
            (facing >= cfg.visible_correlation / 2.0)
        mask = jnp.where(lacking[:, None], mask | fallback, mask)

        pb = jax.tree.map(jnp.asarray, patch_mod.empty_batch(R, C))
        pb = pb.replace(
            center=new_center.astype(jnp.float32),
            normal_sph=geom.normal_to_spherical(rpay[:, 3:6]).astype(
                jnp.float32),
            cam_mask=mask,
            valid=keep & jnp.all(jnp.isfinite(new_center), -1)
                  & (jnp.sum(mask, -1) >= cfg.min_cam_num))
        res = lc.refine_batch(scene, cfg, pb,
                              jax.random.fold_in(key, k), nr, False, 1,
                              view_axis=view_axis)
        rb = res.batch
        acc0 = rb.valid

        # ---- insert-time re-check on the REFINED patches (host mirror:
        # tg_batch_insert): density across every visible view's refined
        # cell + intra-round ref-cell budget, in strategy order ----
        def proj_new(Rc, Tc, fc, ppc):
            return geom.project(rb.center, Rc, Tc, fc, ppc, 1.0)[0]
        nipts = jax.vmap(proj_new, in_axes=(0, 0, 0, 0), out_axes=1)(
            rig.R, rig.T, rig.focal, rig.principal)           # [R, C, 2]
        nipts = jnp.where(jnp.isfinite(nipts), nipts, -1e6)
        ncx2 = jnp.floor(nipts[..., 0] / cell_size).astype(jnp.int32)
        ncy2 = jnp.floor(nipts[..., 1] / cell_size).astype(jnp.int32)
        inm = (ncx2 >= 0) & (ncx2 < cam_cells[None, :, 0]) & \
              (ncy2 >= 0) & (ncy2 < cam_cells[None, :, 1])
        vis2 = rb.cam_mask & inm                              # [R, C]

        # gather the (small) per-row insert metadata to every shard
        normal_new = geom.spherical_to_normal(rb.normal_sph)
        st_new = jnp.concatenate(
            [rb.center, normal_new, rb.correlation[:, None]], -1)  # [R, 7]
        ocell = (rcol * C + rcam) * grid_h + rrow             # orig cand cell
        a_cx = gather(ncx2)                                   # [S*R, C]
        a_cy = gather(ncy2)
        a_vis = gather(vis2)
        a_cm = gather(rb.cam_mask)
        a_ord = gather(rpay[:, 6])
        a_acc = gather(acc0)
        a_st = gather(st_new)
        a_ocell = gather(ocell)
        a_cnt0 = gather(rcnt0)
        a_pc = gather(rpay[:, 0:3])
        a_pn = gather(rpay[:, 3:6])

        # pre-round occupant counts of every visible refined cell: each
        # shard reads the cells it owns, one psum replicates the table
        own2 = (jnp.clip(a_cx // slab_cols, 0, S - 1) == k) & a_vis
        lcol2 = jnp.clip(a_cx - k * slab_cols, 0, slab_cols - 1)
        comb2 = jnp.clip(jnp.arange(C)[None, :] * grid_h + a_cy, 0, CGH - 1)
        cnt_vis = jax.lax.psum(
            jnp.where(own2, occ[lcol2, comb2], 0), PATCH_AXIS)

        # EXACT serial-insert mirror (fixpoint join, replicated compute —
        # identical verdicts on every shard): the live-grid density vote
        # (mvs.cpp:877-895 / _insert_time_cell_filter) and the
        # skipNeighborCell re-check (mvs.cpp:792-807) both see this
        # round's earlier-order ACCEPTED inserts exactly as the host's
        # serial loop does. No extra budget gate on the REFINED reference
        # cell — the host has none (cells may exceed the cap post-insert:
        # the cap gates candidates, not storage).
        acc_all = insert_fixpoint(
            a_acc, a_vis, a_cm, a_ord, a_st, a_ocell, a_cnt0, a_pc, a_pn,
            a_cx, a_cy, cnt_vis, C, grid_h, cap,
            float(cfg.min_correlation), nr)                   # [S*R]
        acc = jax.lax.dynamic_slice_in_dim(acc_all, k * R, R)

        # ---- occupancy update: register every accepted patch in EVERY
        # visible view's cell (CellMap::insert semantics; cells may exceed
        # the cap post-insert — the cap gates candidates, not storage) ----
        upd = own2 & acc_all[:, None]                         # [S*R, C]
        updf = upd.reshape(-1)
        lcolf = lcol2.reshape(-1)
        combf = comb2.reshape(-1)
        cellf = jnp.where(updf, lcolf * CGH + combf, BIGCELL)
        ordf = jnp.repeat(a_ord, C)
        rankf = _run_rank(cellf, ordf)
        slot = occ[lcolf, combf] + rankf
        slot = jnp.where(updf & (slot < cap), slot, cap)      # cap = dropped
        stf = jnp.repeat(a_st, C, axis=0)                     # [S*R*C, 7]
        ost2 = ost.at[lcolf, combf, slot].set(stf, mode="drop")
        occ2 = occ.at[lcolf, combf].add(updf.astype(occ.dtype))
        return rb, acc, occ2, ost2, spilled[None], sp_par, ref_cand

    from pais_mvs_tpu.models import patch as patch_mod2
    spec_pb = jax.tree.map(lambda _: P(PATCH_AXIS),
                           patch_mod2.empty_batch(1, C))

    def wrapper(scene, *args):
        scene_spec = scene_view_specs(scene) if vp > 1 else \
            jax.tree.map(lambda _: P(), scene)
        f = jax.shard_map(
            body, mesh=mesh,
            in_specs=(scene_spec, P(PATCH_AXIS), P(PATCH_AXIS),
                      P(PATCH_AXIS), P(PATCH_AXIS), P(PATCH_AXIS),
                      P(PATCH_AXIS), P(PATCH_AXIS), P(PATCH_AXIS),
                      P(), P(), P()),
            out_specs=(spec_pb, P(PATCH_AXIS), P(PATCH_AXIS),
                       P(PATCH_AXIS), P(), P(), P()),
            check_vma=False)
        return f(scene, *args)

    return jax.jit(wrapper)


def expand_step(scene, cfg, centers, normals, order_rank, valid,
                parent_cam_mask, occ_cnt, occ_state, cam_cells,
                neighbor_radius, key, mesh: Mesh, slab_cols: int,
                grid_h: int, cap_per: int, refine_budget: int,
                cand_done=None):
    """One COMPLETE distributed expansion round (see module docstring).

    Global shapes (patch-axis sharded unless noted): centers/normals
    [N, 3], order_rank [N] f32 strategy-order positions, valid [N],
    parent_cam_mask [N, C]; occ_cnt [S*slab_cols, C*grid_h] i32 and
    occ_state [S*slab_cols, C*grid_h, cap_per, 7] f32 sharded on axis 0;
    cam_cells [C, 2] i32 per-camera grid (w, h) in cells, replicated;
    cand_done [N, 4*C] bool (optional, default all-False) — candidates
    each parent has ALREADY spent a refine on in a spilled earlier round
    (indexed cam*4 + offset), excluded from regeneration so the
    reference's refine-exactly-once queue-pop semantics hold across
    re-queues.

    Returns (refined PatchBatch [S*refine_budget rows, sharded],
    accepted [S*refine_budget] bool, new occ_cnt, new occ_state,
    spilled [1] i32 — candidates deferred by the refine budget this
    round, spilled_parents [N] bool — parent slots to re-queue so those
    candidates are regenerated next round, refined_cands [N, 4*C] bool —
    the candidates that consumed their refine this round, to be OR-ed
    into the re-queued parents' ``cand_done``).
    """
    C = scene.rig.num_cameras
    vp = mesh.shape[VIEW_AXIS]
    assert C % vp == 0, (
        f"view axis {vp} must divide the camera count {C}")
    N = centers.shape[0]
    if cand_done is None:
        cand_done = jnp.zeros((N, 4 * C), bool)
    fn = _expand_step_fn(cfg, mesh, slab_cols, occ_cnt.shape[0], grid_h,
                         cap_per, cfg.cell_size, C, refine_budget)
    return fn(scene, centers, normals, order_rank, valid, parent_cam_mask,
              cand_done, occ_cnt, occ_state, cam_cells,
              jnp.float32(neighbor_radius), key)


def build_occupancy(arena, cell_size: int, cam_cells: np.ndarray,
                    slab_cols: int, S: int, grid_h: int, cap: int):
    """Host-side occupancy (count + state) grids from the live arena,
    registering each patch in EVERY visible view's cell like the
    reference's per-camera CellMaps (mvs.cpp:74-87). Vectorized numpy.

    Returns (occ_cnt [S*slab_cols, C*grid_h] i32,
             occ_state [S*slab_cols, C*grid_h, cap, 7] f32)."""
    C = cam_cells.shape[0]
    grid_w = S * slab_cols
    CGH = C * grid_h
    occ = np.zeros((grid_w, CGH), np.int32)
    ost = np.zeros((grid_w, CGH, cap, OCC_STATE_F), np.float32)
    ids = arena.live_ids()
    if len(ids) == 0:
        return occ, ost
    cm = arena.data["cam_mask"][ids]                          # [L, C]
    ip = arena.data["img_point"][ids]                         # [L, C, 2]
    i_idx, c_idx = np.nonzero(cm)
    cx = np.floor(ip[i_idx, c_idx, 0] / cell_size).astype(np.int64)
    cy = np.floor(ip[i_idx, c_idx, 1] / cell_size).astype(np.int64)
    inb = ((cx >= 0) & (cx < np.minimum(cam_cells[c_idx, 0], grid_w)) &
           (cy >= 0) & (cy < cam_cells[c_idx, 1]))
    i_idx, c_idx, cx, cy = i_idx[inb], c_idx[inb], cx[inb], cy[inb]
    comb = c_idx * grid_h + cy
    np.add.at(occ, (cx, comb), 1)
    # state slots: rank within each cell (stable insertion order by
    # arena id, like the reference's push_back)
    lin = cx * CGH + comb
    order = np.argsort(lin, kind="stable")
    lin_s = lin[order]
    starts = np.r_[0, np.nonzero(lin_s[1:] != lin_s[:-1])[0] + 1]
    rank = np.arange(len(lin_s)) - np.repeat(
        starts, np.diff(np.r_[starts, len(lin_s)]))
    sel = rank < cap
    rows = order[sel]
    ctr = arena.data["center"][ids]
    nrm = arena.normals(ids)
    corr = arena.data["correlation"][ids]
    st = np.concatenate([ctr, nrm, corr[:, None]], -1).astype(np.float32)
    ost[cx[rows], comb[rows], rank[sel]] = st[i_idx[rows]]
    return occ, ost
