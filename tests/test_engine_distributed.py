"""Engine-level distributed expansion (expand_distributed): the SPMD
cell-slab path must grow the cloud on the ground-truth surface AND match
the serial reference-semantics oracle's cloud (full skipNeighborCell,
all-view candidates — parity with the host path's guarantees)."""

import numpy as np
import pytest

from pais_mvs_tpu.config import MvsConfig
from pais_mvs_tpu.data.synthetic import make_scene
from pais_mvs_tpu.engine.reconstructor import Reconstructor
from pais_mvs_tpu.parallel.mesh import make_mesh


def test_expand_distributed_grows_surface():
    cfg = MvsConfig(patch_radius=4, max_lod=3, particle_num=6,
                    max_iteration=6, dist_weighting=4 / 3.0,
                    seed_refine_rounds=1, cell_size=10,
                    batch_size=64, visible_correlation=0.7)
    sc = make_scene(num_cams=4, width=160, height=120, num_seeds=30, seed=5)
    rec = Reconstructor(sc.params, sc.images, cfg, verbose=False)
    rec.load_seeds(sc.seed_centers, sc.seed_cam_masks, sc.seed_img_points,
                   np.full((len(sc.seed_centers), 3), 128.0))
    n_seeds = rec.refine_seeds()
    assert n_seeds > 15

    mesh = make_mesh((8, 1))
    total = rec.expand_distributed(mesh=mesh, max_rounds=4, per_shard=32)
    assert total > n_seeds + 50, f"only grew to {total}"
    pts = rec.live_centers()
    d = sc.surface_distance(pts)
    assert np.median(d) < 0.01, np.median(d)
    # the new patches carry full derived state for the filters/writers
    assert rec.cell_filtering() >= 0
    rec.write_ply("/dev/null")


def test_expand_distributed_matches_serial_oracle():
    """Cloud parity of the SPMD expansion vs the serial reference-semantics
    oracle (mirror of tests/test_oracle_cloud_parity.py for the distributed
    path, which a median-surface-distance gate alone would not cover)."""
    from pais_mvs_tpu.oracle import OraclePipeline, cloud_agreement

    cfg = MvsConfig(patch_radius=4, max_lod=3, particle_num=6,
                    max_iteration=8, dist_weighting=4 / 3.0, cell_size=10,
                    min_cam_num=3, max_cell_patch_num=2,
                    neighbor_radius_scalar=0.08, batch_size=64,
                    seed_refine_rounds=1)
    sc = make_scene(num_cams=4, width=200, height=150, num_seeds=25, seed=3)

    orc = OraclePipeline(sc.params, sc.images, cfg, seed=0)
    orc.load_seeds(sc.seed_centers, sc.seed_cam_masks, sc.seed_img_points)
    orc.refine_seeds()
    orc.expand(max_patches=3000)
    opts = orc.cloud()
    assert len(opts) > 150, "oracle reconstruction degenerate"

    rec = Reconstructor(sc.params, sc.images, cfg, verbose=False)
    rec.load_seeds(sc.seed_centers, sc.seed_cam_masks, sc.seed_img_points,
                   np.full((len(sc.seed_centers), 3), 128.0))
    rec.refine_seeds()
    rec.expand_distributed(mesh=make_mesh((8, 1)), max_rounds=64,
                           per_shard=32)
    epts = rec.live_centers()

    assert np.median(sc.surface_distance(opts)) < 0.005
    assert np.median(sc.surface_distance(epts)) < 0.005

    depth = float(np.linalg.norm(sc.seed_centers.mean(0)
                                 - rec.np_center.mean(0)))
    half_cell = 0.5 * cfg.cell_size * depth / float(rec.np_focal[0, 0])
    ag = cloud_agreement(epts, opts, half_cell)
    assert ag["engine_within_tol"] >= 0.90, ag
    assert ag["oracle_within_tol"] >= 0.90, ag
    ratio = ag["engine_count"] / ag["oracle_count"]
    assert 0.75 <= ratio <= 1.33, ag


def test_expand_distributed_requeues_spilled():
    """Candidates deferred by the per-shard refine budget must NOT be lost
    (the reference's queue never drops, mvs.cpp:632-788): their parents are
    re-queued and the cloud converges to the same size/quality as an
    unconstrained run. A tiny budget forces heavy spill every round."""
    cfg = MvsConfig(patch_radius=4, max_lod=3, particle_num=6,
                    max_iteration=6, dist_weighting=4 / 3.0,
                    seed_refine_rounds=1, cell_size=10,
                    batch_size=64, visible_correlation=0.7)
    sc = make_scene(num_cams=4, width=160, height=120, num_seeds=30, seed=5)

    def run(budget, rounds):
        rec = Reconstructor(sc.params, sc.images, cfg, verbose=False)
        rec.load_seeds(sc.seed_centers, sc.seed_cam_masks,
                       sc.seed_img_points,
                       np.full((len(sc.seed_centers), 3), 128.0))
        rec.refine_seeds()
        rec.expand_distributed(mesh=make_mesh((8, 1)), max_rounds=rounds,
                               per_shard=32, refine_budget=budget)
        return rec

    rec_s = run(budget=8, rounds=24)      # 64 refines/round -> forced spill
    rec_u = run(budget=256, rounds=6)     # effectively unconstrained
    assert rec_s.stats["dist_spilled"] > 0, "budget did not force spill"
    n_s = len(rec_s.arena.live_ids())
    n_u = len(rec_u.arena.live_ids())
    # the spilled candidates were recovered across rounds: the constrained
    # run reaches the unconstrained cloud size (cells fill identically in
    # the limit; small slack for round-order differences)
    assert n_s >= 0.85 * n_u, (n_s, n_u)
    d = sc.surface_distance(rec_s.live_centers())
    assert np.median(d) < 0.01, np.median(d)
    # and the frontier actually drained: every live patch got its turn
    a = rec_s.arena
    assert (~a.expanded[a.live_ids()]).sum() == 0


def test_expand_distributed_realistic_parity():
    """Distributed-vs-host cloud parity on the realistic pawn-rig PHOTO
    scene (real texture, occluding step, photometric jitter, real radial
    rig) — the synthetic 200x150 parity scene hides precision/occlusion
    error classes.

    The gate is RELATIVE: on this scene the host path disagrees with
    ITSELF at ~0.80 mutual agreement when only the wavefront size changes
    (measured wf=32/128/512 pairwise 0.79-0.83 at half-cell tolerance —
    photometric jitter + occlusion edges make insert ORDER genuinely
    load-bearing, unlike the 0.97-agreement synthetic plane), so a fixed
    0.90 bar is unattainable for ANY order-differing pair. The distributed
    path must therefore match the host's own order-sensitivity yardstick,
    measured in-run, not an absolute number."""
    from pais_mvs_tpu.data.realistic import make_realistic_scene
    from pais_mvs_tpu.oracle import cloud_agreement

    sc = make_realistic_scene(num_seeds=60, seed=0)
    base = dict(patch_radius=6, max_lod=4, particle_num=8,
                max_iteration=12, dist_weighting=2.0, cell_size=12,
                min_cam_num=3, max_cell_patch_num=2,
                neighbor_radius_scalar=0.01, batch_size=128,
                seed_refine_rounds=2)

    def build(cfg):
        rec = Reconstructor(sc.params, sc.images, cfg, verbose=False)
        rec.load_seeds(sc.seed_centers, sc.seed_cam_masks,
                       sc.seed_img_points,
                       np.full((len(sc.seed_centers), 3), 128.0))
        rec.refine_seeds()
        return rec

    rec_h = build(MvsConfig(**base, wavefront_size=128))
    rec_h.expand(max_rounds=120)                    # drain the frontier
    hpts = rec_h.live_centers()
    rec_y = build(MvsConfig(**base, wavefront_size=32))   # yardstick arm
    rec_y.expand(max_rounds=120)
    ypts = rec_y.live_centers()
    rec_d = build(MvsConfig(**base, wavefront_size=128))
    rec_d.expand_distributed(mesh=make_mesh((8, 1)), max_rounds=160,
                             per_shard=32)
    dpts = rec_d.live_centers()

    assert len(hpts) > 150 and len(dpts) > 150, (len(hpts), len(dpts))
    assert np.median(sc.surface_distance(hpts)) < 0.005
    assert np.median(sc.surface_distance(dpts)) < 0.005

    depth = float(np.linalg.norm(sc.seed_centers.mean(0)
                                 - rec_h.np_center.mean(0)))
    half_cell = 0.5 * base["cell_size"] * depth / float(rec_h.np_focal[0, 0])
    ag_d = cloud_agreement(dpts, hpts, half_cell)
    ag_y = cloud_agreement(ypts, hpts, half_cell)
    yard = min(ag_y["engine_within_tol"], ag_y["oracle_within_tol"])
    got = min(ag_d["engine_within_tol"], ag_d["oracle_within_tol"])
    # within 8 points of the host's own order-sensitivity, and never
    # below an absolute floor that catches gross semantic divergence
    assert got >= yard - 0.08, (got, yard, ag_d, ag_y)
    assert got >= 0.65, (got, ag_d)
    ratio = ag_d["engine_count"] / ag_d["oracle_count"]
    assert 0.7 <= ratio <= 1.43, ag_d

    # Measure whether the post-filters
    # CONVERGE the order-divergent clouds (the reference ships four
    # interchangeable pop orders, mvs.h:162-165 — implying the authors
    # treated order as a don't-care AFTER filtering). The three
    # STRUCTURAL filters (cell / visibility / neighbor-cell) are
    # measured; neighborPatchFiltering is excluded here because on this
    # scene it is DEGENERATE — patch spacing (~cell_size*depth/focal
    # ~0.02) far exceeds neighborRadius (~0.0076), so every count is ~0
    # and the kill set flips between nothing (avg exactly 0 -> threshold
    # 0) and everything (one close pair -> tiny positive threshold) — a
    # knife edge that faithfully mirrors the reference's Euclidean-count
    # rule (mvs.cpp:448-525) but measures radius calibration, not order.
    # The host arms have been seen on opposite sides of that knife edge
    # (4 vs 1079 survivors on the CPU).
    for r in (rec_h, rec_y, rec_d):
        r.cell_filtering()
        r.visibility_filtering()
        r.neighbor_cell_filtering(0.25)
    hf = rec_h.live_centers()
    ag_d_f = cloud_agreement(rec_d.live_centers(), hf, half_cell)
    ag_y_f = cloud_agreement(rec_y.live_centers(), hf, half_cell)
    yard_f = min(ag_y_f["engine_within_tol"], ag_y_f["oracle_within_tol"])
    got_f = min(ag_d_f["engine_within_tol"], ag_d_f["oracle_within_tol"])
    print(f"\norder-divergence vs filtering: host-vs-host(wf32) "
          f"{yard:.3f} -> {yard_f:.3f} filtered; dist-vs-host "
          f"{got:.3f} -> {got_f:.3f} filtered "
          f"(counts {ag_d_f['engine_count']}/{ag_d_f['oracle_count']})")
    # measured round 5: filtering does NOT converge order-divergent
    # clouds — it mildly amplifies divergence for BOTH arms at the same
    # rate (host-vs-host 0.787 -> 0.690, dist-vs-host 0.760 -> 0.666):
    # the filters' own kill sets are order-sensitive at the margins. The
    # gate is therefore RELATIVE, like the pre-filter one — the
    # distributed arm must track the host's own filtered
    # order-sensitivity yardstick.
    assert got_f >= yard_f - 0.08, (got_f, yard_f, ag_d_f)
    assert got_f >= 0.55, (got_f, ag_d_f)


@pytest.mark.parametrize("strategy", [1, 2, 3])  # best-first covered above
def test_expand_distributed_honors_strategies(strategy):
    """All four queue-pop strategies drive the SPMD path (an earlier
    distributed path ignored them). The strategy order feeds
    the device-side serial rank (orank) that settles every cell-budget
    race, so each ordering must still converge to the surface. Shapes
    mirror test_expand_distributed_grows_surface so compiles are reused."""
    cfg = MvsConfig(patch_radius=4, max_lod=3, particle_num=6,
                    max_iteration=6, dist_weighting=4 / 3.0,
                    seed_refine_rounds=1, cell_size=10,
                    batch_size=64, visible_correlation=0.7,
                    expansion_strategy=strategy)
    sc = make_scene(num_cams=4, width=160, height=120, num_seeds=30, seed=5)
    rec = Reconstructor(sc.params, sc.images, cfg, verbose=False)
    rec.load_seeds(sc.seed_centers, sc.seed_cam_masks, sc.seed_img_points,
                   np.full((len(sc.seed_centers), 3), 128.0))
    n_seeds = rec.refine_seeds()
    assert n_seeds > 15
    total = rec.expand_distributed(mesh=make_mesh((8, 1)), max_rounds=2,
                                   per_shard=32)
    assert total > n_seeds, f"strategy {strategy} did not expand"
    d = sc.surface_distance(rec.live_centers())
    assert np.median(d) < 0.01, np.median(d)
