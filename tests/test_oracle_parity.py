"""Statistical parity: the batched engine vs the sequential NumPy
oracle of the reference pipeline (SURVEY §4 test strategy item 2 — the
reference itself is irreproducible, srand(time), so parity is
depth-tolerance agreement of the optimized patches, not bitwise)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pais_mvs_tpu.config import MvsConfig
from pais_mvs_tpu.data.synthetic import make_scene
from pais_mvs_tpu.models import patch as patch_mod
from pais_mvs_tpu.models.camera import build_scene
from pais_mvs_tpu.ops import geometry as geom
from pais_mvs_tpu.ops import lifecycle as lc
from pais_mvs_tpu import oracle


def test_engine_matches_oracle_depths():
    cfg = MvsConfig(patch_radius=7, max_lod=3, particle_num=8,
                    max_iteration=15, dist_weighting=7 / 3.0,
                    seed_refine_rounds=1, batch_size=8)
    sc = make_scene(num_cams=5, width=240, height=180, num_seeds=20, seed=6)
    B = 8
    rng = np.random.default_rng(0)
    centers0 = sc.seed_centers[:B] + rng.normal(scale=0.01, size=(B, 3))

    # --- engine ---
    scene = build_scene(sc.params, sc.images, cfg)
    pb = patch_mod.from_seeds(centers0, sc.seed_cam_masks[:B],
                              sc.seed_img_points[:B])
    pb = lc.prepare_seeds(scene, cfg, pb)
    res = lc.refine_batch(scene, cfg, pb, jax.random.PRNGKey(0),
                          jnp.float32(0.02), True, 1)
    eng = res.batch
    eng_valid = np.asarray(eng.valid)
    eng_depth = np.asarray(eng.depth)
    eng_ref = np.asarray(eng.ref_cam)

    # --- oracle (same initial state the engine derived) ---
    nps = oracle.NpScene(sc.params, sc.images, cfg)
    sph0 = np.asarray(pb.normal_sph)
    rng_o = np.random.default_rng(1)
    agree = 0
    checked = 0
    for i in range(B):
        if not eng_valid[i]:
            continue
        ref = int(eng_ref[i])
        c0 = np.asarray(pb.center)[i]
        ray = c0 - nps.center[ref]
        depth0 = float(np.linalg.norm(ray))
        ray = ray / depth0
        cams = np.nonzero(sc.seed_cam_masks[i])[0]
        dr = (max(depth0 - 0.05, 0.0), depth0 + 0.05)
        gbest, gfit, _ = oracle.pso_refine_one(
            nps, cfg, rng_o, ref, cams, 0, ray, sph0[i], depth0, dr,
            seed_patch=True)
        checked += 1
        # both optimizers minimize the same photoconsistency basin: the
        # recovered depths must agree to sub-pixel parallax (~2e-3 units
        # at this camera geometry)
        if abs(float(eng_depth[i]) - float(gbest[2])) < 3e-3:
            agree += 1
    assert checked >= 5
    assert agree / checked >= 0.8, f"{agree}/{checked} depths agree"


def test_runtime_filter_own_id_passes_full_cells():
    """mvs.cpp:888-890: a patch FOUND in one of its own cells passes the
    cell-density clause outright — a popped parent registered in the cell
    maps is never cell-capped out of expansion, even when every one of
    its cells sits at max_cell_patch_num. An identical patch that is NOT
    registered must be capped out by the same full cells."""
    from pais_mvs_tpu.engine.cellgrid import CellGrids

    cfg = MvsConfig(patch_radius=4, max_lod=3, particle_num=6,
                    max_iteration=8, dist_weighting=4 / 3.0, cell_size=10,
                    min_cam_num=3, max_cell_patch_num=1,
                    seed_refine_rounds=1)
    sc = make_scene(num_cams=4, width=200, height=150, num_seeds=8, seed=3)
    orc = oracle.OraclePipeline(sc.params, sc.images, cfg, seed=0)
    orc.load_seeds(sc.seed_centers, sc.seed_cam_masks, sc.seed_img_points)
    orc.refine_seeds()
    assert orc.patches, "no seed survived the tiny-config refine"
    p = orc.patches[0]

    widths = [lv[0].shape[1] for lv in orc.scene.levels]
    heights = [lv[0].shape[0] for lv in orc.scene.levels]
    grids = CellGrids(widths, heights, cfg.cell_size)
    grids.insert_patch(p.pid, orc._mask_of(p), p.img_pts)

    # max_cell_patch_num=1: every cell holding p is full, yet p passes
    assert oracle.runtime_filter_oracle(orc.scene, cfg, p, grids)

    # clone everything but the registration: rejected (all cells full)
    q = oracle.OraclePatch(p.center, p.sph, p.cam_idx)
    q.ref_cam, q.depth, q.ray = p.ref_cam, p.depth, p.ray
    q.fitness, q.correlation = p.fitness, p.correlation
    q.priority, q.img_pts = p.priority, p.img_pts
    assert q.pid == -1
    assert not oracle.runtime_filter_oracle(orc.scene, cfg, q, grids)
