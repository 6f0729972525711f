"""End-to-end reconstruction on a synthetic scene: seeds refine onto the
surface, expansion densifies it, filters keep the cloud clean, artifacts
round-trip."""

import numpy as np
import pytest

from pais_mvs_tpu.config import MvsConfig
from pais_mvs_tpu.data.synthetic import make_scene
from pais_mvs_tpu.engine.reconstructor import Reconstructor
from pais_mvs_tpu.io import mvsbin
from pais_mvs_tpu.io.pointcloud import read_ply


@pytest.fixture(scope="module")
def e2e():
    sc = make_scene(num_cams=5, width=200, height=150, num_seeds=30)
    cfg = MvsConfig(patch_radius=5, max_lod=3, particle_num=5,
                    max_iteration=6, seed_refine_rounds=2, batch_size=64,
                    cell_size=12, wavefront_size=128,
                    dist_weighting=5.0 / 3.0, max_fitness=15.0)
    rec = Reconstructor(sc.params, sc.images, cfg, verbose=False)
    rec.load_seeds(sc.seed_centers + np.random.default_rng(0).normal(
        scale=0.02, size=sc.seed_centers.shape),
        sc.seed_cam_masks, sc.seed_img_points, sc.seed_colors)
    n_seed = rec.refine_seeds()
    return sc, rec, n_seed


def test_seed_refinement_accepts_and_lands_on_surface(e2e):
    sc, rec, n_seed = e2e
    assert n_seed >= 20                       # most seeds survive
    d = sc.surface_distance(rec.live_centers())
    assert np.median(d) < 0.01                # scene scale ~2
    # normals recovered
    ids = rec.arena.live_ids()
    normals = rec.arena.normals(ids)
    cosang = np.abs(normals @ sc.plane_normal)
    assert np.median(cosang) > 0.99


def test_expansion_densifies_surface(e2e):
    sc, rec, n_seed = e2e
    total = rec.expand(max_rounds=3)
    assert total > n_seed * 1.5, "expansion should add patches"
    new_ids = rec.arena.live_ids()
    new_mask = ~rec.arena.data["is_seed"][new_ids]
    assert new_mask.sum() > 0
    d = sc.surface_distance(rec.arena.data["center"][new_ids][new_mask])
    assert np.median(d) < 0.02


def test_filters_and_artifacts(e2e, tmp_path):
    sc, rec, _ = e2e
    before = len(rec.arena.live_ids())
    rec.cell_filtering()
    rec.visibility_filtering()
    removed_np = rec.neighbor_patch_filtering(0.1)
    after = len(rec.arena.live_ids())
    assert 0 < after <= before
    d = sc.surface_distance(rec.live_centers())
    assert np.median(d) < 0.02

    mvs_path = str(tmp_path / "exp.mvs")
    ply_path = str(tmp_path / "exp.ply")
    rec.write_mvs(mvs_path)
    rec.write_ply(ply_path)
    rec.write_psr(str(tmp_path / "exp.psr"))
    f = mvsbin.read_mvs(mvs_path)
    assert len(f.patches.centers) == after
    c, n, col = read_ply(ply_path)
    assert len(c) == after
    np.testing.assert_allclose(
        np.sort(c[:, 0]), np.sort(rec.live_centers()[:, 0]), atol=1e-4)


def test_pipelined_expansion_matches_serial():
    """cfg.pipeline_expansion overlaps next-round host candgen with the
    in-flight device refine; its two bounded order shifts (one-round
    frontier deferral, stale-grid candidate generation corrected by the
    insert-time re-check) must land a cloud agreeing with the serial-order
    loop at the synthetic scene's order-insensitive level (~0.97 host
    self-agreement)."""
    from pais_mvs_tpu.oracle import cloud_agreement

    sc = make_scene(num_cams=4, width=200, height=150, num_seeds=25, seed=3)
    base = dict(patch_radius=4, max_lod=3, particle_num=6, max_iteration=8,
                dist_weighting=4 / 3.0, cell_size=10, min_cam_num=3,
                max_cell_patch_num=2, neighbor_radius_scalar=0.08,
                batch_size=64, wavefront_size=64, seed_refine_rounds=1)

    def run(pipe):
        rec = Reconstructor(sc.params, sc.images,
                            MvsConfig(**base, pipeline_expansion=pipe),
                            verbose=False)
        rec.load_seeds(sc.seed_centers, sc.seed_cam_masks,
                       sc.seed_img_points,
                       np.full((len(sc.seed_centers), 3), 128.0))
        rec.refine_seeds()
        rec.expand()
        return rec

    rec_s = run(False)
    rec_p = run(True)
    spts, ppts = rec_s.live_centers(), rec_p.live_centers()
    assert len(ppts) > 150, len(ppts)
    assert np.median(sc.surface_distance(ppts)) < 0.005
    # frontier fully drained in pipelined mode too (the drain loop keeps
    # iterating while an insert revives the frontier)
    assert (~rec_p.arena.expanded[rec_p.arena.live_ids()]).sum() == 0
    depth = float(np.linalg.norm(sc.seed_centers.mean(0)
                                 - rec_s.np_center.mean(0)))
    half_cell = 0.5 * base["cell_size"] * depth / float(rec_s.np_focal[0, 0])
    ag = cloud_agreement(ppts, spts, half_cell)
    assert ag["engine_within_tol"] >= 0.9, ag
    assert ag["oracle_within_tol"] >= 0.9, ag
    assert 0.8 <= len(ppts) / len(spts) <= 1.25, (len(ppts), len(spts))
