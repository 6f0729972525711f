"""End-to-end cloud parity: the engine's wavefront pipeline vs the serial
reference-semantics oracle (mvs.cpp:196-275, 792-898 re-implemented one
patch at a time in NumPy; pais_mvs_tpu/oracle.py::OraclePipeline).

This measures the headline quality metric — "% patches
within depth tolerance of the reference cloud" — with the oracle standing
in for a reference run (the reference binary is Windows-only and
srand(time)-seeded; SURVEY.md §6).

Tolerance: half a cell's world-space footprint. Both clouds sample the
surface at cell centers, so two equally-valid reconstructions differ
laterally by up to the cell quantization; surface accuracy itself is
asserted against the analytic ground truth separately.
"""

import numpy as np
import pytest

from pais_mvs_tpu.config import MvsConfig
from pais_mvs_tpu.data.synthetic import make_scene
from pais_mvs_tpu.engine.reconstructor import Reconstructor
from pais_mvs_tpu.oracle import OraclePipeline, cloud_agreement


def test_engine_cloud_matches_serial_oracle():
    cfg = MvsConfig(patch_radius=4, max_lod=3, particle_num=6,
                    max_iteration=8, dist_weighting=4 / 3.0, cell_size=10,
                    min_cam_num=3, max_cell_patch_num=2,
                    neighbor_radius_scalar=0.08, batch_size=64,
                    wavefront_size=64, seed_refine_rounds=1)
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
    rec.expand()
    epts = rec.live_centers()

    # both clouds must genuinely lie on the analytic surface
    assert np.median(sc.surface_distance(opts)) < 0.005
    assert np.median(sc.surface_distance(epts)) < 0.005

    # world-space half-cell: cell_size pixels back-projected at scene depth
    depth = float(np.linalg.norm(sc.seed_centers.mean(0)
                                 - rec.np_center.mean(0)))
    half_cell = 0.5 * cfg.cell_size * depth / float(rec.np_focal[0, 0])

    ag = cloud_agreement(epts, opts, half_cell)
    assert ag["engine_within_tol"] >= 0.90, ag
    assert ag["oracle_within_tol"] >= 0.90, ag
    # comparable density (the serial skip semantics are preserved by the
    # engine's insert-time re-check; see tg_batch_insert)
    ratio = ag["engine_count"] / ag["oracle_count"]
    assert 0.75 <= ratio <= 1.33, ag
