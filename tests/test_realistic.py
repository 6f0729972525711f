"""Realistic-imagery validation: real photographic
texture, occluding step geometry, per-view photometric jitter, and the
reference's actual pawn camera rig ingested through the NVM loader."""

import numpy as np
import pytest

from pais_mvs_tpu.config import MvsConfig
from pais_mvs_tpu.data.realistic import (PAWN_CAMERAS, make_realistic_scene)
from pais_mvs_tpu.engine.reconstructor import Reconstructor


def test_pawn_nvm_cameras_ingest(tmp_path):
    """The five pawn camera rows from the reference's README.md:68-72 must
    round-trip through the NVM text loader with focals, quaternions,
    centers AND the real radial distortion (~-0.2) intact."""
    from pais_mvs_tpu.io.nvm import load_nvm
    lines = ["NVM_V3", "", "5"]
    for name, f, q, c, r in PAWN_CAMERAS:
        lines.append(f"{name}\t{f} " + " ".join(str(x) for x in q) + " "
                     + " ".join(str(x) for x in c) + f" {r} 0")
    lines += ["", "0", ""]
    p = tmp_path / "pawn.nvm"
    p.write_text("\n".join(lines))
    data = load_nvm(str(p))
    assert len(data.cameras) == 5
    for cam, (name, f, q, c, r) in zip(data.cameras, PAWN_CAMERAS):
        assert cam.file_name == name
        np.testing.assert_allclose(cam.focal, [f, f])
        np.testing.assert_allclose(cam.quaternion, q)
        np.testing.assert_allclose(cam.center, c)
        assert abs(cam.radial_distortion - r) < 1e-12
        assert cam.radial_distortion < -0.19     # the real pawn distortion


def test_realistic_scene_reconstruction():
    """Engine quality on photo texture + occluding step + photometric
    jitter. Gates: surface accuracy ~0.2% of viewing depth, the raised
    step recovered at its true height (not smoothed into the plane)."""
    sc = make_realistic_scene(num_seeds=150, seed=0)
    # occlusion sanity: some seeds must NOT be visible in all 5 views
    assert (sc.seed_cam_masks.sum(1) < 5).any()
    cfg = MvsConfig(patch_radius=6, max_lod=4, particle_num=8,
                    max_iteration=12, dist_weighting=2.0, cell_size=12,
                    min_cam_num=3, max_cell_patch_num=2,
                    neighbor_radius_scalar=0.01, batch_size=128,
                    wavefront_size=128, seed_refine_rounds=2)
    rec = Reconstructor(sc.params, sc.images, cfg, verbose=False)
    rec.load_seeds(sc.seed_centers, sc.seed_cam_masks, sc.seed_img_points,
                   np.full((len(sc.seed_centers), 3), 128.0))
    rec.refine_seeds()
    rec.expand(max_rounds=40)
    pts = rec.live_centers()
    d = sc.surface_distance(pts)
    assert len(pts) > 800, len(pts)
    assert np.median(d) < 0.005, np.median(d)          # depth ~1.1
    assert np.quantile(d, 0.9) < sc.surface.h / 2      # below step height

    # the step's top face is reconstructed AT the step height
    u, v, w = sc.surface.uvw(pts)
    top = (np.abs(u) < sc.surface.a) & (np.abs(v) < sc.surface.b)
    assert top.sum() > 100, int(top.sum())
    assert np.median(np.abs(w[top] - sc.surface.h)) < 0.01


def _recon_median(sc, apply_distortion: bool) -> float:
    from pais_mvs_tpu.models.camera import undistort_points
    cfg = MvsConfig(patch_radius=6, max_lod=4, particle_num=8,
                    max_iteration=12, dist_weighting=2.0, cell_size=12,
                    min_cam_num=3, max_cell_patch_num=2,
                    neighbor_radius_scalar=0.01, batch_size=128,
                    wavefront_size=128, seed_refine_rounds=2,
                    apply_distortion=apply_distortion)
    ipts = sc.seed_img_points.copy()
    if apply_distortion:
        for ci, (p, img) in enumerate(zip(sc.params, sc.images)):
            pp = np.array([img.shape[1] >> 1, img.shape[0] >> 1], float)
            ipts[:, ci] = undistort_points(ipts[:, ci], p.focal, pp,
                                           float(p.radial_distortion))
    rec = Reconstructor(sc.params, sc.images, cfg, verbose=False)
    rec.load_seeds(sc.seed_centers, sc.seed_cam_masks, ipts,
                   np.full((len(sc.seed_centers), 3), 128.0))
    rec.refine_seeds()
    rec.expand(max_rounds=12)
    pts = rec.live_centers()
    assert len(pts) > 150, len(pts)
    return float(np.median(sc.surface_distance(pts)))


def test_cli_distorted_nvm_roundtrip(tmp_path, monkeypatch):
    """Full CLI -r over an NVM whose cameras carry the REAL pawn
    distortion and whose images were rendered through it, with
    applyDistortion in config.txt — exercises the measurement
    undistortion wiring in the CLI load path."""
    from PIL import Image
    from pais_mvs_tpu.io import mvsbin
    from pais_mvs_tpu.io.nvm import save_nvm
    from pais_mvs_tpu import cli

    sc = make_realistic_scene(num_seeds=60, seed=2, distort=True,
                              gain_jitter=0.0, bias_jitter=0.0)
    for p, img in zip(sc.params, sc.images):
        Image.fromarray(img).save(tmp_path / p.file_name)
    # NVM measurements are CENTER-origin distorted-image coordinates
    ipts = sc.seed_img_points.copy()
    for c, img in enumerate(sc.images):
        ipts[:, c, 0] -= img.shape[1] // 2
        ipts[:, c, 1] -= img.shape[0] // 2
    save_nvm(str(tmp_path / "scene.nvm"), sc.params, sc.seed_centers,
             np.full((len(sc.seed_centers), 3), 128.0),
             sc.seed_cam_masks, ipts)
    (tmp_path / "config.txt").write_text(
        "patchRadius 6\nmaxLOD 4\nparticleNum 8\nmaxIteration 12\n"
        "distWeighting 2.0\ncellSize 12\nminCamNum 3\n"
        "maxCellPatchNum 2\nneighborRadiusScalar 0.01\n"
        "seedRefineRounds 2\nbatchSize 128\nwavefrontSize 128\n"
        "applyDistortion 1\n")
    # cap the expansion so the CLI run stays CI-sized
    import pais_mvs_tpu.engine.reconstructor as recon_mod
    orig_expand = recon_mod.Reconstructor.expand
    monkeypatch.setattr(
        recon_mod.Reconstructor, "expand",
        lambda self, max_rounds=10_000, autosave_path=None:
            orig_expand(self, max_rounds=8, autosave_path=autosave_path))
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["-r", "scene.nvm", "-o", str(tmp_path)])
    assert rc == 0
    f = mvsbin.read_mvs(str(tmp_path / "exp.mvs"))
    assert len(f.patches.centers) > 100
    d = sc.surface_distance(f.patches.centers)
    assert np.median(d) < 0.006, np.median(d)
    # the loader must preserve the distortion coefficient round-trip
    assert all(c.radial_distortion < -0.19 for c in f.cameras)


def test_radial_distortion_correction():
    """Images rendered through the pawn cameras' REAL radial distortion
    (r ~ -0.2, up to ~25 px displacement at the corners): ignoring r must
    measurably bias the cloud, and apply_distortion must fix it
    (reference model camera.cpp:148-155)."""
    sc = make_realistic_scene(num_seeds=120, seed=1, distort=True,
                              gain_jitter=0.0, bias_jitter=0.0)
    d_ignore = _recon_median(sc, apply_distortion=False)
    d_fixed = _recon_median(sc, apply_distortion=True)
    assert d_fixed < 0.006, d_fixed
    assert d_ignore > 1.5 * d_fixed, (d_ignore, d_fixed)
