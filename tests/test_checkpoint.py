"""Checkpoint/resume: the .state.npz sidecar restores the full arena
including the expansion frontier (SURVEY §5.4 build equivalent — the
reference's .mvs checkpoint loses queue/expanded state)."""

import numpy as np
import pytest

from pais_mvs_tpu.config import MvsConfig
from pais_mvs_tpu.data.synthetic import make_scene
from pais_mvs_tpu.engine.reconstructor import Reconstructor


@pytest.fixture(scope="module")
def small():
    cfg = MvsConfig(patch_radius=4, max_lod=3, particle_num=6,
                    max_iteration=6, dist_weighting=4 / 3.0,
                    seed_refine_rounds=1, cell_size=10,
                    batch_size=64, wavefront_size=64)
    sc = make_scene(num_cams=4, width=160, height=120, num_seeds=30, seed=9)
    return cfg, sc


def _fresh(cfg, sc):
    rec = Reconstructor(sc.params, sc.images, cfg, verbose=False)
    rec.load_seeds(sc.seed_centers, sc.seed_cam_masks, sc.seed_img_points,
                   np.full((len(sc.seed_centers), 3), 128.0))
    return rec


def test_checkpoint_roundtrip_and_resume(tmp_path, small):
    cfg, sc = small
    rec = _fresh(cfg, sc)
    rec.refine_seeds()
    rec.expand(max_rounds=2)                  # interrupt mid-expansion
    ck = str(tmp_path / "auto_save.mvs")
    rec.save_checkpoint(ck)

    rec2 = Reconstructor(sc.params, sc.images, cfg, verbose=False)
    assert rec2.load_checkpoint(ck)
    a1, a2 = rec.arena, rec2.arena
    assert a1.count == a2.count
    np.testing.assert_array_equal(a1.alive[:a1.count], a2.alive[:a2.count])
    np.testing.assert_array_equal(a1.expanded[:a1.count],
                                  a2.expanded[:a2.count])
    for k in a1.data:
        np.testing.assert_array_equal(a1.data[k][:a1.count],
                                      a2.data[k][:a2.count])
    assert rec2.neighbor_radius == rec.neighbor_radius
    frontier_before = int((~a2.expanded[:a2.count]
                           & a2.alive[:a2.count]).sum())
    assert frontier_before > 0, "interrupted run should leave a frontier"

    n_before = len(a2.live_ids())
    rec2.expand(max_rounds=50)
    assert len(rec2.arena.live_ids()) >= n_before
    # the frontier drains: everything alive has been expanded
    a = rec2.arena
    assert int((~a.expanded[:a.count] & a.alive[:a.count]).sum()) == 0


def test_load_checkpoint_missing_returns_false(tmp_path, small):
    cfg, sc = small
    rec = Reconstructor(sc.params, sc.images, cfg, verbose=False)
    assert not rec.load_checkpoint(str(tmp_path / "nope.mvs"))


def test_corrupt_sidecar_leaves_arena_untouched(tmp_path, small):
    """A sidecar that OPENS but has a bad member must be rejected without
    half-mutating the arena (every field materializes inside the try
    before any arena write)."""
    cfg, sc = small
    rec = _fresh(cfg, sc)
    rec.refine_seeds()
    ck = str(tmp_path / "auto_save.mvs")
    rec.save_checkpoint(ck)

    # corrupt one member: rewrite the npz with a truncated field
    st = dict(np.load(ck + ".state.npz"))
    st["d_center"] = st["d_center"][:3]        # wrong row count
    np.savez_compressed(ck + ".state.npz", **st)

    rec2 = Reconstructor(sc.params, sc.images, cfg, verbose=False)
    before_count = rec2.arena.count
    assert not rec2.load_checkpoint(ck)
    assert rec2.arena.count == before_count    # nothing mutated


def test_live_snapshot_written_during_expansion(tmp_path, small):
    """--live-snapshots analog of the reference's addPatchView live-viewer
    hook (TMVS/mvs/mvs.h:12, mvs.cpp:223,600): every autosave must also
    refresh live_snapshot.ply so the growing cloud is watchable mid-run."""
    from pais_mvs_tpu.io.pointcloud import read_ply
    cfg, sc = small
    rec = _fresh(cfg, sc)
    rec.refine_seeds()
    rec.autosave_interval = 10            # force several autosaves
    rec.live_snapshot_dir = str(tmp_path)
    snap = tmp_path / "live_snapshot.ply"
    counts = []
    orig = type(rec)._live_snapshot

    def spy(self):
        orig(self)
        if snap.exists():
            counts.append(len(read_ply(str(snap))[0]))
    type(rec)._live_snapshot = spy
    try:
        rec.expand(max_rounds=6,
                   autosave_path=str(tmp_path / "auto_save.mvs"))
    finally:
        type(rec)._live_snapshot = orig
    n_final = len(rec.arena.live_ids())
    assert snap.exists()
    assert len(counts) >= 2, counts       # refreshed repeatedly mid-run
    assert counts[0] < n_final            # first snapshot was mid-flight
    assert counts == sorted(counts)       # monotone growing cloud
    c, n, col = read_ply(str(snap))
    assert np.isfinite(c).all() and len(c) <= n_final


def test_cand_done_survives_checkpoint(tmp_path, small):
    """The distributed path's refine-exactly-once record (re-queued
    parents' consumed candidates) must roundtrip through the sidecar, or
    a resumed run re-refines spilled candidates (the divergence
    ``cand_done`` exists to close)."""
    cfg, sc = small
    rec = _fresh(cfg, sc)
    rec.refine_seeds()
    C = rec.arena.num_cams
    m1 = np.zeros(4 * C, bool)
    m1[[0, 5]] = True
    m2 = np.zeros(4 * C, bool)
    m2[3] = True
    rec._dist_cand_done = {2: m1, 7: m2}
    ck = str(tmp_path / "cd_save.mvs")
    rec.save_checkpoint(ck)

    rec2 = Reconstructor(sc.params, sc.images, cfg, verbose=False)
    assert rec2.load_checkpoint(ck)
    got = rec2._dist_cand_done
    assert set(got) == {2, 7}
    np.testing.assert_array_equal(got[2], m1)
    np.testing.assert_array_equal(got[7], m2)

    # absent record loads as empty (old sidecars stay readable)
    rec._dist_cand_done = {}
    rec.save_checkpoint(ck)
    rec3 = Reconstructor(sc.params, sc.images, cfg, verbose=False)
    assert rec3.load_checkpoint(ck)
    assert rec3._dist_cand_done == {}


def test_pipelined_autosave_resumes_consistently(tmp_path, small):
    """With pipeline_expansion, an autosave fires while the NEXT round's
    parents are already popped and their refine is in flight — the
    checkpoint must record those parents UNEXPANDED ("the round never
    happened"), or a crash+resume silently loses their subtrees
    (code-review round 5). Snapshot every autosave mid-run, resume from
    the first, drain, and require the resumed cloud to recover the
    uninterrupted run's size."""
    import shutil
    from pais_mvs_tpu.engine.reconstructor import Reconstructor
    base_cfg, sc = small
    cfg = base_cfg.replace(pipeline_expansion=True)

    rec = Reconstructor(sc.params, sc.images, cfg, verbose=False)
    rec.load_seeds(sc.seed_centers, sc.seed_cam_masks, sc.seed_img_points,
                   np.full((len(sc.seed_centers), 3), 128.0))
    rec.refine_seeds()
    rec.autosave_interval = 60          # force mid-run autosaves
    saves = []
    orig = Reconstructor.save_checkpoint

    def spy(self, p):
        orig(self, p)
        d = tmp_path / f"save{len(saves)}"
        d.mkdir()
        shutil.copy(p, d / "auto_save.mvs")
        shutil.copy(p + ".state.npz", d / "auto_save.mvs.state.npz")
        saves.append(d)

    Reconstructor.save_checkpoint = spy
    try:
        rec.expand(autosave_path=str(tmp_path / "auto_save.mvs"))
    finally:
        Reconstructor.save_checkpoint = orig
    full = len(rec.arena.live_ids())
    assert saves, "no mid-run autosave fired — lower autosave_interval"

    rec2 = Reconstructor(sc.params, sc.images, cfg, verbose=False)
    assert rec2.load_checkpoint(str(saves[0] / "auto_save.mvs"))
    n0 = len(rec2.arena.live_ids())
    rec2.expand()
    n2 = len(rec2.arena.live_ids())
    assert n2 > n0, "resume did not continue expanding"
    assert n2 >= 0.85 * full, (n2, full)
