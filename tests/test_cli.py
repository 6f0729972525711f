"""CLI-level smoke tests: full -r/-f/-v/-a flows through the argparse
entry point on a tiny on-disk scene, plus reconstruction determinism."""

import json
import os

import numpy as np
import pytest

from pais_mvs_tpu import cli
from pais_mvs_tpu.data.synthetic import make_scene
from pais_mvs_tpu.io import mvsbin
from pais_mvs_tpu.io.nvm import save_nvm


@pytest.fixture(scope="module")
def disk_scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("scene")
    from PIL import Image
    sc = make_scene(num_cams=4, width=160, height=120, num_seeds=12, seed=7)
    for p, img in zip(sc.params, sc.images):
        Image.fromarray(img).save(str(d / p.file_name))
    ipts = sc.seed_img_points.copy()
    ipts[..., 0] -= 80
    ipts[..., 1] -= 60
    save_nvm(str(d / "scene.nvm"), sc.params, sc.seed_centers,
             np.full((len(sc.seed_centers), 3), 128.0),
             sc.seed_cam_masks, ipts)
    (d / "config.txt").write_text(
        "patchRadius 4\nmaxLOD 3\nparticleNum 6\nmaxIteration 6\n"
        "distWeighting 1.3333\nseedRefineRounds 1\nminCamNum 3\n"
        "cellSize 14\nwavefrontSize 64\nbatchSize 64\n")
    return d, sc


def test_cli_seedless_nvm_e2e(tmp_path, monkeypatch):
    """A ZERO-point NVM must flow through the feature-seeding fallback
    (reference FeatureManager, TMVS.cpp:98-103) into a full reconstruction
    meeting the surface-quality gate — the last untested CLI branch."""
    from PIL import Image
    sc = make_scene(num_cams=4, width=240, height=180, num_seeds=10, seed=5)
    for p, img in zip(sc.params, sc.images):
        Image.fromarray(img).save(str(tmp_path / p.file_name))
    save_nvm(str(tmp_path / "scene.nvm"), sc.params, np.zeros((0, 3)),
             np.zeros((0, 3)), np.zeros((0, 4), bool), np.zeros((0, 4, 2)))
    (tmp_path / "config.txt").write_text(
        "patchRadius 5\nmaxLOD 3\nparticleNum 8\nmaxIteration 10\n"
        "distWeighting 1.6667\nseedRefineRounds 1\nminCamNum 3\n")
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["-r", "scene.nvm", "-o", str(tmp_path)])
    assert rc == 0
    f = mvsbin.read_mvs(str(tmp_path / "exp.mvs"))
    assert len(f.patches.centers) > 1000, len(f.patches.centers)
    d = sc.surface_distance(f.patches.centers)
    assert np.median(d) < 0.01, float(np.median(d))


def test_cli_full_flow(disk_scene, monkeypatch):
    d, sc = disk_scene
    monkeypatch.chdir(d)          # config.txt + image paths resolve from cwd
    rc = cli.main(["-r", "scene.nvm", "-o", str(d)])
    assert rc == 0
    for name in ("init.mvs", "seed.mvs", "exp.mvs", "exp.ply", "exp.psr",
                 "stats.json", "log.txt"):
        assert (d / name).exists(), name
    f = mvsbin.read_mvs(str(d / "exp.mvs"))
    # ~97 patches since the insert-time skipNeighborCell re-check matched
    # the serial reference's cell density (tg_batch_insert)
    assert len(f.patches.centers) > 80
    d_surf = sc.surface_distance(f.patches.centers)
    assert np.median(d_surf) < 0.01
    stats = json.loads((d / "stats.json").read_text())
    assert stats["live_patches"] == len(f.patches.centers)

    rc = cli.main(["-f", str(d / "exp.mvs"), "-o", str(d)])
    assert rc == 0
    assert (d / "PCMVS_filter.ply").exists()

    rc = cli.main(["-v", str(d / "exp.mvs"), "-o", str(d),
                   "--patch-id", "3"])
    assert rc == 0
    assert (d / "view.html").exists()
    assert (d / "patch3_views.png").exists()

    rc = cli.main(["-a", str(d / "exp.mvs"), "-o", str(d)])
    assert rc == 0
    assert (d / "animate.ply").exists()


def test_reconstruction_is_deterministic(disk_scene, monkeypatch, tmp_path):
    """Same rngSeed -> bit-identical dense cloud (the reference is
    srand(time)-seeded and irreproducible; determinism is an engine
    guarantee)."""
    d, sc = disk_scene
    monkeypatch.chdir(d)
    o1 = tmp_path / "r1"
    o2 = tmp_path / "r2"
    o1.mkdir(); o2.mkdir()
    assert cli.main(["-r", "scene.nvm", "-o", str(o1)]) == 0
    assert cli.main(["-r", "scene.nvm", "-o", str(o2)]) == 0
    a = mvsbin.read_mvs(str(o1 / "exp.mvs"))
    b = mvsbin.read_mvs(str(o2 / "exp.mvs"))
    np.testing.assert_array_equal(a.patches.centers, b.patches.centers)
    np.testing.assert_array_equal(a.patches.fitness, b.patches.fitness)


_BLOCK_IMAGING = """
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("flax", "PIL", "matplotlib"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, _Block())
from pais_mvs_tpu import cli
rc = cli.main(["-r", "scene.nvm"])
assert not any(m.split(".")[0] in ("flax", "PIL", "matplotlib")
               for m in sys.modules), "optional package imported"
sys.exit(rc)
"""


def test_cli_runs_without_flax_pil_matplotlib(tmp_path):
    """`-r` on a PPM scene runs in a fresh interpreter in which flax, PIL
    and matplotlib cannot be imported (the packages a GPU host may lack)."""
    import subprocess
    import sys
    from pais_mvs_tpu.io.images import write_pnm
    sc = make_scene(num_cams=4, width=120, height=90, num_seeds=10, seed=3)
    for p, img in zip(sc.params, sc.images):
        p.file_name = p.file_name.rsplit(".", 1)[0] + ".ppm"
        write_pnm(str(tmp_path / p.file_name), img)
    ipts = sc.seed_img_points.copy()
    ipts[..., 0] -= 60
    ipts[..., 1] -= 45
    save_nvm(str(tmp_path / "scene.nvm"), sc.params, sc.seed_centers,
             np.full((len(sc.seed_centers), 3), 128.0),
             sc.seed_cam_masks, ipts)
    (tmp_path / "config.txt").write_text(
        "patchRadius 3\nmaxLOD 2\nparticleNum 4\nmaxIteration 4\n"
        "distWeighting 1.0\nseedRefineRounds 1\nminCamNum 3\n"
        "cellSize 12\nwavefrontSize 32\nbatchSize 32\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=root)
    r = subprocess.run([sys.executable, "-c", _BLOCK_IMAGING],
                       cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    f = mvsbin.read_mvs(str(tmp_path / "exp.mvs"))
    assert len(f.patches.centers) > 0
    assert np.median(sc.surface_distance(f.patches.centers)) < 0.02
