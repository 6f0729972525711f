"""File-format round-trips: NVM, binary MVS, PLY, PSR, config."""

import os

import numpy as np
import pytest

from pais_mvs_tpu.config import MvsConfig
from pais_mvs_tpu.data.synthetic import make_scene
from pais_mvs_tpu.io import nvm as nvm_io
from pais_mvs_tpu.io import mvsbin
from pais_mvs_tpu.io.pointcloud import write_ply, read_ply, write_psr, read_psr


@pytest.fixture(scope="module")
def sc():
    return make_scene(num_cams=4, width=160, height=120, num_seeds=25)


def test_nvm_round_trip(sc, tmp_path):
    path = str(tmp_path / "scene.nvm")
    # img points in NVM are center-origin
    ipts = sc.seed_img_points.copy()
    for c in range(len(sc.params)):
        ipts[:, c, 0] -= 160 // 2
        ipts[:, c, 1] -= 120 // 2
    nvm_io.save_nvm(path, sc.params, sc.seed_centers, sc.seed_colors,
                    sc.seed_cam_masks, ipts)
    data = nvm_io.load_nvm(path)
    assert len(data.cameras) == 4
    np.testing.assert_allclose(data.cameras[1].center, sc.params[1].center,
                               rtol=1e-6)
    np.testing.assert_allclose(data.cameras[2].quaternion,
                               sc.params[2].quaternion, rtol=1e-6)
    np.testing.assert_allclose(data.centers, sc.seed_centers, rtol=1e-5)
    np.testing.assert_array_equal(data.cam_masks, sc.seed_cam_masks)
    back = nvm_io.decenter_image_points(data, [160] * 4, [120] * 4)
    sel = sc.seed_cam_masks
    np.testing.assert_allclose(back[sel], sc.seed_img_points[sel], atol=1e-4)


def test_nvm2_round_trip(sc, tmp_path):
    """NVM2: anisotropic focal + explicit principal point
    (fileloader.cpp:62-109)."""
    import dataclasses
    path = str(tmp_path / "scene.nvm2")
    params = [dataclasses.replace(
        p, focal=np.array([p.focal[0], p.focal[0] * 1.02]),
        principal=np.array([77.0, 55.0])) for p in sc.params]
    nvm_io.save_nvm(path, params, sc.seed_centers, sc.seed_colors,
                    sc.seed_cam_masks,
                    np.zeros_like(sc.seed_img_points), nvm2=True)
    data = nvm_io.load_nvm(path, nvm2=True)
    np.testing.assert_allclose(data.cameras[1].focal, params[1].focal,
                               rtol=1e-6)
    np.testing.assert_allclose(data.cameras[3].principal, [77.0, 55.0])
    np.testing.assert_allclose(data.centers, sc.seed_centers, rtol=1e-5)


def test_mvs_binary_round_trip(sc, tmp_path):
    path = str(tmp_path / "ckpt.mvs")
    cfg = MvsConfig(patch_radius=9, lod_ratio=0.75)
    M, C = 17, 4
    rng = np.random.default_rng(0)
    patches = mvsbin.MvsPatchData(
        centers=rng.normal(size=(M, 3)),
        normal_sph=rng.uniform(0, 3, size=(M, 2)),
        cam_masks=rng.uniform(size=(M, C)) > 0.4,
        fitness=rng.uniform(size=M),
        correlation=rng.uniform(size=M))
    mvsbin.write_mvs(path, cfg, sc.params, patches)
    f = mvsbin.read_mvs(path)
    assert f.config.patch_radius == 9
    assert f.config.lod_ratio == 0.75
    assert len(f.cameras) == 4
    assert f.cameras[0].file_name == sc.params[0].file_name
    np.testing.assert_allclose(f.patches.centers, patches.centers)
    np.testing.assert_allclose(f.patches.normal_sph, patches.normal_sph)
    np.testing.assert_array_equal(f.patches.cam_masks, patches.cam_masks)
    np.testing.assert_allclose(f.patches.fitness, patches.fitness)
    np.testing.assert_allclose(f.patches.correlation, patches.correlation)


def test_ply_round_trip(tmp_path):
    path = str(tmp_path / "cloud.ply")
    rng = np.random.default_rng(1)
    c = rng.normal(size=(9, 3))
    n = rng.normal(size=(9, 3))
    col = rng.integers(0, 255, size=(9, 3)).astype(np.float64)
    write_ply(path, c, n, col)
    c2, n2, col2 = read_ply(path)
    np.testing.assert_allclose(c2, c, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(n2, n, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(col2, col)
    with open(path) as f:
        head = f.read(200)
    assert head.startswith("ply\nformat ascii 1.0\nelement vertex 9\n")
    assert "diffuse_red" in head  # reference property naming


def test_psr_round_trip(tmp_path):
    path = str(tmp_path / "cloud.psr")
    rng = np.random.default_rng(2)
    c = rng.normal(size=(7, 3)).astype(np.float32)
    n = rng.normal(size=(7, 3)).astype(np.float32)
    write_psr(path, c, n)
    assert os.path.getsize(path) == 7 * 6 * 4  # raw float32 records
    c2, n2 = read_psr(path)
    np.testing.assert_allclose(c2, c, rtol=1e-6)
    np.testing.assert_allclose(n2, n, rtol=1e-6)


@pytest.mark.parametrize("shape,ext", [((7, 5), ".pgm"), ((7, 5, 3), ".ppm"),
                                       ((7, 5, 3), ".npy")])
def test_image_round_trip_without_pillow(tmp_path, shape, ext):
    """PGM/PPM/.npy inputs decode with numpy alone, to uint8 RGB."""
    from pais_mvs_tpu.io.images import read_image, write_pnm
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / f"img{ext}")
    if ext == ".npy":
        np.save(path, img)
    else:
        write_pnm(path, img)
    out = read_image(path)
    assert out.dtype == np.uint8 and out.shape == (7, 5, 3)
    want = img if img.ndim == 3 else np.repeat(img[..., None], 3, axis=2)
    np.testing.assert_array_equal(out, want)


def test_pnm_header_comments_and_whitespace(tmp_path):
    from pais_mvs_tpu.io.images import read_pnm
    img = np.arange(6, dtype=np.uint8).reshape(2, 3)
    path = tmp_path / "c.pgm"
    path.write_bytes(b"P5\n# a comment\n3  # width\n2\n255\n" + img.tobytes())
    np.testing.assert_array_equal(read_pnm(str(path)), img)


@pytest.mark.parametrize("header,body,msg", [
    (b"P2\n3 2\n255\n", b"0 1 2 3 4 5", "binary P5/P6"),
    (b"P5\n3 2\n65535\n", bytes(12), "8-bit"),
    (b"P6\n3 2\n255\n", bytes(10), "truncated"),
    (b"P5\n3 x\n255\n", bytes(6), "malformed"),
])
def test_pnm_rejects_bad_files(tmp_path, header, body, msg):
    from pais_mvs_tpu.io.images import read_pnm
    path = tmp_path / "bad.pnm"
    path.write_bytes(header + body)
    with pytest.raises(ValueError, match=msg):
        read_pnm(str(path))


def test_other_formats_name_the_missing_package(tmp_path, monkeypatch):
    """Without Pillow, a PNG input fails with an error naming the format."""
    import builtins
    from pais_mvs_tpu.io.images import read_image
    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    (tmp_path / "x.png").write_bytes(b"\x89PNG")
    with pytest.raises(RuntimeError, match=r"'\.png' images needs Pillow"):
        read_image(str(tmp_path / "x.png"))
