"""Geometry primitives vs. independent NumPy/closed-form oracles."""

import numpy as np
import jax.numpy as jnp

from pais_mvs_tpu.ops import geometry as geom


def test_spherical_round_trip():
    rng = np.random.default_rng(0)
    n = rng.normal(size=(100, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    sph = geom.normal_to_spherical(jnp.asarray(n))
    back = geom.spherical_to_normal(sph)
    np.testing.assert_allclose(np.asarray(back), n, atol=2e-6)
    assert np.all(np.asarray(sph[:, 0]) >= 0)
    assert np.all(np.asarray(sph[:, 0]) <= np.pi)


def test_quat_to_rotation_orthonormal_and_matches_formula():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(50, 4))
    R = np.asarray(geom.quat_to_rotation(jnp.asarray(q)))
    eye = np.einsum("bij,bkj->bik", R, R)
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3), eye.shape),
                               atol=1e-5)
    det = np.linalg.det(R)
    np.testing.assert_allclose(det, 1.0, atol=1e-5)
    # rotating the quaternion axis leaves it fixed
    qn = q / np.linalg.norm(q, axis=-1, keepdims=True)
    axis = qn[:, 1:]
    nz = np.linalg.norm(axis, axis=-1) > 1e-3
    rotated = np.einsum("bij,bj->bi", R[nz], axis[nz])
    np.testing.assert_allclose(rotated, axis[nz], atol=1e-5)


def test_project_matches_manual_pinhole():
    rng = np.random.default_rng(2)
    q = rng.normal(size=4)
    R = np.asarray(geom.quat_to_rotation(jnp.asarray(q)))
    C = np.array([0.3, -0.2, -2.0])
    T = -R @ C
    f = np.array([600.0, 610.0])
    pp = np.array([320.0, 240.0])
    X = np.array([0.1, 0.2, 0.5])
    xy, z = geom.project(jnp.asarray(X), jnp.asarray(R), jnp.asarray(T),
                         jnp.asarray(f), jnp.asarray(pp), 0.8 ** 2)
    xc = R @ X + T
    expect = (np.array([f[0] * xc[0] / xc[2] + pp[0],
                        f[1] * xc[1] / xc[2] + pp[1]]) * 0.8 ** 2)
    np.testing.assert_allclose(np.asarray(xy), expect, rtol=1e-5)
    np.testing.assert_allclose(float(z), xc[2], rtol=1e-5)


def test_project_radial_distortion():
    R = np.eye(3)
    T = np.zeros(3)
    f = np.array([500.0, 500.0])
    pp = np.array([200.0, 150.0])
    k = 0.1
    X = np.array([0.2, -0.1, 1.0])
    xy, _ = geom.project(jnp.asarray(X), jnp.asarray(R), jnp.asarray(T),
                         jnp.asarray(f), jnp.asarray(pp), 1.0,
                         distortion=k)
    xn, yn = 0.2, -0.1
    r = k * (xn * xn + yn * yn)
    expect = np.array([(1 + r) * f[0] * xn + pp[0],
                       (1 + r) * f[1] * yn + pp[1]])
    np.testing.assert_allclose(np.asarray(xy), expect, rtol=1e-5)


def test_triangulate_recovers_point():
    rng = np.random.default_rng(3)
    X = np.array([0.5, -0.3, 1.2])
    origins = rng.normal(size=(6, 3)) * 2.0
    dirs = X - origins
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    mask = np.array([True, True, True, True, False, False])
    # corrupt masked-out rays to prove they are ignored
    dirs[4:] = rng.normal(size=(2, 3))
    out = geom.triangulate_rays(jnp.asarray(origins, dtype=jnp.float32),
                                jnp.asarray(dirs, dtype=jnp.float32),
                                jnp.asarray(mask))
    np.testing.assert_allclose(np.asarray(out), X, atol=1e-3)


def test_ray_plane_intersect():
    origin = jnp.asarray([0.0, 0.0, -2.0])
    direction = jnp.asarray([0.1, 0.2, 1.0])
    p = geom.ray_plane_intersect(origin, direction,
                                 jnp.asarray([5.0, 7.0, 0.0]),
                                 jnp.asarray([0.0, 0.0, 1.0]))
    np.testing.assert_allclose(float(p[2]), 0.0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(p[:2]), [0.2, 0.4], atol=1e-5)


def test_plane_homography_transfers_plane_points():
    """Points on the patch plane must map ref-pixel -> target-pixel exactly."""
    rng = np.random.default_rng(5)
    from pais_mvs_tpu.data.synthetic import make_scene
    sc = make_scene(num_cams=2, width=200, height=150, num_seeds=5)
    from pais_mvs_tpu.models.camera import build_scene
    from pais_mvs_tpu.config import MvsConfig
    scene = build_scene(sc.params, sc.images, MvsConfig(max_lod=2))
    rig = scene.rig
    center = jnp.asarray([0.05, -0.02, 0.0])
    normal = jnp.asarray(sc.plane_normal, dtype=jnp.float32)
    H, ok = geom.plane_homography(
        center, normal,
        rig.R[0], rig.T[0], rig.focal[0], rig.principal[0],
        rig.R[1], rig.T[1], rig.focal[1], rig.principal[1],
        jnp.asarray(1.0))
    assert bool(ok)
    # sample plane points near the center, project into both cameras
    for _ in range(5):
        d = rng.normal(size=3) * 0.05
        d[2] = 0.0  # stay on the z=0 plane
        X = np.asarray(center) + d
        xy0, _ = geom.project(jnp.asarray(X), rig.R[0], rig.T[0],
                              rig.focal[0], rig.principal[0], 1.0)
        xy1, _ = geom.project(jnp.asarray(X), rig.R[1], rig.T[1],
                              rig.focal[1], rig.principal[1], 1.0)
        mapped, w = geom.homography_apply(H, xy0)
        np.testing.assert_allclose(np.asarray(mapped), np.asarray(xy1),
                                   atol=0.1)


def test_region_ratio_identity_is_one():
    H = jnp.eye(3)
    r = geom.homography_region_ratio(H, jnp.asarray([10.0, 20.0]))
    np.testing.assert_allclose(float(r), 1.0, atol=1e-5)


def test_region_ratio_anisotropic_scale():
    H = jnp.asarray(np.diag([4.0, 1.0, 1.0]))
    r = geom.homography_region_ratio(H, jnp.asarray([3.0, 3.0]))
    np.testing.assert_allclose(float(r), 0.25, atol=1e-5)


def test_package_defaults_full_precision_matmuls():
    """Importing the package must pin true-f32 einsums: the GPU's default
    TF32 lowering of f32 dots would degrade the geometry chain
    (homographies, projections, NCC tables)."""
    import jax
    import pais_mvs_tpu  # noqa: F401  (import applies the default)
    assert jax.config.jax_default_matmul_precision == "highest"
