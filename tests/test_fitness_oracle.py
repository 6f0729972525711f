"""The XLA photoconsistency fitness (ops.fitness.patch_fitness) against the
independent NumPy oracle (oracle.fitness_np) of TMVS's getFitness
(patch.cpp:914-1047): every adaptive-weight combination, several pyramid
levels, small to large windows (no radius ceiling), and real photographic
texture."""

import itertools

import numpy as np
import jax.numpy as jnp
import pytest

from pais_mvs_tpu import oracle
from pais_mvs_tpu.config import MvsConfig
from pais_mvs_tpu.data.synthetic import make_scene
from pais_mvs_tpu.models.camera import build_scene
from pais_mvs_tpu.ops import fitness as F
from pais_mvs_tpu.ops import geometry as geom


def _problem(sc, scene, B, P, seed=0):
    """B seed patches seen from camera 2, P hypotheses each scattered
    around the triangulated normal and depth. Particle 0 sits far behind
    the surface (out of every view) and particle 1 faces away from the
    reference camera, so both rejection paths are compared too."""
    centers = sc.seed_centers[:B].astype(np.float32)
    ref = np.full(B, 2, np.int32)
    rays = centers - np.asarray(scene.rig.center)[ref]
    depths = np.linalg.norm(rays, axis=-1)
    rays = (rays / depths[:, None]).astype(np.float32)
    cm = np.asarray(sc.seed_cam_masks[:B]).copy()
    cm[:, 2] = True
    n0 = np.asarray(geom.estimated_normal(
        jnp.asarray(centers), scene.rig.center[None].repeat(B, 0),
        jnp.asarray(cm)))
    sph = np.asarray(geom.normal_to_spherical(jnp.asarray(n0)))
    rng = np.random.default_rng(seed)
    pos = np.stack([
        sph[:, 0:1] + rng.normal(scale=0.5, size=(B, P)),
        sph[:, 1:2] + rng.normal(scale=0.8, size=(B, P)),
        depths[:, None] + rng.uniform(-0.1, 0.1, size=(B, P)),
    ], -1).astype(np.float32)
    pos[:, 0, 2] = depths * 20.0
    flipped = np.asarray(geom.normal_to_spherical(-jnp.asarray(n0)))
    pos[:, 1, :2] = flipped
    return ref, cm, rays, pos


def _compare(sc, cfg, lod, B=8, P=9):
    scene = build_scene(sc.params, sc.images, cfg)
    ref, cm, rays, pos = _problem(sc, scene, B, P)
    lods = np.full(B, lod, np.int32)
    dev = np.asarray(F.patch_fitness(
        scene, cfg, jnp.asarray(ref), jnp.asarray(cm), jnp.asarray(lods),
        jnp.asarray(rays), jnp.asarray(pos)))
    nps = oracle.NpScene(sc.params, sc.images, cfg)
    ref_np = np.stack([
        oracle.fitness_np(nps, cfg, int(ref[i]), np.nonzero(cm[i])[0], lod,
                          rays[i].astype(np.float64),
                          pos[i].astype(np.float64))
        for i in range(B)])
    v_dev, v_np = dev < 1e20, ref_np < 1e20
    assert not v_dev[:, :2].any() and not v_np[:, :2].any()
    assert (v_dev == v_np).mean() >= 0.98
    both = v_dev & v_np
    assert both.sum() >= B * (P - 2) // 2, both.sum()
    err = np.abs(dev[both] - ref_np[both])
    tol = oracle.FITNESS_TOL * np.maximum(1.0, np.abs(ref_np[both]))
    assert np.all(err <= tol), float((err / tol).max())


@pytest.fixture(scope="module")
def scene_small():
    return make_scene(num_cams=5, width=200, height=150, num_seeds=40)


@pytest.fixture(scope="module")
def scene_wide():
    return make_scene(num_cams=5, width=320, height=240, num_seeds=40)


@pytest.mark.parametrize("dist,diff,grad",
                         list(itertools.product([False, True], repeat=3)))
def test_adaptive_weights_match_oracle(scene_small, dist, diff, grad):
    cfg = MvsConfig(patch_radius=5, max_lod=4, dist_weighting=5.0 / 3.0,
                    adaptive_distance_enable=dist,
                    adaptive_difference_enable=diff,
                    adaptive_gradient_enable=grad)
    _compare(scene_small, cfg, lod=0)


@pytest.mark.parametrize("lod", [0, 1, 2])
def test_pyramid_levels_match_oracle(scene_small, lod):
    cfg = MvsConfig(patch_radius=5, max_lod=4, dist_weighting=5.0 / 3.0,
                    adaptive_gradient_enable=True)
    _compare(scene_small, cfg, lod=lod)


@pytest.mark.parametrize("radius", [6, 15, 25])
def test_window_radius_matches_oracle(scene_wide, radius):
    """r=25 (a 51x51 window) scores like the oracle: the XLA path has no
    window-size ceiling."""
    cfg = MvsConfig(patch_radius=radius, max_lod=4,
                    dist_weighting=radius / 3.0)
    _compare(scene_wide, cfg, lod=0)


def test_real_photo_rig_matches_oracle():
    from pais_mvs_tpu.data.realistic import make_realistic_scene
    rsc = make_realistic_scene(num_seeds=16, seed=0)
    cfg = MvsConfig(patch_radius=6, max_lod=4, dist_weighting=2.0)
    _compare(rsc, cfg, lod=0)
