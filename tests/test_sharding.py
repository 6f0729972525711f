"""SPMD execution on a virtual 8-device CPU mesh: sharded fitness must
match the single-device kernel, and the full sharded PSO step must run and
improve patches."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pais_mvs_tpu.config import MvsConfig
from pais_mvs_tpu.data.synthetic import make_scene
from pais_mvs_tpu.models.camera import build_scene
from pais_mvs_tpu.ops import fitness as F
from pais_mvs_tpu.ops import geometry as geom
from pais_mvs_tpu.parallel import mesh as mesh_mod
from pais_mvs_tpu.parallel.sharded import sharded_pso_refine


@pytest.fixture(scope="module")
def setup():
    assert jax.device_count() >= 8, "conftest must provide 8 CPU devices"
    sc = make_scene(num_cams=4, width=160, height=120, num_seeds=40)
    cfg = MvsConfig(patch_radius=4, max_lod=3, particle_num=6,
                    max_iteration=8, dist_weighting=4 / 3.0)
    scene = build_scene(sc.params, sc.images, cfg)
    return sc, cfg, scene


def _problem(sc, scene, B):
    rig = scene.rig
    centers = sc.seed_centers[:B].astype(np.float32)
    ref = np.full(B, 1, dtype=np.int32)
    rays = centers - np.asarray(rig.center)[ref]
    depths = np.linalg.norm(rays, axis=-1)
    rays = (rays / depths[:, None]).astype(np.float32)
    n0 = np.asarray(geom.estimated_normal(
        jnp.asarray(centers), rig.center[None].repeat(B, 0),
        jnp.ones((B, 4), bool)))
    sph = np.asarray(geom.normal_to_spherical(jnp.asarray(n0)))
    lo = np.stack([np.zeros(B), sph[:, 1] - np.pi / 2, depths - 0.1],
                  -1).astype(np.float32)
    hi = np.stack([np.full(B, np.pi), sph[:, 1] + np.pi / 2, depths + 0.1],
                  -1).astype(np.float32)
    init = np.stack([sph[:, 0], sph[:, 1], depths], -1).astype(np.float32)
    return ref, rays, depths, lo, hi, init


def test_sharded_pso_matches_quality_and_runs_2d(setup):
    """2-D mesh (4 patch x 2 view): runs, and results land on the surface."""
    sc, cfg, scene = setup
    B = 16
    ref, rays, depths, lo, hi, init = _problem(sc, scene, B)
    mesh = mesh_mod.make_mesh((4, 2))
    res = sharded_pso_refine(
        scene.rig, scene.pyramids.images, scene.pyramids.edges,
        scene.pyramids.dims, scene.pyramids.yoff, cfg,
        jnp.asarray(ref), jnp.ones((B, 4), bool),
        jnp.zeros(B, dtype=jnp.int32), jnp.asarray(rays),
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(init),
        jax.random.PRNGKey(0), mesh, cfg.particle_num, cfg.max_iteration)
    g = np.asarray(res.gbest)
    fits = np.asarray(res.gbest_fit)
    assert np.all(np.isfinite(fits)) and np.all(fits < 1e20)
    new_centers = rays * g[:, 2:3] + np.asarray(scene.rig.center)[ref]
    d = sc.surface_distance(new_centers)
    assert np.median(d) < 0.01


def test_sharded_fitness_equals_single_device(setup):
    """The psum-composed view-sharded fitness must equal the reference jnp
    kernel on identical candidates."""
    sc, cfg, scene = setup
    B, P = 8, 5
    ref, rays, depths, lo, hi, init = _problem(sc, scene, B)
    rng = np.random.default_rng(0)
    pos = np.stack([
        rng.uniform(0.3, 2.8, size=(B, P)),
        rng.uniform(-2, 2, size=(B, P)),
        depths[:, None] + rng.uniform(-0.05, 0.05, size=(B, P)),
    ], axis=-1).astype(np.float32)
    cam_mask = jnp.ones((B, 4), bool)
    lod = jnp.zeros(B, dtype=jnp.int32)

    single = F.patch_fitness(scene, cfg, jnp.asarray(ref), cam_mask, lod,
                             jnp.asarray(rays), jnp.asarray(pos))

    from pais_mvs_tpu.ops.view_fitness import fitness_view_jnp
    from jax.sharding import PartitionSpec as Sp
    mesh = mesh_mod.make_mesh((2, 4))  # 4-way view sharding (1 cam each)

    def body(rig, img, edg, dims, yo, ref_c, cm, ld, ry, ps):
        return fitness_view_jnp(rig, img, edg, dims, yo, cfg, 1,
                                ref_c, cm, ld, ry, ps, "view")
    f = jax.shard_map(
        body, mesh=mesh,
        in_specs=(Sp(), Sp("view"), Sp("view"), Sp(), Sp(),
                  Sp("patch"), Sp("patch"), Sp("patch"), Sp("patch"),
                  Sp("patch")),
        out_specs=Sp("patch"), check_vma=False)
    sharded = f(scene.rig, scene.pyramids.images, scene.pyramids.edges,
                scene.pyramids.dims, scene.pyramids.yoff, jnp.asarray(ref),
                cam_mask, lod, jnp.asarray(rays), jnp.asarray(pos))
    a = np.asarray(single)
    b = np.asarray(sharded)
    big = a >= 1e20
    np.testing.assert_array_equal(big, b >= 1e20)
    np.testing.assert_allclose(b[~big], a[~big], rtol=2e-4, atol=1e-4)


def test_patch_sharded_refine_batch_runs(setup):
    """The engine's refine_batch jit runs with a patch-sharded input batch
    (pure data parallelism via GSPMD propagation)."""
    sc, cfg, scene = setup
    from pais_mvs_tpu.models import patch as patch_mod
    from pais_mvs_tpu.ops import lifecycle as lc
    B = 16
    pb = patch_mod.from_seeds(sc.seed_centers[:B], sc.seed_cam_masks[:B],
                              sc.seed_img_points[:B])
    pb = lc.prepare_seeds(scene, cfg, pb)
    mesh = mesh_mod.make_mesh((8, 1))
    pb = mesh_mod.shard_patch_batch(pb, mesh)
    scene_r = mesh_mod.replicate_scene(scene, mesh)
    res = lc.refine_batch(scene_r, cfg, pb, jax.random.PRNGKey(1),
                          jnp.float32(0.005), True, 1)
    keep = np.asarray(res.batch.valid)
    assert keep.sum() >= B * 0.6
    d = sc.surface_distance(np.asarray(res.batch.center)[keep])
    assert np.median(d) < 0.01
