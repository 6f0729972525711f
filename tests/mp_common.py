"""Shared problem definition for the multi-process distributed test:
the SAME code runs in the 2-process workers (over the cross-process global
mesh) and in the single-process reference (8 local devices), so any result
difference isolates the process boundary itself."""

import numpy as np


def build_problem(view: bool = False):
    """Deterministic scene + frontier packing, identical in every process.

    ``view=True`` builds the (4, 2) patch x view variant with the mesh
    devices INTERLEAVED so each view pair holds one device from EACH
    process — the view-axis psums (fitness mean/SAD/validity, ownership
    routing) then cross the DCN-style process boundary, which the flat
    (8, 1) variant never exercises. Every view-axis collective here has
    exactly 2 summands, so cross-process reduction order cannot change
    the bits and the single-process comparison stays exact."""
    import jax
    import jax.numpy as jnp
    from pais_mvs_tpu.config import MvsConfig
    from pais_mvs_tpu.data.synthetic import make_scene
    from pais_mvs_tpu.models import patch as patch_mod
    from pais_mvs_tpu.models.camera import build_scene
    from pais_mvs_tpu.ops import geometry as geom
    from pais_mvs_tpu.ops import lifecycle as lc
    from pais_mvs_tpu.parallel.mesh import make_mesh

    S = 4 if view else 8
    cfg = MvsConfig(patch_radius=4, max_lod=3, particle_num=6,
                    max_iteration=6, dist_weighting=4 / 3.0, cell_size=10,
                    visible_correlation=0.7, min_cam_num=3)
    sc = make_scene(num_cams=4, width=160, height=120, num_seeds=64, seed=5)
    scene = build_scene(sc.params, sc.images, cfg)
    C = 4

    # make_scene can yield fewer visible seeds than requested — clip to a
    # multiple of the mesh size so the patch axis shards evenly
    B = (len(sc.seed_centers) // S) * S
    pb = patch_mod.from_seeds(sc.seed_centers[:B], sc.seed_cam_masks[:B],
                              sc.seed_img_points[:B])
    pb = lc.prepare_seeds(scene, cfg, pb)
    pb = jax.device_get(pb)

    cam_cells = np.stack(
        [np.asarray([-(-160 // cfg.cell_size)] * C, np.int32),
         np.asarray([-(-120 // cfg.cell_size)] * C, np.int32)], -1)
    gh = int(cam_cells[:, 1].max())
    slab = max(1, -(-int(cam_cells[:, 0].max()) // S))

    def mesh_fn():
        import numpy as _np
        if not view:
            return make_mesh((S, 1))
        devs = sorted(jax.devices(), key=lambda d: d.id)   # process-major
        inter = _np.asarray(devs).reshape(2, 4).T.reshape(-1)  # interleave
        return make_mesh((S, 2), list(inter))

    return dict(cfg=cfg, scene=scene, pb=pb, cam_cells=cam_cells,
                gh=gh, slab=slab, S=S, C=C, view=view, mesh_fn=mesh_fn)


def run_sharded(prob, mesh, to_global, make_global=None):
    """(a) patch-sharded refine over the mesh; (b) one expand_step round
    from the refined frontier. Returns name -> GLOBAL jax array.

    ``make_global(x, spec)`` places an array with an arbitrary
    PartitionSpec on the global mesh (needed by the view=True variant to
    shard the pyramid atlases over the view axis; callers that only run
    the flat variant may omit it)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from pais_mvs_tpu.ops import geometry as geom
    from pais_mvs_tpu.ops import lifecycle as lc
    from pais_mvs_tpu.parallel.expansion import expand_step, OCC_STATE_F
    from pais_mvs_tpu.parallel.mesh import PATCH_AXIS, VIEW_AXIS, \
        scene_view_specs

    cfg, scene, pb = prob["cfg"], prob["scene"], prob["pb"]
    S, C, gh, slab = prob["S"], prob["C"], prob["gh"], prob["slab"]
    view = prob.get("view", False)

    pb_g = jax.tree.map(to_global, pb)
    spec = jax.tree.map(lambda _: P(PATCH_AXIS), pb)

    if view:
        # place the WHOLE scene on the global mesh: big atlases sharded
        # over the view axis, small leaves replicated — expand_step's
        # shard_map then consumes it without any cross-process reshard
        sspec = scene_view_specs(scene)
        scene_g = jax.tree.map(lambda x, sp: make_global(x, sp),
                               scene, sspec)

        def body(sc_l, pbs, nr):
            k = jax.random.fold_in(jax.random.PRNGKey(0),
                                   jax.lax.axis_index(PATCH_AXIS))
            return lc.refine_batch(sc_l, cfg, pbs, k, nr, True, 1,
                                   view_axis=VIEW_AXIS)

        fn = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(sspec, spec, P()),
            out_specs=lc.RefineResult(spec, P(PATCH_AXIS)),
            check_vma=False))
        res = fn(scene_g, pb_g, jnp.float32(0.01))
    else:
        scene_g = scene

        def body(pbs, nr):
            k = jax.random.fold_in(jax.random.PRNGKey(0),
                                   jax.lax.axis_index(PATCH_AXIS))
            return lc.refine_batch(scene, cfg, pbs, k, nr, True, 1)

        fn = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(spec, P()),
            out_specs=lc.RefineResult(spec, P(PATCH_AXIS)),
            check_vma=False))
        res = fn(pb_g, jnp.float32(0.01))
    rb = res.batch

    # frontier packing from the refined batch (deterministic, replicated):
    # identity packing — row t of the refine output is parent t
    per = rb.center.shape[0] // S
    normals = geom.spherical_to_normal(rb.normal_sph)
    orank = jnp.arange(rb.center.shape[0], dtype=jnp.float32)

    occ = to_global(np.zeros((S * slab, C * gh), np.int32))
    ost = to_global(np.zeros((S * slab, C * gh, 2, OCC_STATE_F), np.float32))
    out_pb, accepted, occ2, ost2, spilled, _sp_par, _rc = expand_step(
        scene_g, cfg, rb.center, normals, orank, rb.valid, rb.cam_mask,
        occ, ost, jnp.asarray(prob["cam_cells"]), 0.01,
        jax.random.PRNGKey(1), mesh, slab, gh, cap_per=2, refine_budget=32)

    return {
        "refined_center": rb.center, "refined_valid": res.batch.valid,
        "refined_fitness": rb.fitness,
        "exp_center": out_pb.center, "exp_accepted": accepted,
        "occ2": occ2,
    }
