"""Scaling measurement: refined patches/s at 1..N local devices.

Refined patches/s and scaling efficiency at every attached device count,
by re-running the data-parallel refine over sub-meshes (one GPU gives a
single point; a four-GPU host prints the whole curve). Prints one JSON
line per device count.

Usage:  python bench_scaling.py            (real devices)
        JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
            python bench_scaling.py        (virtual-mesh smoke run; the
            numbers are NOT hardware scaling, just a correctness drive)
"""

import json
import os
import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from pais_mvs_tpu.config import MvsConfig
    from pais_mvs_tpu.data.synthetic import make_scene
    from pais_mvs_tpu.models import patch as patch_mod
    from pais_mvs_tpu.models.camera import build_scene
    from pais_mvs_tpu.ops import lifecycle as lc

    from pais_mvs_tpu.cache import enable_persistent_cache
    enable_persistent_cache()

    sync = jax.block_until_ready

    devices = jax.devices()
    per_dev = int(os.environ.get("BENCH_PER_DEVICE", "512"))
    cfg0 = MvsConfig(particle_num=15, max_iteration=30, dist_weighting=5.0,
                     max_lod=6)
    sc = make_scene(num_cams=5, width=640, height=480,
                    num_seeds=per_dev * len(devices) + 64, seed=0)
    rng = np.random.default_rng(0)

    base_pps = None
    for n in range(1, len(devices) + 1):
        B = per_dev * n
        cfg = cfg0.replace(batch_size=B)
        scene = build_scene(sc.params, sc.images, cfg)
        centers = sc.seed_centers[:B] + rng.normal(scale=0.01, size=(B, 3))
        pb = patch_mod.from_seeds(centers, sc.seed_cam_masks[:B],
                                  sc.seed_img_points[:B])
        pb = lc.prepare_seeds(scene, cfg, pb)
        nr = jnp.float32(0.005)
        key = jax.random.PRNGKey(0)

        mesh = Mesh(np.array(devices[:n]), ("dp",))

        def body(pbs, k):
            kk = jax.random.fold_in(k, jax.lax.axis_index("dp"))
            return lc.refine_batch(scene, cfg, pbs, kk, nr, True, 1)

        f = jax.jit(jax.shard_map(
            body, mesh=mesh,
            in_specs=(jax.tree.map(lambda _: P("dp"), pb), P()),
            out_specs=lc.RefineResult(
                jax.tree.map(lambda _: P("dp"), pb), P("dp")),
            check_vma=False))
        res = f(pb, key)
        sync(res.batch.fitness)
        t0 = time.time()
        reps = 2
        for i in range(reps):
            res = f(pb, jax.random.fold_in(key, i))
        sync(res.batch.fitness)
        dt = time.time() - t0
        pps = B * reps / dt
        if base_pps is None:
            base_pps = pps
        eff = pps / (base_pps * n)
        print(json.dumps({
            "metric": "dp-refine throughput",
            "devices": n, "value": round(pps, 2),
            "unit": "patches/s", "scaling_efficiency": round(eff, 3)}))

    _view_sharded_curve(per_dev)
    _distributed_expansion_curve(per_dev)


def _view_sharded_curve(per_dev: int):
    """sharded_pso_refine: pyramids sharded over the VIEW axis, fitness
    psum-reduced across view shards (the memory-scaling path)."""
    import jax
    import jax.numpy as jnp
    from pais_mvs_tpu.config import MvsConfig
    from pais_mvs_tpu.data.synthetic import make_scene
    from pais_mvs_tpu.models.camera import build_scene
    from pais_mvs_tpu.ops import geometry as geom
    from pais_mvs_tpu.parallel import mesh as mesh_mod
    from pais_mvs_tpu.parallel.sharded import sharded_pso_refine

    sync = jax.block_until_ready

    devices = jax.devices()
    C = 4
    cfg = MvsConfig(particle_num=15, max_iteration=30, dist_weighting=5.0,
                    max_lod=6)
    sc = make_scene(num_cams=C, width=640, height=480,
                    num_seeds=per_dev * len(devices) + 64, seed=0)
    scene = build_scene(sc.params, sc.images, cfg)
    base = None
    for n in range(1, len(devices) + 1):
        vp = 2 if (n % 2 == 0 and C % 2 == 0) else 1
        dp = n // vp
        B = per_dev * dp
        mesh = mesh_mod.make_mesh((dp, vp), devices[:n])
        centers = sc.seed_centers[:B].astype(np.float32)
        ref = np.full(B, 1, np.int32)
        rays = centers - np.asarray(scene.rig.center)[ref]
        depths = np.linalg.norm(rays, axis=-1)
        rays = (rays / depths[:, None]).astype(np.float32)
        import jax.numpy as jnp
        n0 = np.asarray(geom.estimated_normal(
            jnp.asarray(centers), scene.rig.center[None].repeat(B, 0),
            jnp.ones((B, C), bool)))
        sph = np.asarray(geom.normal_to_spherical(jnp.asarray(n0)))
        lo = np.stack([np.zeros(B), sph[:, 1] - np.pi / 2, depths - 0.02],
                      -1).astype(np.float32)
        hi = np.stack([np.full(B, np.pi), sph[:, 1] + np.pi / 2,
                       depths + 0.02], -1).astype(np.float32)
        init = np.stack([sph[:, 0], sph[:, 1], depths],
                        -1).astype(np.float32)

        def run(k):
            return sharded_pso_refine(
                scene.rig, scene.pyramids.images, scene.pyramids.edges,
                scene.pyramids.dims, scene.pyramids.yoff, cfg,
                jnp.asarray(ref), jnp.ones((B, C), bool),
                jnp.zeros(B, jnp.int32), jnp.asarray(rays),
                jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(init),
                k, mesh, cfg.particle_num, cfg.max_iteration)
        res = run(jax.random.PRNGKey(0))
        sync(res.gbest_fit)
        t0 = time.time()
        reps = 2
        for i in range(reps):
            res = run(jax.random.PRNGKey(i))
        sync(res.gbest_fit)
        dt = time.time() - t0
        pps = B * reps / dt
        if base is None:
            base = pps
        # psum traffic: one [B_local, P] fitness reduction per PSO iteration
        psum_bytes = (B // max(dp, 1)) * cfg.particle_num * 4 \
            * (cfg.max_iteration + 1) * max(vp - 1, 0)
        print(json.dumps({
            "metric": "view-sharded pso refine", "devices": n,
            "mesh": [dp, vp], "value": round(pps, 2), "unit": "patches/s",
            "scaling_efficiency": round(pps / (base * n), 3),
            "psum_bytes_per_call_per_shard": psum_bytes}))


def _distributed_expansion_curve(per_dev: int):
    """Multi-round parallel.expansion.expand_step: the full SPMD expansion
    path (all-view candidates -> all_gather routing -> three-clause
    skipNeighborCell -> refine -> insert-time re-check)."""
    import jax
    import jax.numpy as jnp
    from pais_mvs_tpu.config import MvsConfig
    from pais_mvs_tpu.data.synthetic import make_scene
    from pais_mvs_tpu.engine.reconstructor import Reconstructor
    from pais_mvs_tpu.parallel import mesh as mesh_mod

    devices = jax.devices()
    rounds = int(os.environ.get("BENCH_EXP_ROUNDS", "3"))
    per_shard = int(os.environ.get("BENCH_EXP_PER_SHARD", "64"))
    base = None
    for n in range(1, len(devices) + 1):
        cfg = MvsConfig(patch_radius=6, max_lod=4, particle_num=8,
                        max_iteration=10, dist_weighting=2.0, cell_size=10,
                        min_cam_num=3, batch_size=256,
                        seed_refine_rounds=1)
        sc = make_scene(num_cams=4, width=320, height=240,
                        num_seeds=per_shard * n, seed=1)
        rec = Reconstructor(sc.params, sc.images, cfg, verbose=False)
        rec.load_seeds(sc.seed_centers, sc.seed_cam_masks,
                       sc.seed_img_points,
                       np.full((len(sc.seed_centers), 3), 128.0))
        rec.refine_seeds()
        mesh = mesh_mod.make_mesh((n, 1), devices[:n])
        t0 = time.time()
        rec.expand_distributed(mesh=mesh, max_rounds=rounds,
                               per_shard=per_shard)
        dt = time.time() - t0
        inserted = rec.stats.get("dist_inserted", 0)
        rps = inserted / dt if dt > 0 else 0.0
        if base is None:
            base = max(rps, 1e-9)
        # all_gather traffic per round per shard: candidate payload rows
        # (S x 4*per_shard*C rows x (8 + C) f32 + cols/rows/flags) plus the
        # insert-metadata gather (S x refine_budget x ~(3C + 12) f32)
        Ccams = 4
        gather_bytes = n * 4 * per_shard * Ccams * (11 + Ccams) * 4 \
            + n * 8 * per_shard * (3 * Ccams + 12) * 4
        print(json.dumps({
            "metric": "distributed expansion", "devices": n,
            "rounds": rounds, "inserted": int(inserted),
            "value": round(rps, 2), "unit": "accepted patches/s",
            "scaling_efficiency": round(rps / (base * n), 3),
            "allgather_bytes_per_round_per_shard": gather_bytes}))


def _multiprocess(per_dev: int):
    """--multiprocess: spawn jax.distributed worker PROCESSES on the CPU
    backend (4 virtual devices each) and measure the patch-dp refine over
    the joined global mesh, vs a 1-process run with the same total device
    count. On one machine this exercises the DCN-style process boundary
    (gloo collectives, cross-process global arrays); on a real pod the
    same flags measure true multi-host scaling."""
    import socket
    import subprocess

    def free_port():
        s = socket.socket()
        s.bind(("localhost", 0))
        p = s.getsockname()[1]
        s.close()
        return p

    here = os.path.abspath(__file__)
    results = {}
    for nproc, per_proc in ((1, 8), (2, 4)):
        port = free_port()
        env = dict(os.environ)
        env["PYTHONPATH"] = os.path.dirname(here) + os.pathsep + \
            env.get("PYTHONPATH", "")
        env.pop("XLA_FLAGS", None)
        procs = [subprocess.Popen(
            [sys.executable, here, "--mp-worker", str(pid), str(nproc),
             str(per_proc), str(port), str(per_dev)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for pid in range(nproc)]
        outs = [p.communicate(timeout=1800)[0] for p in procs]
        for p, out in zip(procs, outs):
            if p.returncode != 0:
                print(out[-2000:], file=sys.stderr)
                raise SystemExit("multiprocess worker failed")
        for line in outs[0].splitlines():
            if line.startswith("MPRESULT "):
                results[nproc] = json.loads(line[len("MPRESULT "):])
    eff = results[2]["value"] / max(results[1]["value"], 1e-9)
    print(json.dumps({
        "metric": "multi-process dp-refine (2 procs x 4 CPU devs vs "
                  "1 proc x 8)",
        "value": results[2]["value"], "unit": "patches/s",
        "single_process": results[1]["value"],
        "scaling_efficiency_vs_1proc": round(eff, 3)}))


def _mp_worker(pid: int, nproc: int, per_proc: int, port: int,
               per_dev: int):
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", per_proc)
    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass
    if nproc > 1:
        from pais_mvs_tpu.parallel.distributed import init_distributed
        assert init_distributed(f"localhost:{port}", nproc, pid)

    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from pais_mvs_tpu.config import MvsConfig
    from pais_mvs_tpu.data.synthetic import make_scene
    from pais_mvs_tpu.models import patch as patch_mod
    from pais_mvs_tpu.models.camera import build_scene
    from pais_mvs_tpu.ops import lifecycle as lc

    devices = jax.devices()
    n = len(devices)
    B = per_dev * n
    cfg = MvsConfig(particle_num=15, max_iteration=30, dist_weighting=5.0,
                    max_lod=6, batch_size=B)
    sc = make_scene(num_cams=5, width=640, height=480, num_seeds=B + 64,
                    seed=0)
    scene = build_scene(sc.params, sc.images, cfg)
    rng = np.random.default_rng(0)
    centers = sc.seed_centers[:B] + rng.normal(scale=0.01, size=(B, 3))
    pb = patch_mod.from_seeds(centers, sc.seed_cam_masks[:B],
                              sc.seed_img_points[:B])
    pb = jax.device_get(lc.prepare_seeds(scene, cfg, pb))
    mesh = Mesh(np.array(devices), ("dp",))

    def to_global(x):
        x = np.asarray(x)
        sh = NamedSharding(mesh, P("dp", *([None] * (x.ndim - 1))))
        return jax.make_array_from_callback(x.shape, sh, lambda i: x[i])

    pb_g = jax.tree.map(to_global, pb)

    def body(pbs, k):
        kk = jax.random.fold_in(k, jax.lax.axis_index("dp"))
        return lc.refine_batch(scene, cfg, pbs, kk, jnp.float32(0.005),
                               True, 1)

    spec = jax.tree.map(lambda _: P("dp"), pb)
    f = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(spec, P()),
        out_specs=lc.RefineResult(spec, P("dp")), check_vma=False))
    res = f(pb_g, jax.random.PRNGKey(0))
    jax.block_until_ready(res.batch.fitness)
    t0 = time.time()
    reps = 2
    for i in range(reps):
        res = f(pb_g, jax.random.PRNGKey(i))
    jax.block_until_ready(res.batch.fitness)
    dt = time.time() - t0
    if pid == 0:
        print("MPRESULT " + json.dumps({
            "processes": nproc, "devices": n * nproc // max(nproc, 1) * 1,
            "value": round(B * reps / dt, 2), "unit": "patches/s"}))


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--mp-worker":
        _mp_worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                   int(sys.argv[5]), int(sys.argv[6]))
    elif "--multiprocess" in sys.argv:
        per_dev = int(os.environ.get("BENCH_PER_DEVICE", "128"))
        _multiprocess(per_dev)
    else:
        main()
