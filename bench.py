"""Benchmark: patch-refinement throughput on the pawn-shaped workload.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "patches/s", "vs_baseline": N,
   "device": {"platform", "kind", "count"}, ...}

Workload = the reference's default pawn configuration (README config.txt /
TMVS/TMVS.cpp:49-50): 5 cameras at 640x480, patchRadius 15 (961-px windows),
15 particles x 30 iterations with seed patches using 2x both. The metric is
end-to-end refined patches per second on one device through refine_batch —
PSO, photoconsistency, NCC visibility pruning, LOD selection and runtime
filtering included (more work per patch than the CPU baseline measures, so
the comparison is conservative).

vs_baseline divides by the sequential CPU oracle's patches/s
(baseline_cpu.json; pais_mvs_tpu/oracle.py — the reference publishes no
numbers, SURVEY.md §6). The bench times BENCH_BLOCKS independent blocks and
reports the median and interquartile range. It refuses to run without an
accelerator: a CPU number is not a device measurement.
"""

import json
import os
import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    from pais_mvs_tpu.cache import enable_persistent_cache
    from pais_mvs_tpu.config import MvsConfig
    from pais_mvs_tpu.data.synthetic import make_scene
    from pais_mvs_tpu.models import patch as patch_mod
    from pais_mvs_tpu.models.camera import build_scene
    from pais_mvs_tpu.ops import lifecycle as lc

    if jax.default_backend() == "cpu":
        sys.exit("bench: no accelerator found (JAX backend is cpu)")
    enable_persistent_cache()
    dev = jax.devices()[0]

    B = int(os.environ.get("BENCH_BATCH", "1024"))
    reps = int(os.environ.get("BENCH_REPS", "3"))
    nblocks = int(os.environ.get("BENCH_BLOCKS", "4"))

    # max_lod=6 keeps the pyramid stack + LOD-search unroll bounded (the
    # pawn workload's texture keeps patches at LOD 0-2 anyway)
    cfg = MvsConfig(particle_num=15, max_iteration=30, dist_weighting=5.0,
                    batch_size=B, max_lod=6)
    exit_chunk = int(os.environ.get("BENCH_EXIT_CHUNK", "-1"))
    if exit_chunk >= 0:
        cfg = cfg.replace(pso_exit_chunk=exit_chunk)
    sc = make_scene(num_cams=5, width=640, height=480, num_seeds=B + 64,
                    seed=0)
    scene = build_scene(sc.params, sc.images, cfg)
    print(f"device: {dev.device_kind} x{jax.device_count()}", file=sys.stderr)

    rng = np.random.default_rng(0)
    centers = sc.seed_centers[:B] + rng.normal(scale=0.01, size=(B, 3))
    pb = patch_mod.from_seeds(centers, sc.seed_cam_masks[:B],
                              sc.seed_img_points[:B])
    pb = lc.prepare_seeds(scene, cfg, pb)
    key = jax.random.PRNGKey(0)
    nr = jnp.float32(0.005)

    # compile + warm up (set-up time, reported apart from the rate)
    t0 = time.perf_counter()
    res = jax.block_until_ready(lc.refine_batch(scene, cfg, pb, key, nr,
                                                True, 1))
    compile_s = time.perf_counter() - t0
    print(f"compile+first run: {compile_s:.1f}s", file=sys.stderr)

    # REAL-imagery quality gate on the device: the pawn-rig photo scene
    # catches precision and warp-clipping error classes the synthetic
    # scene is blind to. Its texture is matplotlib's sample photograph;
    # where matplotlib is missing the gate is reported as not run.
    realistic_ok = True
    racc, Br, rmed, rsc = None, None, None, None
    if os.environ.get("BENCH_REALISTIC", "1") != "0":
        from pais_mvs_tpu.data.realistic import make_realistic_scene
        try:
            rsc = make_realistic_scene(num_seeds=128, seed=0)
        except RuntimeError as e:
            print(f"realistic gate not run: {e}", file=sys.stderr)
    if rsc is not None:
        rcfg = MvsConfig(patch_radius=6, max_lod=4, particle_num=8,
                         max_iteration=12, dist_weighting=2.0, cell_size=12,
                         min_cam_num=3, batch_size=128)
        rscene = build_scene(rsc.params, rsc.images, rcfg)
        Br = (len(rsc.seed_centers) // 8) * 8
        rpb = patch_mod.from_seeds(rsc.seed_centers[:Br],
                                   rsc.seed_cam_masks[:Br],
                                   rsc.seed_img_points[:Br])
        rpb = lc.prepare_seeds(rscene, rcfg, rpb)
        rres = lc.refine_batch(rscene, rcfg, rpb, jax.random.PRNGKey(3),
                               jnp.float32(0.01), True, 2)
        rkeep = np.asarray(rres.batch.valid)
        rd = (rsc.surface_distance(np.asarray(rres.batch.center)[rkeep])
              if rkeep.any() else np.array([np.inf]))
        rmed = float(np.median(rd))
        racc = int(rkeep.sum())
        realistic_ok = racc > 0.4 * Br and rmed < 2.5e-3
        print(f"realistic gate: {racc}/{Br} seeds, median "
              f"surface dist {rmed:.5f} -> "
              f"{'ok' if realistic_ok else 'FAIL'}", file=sys.stderr)

    def timed_block(i0):
        t0 = time.perf_counter()
        for i in range(reps):
            r = lc.refine_batch(scene, cfg, pb,
                                jax.random.fold_in(key, i0 + i), nr, True, 1)
        jax.block_until_ready(r)
        return B * reps / (time.perf_counter() - t0), r

    timed_block(10_000)                     # untimed re-warm block
    pps_blocks = []
    for k in range(nblocks):
        v, res = timed_block(k * reps)
        pps_blocks.append(v)
    pps = float(np.median(pps_blocks))
    iqr = [float(np.percentile(pps_blocks, 25)),
           float(np.percentile(pps_blocks, 75))]
    print(f"blocks: {pps_blocks}", file=sys.stderr)

    # sanity: the result must actually be a reconstruction, not garbage
    keep = np.asarray(res.batch.valid)
    d = sc.surface_distance(np.asarray(res.batch.center)[keep]) if \
        keep.any() else np.array([np.inf])
    print(f"accepted {keep.sum()}/{B}, median surface dist "
          f"{np.median(d):.5f}", file=sys.stderr)
    quality_ok = keep.sum() > B * 0.5 and np.median(d) < 0.003 \
        and realistic_ok

    # no silent fallback: a missing/corrupt baseline file must fail loudly
    with open(os.path.join(os.path.dirname(__file__),
                           "baseline_cpu.json")) as f:
        cpu_pps = json.load(f)["value"]

    stats = dev.memory_stats() or {}
    print(json.dumps({
        "metric": "pawn-shaped dense-recon patch refinement throughput"
                  + ("" if quality_ok else " [QUALITY CHECK FAILED]"),
        "value": pps,
        "unit": "patches/s",
        "vs_baseline": pps / cpu_pps,
        "iqr": iqr,
        "blocks": nblocks,
        "compile_s": compile_s,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "realistic_accept": None if racc is None else [racc, Br],
        "realistic_median_dist": rmed,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": jax.device_count()},
    }))


if __name__ == "__main__":
    main()
