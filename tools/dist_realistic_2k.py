"""2K-class distributed-expansion parity evidence: the SPMD expand path's realistic-photo parity had only been measured
on ~150-patch clouds at 640x480. This runs the SAME pawn-rig photo scene
rendered at scale x (640x480) through ``expand_distributed`` on the
virtual 8-device CPU mesh vs the host engine, and reports the same
relative gates the CI test uses (test_expand_distributed_realistic_parity
— the host's own order-sensitivity is the yardstick).

Run: JAX_PLATFORMS=cpu PYTHONPATH=. python \
         tools/dist_realistic_2k.py [--scale 3] [--seeds 300]
"""

import argparse
import json
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=3,
                    help="render at scale*(640x480); 3 -> 1920x1440")
    ap.add_argument("--seeds", type=int, default=300)
    ap.add_argument("--rounds", type=int, default=200)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    import numpy as np
    from pais_mvs_tpu.config import MvsConfig
    from pais_mvs_tpu.data.realistic import make_realistic_scene
    from pais_mvs_tpu.engine.reconstructor import Reconstructor
    from pais_mvs_tpu.oracle import cloud_agreement
    from pais_mvs_tpu.parallel.mesh import make_mesh

    t0 = time.time()
    sc = make_realistic_scene(num_seeds=args.seeds, seed=0,
                              scale=args.scale)
    print(f"scene: {args.scale}x pawn rig "
          f"({640 * args.scale}x{480 * args.scale}), "
          f"{len(sc.seed_centers)} seeds, gen {time.time() - t0:.1f}s",
          file=sys.stderr)

    cfg = MvsConfig(patch_radius=6, max_lod=6, particle_num=8,
                    max_iteration=12, dist_weighting=2.0,
                    cell_size=12, min_cam_num=3, max_cell_patch_num=2,
                    neighbor_radius_scalar=0.01, batch_size=256,
                    seed_refine_rounds=2, wavefront_size=256)

    def build():
        rec = Reconstructor(sc.params, sc.images, cfg, verbose=False)
        rec.load_seeds(sc.seed_centers, sc.seed_cam_masks,
                       sc.seed_img_points,
                       np.full((len(sc.seed_centers), 3), 128.0))
        rec.refine_seeds()
        return rec

    t0 = time.time()
    rec_h = build()
    rec_h.expand(max_rounds=args.rounds)
    hpts = rec_h.live_centers()
    t_h = time.time() - t0
    print(f"host: {len(hpts)} patches in {t_h:.0f}s", file=sys.stderr)

    t0 = time.time()
    rec_d = build()
    rec_d.expand_distributed(mesh=make_mesh((8, 1)),
                             max_rounds=args.rounds * 2, per_shard=64)
    dpts = rec_d.live_centers()
    t_d = time.time() - t0
    print(f"dist: {len(dpts)} patches in {t_d:.0f}s "
          f"(spilled {rec_d.stats.get('dist_spilled', 0)})",
          file=sys.stderr)

    d_h = float(np.median(sc.surface_distance(hpts)))
    d_d = float(np.median(sc.surface_distance(dpts)))
    depth = float(np.linalg.norm(sc.seed_centers.mean(0)
                                 - rec_h.np_center.mean(0)))
    half_cell = 0.5 * cfg.cell_size * depth / float(rec_h.np_focal[0, 0])
    ag = cloud_agreement(dpts, hpts, half_cell)
    out = {
        "scene": f"pawn-rig photo {args.scale}x "
                 f"({640 * args.scale}x{480 * args.scale})",
        "host_patches": int(len(hpts)),
        "dist_patches": int(len(dpts)),
        "host_median_dist": d_h,
        "dist_median_dist": d_d,
        "mutual_agreement": [round(ag["engine_within_tol"], 3),
                             round(ag["oracle_within_tol"], 3)],
        "count_ratio": round(len(dpts) / max(len(hpts), 1), 3),
        "host_wall_s": round(t_h, 1),
        "dist_wall_s": round(t_d, 1),
    }
    print(json.dumps(out))
    assert d_d < max(1.5 * d_h, 0.003), (d_d, d_h)
    assert min(ag["engine_within_tol"], ag["oracle_within_tol"]) >= 0.65, ag


if __name__ == "__main__":
    main()
