"""Command-line driver, mirroring the reference TMVS modes
(TMVS/TMVS.cpp:174-203):

  python -m pais_mvs_tpu.cli -r scene.nvm[.nvm2|.mvs]   reconstruction
  python -m pais_mvs_tpu.cli -f scene.mvs               post-filtering
  python -m pais_mvs_tpu.cli -v scene.mvs               snapshot "viewer"

Config resolution matches the reference: compiled defaults
(TMVS.cpp:26-52) overridden by ./config.txt if present (TMVS.cpp:178),
re-applied after an .mvs load (TMVS.cpp:92). Staged artifacts
(init/seed/exp.mvs, exp.ply, exp.psr, PMVS/PCMVS filter dumps) keep the
reference's names so downstream tooling is drop-in.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from pais_mvs_tpu.config import MvsConfig, load_config_txt
from pais_mvs_tpu.engine.reconstructor import Reconstructor
from pais_mvs_tpu.io import nvm as nvm_io
from pais_mvs_tpu.io import mvsbin
from pais_mvs_tpu.io.images import read_image
from pais_mvs_tpu.io.pointcloud import write_ply

CONFIG_FILE_NAME = "config.txt"


def _load_images(params, base_dir):
    images = []
    for p in params:
        path = p.file_name
        if not os.path.isabs(path):
            path = os.path.join(base_dir, path)
        images.append(read_image(path))
    return images


def _resolve_config(base: MvsConfig | None = None) -> MvsConfig:
    cfg = base or MvsConfig()
    if os.path.exists(CONFIG_FILE_NAME):
        cfg = load_config_txt(CONFIG_FILE_NAME, cfg)
    return cfg


def _refine_poses(params, images, centers, cam_masks, img_points):
    """Pose-refinement bundle adjustment over the SfM tracks before dense
    reconstruction (new scope vs the reference, which trusts VisualSFM
    poses as-is). Returns (params, centers) updated in place."""
    import jax.numpy as jnp
    from pais_mvs_tpu.data.synthetic import rotation_to_quaternion
    from pais_mvs_tpu.models.camera import _np_quat_to_rotation
    from pais_mvs_tpu.ops.bundle import BaProblem, bundle_adjust

    C = len(params)
    Rs, cs, fs, pps = [], [], [], []
    for i, p in enumerate(params):
        Rs.append(_np_quat_to_rotation(np.asarray(p.quaternion, float)))
        cs.append(np.asarray(p.center, float))
        fs.append(np.asarray(p.focal, float))
        pp = np.asarray(p.principal, float)
        if pp[0] < 0 and pp[1] < 0:
            h, w = images[i].shape[:2]
            pp = np.array([w >> 1, h >> 1], dtype=float)
        pps.append(pp)
    prob = BaProblem(
        R=jnp.asarray(np.stack(Rs), jnp.float32),
        center=jnp.asarray(np.stack(cs), jnp.float32),
        focal=jnp.asarray(np.stack(fs), jnp.float32),
        principal=jnp.asarray(np.stack(pps), jnp.float32),
        points=jnp.asarray(centers, jnp.float32),
        obs=jnp.asarray(img_points, jnp.float32),
        mask=jnp.asarray(cam_masks))
    res = bundle_adjust(prob, num_iters=8)
    h = np.asarray(res.rms_history)
    print(f"pose refinement: reprojection RMS {h[0]:.3f} -> {h[-1]:.3f} px")
    Rn = np.asarray(res.R, dtype=float)
    cn = np.asarray(res.center, dtype=float)
    for i, p in enumerate(params):
        p.quaternion = rotation_to_quaternion(Rn[i])
        p.center = cn[i]
    return params, np.asarray(res.points, dtype=float)


def _cam_principal(cam, img) -> np.ndarray:
    """Principal point with the reference's image-center fallback for
    unset (-1, -1) NVM principals."""
    if cam.principal[0] < 0 and cam.principal[1] < 0:
        return np.array([img.shape[1] >> 1, img.shape[0] >> 1], float)
    return np.asarray(cam.principal, float)


def _pinhole_points(cameras, images, ipts: np.ndarray,
                    cfg: MvsConfig) -> np.ndarray:
    """Undistort per-camera pixel measurements when applyDistortion is set
    (the engine runs pure pinhole; build_scene undistorts the images)."""
    if not cfg.apply_distortion:
        return ipts
    from pais_mvs_tpu.models.camera import undistort_points
    ipts = np.array(ipts, dtype=float, copy=True)
    for ci, (cam, img) in enumerate(zip(cameras, images)):
        if abs(float(cam.radial_distortion)) < 1e-12:
            continue
        ipts[:, ci] = undistort_points(
            ipts[:, ci], cam.focal, _cam_principal(cam, img),
            float(cam.radial_distortion))
    return ipts


def _pinhole_images(cameras, images, cfg: MvsConfig):
    """Undistorted copies of the input images when applyDistortion is set
    (for host-side consumers like feature seeding that must see the same
    pinhole imagery the engine samples)."""
    if not cfg.apply_distortion:
        return images
    from pais_mvs_tpu.models.camera import undistort_image
    return [undistort_image(img, cam.focal, _cam_principal(cam, img),
                            float(cam.radial_distortion))
            if abs(float(cam.radial_distortion)) >= 1e-12 else img
            for cam, img in zip(cameras, images)]


def _build_reconstructor(path: str, out_dir: str,
                         refine_poses: bool = False) -> Reconstructor:
    from pais_mvs_tpu.io.logmanager import LogManager
    logger = LogManager(os.path.join(out_dir, "log.txt"))
    ext = path.rsplit(".", 1)[-1].lower()
    base_dir = os.path.dirname(os.path.abspath(path))
    if ext in ("nvm", "nvm2"):
        data = nvm_io.load_nvm(path, nvm2=(ext == "nvm2"))
        cfg = _resolve_config()
        images = _load_images(data.cameras, base_dir)
        if refine_poses and len(data.centers):
            widths = [img.shape[1] for img in images]
            heights = [img.shape[0] for img in images]
            ipts = nvm_io.decenter_image_points(data, widths, heights)
            # bundle adjustment is pure pinhole: measurements from a
            # distorted NVM must be undistorted first
            ipts = _pinhole_points(data.cameras, images, ipts, cfg)
            _, new_pts = _refine_poses(data.cameras, images, data.centers,
                                       data.cam_masks, ipts)
            data.centers = new_pts
        elif refine_poses:
            logger.warning("--refine-poses ignored: the NVM has no sparse "
                           "tracks to bundle-adjust over")
        rec = Reconstructor(data.cameras, images, cfg, logger=logger)
        if len(data.centers):
            widths = [img.shape[1] for img in images]
            heights = [img.shape[0] for img in images]
            ipts = nvm_io.decenter_image_points(data, widths, heights)
            ipts = _pinhole_points(data.cameras, images, ipts, cfg)
            rec.load_seeds(data.centers, data.cam_masks, ipts, data.colors)
        else:
            # no sparse points in the NVM: feature-match our own seeds
            # (reference FeatureManager fallback, TMVS.cpp:98-103,
            # epipolar tolerance 3.0 px). Detection must run on the SAME
            # pinhole imagery the engine uses — undistort first when
            # applyDistortion is set (build_scene undistorts its copies).
            from pais_mvs_tpu.features import generate_seed_patches
            centers, cam_masks, s_ipts, colors = generate_seed_patches(
                data.cameras, _pinhole_images(data.cameras, images, cfg),
                cfg, max_epipolar_dist=3.0)
            if len(centers):
                rec.load_seeds(centers, cam_masks, s_ipts, colors)
    elif ext == "mvs":
        if refine_poses:
            logger.warning("--refine-poses ignored: .mvs checkpoints carry "
                           "no track measurements to bundle-adjust over")
        f = mvsbin.read_mvs(path)
        cfg = _resolve_config(f.config)
        images = _load_images(f.cameras, base_dir)
        rec = Reconstructor(f.cameras, images, cfg, logger=logger)
        # a .state.npz sidecar (written by autosave) restores the full
        # arena incl. the expansion frontier; otherwise treat the .mvs
        # patches as seeds to re-refine (reference -r .mvs semantics)
        if rec.load_checkpoint(path):
            rec.resumed = True
        elif len(f.patches.centers):
            rec.load_seeds_from_mvs(f.patches)
    else:
        raise SystemExit(f"unsupported input: {path}")
    return rec


def _dump_stats(rec: Reconstructor, out_dir: str) -> None:
    import json
    stats = dict(rec.stats)
    stats["live_patches"] = int(len(rec.arena.live_ids()))
    stats["total_patches"] = int(rec.arena.count)
    stats["deleted_patches"] = int(len(rec.arena.deleted_ids))
    stats["neighbor_radius"] = float(rec.neighbor_radius)
    with open(os.path.join(out_dir, "stats.json"), "w") as f:
        json.dump(stats, f, indent=1)


def run_reconstruct(path: str, out_dir: str = ".",
                    refine_poses: bool = False,
                    distributed: bool = False,
                    live_snapshots: bool = False,
                    mesh_shape=None) -> None:
    rec = _build_reconstructor(path, out_dir, refine_poses=refine_poses)
    if live_snapshots:
        rec.live_snapshot_dir = out_dir
    rec._log(rec.cfg.describe())
    j = lambda n: os.path.join(out_dir, n)
    # validate the mesh BEFORE the seed-refine phase spends minutes on
    # compiles: the device-count product and the camera-divisibility
    # constraint are both known now
    mesh = None
    if distributed and mesh_shape is not None:
        from pais_mvs_tpu.parallel.mesh import make_mesh
        if len(mesh_shape) != 2:
            raise SystemExit(
                f"--mesh-shape must be dp,vp (got {','.join(map(str, mesh_shape))})")
        vp = mesh_shape[1]
        C = rec.scene.num_cameras
        if C % vp != 0:
            raise SystemExit(
                f"--mesh-shape view axis {vp} must divide the camera "
                f"count {C}")
        mesh = make_mesh(tuple(mesh_shape))
    t0 = time.time()

    def _expand():
        if distributed:
            rec.expand_distributed(mesh=mesh,
                                   autosave_path=j("auto_save.mvs"))
        else:
            rec.expand(autosave_path=j("auto_save.mvs"))

    if getattr(rec, "resumed", False):
        # frontier checkpoint: continue expansion where it stopped
        _expand()
    else:
        rec.write_mvs(j("init.mvs"))
        rec.refine_seeds()
        rec.write_mvs(j("seed.mvs"))
        _expand()
    rec.write_mvs(j("exp.mvs"))
    rec.write_ply(j("exp.ply"))
    rec.write_psr(j("exp.psr"))
    _dump_stats(rec, out_dir)
    print(f"time1\t{time.time() - t0:f}")


def run_filter(path: str, out_dir: str = ".") -> None:
    if not path.endswith(".mvs"):
        print("filtering only mvs file")
        return
    rec = _build_reconstructor(path, out_dir)
    rec._log(rec.cfg.describe())
    if not getattr(rec, "resumed", False):
        rec.adopt_loaded_patches()
    j = lambda n: os.path.join(out_dir, n)
    t0 = time.time()
    rec.cell_filtering()
    rec.write_mvs(j("PMVS_filter1.mvs")); rec.write_ply(j("PMVS_filter1.ply"))
    rec.visibility_filtering()
    rec.write_mvs(j("PMVS_filter2.mvs")); rec.write_ply(j("PMVS_filter2.ply"))
    rec.neighbor_cell_filtering(0.25)
    rec.write_mvs(j("PMVS_filter3.mvs")); rec.write_ply(j("PMVS_filter3.ply"))
    rec.write_mvs(j("PMVS_filter_deleted.mvs"), deleted=True)
    rec.write_ply(j("PMVS_filter_deleted.ply"), deleted=True)
    rec.arena.deleted_ids.clear()
    rec.neighbor_patch_filtering(0.25)
    rec.write_mvs(j("PCMVS_filter.mvs")); rec.write_ply(j("PCMVS_filter.ply"))
    rec.write_mvs(j("PCMVS_filter_deleted.mvs"), deleted=True)
    rec.write_ply(j("PCMVS_filter_deleted.ply"), deleted=True)
    _dump_stats(rec, out_dir)
    print(f"time1\t{time.time() - t0:f}")


def run_view(path: str, out_dir: str = ".",
             patch_id: int | None = None,
             reoptimize: bool = False) -> None:
    """Offline replacement for the PCL viewer: dump a PLY snapshot + stats
    (interactive parity is out of scope; PLY opens in MeshLab as the
    reference README suggests). With ``patch_id``, additionally save the
    picked patch's warped-window mosaic + SAD heat-map (the viewer's
    point-pick diagnostics, view/mvsviewer.cpp:441-471)."""
    f = mvsbin.read_mvs(path)
    p = f.patches
    st = np.sin(p.normal_sph[:, 0])
    normals = np.stack([st * np.cos(p.normal_sph[:, 1]),
                        st * np.sin(p.normal_sph[:, 1]),
                        np.cos(p.normal_sph[:, 0])], -1)
    out = os.path.join(out_dir, "view_snapshot.ply")
    write_ply(out, p.centers, normals,
              np.full((len(p.centers), 3), 200.0))
    print(f"cameras: {len(f.cameras)}  patches: {len(p.centers)}")
    print(f"fitness: mean {p.fitness.mean():.4f}  "
          f"correlation: mean {p.correlation.mean():.4f}")
    print(f"wrote {out}")

    from pais_mvs_tpu.diagnostics import write_html_viewer
    from pais_mvs_tpu.models.camera import _np_quat_to_rotation
    html = os.path.join(out_dir, "view.html")
    cam_c = np.array([np.asarray(c.center, float) for c in f.cameras])
    cam_ax = np.array([
        _np_quat_to_rotation(np.asarray(c.quaternion, float)).T
        @ np.array([0.0, 0.0, 1.0]) for c in f.cameras])
    write_html_viewer(html, p.centers,
                      np.full((len(p.centers), 3), 200.0),
                      normals=normals, ids=np.arange(len(p.centers)),
                      cam_centers=cam_c, cam_axes=cam_ax,
                      cam_names=[c.file_name for c in f.cameras])
    print(f"wrote {html} (interactive: orbit/zoom, 'c' color, 'o' replay,"
          f" 'n' normals, 'v' cameras, click = patch readout)")

    if patch_id is not None:
        from pais_mvs_tpu.diagnostics import save_patch_diagnostics
        base_dir = os.path.dirname(os.path.abspath(path))
        cfg = _resolve_config(f.config)
        images = _load_images(f.cameras, base_dir)
        rec = Reconstructor(f.cameras, images, cfg, verbose=False)
        rec.load_seeds_from_mvs(f.patches)
        pb = rec._seed_pb
        i = int(patch_id)
        if not (0 <= i < len(p.centers)):
            raise SystemExit(f"patch id {i} out of range")
        save_patch_diagnostics(
            rec.scene, cfg, np.asarray(pb.center)[i],
            np.asarray(pb.normal_sph)[i], int(np.asarray(pb.ref_cam)[i]),
            np.asarray(pb.cam_mask)[i], int(np.asarray(pb.lod)[i]),
            out_dir, i, fitness=float(p.fitness[i]))

        if reoptimize:
            # re-run the optimizer on this one patch (the viewer's Shift+S,
            # view/mvsviewer.cpp:56-71) and save 'after' diagnostics.
            # Recover the volume-derived neighborRadius from the loaded
            # cloud (the .mvs does not embed it) so the depth-search bounds
            # match the original reconstruction's.
            ext = p.centers.max(0) - p.centers.min(0)
            vol = float(abs(ext[0] * ext[1] * ext[2]))
            if vol > 0:
                rec.neighbor_radius = (vol ** (1.0 / 3.0)
                                       * cfg.neighbor_radius_scalar)
            import jax
            import jax.numpy as jnp
            from pais_mvs_tpu.models import patch as patch_mod
            from pais_mvs_tpu.ops import lifecycle as lc
            one = patch_mod.take(pb, np.asarray([i]))
            out = lc.refine_batch(rec.scene, cfg,
                                  jax.tree.map(jnp.asarray, one),
                                  jax.random.PRNGKey(cfg.rng_seed),
                                  jnp.float32(rec.neighbor_radius),
                                  True, 1)
            nb = jax.device_get(out.batch)
            print(f"re-optimized: fitness {float(p.fitness[i]):.6f} -> "
                  f"{float(nb.fitness[0]):.6f}, "
                  f"center {np.asarray(pb.center)[i]} -> {nb.center[0]}, "
                  f"valid={bool(nb.valid[0])}")
            save_patch_diagnostics(
                rec.scene, cfg, nb.center[0], nb.normal_sph[0],
                int(nb.ref_cam[0]), nb.cam_mask[0], int(nb.lod[0]),
                out_dir, i * 1000000 + 1,
                fitness=float(nb.fitness[0]))


def run_animate(path: str, out_dir: str = ".") -> None:
    """Insertion-order replay export (the reference's -a animate mode,
    TMVS.cpp:66-74 / view/mvsviewer.cpp:258-265): a PLY with a per-point
    ``order`` scalar — color by it to watch the reconstruction grow."""
    from pais_mvs_tpu.diagnostics import write_animate_ply
    f = mvsbin.read_mvs(path)
    p = f.patches
    st = np.sin(p.normal_sph[:, 0])
    normals = np.stack([st * np.cos(p.normal_sph[:, 1]),
                        st * np.sin(p.normal_sph[:, 1]),
                        np.cos(p.normal_sph[:, 0])], -1)
    out = os.path.join(out_dir, "animate.ply")
    write_animate_ply(out, p.centers, normals,
                      np.full((len(p.centers), 3), 200.0))
    print(f"wrote {out} ({len(p.centers)} patches in insertion order)")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="pais-mvs-tpu",
        description="Patch-based multi-view stereo in JAX")
    ap.add_argument("-r", metavar="FILE", help="reconstruct (.nvm/.nvm2/.mvs)")
    ap.add_argument("-f", metavar="FILE", help="post-filter (.mvs)")
    ap.add_argument("-v", metavar="FILE", help="snapshot view (.mvs)")
    ap.add_argument("-a", metavar="FILE",
                    help="animate: insertion-order replay PLY (.mvs)")
    ap.add_argument("-o", "--out-dir", default=".", help="output directory")
    ap.add_argument("-b", "--refine-poses", action="store_true",
                    help="bundle-adjust camera poses over the SfM tracks "
                         "before dense reconstruction")
    ap.add_argument("--mesh-shape", default=None,
                    help="dp,vp device-mesh shape for --distributed-"
                         "expansion: patch-parallel shards x view shards "
                         "(camera-block-sharded pyramids; dp*vp must equal "
                         "the device count and vp must divide the camera "
                         "count). Default: all devices on the patch axis.")
    ap.add_argument("--distributed-expansion", action="store_true",
                    help="run expansion as SPMD cell-slab rounds over all "
                         "devices (SPMD occupancy exchange; multi-chip scale path)")
    ap.add_argument("--live-snapshots", action="store_true",
                    help="refresh OUT_DIR/live_snapshot.ply at every "
                         "autosave so the growing cloud can be watched "
                         "mid-run (the reference's addPatchView live-viewer "
                         "hook, offline-honest)")
    ap.add_argument("--patch-id", type=int, default=None,
                    help="with -v: dump the patch's warped-window mosaic "
                         "and SAD heat-map PNGs")
    ap.add_argument("--reoptimize", action="store_true",
                    help="with -v --patch-id: re-run the optimizer on that "
                         "patch and report before/after (viewer Shift+S)")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="capture a jax.profiler trace of the run into DIR")
    args = ap.parse_args(argv)

    # persistent compilation cache: the refine programs are large and
    # recompile identically across runs (see cache.py)
    from pais_mvs_tpu.cache import enable_persistent_cache
    enable_persistent_cache()

    profile_cm = None
    if args.profile:
        import jax
        profile_cm = jax.profiler.trace(args.profile)
        profile_cm.__enter__()
    try:
        if args.r:
            run_reconstruct(args.r, args.out_dir,
                            refine_poses=args.refine_poses,
                            distributed=args.distributed_expansion,
                            mesh_shape=(tuple(int(x) for x in
                                        args.mesh_shape.split(","))
                                        if args.mesh_shape else None),
                            live_snapshots=args.live_snapshots)
        elif args.f:
            run_filter(args.f, args.out_dir)
        elif args.v:
            run_view(args.v, args.out_dir, patch_id=args.patch_id,
                     reoptimize=args.reoptimize)
        elif args.a:
            run_animate(args.a, args.out_dir)
        else:
            ap.print_help()
            return 1
    finally:
        if profile_cm is not None:
            profile_cm.__exit__(None, None, None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
