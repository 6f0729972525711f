"""Smoke test of the MVS engine on an NVIDIA GPU, through its entry points.

    python chip_smoke.py               one GPU: device, fitness parity at real
                                       widths, the pawn-shaped -r/-f run
    python chip_smoke.py --four-cards  four GPUs: distributed -r on a (2, 2)
                                       patch x view mesh vs the host path
                                       (only this phase)

Every phase gates its own result and exits non-zero on failure; there is no
CPU fallback. The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``, printed only when
every phase passed. Everything runs in this one process (one JAX process per
card); scratch files go to a temporary directory that is removed at exit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# Tolerances of the GPU-vs-CPU fitness parity (same jitted program, same
# inputs, both float32 at "highest" matmul precision; they differ only in
# fusion, reduction order and FMA contraction):
#   * validity (finite vs BIG) agreement >= 0.999 of all candidates: a
#     window bound compared in f32 can flip when the warped coordinate lies
#     within rounding of the bound;
#   * on candidates both score finitely, the 99.9th percentile of
#     |fit_gpu - fit_cpu| / max(1, |fit_cpu|) <= 1e-4.
VALID_AGREEMENT = 0.999
REL_TOL_P999 = 1e-4

# The pawn-shaped deployment: 5 cameras at 640x480, 961-pixel windows,
# GLN-PSO 15 particles x 30 iterations (seeds refine at 2x both).
PAWN_CONFIG = ("patchRadius 15\nparticleNum 15\nmaxIteration 30\n"
               "maxLOD 6\n")
MIN_PATCHES = 2000          # accepted patches in exp.mvs at the pawn shape
MAX_MEDIAN_DIST = 3e-3      # median distance to the synthetic surface


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def gate(ok: bool, msg: str) -> None:
    print(f"  [{'ok' if ok else 'FAIL'}] {msg}", flush=True)
    if not ok:
        fail(msg)


class CompileMeter:
    """Sums JAX's compile and persistent-cache events between resets."""

    def __init__(self):
        import jax
        self.reset()
        jax.monitoring.register_event_duration_secs_listener(self._dur)
        jax.monitoring.register_event_listener(self._event)

    def reset(self):
        self.compile_s, self.compiles = 0.0, 0
        self.cache_read_s, self.cache_hits, self.cache_misses = 0.0, 0, 0

    def _dur(self, event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.compile_s += duration
            self.compiles += 1
        elif event == "/jax/compilation_cache/cache_retrieval_time_sec":
            self.cache_read_s += duration

    def _event(self, event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            self.cache_hits += 1
        elif event == "/jax/compilation_cache/cache_misses":
            self.cache_misses += 1

    def line(self) -> str:
        return (f"compile {self.compile_s:.1f}s over {self.compiles} "
                f"programs, persistent-cache hits {self.cache_hits} "
                f"(read {self.cache_read_s:.1f}s), misses "
                f"{self.cache_misses}")


@contextlib.contextmanager
def fresh_compile_cache(path: str):
    """Run the body with JAX's persistent cache in the empty directory
    ``path``: set in the environment too, so that cache.py (which the CLI
    calls) keeps it. The previous directory is restored on exit."""
    import jax
    from jax.experimental.compilation_cache import compilation_cache as cc
    key = "JAX_COMPILATION_CACHE_DIR"
    prev_env, prev_dir = os.environ.get(key), \
        jax.config.jax_compilation_cache_dir
    os.environ[key] = path
    jax.config.update("jax_compilation_cache_dir", path)
    cc.reset_cache()
    try:
        yield path
    finally:
        if prev_env is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = prev_env
        jax.config.update("jax_compilation_cache_dir", prev_dir)
        cc.reset_cache()


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def phase_device(want: int) -> dict:
    import jax
    import jaxlib
    print("phase 1: device", flush=True)
    if jax.default_backend() != "gpu":
        fail(f"no GPU: JAX's default backend is {jax.default_backend()!r}")
    if jax.device_count() < want:
        fail(f"need {want} GPUs, JAX sees {jax.device_count()}")
    import pais_mvs_tpu  # noqa: F401  (applies the matmul precision)
    from pais_mvs_tpu import native
    from pais_mvs_tpu.cache import enable_persistent_cache
    dev = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    gate(smi.returncode == 0 and smi.stdout.strip() != "",
         "nvidia-smi reports the card's name and power limit")
    for line in smi.stdout.strip().splitlines():
        print(f"  nvidia-smi: {line.strip()}")
    cache_dir = enable_persistent_cache()
    n_cached = len(os.listdir(cache_dir)) if os.path.isdir(cache_dir) else 0
    print(f"  jax {jax.__version__}, jaxlib {jaxlib.__version__}; "
          f"{jax.device_count()} x {dev.device_kind}; matmul precision "
          f"{jax.config.jax_default_matmul_precision}")
    print(f"  compile cache {cache_dir} ({n_cached} entries at start)")
    print(f"  host runtime: {'native' if native.available() else 'python'}",
          flush=True)
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": jax.device_count()}


# ---------------------------------------------------------------------------
# phase 2: fitness parity at real widths
# ---------------------------------------------------------------------------

def parity_problem(B: int, P: int, radius: int, width: int, height: int):
    """Pawn-shaped scoring problem: B seed patches at LOD 0-2, P hypotheses
    each scattered around the seed (wide enough that some are rejected)."""
    import jax
    import jax.numpy as jnp
    from pais_mvs_tpu.config import MvsConfig
    from pais_mvs_tpu.data.synthetic import make_scene
    from pais_mvs_tpu.models import patch as patch_mod
    from pais_mvs_tpu.models.camera import build_scene
    from pais_mvs_tpu.ops import geometry as geom
    from pais_mvs_tpu.ops import lifecycle as lc

    cfg = MvsConfig(patch_radius=radius, particle_num=15, max_iteration=30,
                    dist_weighting=radius / 3.0, max_lod=6)
    sc = make_scene(num_cams=5, width=width, height=height,
                    num_seeds=2 * B, seed=0)
    if len(sc.seed_centers) < B:
        fail(f"scene has {len(sc.seed_centers)} seeds, need {B}")
    scene = build_scene(sc.params, sc.images, cfg)
    pb = lc.prepare_seeds(scene, cfg, patch_mod.from_seeds(
        sc.seed_centers[:B], sc.seed_cam_masks[:B], sc.seed_img_points[:B]))
    normal = geom.spherical_to_normal(pb.normal_sph)
    ref_cam = lc.set_reference_camera(scene, normal, pb.cam_mask)
    depth, ray = lc.set_depth_and_ray(scene, pb.center, ref_cam)
    lod = jnp.asarray(np.arange(B) % 3, jnp.int32)
    init = jnp.stack([pb.normal_sph[:, 0], pb.normal_sph[:, 1], depth], -1)
    noise = jax.random.normal(jax.random.PRNGKey(7), (B, P, 3)) \
        * jnp.array([0.3, 0.4, 0.01])
    pos = init[:, None, :] + noise
    return sc, cfg, scene, (ref_cam, pb.cam_mask, lod, ray, pos), \
        (pb.center, normal, ref_cam, pb.cam_mask, lod)


def _rel_p999(a, b):
    rel = np.abs(a - b) / np.maximum(1.0, np.abs(b))
    return float(np.percentile(rel, 99.9)) if rel.size else 0.0


def phase_parity(B=256, P=30, radius=15, width=640, height=480,
                 n_oracle=8) -> None:
    import jax
    from pais_mvs_tpu import oracle
    from pais_mvs_tpu.ops import fitness as F
    print(f"phase 2: fitness parity (B={B}, P={P}, r={radius}, 5 cams "
          f"{width}x{height}, LOD 0-2; precision "
          f"{jax.config.jax_default_matmul_precision})", flush=True)
    t0 = time.perf_counter()
    sc, cfg, scene, fit_args, vec_args = parity_problem(B, P, radius, width,
                                                        height)
    cpu = jax.devices("cpu")[0]
    fit_gpu = np.asarray(F.patch_fitness(scene, cfg, *fit_args))
    scene_c, fit_args_c, vec_args_c = jax.device_put(
        (scene, fit_args, vec_args), cpu)
    fit_cpu = np.asarray(F.patch_fitness(scene_c, cfg, *fit_args_c))
    v_gpu, v_cpu = fit_gpu < 1e20, fit_cpu < 1e20
    both = v_gpu & v_cpu
    agree = float((v_gpu == v_cpu).mean())
    p999 = _rel_p999(fit_gpu[both], fit_cpu[both])
    print(f"  patch_fitness gpu vs cpu: {v_gpu.sum()}/{v_gpu.size} finite on "
          f"gpu, {v_cpu.sum()} on cpu; validity agreement {agree:.5f}; "
          f"|dfit|/max(1,|fit|) p50 "
          f"{np.median(np.abs(fit_gpu[both] - fit_cpu[both])):.3g} "
          f"p99.9 {p999:.3g}")
    gate(both.sum() > 0.2 * both.size, "a fifth of the candidates score "
         "finitely on both")
    gate(agree >= VALID_AGREEMENT,
         f"validity agreement {agree:.5f} >= {VALID_AGREEMENT}")
    gate(p999 <= REL_TOL_P999, f"fitness p99.9 rel diff {p999:.3g} <= "
         f"{REL_TOL_P999}")

    vg = [np.asarray(x) for x in F.warped_patch_vectors(scene, cfg,
                                                        *vec_args)]
    vc = [np.asarray(x) for x in F.warped_patch_vectors(scene_c, cfg,
                                                        *vec_args_c)]
    ok = vg[3] & vc[3]
    ok_agree = float((vg[3] == vc[3]).mean())
    vec_p999 = _rel_p999(vg[0][ok], vc[0][ok])
    corr_p999 = _rel_p999(vg[2][ok], vc[2][ok])
    print(f"  warped_patch_vectors gpu vs cpu: ok agreement {ok_agree:.5f} "
          f"({ok.sum()}/{ok.size} kept); |dvec| p99.9 {vec_p999:.3g}, "
          f"|dcorrelation| p99.9 {corr_p999:.3g}")
    gate(ok.sum() > 0.5 * ok.size, "half the patches keep their NCC window")
    gate(ok_agree >= VALID_AGREEMENT,
         f"NCC validity agreement {ok_agree:.5f} >= {VALID_AGREEMENT}")
    gate(max(vec_p999, corr_p999) <= REL_TOL_P999,
         f"NCC vectors/correlation p99.9 diff <= {REL_TOL_P999}")

    # independent NumPy reference on a subset (float64 pyramids vs the
    # device's bf16 atlases: oracle.FITNESS_TOL)
    nps = oracle.NpScene(sc.params, sc.images, cfg)
    ref_cam, cam_mask, lod, ray, pos = (np.asarray(x) for x in fit_args)
    o = np.stack([oracle.fitness_np(
        nps, cfg, int(ref_cam[i]), np.nonzero(cam_mask[i])[0], int(lod[i]),
        ray[i].astype(np.float64), pos[i].astype(np.float64))
        for i in range(n_oracle)])
    g = fit_gpu[:n_oracle]
    vo, vg_ = o < 1e20, g < 1e20
    bo = vo & vg_
    o_agree = float((vo == vg_).mean())
    ratio = np.abs(g[bo] - o[bo]) / (oracle.FITNESS_TOL
                                     * np.maximum(1.0, np.abs(o[bo])))
    worst = float(ratio.max()) if ratio.size else 0.0
    print(f"  patch_fitness gpu vs oracle.fitness_np ({n_oracle} patches x "
          f"{P}): validity agreement {o_agree:.4f}, {bo.sum()} compared, "
          f"worst |dfit| = {worst:.3f} x tolerance "
          f"({oracle.FITNESS_TOL} x max(1,|fit|))")
    gate(bo.sum() >= n_oracle * P // 4, "a quarter of the oracle subset "
         "scores finitely")
    gate(o_agree >= 0.98, f"oracle validity agreement {o_agree:.4f} >= 0.98")
    gate(worst <= 1.0, "oracle fitness within tolerance")
    print(f"  phase 2 took {time.perf_counter() - t0:.1f}s", flush=True)


# ---------------------------------------------------------------------------
# phase 3: the main path through the CLI
# ---------------------------------------------------------------------------

def write_scene(d: str, sc) -> None:
    """PPM images + scene.nvm (center-origin measurements) in ``d``."""
    from pais_mvs_tpu.io.images import write_pnm
    from pais_mvs_tpu.io.nvm import save_nvm
    for p, img in zip(sc.params, sc.images):
        p.file_name = os.path.splitext(p.file_name)[0] + ".ppm"
        write_pnm(os.path.join(d, p.file_name), img)
    ipts = sc.seed_img_points.copy()
    for c, img in enumerate(sc.images):
        ipts[:, c, 0] -= img.shape[1] // 2
        ipts[:, c, 1] -= img.shape[0] // 2
    save_nvm(os.path.join(d, "scene.nvm"), sc.params, sc.seed_centers,
             sc.seed_colors, sc.seed_cam_masks, ipts)


def run_cli(cwd: str, args, meter: CompileMeter, label: str) -> float:
    """``python -m pais_mvs_tpu.cli ARGS`` from ``cwd``, in this process."""
    from pais_mvs_tpu import cli
    here = os.getcwd()
    os.chdir(cwd)
    meter.reset()
    t0 = time.perf_counter()
    try:
        rc = cli.main(list(args))
    finally:
        os.chdir(here)
    wall = time.perf_counter() - t0
    print(f"  {label}: wall {wall:.1f}s, {meter.line()}", flush=True)
    gate(rc == 0, f"{label} exits 0")
    return wall


def cloud(path: str, sc):
    from pais_mvs_tpu.io import mvsbin
    pts = mvsbin.read_mvs(path).patches.centers
    med = float(np.median(sc.surface_distance(pts))) if len(pts) else np.inf
    return pts, med


def phase_main_path(num_cams=5, width=640, height=480, num_seeds=256,
                    config=PAWN_CONFIG, min_patches=MIN_PATCHES) -> None:
    import jax
    from pais_mvs_tpu.data.synthetic import make_scene
    print(f"phase 3: main path, cli -r then -f ({num_cams} cams "
          f"{width}x{height}, {num_seeds} seeds; "
          f"{config.strip().replace(chr(10), ', ')})", flush=True)
    meter = CompileMeter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d, \
            fresh_compile_cache(os.path.join(d, "jax_cache")):
        sc = make_scene(num_cams=num_cams, width=width, height=height,
                        num_seeds=num_seeds, seed=0)
        write_scene(d, sc)
        with open(os.path.join(d, "config.txt"), "w") as f:
            f.write(config)
        # the cold run writes next to the scene, as a user's run does (-f
        # finds the images relative to exp.mvs); the warm run elsewhere
        cold, warm = d, os.path.join(d, "warm")
        os.makedirs(warm)

        # cold: nothing compiled in memory (phase 2's programs dropped)
        # and an empty persistent cache
        jax.clear_caches()
        run_cli(d, ["-r", "scene.nvm", "-o", cold], meter, "cold -r")
        cold_compile = meter.compile_s
        gate(meter.cache_hits == 0 and meter.compiles > 0,
             "the cold -r compiles its programs (no cache hits)")
        pts, med = cloud(os.path.join(cold, "exp.mvs"), sc)
        print(f"  exp.mvs: {len(pts)} patches, median surface distance "
              f"{med:.3g}")
        with open(os.path.join(cold, "stats.json")) as f:
            print(f"  stats: {json.load(f)}")
        gate(len(pts) > min_patches, f"more than {min_patches} patches")
        gate(med < MAX_MEDIAN_DIST, f"median distance < {MAX_MEDIAN_DIST}")

        run_cli(d, ["-f", os.path.join(cold, "exp.mvs"), "-o", cold], meter,
                "-f")
        fpts, fmed = cloud(os.path.join(cold, "PCMVS_filter.mvs"), sc)
        print(f"  PCMVS_filter.mvs: {len(fpts)} patches, median surface "
              f"distance {fmed:.3g}")
        gate(len(fpts) > 0 and fmed < MAX_MEDIAN_DIST,
             "filtered cloud is non-empty and on the surface")

        # drop in-memory executables: the warm run reloads from the
        # persistent cache, as a second invocation of the CLI would
        jax.clear_caches()
        run_cli(d, ["-r", "scene.nvm", "-o", warm], meter, "warm -r")
        print(f"  cold vs warm compile: {cold_compile:.1f}s vs "
              f"{meter.compile_s:.1f}s (+{meter.cache_read_s:.1f}s cache "
              f"reads, {meter.cache_hits} hits)")
        gate(meter.cache_hits > 0, "the warm -r reads programs back from "
             "the persistent cache")
        wpts, wmed = cloud(os.path.join(warm, "exp.mvs"), sc)
        same = len(wpts) == len(pts) and np.array_equal(wpts, pts)
        print(f"  warm exp.mvs: {len(wpts)} patches, median {wmed:.3g}; "
              f"{'identical to' if same else 'differs from'} the cold cloud")
        gate(len(wpts) > min_patches and wmed < MAX_MEDIAN_DIST,
             "warm run passes the same gates")
    stats = jax.devices()[0].memory_stats() or {}
    print(f"  peak_bytes_in_use {stats.get('peak_bytes_in_use')}",
          flush=True)


# ---------------------------------------------------------------------------
# phase 4 (--four-cards): distributed expansion vs the host path
# ---------------------------------------------------------------------------

# Agreement gates of the four-card phase (the smaller of the two fractions
# of points within half a cell of the other cloud; see phase_four_cards).
# Both comparisons of the distributed cloud, with the host-yardstick cloud
# (same seed streams and round size) and with the plain host cloud, must
# come within YARDSTICK_SLACK of the yardstick's own agreement with the
# host cloud, and above a floor just under what was measured: 0.85 for the
# first (0.880 on 4 CPU devices at 8 cams 320x240), 0.88 for the second
# (0.902, and 0.907 host vs yardstick, on four H100s at this scene).
YARDSTICK_SLACK = 0.03
MATCHED_FLOOR = 0.85
HOST_FLOOR = 0.88


def _agreement(a, b, tol) -> float:
    from pais_mvs_tpu.oracle import cloud_agreement
    ag = cloud_agreement(a, b, tol)
    return min(ag["engine_within_tol"], ag["oracle_within_tol"])


def phase_four_cards(num_cams=8, width=640, height=480, num_seeds=256,
                     config=PAWN_CONFIG, dp=2, vp=2,
                     min_patches=MIN_PATCHES) -> None:
    """Distributed -r on a (dp, vp) mesh against the single-card host path.

    The two differ in expansion order (the SPMD path takes dp x 256
    parents per round, the host path wavefrontSize) and in the seeds'
    random streams (the distributed run's seed refine is data-parallel
    over all cards), and on a dense cloud either alone moves patches by
    sub-cell amounts. So a third run, host-yardstick, is the host path
    with those two differences (data-parallel seeds, wavefront = the SPMD
    per-round budget); its agreement with the host cloud measures the
    host's own sensitivity to them, in-run, as in
    tests/test_engine_distributed. The distributed cloud must agree with
    the yardstick cloud and with the host cloud at least about as well."""
    from pais_mvs_tpu.config import load_config_txt
    from pais_mvs_tpu.data.synthetic import make_scene
    print(f"phase 4: -r --distributed-expansion --mesh-shape {dp},{vp} vs "
          f"the single-card host path ({num_cams} cams {width}x{height})",
          flush=True)
    meter = CompileMeter()
    host_cfg = config + "dataParallel off\n"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        sc = make_scene(num_cams=num_cams, width=width, height=height,
                        num_seeds=num_seeds, seed=0)
        write_scene(d, sc)
        nvm = os.path.join(d, "scene.nvm")
        runs = {}
        for name, cfg_txt, extra_args in (
                ("distributed", config, ["--distributed-expansion",
                                         "--mesh-shape", f"{dp},{vp}"]),
                ("host", host_cfg, []),
                ("host-yardstick", config + f"wavefrontSize {dp * 256}\n",
                 [])):
            out = os.path.join(d, name)
            os.makedirs(out)
            with open(os.path.join(out, "config.txt"), "w") as f:
                f.write(cfg_txt)
            cell = load_config_txt(os.path.join(out, "config.txt")).cell_size
            wall = run_cli(out, ["-r", nvm, "-o", out] + extra_args, meter,
                           f"{name} -r")
            pts, med = cloud(os.path.join(out, "exp.mvs"), sc)
            print(f"  {name}: {len(pts)} patches, median surface distance "
                  f"{med:.3g}, wall {wall:.1f}s")
            runs[name] = (pts, med)
    (dpts, dmed), (hpts, hmed) = runs["distributed"], runs["host"]
    ypts = runs["host-yardstick"][0]
    # agreement tolerance: half a cell at the scene's depth (the measure of
    # __graft_entry__.dryrun_multichip and tests/test_engine_distributed)
    cams = np.array([p.center for p in sc.params])
    depth = float(np.linalg.norm(sc.seed_centers.mean(0) - cams.mean(0)))
    tol = 0.5 * cell * depth / float(sc.params[0].focal[0])
    dist_yard = _agreement(dpts, ypts, tol)
    dist_host = _agreement(dpts, hpts, tol)
    yard_host = _agreement(ypts, hpts, tol)
    print(f"  cloud agreement (min of both ways): distributed vs "
          f"host-yardstick {dist_yard:.3f}; with the host cloud: "
          f"distributed {dist_host:.3f}, host-yardstick {yard_host:.3f}")
    gate(len(dpts) > min_patches, f"distributed run has more than "
         f"{min_patches} patches")
    for name, got, floor in (("host-yardstick", dist_yard, MATCHED_FLOOR),
                             ("host", dist_host, HOST_FLOOR)):
        gate(got >= yard_host - YARDSTICK_SLACK and got >= floor,
             f"distributed vs {name} {got:.3f} >= host-yardstick vs host "
             f"{yard_host:.3f} - {YARDSTICK_SLACK} and >= {floor}")
    gate(dmed < max(1.5 * hmed, 3e-3),
         f"distributed median {dmed:.3g} within 1.5x of host {hmed:.3g} "
         "or 3e-3")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU distributed phase")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    device = phase_device(4 if args.four_cards else 1)
    if args.four_cards:
        phase_four_cards()
    else:
        phase_parity()
        phase_main_path()
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f}s",
          flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
