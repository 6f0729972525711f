"""Profile one seed-refine batch at the pawn shape and reduce the trace to
per-kernel device time and bytes.

    PYTHONPATH=. python tools/trace_refine.py [--out chiprun_out/trace] [--batch 1024]

Workload: bench.py's (5 cameras at 640x480, patchRadius 15, GLN-PSO 15x30,
seeds at 2x both, so one refine_batch call runs 61 fitness evaluations).
The script compiles and warms refine_batch, times untraced calls, traces
ONE call with jax.profiler, and prints

  * the wall time of a call, the device busy time inside the traced call
    (union of kernel intervals) and the device's idle share;
  * for the kernels with the most device time: launches, total and
    per-launch time, a byte count (XLA's cost model when the trace carries
    it, else operands + result of the optimized HLO instruction) and the
    rate that count implies against the H100's 3.35 TB/s. The count is a
    model, not measured DRAM traffic: it charges a sliced or broadcast
    operand at its full size (a share above 1.0 shows the overcount) and
    a gathered table once however often it is read, and does not see what
    L2 serves;
  * which of them come from ops/fitness.py::patch_fitness (HLO metadata).

Needs an accelerator; the reduction itself is plain Python over
jax.profiler.ProfileData. A JSON copy goes to OUT/summary.json.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import time
from collections import defaultdict

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
_DTYPE_BYTES = {"pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2,
                "f16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
                "f64": 8}
_SHAPE = re.compile(r"\b(" + "|".join(_DTYPE_BYTES) + r")\[([0-9,]*)\]")
_OPERAND = re.compile(r"%([\w.\-]+)")
_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*?)\s"
                    r"(fusion|custom-call|[\w\-]+)\((.*)$")


def _shape_bytes(text: str) -> int:
    total = 0
    for dt, dims in _SHAPE.findall(text):
        n = 1
        for d in filter(None, dims.split(",")):
            n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def hlo_instructions(hlo_text: str) -> dict:
    """name -> (operand+result bytes, op_name metadata) for every
    instruction of the optimized HLO module (operands are printed by name,
    so their sizes come from their own result shapes)."""
    parsed = {}
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if not m:
            continue
        name, result, _, rest = m.groups()
        meta = re.search(r'op_name="([^"]*)"', rest)
        parsed[name] = (_shape_bytes(result), _OPERAND.findall(
            rest.split(")", 1)[0]), meta.group(1) if meta else "")
    return {name: (res + sum(parsed[o][0] for o in ops if o in parsed),
                   meta)
            for name, (res, ops, meta) in parsed.items()}


def device_events(xplane_path: str):
    """[(name, start_ns, dur_ns, stats)] of the first GPU plane's kernel
    line ("XLA Ops" when present, else every stream line)."""
    from jax.profiler import ProfileData
    pd = ProfileData.from_file(xplane_path)
    planes = [p for p in pd.planes if p.name.startswith("/device:GPU")]
    if not planes:
        raise SystemExit("trace has no GPU device plane: "
                         f"{[p.name for p in pd.planes]}")
    plane = sorted(planes, key=lambda p: p.name)[0]
    lines = list(plane.lines)
    print(f"device plane {plane.name}: lines {[l.name for l in lines]}")
    ops = [l for l in lines if l.name == "XLA Ops"]
    use = ops or [l for l in lines if "Stream" in l.name]
    evs = []
    for line in use:
        for e in line.events:
            evs.append((e.name, e.start_ns, e.duration_ns, dict(e.stats)))
    return evs


def busy_ns(evs) -> float:
    iv = sorted((s, s + d) for _, s, d, _ in evs)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/trace")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    if jax.default_backend() != "gpu":
        sys.exit(f"trace_refine: no GPU (backend {jax.default_backend()!r})")
    from pais_mvs_tpu.cache import enable_persistent_cache
    from pais_mvs_tpu.config import MvsConfig
    from pais_mvs_tpu.data.synthetic import make_scene
    from pais_mvs_tpu.models import patch as patch_mod
    from pais_mvs_tpu.models.camera import build_scene
    from pais_mvs_tpu.ops import lifecycle as lc
    enable_persistent_cache()

    B = args.batch
    cfg = MvsConfig(particle_num=15, max_iteration=30, dist_weighting=5.0,
                    batch_size=B, max_lod=6)
    sc = make_scene(num_cams=5, width=640, height=480, num_seeds=B + 64,
                    seed=0)
    scene = build_scene(sc.params, sc.images, cfg)
    rng = np.random.default_rng(0)
    centers = sc.seed_centers[:B] + rng.normal(scale=0.01, size=(B, 3))
    pb = lc.prepare_seeds(scene, cfg, patch_mod.from_seeds(
        centers, sc.seed_cam_masks[:B], sc.seed_img_points[:B]))
    key, nr = jax.random.PRNGKey(0), jnp.float32(0.005)
    run = lambda k: lc.refine_batch(scene, cfg, pb, k, nr, True, 1)

    t0 = time.perf_counter()
    compiled = lc.refine_batch.lower(scene, cfg, pb, key, nr, True,
                                     1).compile()
    compile_s = time.perf_counter() - t0
    hlo_text = compiled.as_text()
    instrs = hlo_instructions(hlo_text)
    by_kernel = {re.sub(r"[.\-]", "_", k): v for k, v in instrs.items()}
    jax.block_until_ready(run(key))
    walls = []
    for i in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(run(jax.random.fold_in(key, i)))
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "refine_batch.hlo.txt"), "w") as f:
        f.write(hlo_text)
    with jax.profiler.trace(args.out):
        t0 = time.perf_counter()
        jax.block_until_ready(run(jax.random.fold_in(key, 99)))
        traced_wall = time.perf_counter() - t0
    path = sorted(glob.glob(os.path.join(
        args.out, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    evs = device_events(path)
    if evs:
        keys = sorted({k for *_, st in evs[:200] for k in st})
        print(f"kernel event stats: {keys}")
    # kernels of the refine program only (the trace also holds the PRNG
    # key derivation), keyed by their HLO instruction
    evs = [e for e in evs if e[3].get("hlo_module") == "jit_refine_batch"]
    busy = busy_ns(evs) * 1e-9
    t_first = min(s for _, s, _, _ in evs) if evs else 0
    t_last = max(s + d for _, s, d, _ in evs) if evs else 0
    span = (t_last - t_first) * 1e-9
    agg = defaultdict(lambda: [0, 0.0, None])
    for name, _, dur, st in evs:
        # kernels replayed from a CUDA graph report hlo_op "command_buffer";
        # their names are the HLO instruction's with "." spelled "_"
        op = st.get("hlo_op")
        a = agg[op if op in instrs else name]
        a[0] += 1
        a[1] += dur * 1e-9
        if a[2] is None and "bytes_accessed" in st:
            a[2] = float(st["bytes_accessed"])
    rows = []
    for name, (n, tot, model_bytes) in agg.items():
        hlo_bytes, op_name = instrs.get(name) or by_kernel.get(name,
                                                               (None, ""))
        nbytes = model_bytes if model_bytes is not None else hlo_bytes
        per = tot / n
        rows.append({
            "kernel": name, "launches": n, "total_ms": tot * 1e3,
            "per_launch_us": per * 1e6, "bytes_per_launch": nbytes,
            "bytes_source": ("cost model" if model_bytes is not None else
                             "hlo operands+result" if hlo_bytes else None),
            "tb_per_s": nbytes / per / 1e12 if nbytes and per > 0 else None,
            "hbm_share": (nbytes / per / HBM_BYTES_PER_S
                          if nbytes and per > 0 else None),
            "patch_fitness": "patch_fitness" in op_name,
            "op_name": op_name[-120:],
        })
    rows.sort(key=lambda r: -r["total_ms"])
    fit_ms = sum(r["total_ms"] for r in rows if r["patch_fitness"])

    print(f"refine_batch B={B}: compile {compile_s:.1f}s; wall per call "
          f"{wall * 1e3:.1f} ms (untraced median of 3: "
          f"{[round(w * 1e3, 1) for w in walls]}), traced {traced_wall * 1e3:.1f} ms")
    print(f"device: busy {busy * 1e3:.1f} ms over a {span * 1e3:.1f} ms "
          f"kernel span, idle share of the traced call "
          f"{1 - busy / traced_wall:.3f}; {len(evs)} kernel launches; "
          f"patch_fitness kernels {fit_ms:.1f} ms "
          f"({fit_ms / max(busy * 1e3, 1e-9):.3f} of busy)")
    print("bytes by model (see the module docstring), not measured traffic")
    print(f"{'kernel':44s} {'n':>5s} {'tot ms':>8s} {'us/launch':>9s} "
          f"{'MB/launch':>9s} {'TB/s':>6s} {'peak':>5s} fit")
    for r in rows[:args.top]:
        mb = (f"{r['bytes_per_launch'] / 1e6:9.1f}"
              if r["bytes_per_launch"] else f"{'-':>9s}")
        tb = f"{r['tb_per_s']:6.2f}" if r["tb_per_s"] else f"{'-':>6s}"
        hs = f"{r['hbm_share']:5.2f}" if r["hbm_share"] else f"{'-':>5s}"
        print(f"{r['kernel'][:44]:44s} {r['launches']:5d} "
              f"{r['total_ms']:8.2f} {r['per_launch_us']:9.1f} {mb} {tb} "
              f"{hs} {'Y' if r['patch_fitness'] else ''}")
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump({"batch": B, "compile_s": compile_s, "wall_s": wall,
                   "walls_s": walls, "traced_wall_s": traced_wall,
                   "busy_s": busy, "kernel_span_s": span,
                   "launches": len(evs), "patch_fitness_ms": fit_ms,
                   "device": jax.devices()[0].device_kind,
                   "kernels": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
