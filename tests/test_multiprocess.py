"""REAL multi-process distributed execution: 2 local processes x 4 CPU
devices each, joined by jax.distributed into one 8-device global mesh
(DCN-style process boundary), running the patch-sharded refine and one
full distributed expansion round. Results must match the single-process
8-device run bit-for-bit — the same code runs in both topologies
(tests/mp_common.py), so any difference isolates the process boundary.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from pais_mvs_tpu.parallel.distributed import local_device_ids

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("coordinator, process_id, want", [
    ("localhost:9876", 2, [2]),                # one-host launch
    ("localhost:1234", 0, [0]),
    ("127.0.0.1:9876", 1, [1]),
    ("127.0.1.1:9876", 3, [3]),
    ("[::1]:9876", 3, [3]),
    ("host0:9876", 1, None),                   # may span hosts: all GPUs
    ("10.0.0.5:9876", 3, None),
    (socket.gethostname() + ":9876", 2, None),
])
def test_local_device_ids(coordinator, process_id, want):
    """A process opens one GPU only when all processes are known to share
    its host (loopback coordinator): on the coordinator's own host in a
    multi-host launch, pinning card ``process_id`` would leave that host's
    devices mismatched across processes (or name a card that does not
    exist)."""
    assert local_device_ids(coordinator, process_id) == want


def test_package_import_starts_no_backend():
    """``jax.distributed.initialize`` must precede the first backend use,
    so importing the package (CLI and engine included) must not start one:
    a module-level ``jnp`` value would."""
    code = ("import jax._src.xla_bridge as xb\n"
            "def spy(*a, **k):\n"
            "    raise SystemExit('backend started at import')\n"
            "xb.backends = spy\n"
            "import pais_mvs_tpu.cli, pais_mvs_tpu.parallel.sharded, "
            "pais_mvs_tpu.parallel.expansion, pais_mvs_tpu.ops.bundle\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", \
        out.stdout + out.stderr


def _stitch(prefix, nproc, names):
    full = {}
    for name in names:
        parts = []
        for pid in range(nproc):
            d = np.load(f"{prefix}-{pid}.npz")
            parts.append((d[name + "_rows"][0], d[name]))
        parts.sort(key=lambda t: t[0])
        full[name] = np.concatenate([p[1] for p in parts])
    return full


@pytest.mark.slow
def test_two_process_matches_single_process(tmp_path):
    port = _free_port()
    prefix = str(tmp_path / "mp")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)          # workers set their own device count
    env["JAX_PLATFORMS"] = "cpu"
    worker = os.path.join(os.path.dirname(__file__), "mp_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(pid), "2", str(port), prefix],
        env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"

    names = ["refined_center", "refined_valid", "refined_fitness",
             "exp_center", "exp_accepted", "occ2"]
    mp = _stitch(prefix, 2, names)

    # single-process reference on this test process's 8 virtual devices
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from tests.mp_common import build_problem, run_sharded
    prob = build_problem()
    mesh = prob["mesh_fn"]()

    def to_global(x):
        x = np.asarray(x)
        sh = NamedSharding(mesh, P("patch", *([None] * (x.ndim - 1))))
        return jax.device_put(x, sh)

    ref = {k: np.asarray(v)
           for k, v in run_sharded(prob, mesh, to_global).items()}

    assert (mp["refined_valid"] == ref["refined_valid"]).all()
    assert (mp["exp_accepted"] == ref["exp_accepted"]).all()
    assert (mp["occ2"] == ref["occ2"]).all()
    np.testing.assert_allclose(mp["refined_center"], ref["refined_center"],
                               rtol=0, atol=0)
    np.testing.assert_allclose(mp["exp_center"], ref["exp_center"],
                               rtol=0, atol=0)
    # sanity: the run did real work
    assert ref["refined_valid"].sum() > 30
    assert ref["exp_accepted"].sum() > 5


@pytest.mark.slow
def test_two_process_view_sharded_matches_single_process(tmp_path):
    """The VIEW axis crossing the process boundary: a (4, 2) mesh with the
    devices interleaved so every view pair holds one device from EACH
    process — the view-sharded fitness psums / all_gathers and the
    ownership-routed LOD/color/filter lookups all ride the DCN-style
    boundary (the flat variant above only crosses it on the patch axis).
    Every view collective has exactly 2 summands, so the comparison to the
    single-process run stays bit-exact."""
    port = _free_port()
    prefix = str(tmp_path / "mpv")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    worker = os.path.join(os.path.dirname(__file__), "mp_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(pid), "2", str(port), prefix, "view"],
        env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"

    # every process addresses a full (view-replicated) copy of the patch
    # axis — each file is complete; the two copies must agree bit-for-bit
    # (cross-process consistency of the view collectives), then either
    # compares against the single-process reference
    names = ["refined_center", "refined_valid", "refined_fitness",
             "exp_center", "exp_accepted", "occ2"]
    d0 = np.load(f"{prefix}-0.npz")
    d1 = np.load(f"{prefix}-1.npz")
    mp = {}
    for name in names:
        np.testing.assert_array_equal(d0[name], d1[name])
        mp[name] = d0[name]

    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from tests.mp_common import build_problem, run_sharded
    prob = build_problem(view=True)
    mesh = prob["mesh_fn"]()

    def make_global(x, spec):
        return jax.device_put(np.asarray(x), NamedSharding(mesh, spec))

    def to_global(x):
        x = np.asarray(x)
        return make_global(x, P("patch", *([None] * (x.ndim - 1))))

    ref = {k: np.asarray(v)
           for k, v in run_sharded(prob, mesh, to_global,
                                   make_global).items()}

    assert (mp["refined_valid"] == ref["refined_valid"]).all()
    assert (mp["exp_accepted"] == ref["exp_accepted"]).all()
    assert (mp["occ2"] == ref["occ2"]).all()
    np.testing.assert_allclose(mp["refined_center"], ref["refined_center"],
                               rtol=0, atol=0)
    np.testing.assert_allclose(mp["exp_center"], ref["exp_center"],
                               rtol=0, atol=0)
    assert ref["refined_valid"].sum() > 30
    assert ref["exp_accepted"].sum() > 5
