"""Card-only checks: the phases of chip_smoke.py that compare the GPU build
of the fitness with the CPU build and with the NumPy oracle, at a reduced
batch, and a two-process launch on one host. They skip on machines without
a GPU (decided inside each fixture or test)."""

import importlib.util
import json
import os
import shutil
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def chip_smoke():
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX backend is "
                    f"{jax.default_backend()!r})")
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("radius", [6, 15])
def test_gpu_fitness_matches_cpu_and_oracle(chip_smoke, radius):
    chip_smoke.phase_parity(B=64, P=16, radius=radius, n_oracle=4)


# one process of the two-process launch: join over a loopback coordinator,
# report what it opened, and sum one value per process over the global mesh
_PINNED_WORKER = """
import json, sys
import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from pais_mvs_tpu.parallel.distributed import init_distributed
pid, port = int(sys.argv[1]), sys.argv[2]
assert init_distributed(f"localhost:{port}", 2, pid)
mesh = Mesh(np.array(jax.devices()), ("x",))
x = jax.make_array_from_callback(
    (2,), NamedSharding(mesh, P("x")),
    lambda i: np.arange(1, 3, dtype=np.float32)[i])
tot = jax.jit(lambda a: a.sum(), out_shardings=NamedSharding(mesh, P()))(x)
dev = jax.local_devices()[0]
print(json.dumps({"platform": dev.platform, "local": jax.local_device_count(),
                  "global": jax.device_count(),
                  "hw": dev.local_hardware_id,
                  "sum": float(tot.addressable_data(0))}))
"""


def test_two_processes_each_open_one_gpu():
    """Two processes behind a ``localhost`` coordinator: each opens only its
    own card (local GPU = process id), and together they form one
    two-device mesh whose collective crosses the process boundary."""
    smi = shutil.which("nvidia-smi")
    n_gpu = (len(subprocess.run([smi, "-L"], capture_output=True, text=True,
                                timeout=60).stdout.strip().splitlines())
             if smi else 0)
    if n_gpu < 2:
        pytest.skip(f"needs two NVIDIA GPUs (found {n_gpu})")
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, JAX_PLATFORMS="cuda",
               XLA_PYTHON_CLIENT_MEM_FRACTION="0.1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PINNED_WORKER, str(pid), str(port)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600))
    finally:
        for p in procs:
            p.kill()
    reps = []
    for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid}:\n{out}\n{err[-3000:]}"
        reps.append(json.loads(out.strip().splitlines()[-1]))
        print(f"process {pid}: {reps[-1]}")
    for rep in reps:
        assert rep["platform"] == "gpu"
        assert rep["local"] == 1 and rep["global"] == 2, reps
        assert rep["sum"] == 3.0, reps
    assert reps[0]["hw"] != reps[1]["hw"], reps     # two different cards
