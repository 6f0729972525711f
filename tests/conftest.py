"""Test harness: run everything on a virtual 8-device CPU mesh.

The platform is pinned with jax.config.update, which wins over the
environment as long as no backend has been initialized yet.
"""

import os

# CPU unless the caller names platforms: the card-only tests (marker
# "gpu") run with JAX_PLATFORMS=cuda,cpu on a machine with a GPU
_platforms = os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", _platforms)
jax.config.update("jax_num_cpu_devices", 8)

# Disable the persistent compile cache for the whole suite: test_cli
# drives cli.main in-process, whose enable_persistent_cache() would
# otherwise engage a shared cache — and XLA:CPU executable DESERIALIZE
# segfaults the interpreter from C (not catchable). This is not only a
# stale/cross-host hazard: a per-run PRIVATE tempdir cache reproducibly
# segfaulted mid-suite when a program written by one test file was
# re-read by a later one (compilation_cache.get_executable_and_time).
# CPU compiles are cheap — keep the suite on the always-safe recompile
# path (pais_mvs_tpu/cache.py keeps the cache off on the CPU anyway).
jax.config.update("jax_enable_compilation_cache", False)

import gc  # noqa: E402

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_programs_between_modules():
    """Free compiled executables after each test module.

    The full suite compiles ~130 distinct XLA:CPU programs in one
    process; with all of them retained, a late compile reproducibly
    segfaults inside backend_compile (and, when the persistent cache was
    on, inside the cache's executable deserialize) — always at the same
    test, while any half of the suite passes. Dropping JAX's jit caches
    between modules keeps the live-executable population bounded; the
    cost is re-tracing shared fixtures' programs per module."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="session")
def tiny_scene():
    """Small synthetic 5-camera scene shared across tests."""
    from pais_mvs_tpu.data.synthetic import make_scene
    return make_scene(num_cams=5, width=200, height=150, num_seeds=40)


@pytest.fixture(scope="session")
def tiny_cfg():
    from pais_mvs_tpu.config import MvsConfig
    return MvsConfig(patch_radius=5, max_lod=4, particle_num=8,
                     max_iteration=12, batch_size=64,
                     dist_weighting=5.0 / 3.0)


@pytest.fixture(scope="session")
def tiny_built(tiny_scene, tiny_cfg):
    from pais_mvs_tpu.models.camera import build_scene
    return build_scene(tiny_scene.params, tiny_scene.images, tiny_cfg)
