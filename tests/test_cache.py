"""Persistent compilation cache policy (pais_mvs_tpu/cache.py): off on the
CPU backend; on the GPU, JAX_COMPILATION_CACHE_DIR when set, else the
fixed <checkout>/.jax_cache."""

import os

import jax
import pytest

from pais_mvs_tpu import cache


@pytest.fixture
def recorded(monkeypatch):
    """Record config updates instead of applying them (the suite keeps the
    real cache off), with the backend query stubbed."""
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    return calls


def test_gpu_default_dir_is_fixed_in_checkout(recorded, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(root, ".jax_cache")
    assert cache.enable_persistent_cache() == want
    assert recorded == {"jax_compilation_cache_dir": want}


def test_gpu_honours_env_dir_and_sets_no_other(recorded, monkeypatch,
                                               tmp_path):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable_persistent_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in recorded
    assert recorded == {}


def test_cpu_keeps_cache_off(recorded, monkeypatch, tmp_path):
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable_persistent_cache() is None
    assert recorded == {"jax_enable_compilation_cache": False}
