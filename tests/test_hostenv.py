"""Process set-up helpers (utils/hostenv.py): the compile-cache path and
the explicit platform choice."""

import os

import pytest

from dpgo_ros_tpu.utils import hostenv


def test_compile_cache_follows_env_var(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert hostenv.compile_cache_dir("gpu") == str(tmp_path)
    assert hostenv.compile_cache_dir("cpu") == str(tmp_path)


def test_compile_cache_default_is_fixed_per_platform_in_checkout(
    monkeypatch,
):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    cpu = hostenv.compile_cache_dir("cpu")
    gpu = hostenv.compile_cache_dir("gpu")
    # inside the checkout, one directory per platform, stable across calls
    assert cpu == os.path.join(hostenv.REPO_ROOT, ".jax_cache", "cpu")
    assert gpu == os.path.join(hostenv.REPO_ROOT, ".jax_cache", "gpu")
    assert hostenv.compile_cache_dir("cpu") == cpu
    # and git never sees it
    with open(os.path.join(hostenv.REPO_ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_setup_compile_cache_sets_jax_config(monkeypatch, tmp_path):
    import jax

    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    try:
        d = hostenv.setup_compile_cache(platform="cpu")
        assert d == str(tmp_path / "c") and os.path.isdir(d)
        assert jax.config.jax_compilation_cache_dir == d
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_select_platform_checks_the_backend():
    # the test session runs on the CPU backend
    hostenv.select_platform("cpu")
    with pytest.raises(ValueError):
        hostenv.select_platform("rocm")
