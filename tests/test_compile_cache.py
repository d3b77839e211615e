"""The persistent compile cache: JAX_COMPILATION_CACHE_DIR when set,
otherwise one fixed directory inside the checkout."""

import os
from pathlib import Path

import jax

from orbslam2_tpu.utils import compile_cache


def test_env_var_is_honoured(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert compile_cache.cache_dir() == str(tmp_path / "c")
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable() == str(tmp_path / "c")
    # JAX reads the variable itself: no other directory is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_fixed_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = Path(__file__).resolve().parents[1]
    assert compile_cache.cache_dir() == str(repo / ".jax_cache")
    # stable across calls: no temporary name, process id or time in it
    assert compile_cache.cache_dir() == compile_cache.cache_dir()
    assert str(os.getpid()) not in compile_cache.cache_dir()
