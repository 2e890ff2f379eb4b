"""The compile-cache rule (runtime/compile_cache.py)."""

import os

import jax
import pytest

from srmeetsps_cuda_tpu.runtime import compile_cache


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_env_set_program_sets_nothing(monkeypatch, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.cache_dir() is None
    assert compile_cache.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


def test_env_unset_uses_checkout_dir(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(checkout, ".jax_cache")
    assert compile_cache.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    assert os.path.isdir(want)


def test_path_is_stable(monkeypatch, tmp_path):
    """The path is part of the cache key: it must not depend on the
    working directory, the home directory or the call."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = compile_cache.cache_dir()
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert compile_cache.cache_dir() == first
    assert os.path.isabs(first)


def test_cli_entry_point_enables_cache(monkeypatch, capsys):
    from srmeetsps_cuda_tpu import cli

    calls = []
    monkeypatch.setattr(compile_cache, "enable_compile_cache",
                        lambda: calls.append(1))
    assert cli.run([]) == 0
    assert calls == [1]
