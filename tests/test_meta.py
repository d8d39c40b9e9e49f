"""Tests for host utilities (sliding windows, transparent decompression)."""

import gzip
import io

import pytest

from gecco_tpu._meta import UniversalContainer, sliding_window, zopen


def test_sliding_window_full_cover():
    slices = list(sliding_window(5, 3, 1))
    assert slices == [slice(0, 3), slice(1, 4), slice(2, 5)]


def test_sliding_window_short_sequence_yields_nothing():
    assert list(sliding_window(2, 3, 1)) == []


def test_sliding_window_step():
    assert list(sliding_window(10, 4, 3)) == [slice(0, 4), slice(3, 7), slice(6, 10)]


def test_sliding_window_invalid():
    with pytest.raises(ValueError):
        list(sliding_window(5, 0, 1))
    with pytest.raises(ValueError):
        list(sliding_window(5, 3, 4))


def test_universal_container():
    container = UniversalContainer()
    assert "anything" in container
    assert 42 in container


def test_zopen_plain(tmp_path):
    path = tmp_path / "data.txt"
    path.write_bytes(b"hello world")
    with zopen(str(path)) as f:
        assert f.read() == b"hello world"


def test_zopen_gzip(tmp_path):
    path = tmp_path / "data.txt.gz"
    path.write_bytes(gzip.compress(b"compressed payload"))
    with zopen(str(path)) as f:
        assert f.read() == b"compressed payload"


def test_zopen_filelike():
    raw = io.BytesIO(gzip.compress(b"stream"))
    with zopen(raw) as f:
        assert f.read() == b"stream"


def test_compile_cache_defaults_to_checkout():
    """Without ``JAX_COMPILATION_CACHE_DIR`` the compile cache lives at
    ``<checkout>/.jax_cache``; a directory JAX already has is kept."""
    import os

    import jax

    from gecco_tpu import _meta

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert _meta.JAX_CACHE_DIR == os.path.join(root, ".jax_cache")
    before = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        _meta.enable_jax_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == _meta.JAX_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", str(root))
        _meta.enable_jax_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == str(root)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
