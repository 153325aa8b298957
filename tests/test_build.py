"""Where the program keeps what it builds: compile cache and native libs."""
import pathlib
import shutil

import jax

from cp_pfdr_graph_d1_tpu import native_build
from cp_pfdr_graph_d1_tpu.utils import compile_cache

CHECKOUT = pathlib.Path(__file__).resolve().parents[1]


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_default_is_fixed_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = pathlib.Path(compile_cache.compile_cache_dir())
    assert path == CHECKOUT / ".jax_cache"
    assert path == pathlib.Path(compile_cache.compile_cache_dir())


def test_native_build_keyed_by_source_content(monkeypatch, tmp_path):
    """The library is built from the committed sources into a directory
    keyed by their content: an edited source gets a new build, and the
    built library is what gets loaded."""
    import ctypes

    src_dir = CHECKOUT / "cp_pfdr_graph_d1_tpu" / "maxflow"
    src = tmp_path / "mincut.cpp"
    shutil.copy(src_dir / "mincut.cpp", src)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    first = native_build.build_library("cpmincut", [src])
    assert first.parent == tmp_path / "build" and first.exists()
    assert native_build.build_library("cpmincut", [src]) == first
    ctypes.CDLL(str(first)).cp_steepest_cut  # noqa: B018 (symbol exists)
    src.write_text(src.read_text() + "\n// edited\n")
    second = native_build.library_path("cpmincut", [src])
    assert second != first and not second.exists()
    assert native_build.build_library("cpmincut", [src]) == second
    assert second.exists()
