"""Host/device helpers: the compile-cache location and the GPU check."""

import jax
import pytest

from srsue_tpu.utils import jaxutil


def test_compile_cache_dir_prefers_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jaxutil.compile_cache_dir() == str(tmp_path)
    assert jaxutil.compile_cache_dir("cpu-abc") == str(tmp_path)


@pytest.mark.parametrize("subdir,tail", [(None, ".jax_cache"),
                                         ("cpu-abc", ".jax_cache/cpu-abc")])
def test_compile_cache_dir_defaults_to_checkout(monkeypatch, subdir, tail):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = jaxutil.compile_cache_dir(subdir)
    assert path == str(jaxutil.CHECKOUT / tail)
    assert (jaxutil.CHECKOUT / "srsue_tpu" / "utils" / "jaxutil.py").exists()


def test_compile_cache_dir_is_ignored_by_git():
    lines = (jaxutil.CHECKOUT / ".gitignore").read_text().split()
    assert ".jax_cache/" in lines


def test_use_compile_cache_sets_jax_config(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert jaxutil.use_compile_cache("ignored") == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(SystemExit, match="no GPU found"):
        jaxutil.require_gpu()


@pytest.mark.gpu
def test_require_gpu_on_the_card(gpu_device):
    assert jaxutil.require_gpu().platform == "gpu"
    name, limit = jaxutil.card_line().splitlines()[0].split(",")
    assert name.strip() and limit.strip().endswith("W")
