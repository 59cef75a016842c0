"""Host-side configuration: the compilation-cache path and the device
memory budget for resident streamed groups."""

import os
import types

import jax
import pytest

from image_matching.matching import streaming
from image_matching.utils import jaxcfg


@pytest.fixture
def restore_cache_config():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs",
            "jax_persistent_cache_min_entry_size_bytes")
    old = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in old.items():
        jax.config.update(k, v)


def test_cache_honours_env_var(tmp_path, monkeypatch, restore_cache_config):
    target = tmp_path / "cc"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(target))
    assert jaxcfg.enable_compilation_cache() == str(target)
    assert jax.config.jax_compilation_cache_dir == str(target)
    assert target.is_dir()


def test_cache_defaults_to_checkout(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = jaxcfg.enable_compilation_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(jaxcfg.__file__)))
    assert path == os.path.join(os.path.dirname(root), ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


class _FakeDevice:
    device_kind = "fake accelerator"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


_CTX = types.SimpleNamespace(Lq=14, n=32768)
_RESERVE = 2 * 2**30 + 8 * 14 * 32768 * 4 * 512


@pytest.mark.parametrize("limit_gb", [16, 60])
def test_hbm_budget_from_bytes_limit(limit_gb, monkeypatch):
    monkeypatch.delenv("IMTPU_HBM_BUDGET_GB", raising=False)
    dev = _FakeDevice({"bytes_limit": limit_gb * 2**30, "bytes_in_use": 5})
    assert streaming._hbm_budget_bytes(_CTX, dev) == limit_gb * 2**30 - _RESERVE


def test_hbm_budget_never_negative(monkeypatch):
    monkeypatch.delenv("IMTPU_HBM_BUDGET_GB", raising=False)
    dev = _FakeDevice({"bytes_limit": 2**30})
    assert streaming._hbm_budget_bytes(_CTX, dev) == 0


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 1}])
def test_hbm_budget_without_stats_is_an_error(stats, monkeypatch):
    monkeypatch.delenv("IMTPU_HBM_BUDGET_GB", raising=False)
    with pytest.raises(RuntimeError, match="bytes_limit"):
        streaming._hbm_budget_bytes(_CTX, _FakeDevice(stats))


def test_hbm_budget_env_override(monkeypatch):
    monkeypatch.setenv("IMTPU_HBM_BUDGET_GB", "0.5")
    assert streaming._hbm_budget_bytes(_CTX, _FakeDevice(None)) == 2**29
