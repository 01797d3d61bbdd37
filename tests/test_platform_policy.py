"""Per-platform engine policy and compile-cache resolution, with the
platform and environment monkeypatched (no accelerator needed)."""

import os
import types

import pytest

import dashing2_tpu
from dashing2_tpu.cmp import core as C


def _platform(monkeypatch, name):
    import jax
    monkeypatch.setattr(jax, "devices",
                        lambda *a: [types.SimpleNamespace(platform=name)])


@pytest.mark.parametrize("plat,mode", [("cpu", "xla"), ("gpu", "tri")])
def test_kernel_mode_per_platform(monkeypatch, plat, mode):
    monkeypatch.delenv("DASHING2_TPU_KERNEL", raising=False)
    _platform(monkeypatch, plat)
    assert C._kernel_mode() == mode


def test_kernel_mode_unknown_platform_is_an_error(monkeypatch):
    monkeypatch.delenv("DASHING2_TPU_KERNEL", raising=False)
    _platform(monkeypatch, "rocm")
    with pytest.raises(RuntimeError, match="no comparison-engine policy"):
        C._kernel_mode()


@pytest.mark.parametrize("env", ["xla", "swar", "tri"])
def test_kernel_mode_env_override(monkeypatch, env):
    monkeypatch.setenv("DASHING2_TPU_KERNEL", env)
    _platform(monkeypatch, "gpu")
    assert C._kernel_mode() == env


def test_kernel_mode_rejects_removed_modes(monkeypatch):
    monkeypatch.setenv("DASHING2_TPU_KERNEL", "pallas")
    with pytest.raises(ValueError, match="DASHING2_TPU_KERNEL"):
        C._kernel_mode()


@pytest.mark.parametrize("n,mode,on", [(10, "swar", True), (10, "tri", False),
                                       (64, "tri", True), (64, "xla", False),
                                       (1 << 30, "swar", False)])
def test_swar_route_by_mode(n, mode, on):
    assert C._swar_route(n, mode) is on


def _cache_env(monkeypatch, **env):
    for k in ("JAX_COMPILATION_CACHE_DIR", "JAX_PLATFORMS",
              "DASHING2_TPU_NO_COMPILE_CACHE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def test_compile_cache_env_dir_wins(monkeypatch, tmp_path):
    _cache_env(monkeypatch, JAX_COMPILATION_CACHE_DIR=str(tmp_path),
               JAX_PLATFORMS="cpu")
    assert dashing2_tpu.compile_cache_dir() == str(tmp_path)


@pytest.mark.parametrize("plats", ["", "cuda", "gpu,cpu"])
def test_compile_cache_default_is_fixed_in_checkout(monkeypatch, plats):
    _cache_env(monkeypatch, **({"JAX_PLATFORMS": plats} if plats else {}))
    d = dashing2_tpu.compile_cache_dir()
    root = os.path.dirname(os.path.dirname(dashing2_tpu.__file__))
    assert d == os.path.join(root, ".jax_cache")
    assert dashing2_tpu.compile_cache_dir() == d   # no host, pid or time


@pytest.mark.parametrize("env", [{"JAX_PLATFORMS": "cpu"},
                                 {"JAX_PLATFORMS": "CPU, cpu"},
                                 {"DASHING2_TPU_NO_COMPILE_CACHE": "1"}])
def test_compile_cache_off(monkeypatch, env):
    _cache_env(monkeypatch, **env)
    assert dashing2_tpu.compile_cache_dir() is None
