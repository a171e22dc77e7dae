"""Run-environment rules: the compile-cache location, and entry points
that measure the device refusing to run without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

from nmc_tpu.utils import compcache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_honours_env(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    assert compcache.cache_dir() is None


def test_compile_cache_default_is_fixed_in_repo(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compcache.cache_dir() == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def _run(args, cwd, **env):
    full = {k: v for k, v in os.environ.items()
            if k not in ("PYTHONPATH", "XLA_FLAGS")}
    full.update(JAX_PLATFORMS="cpu", **env)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=full,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_cpu_backend(script):
    r = _run([script], REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout and '"value"' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], str(tmp_path))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
