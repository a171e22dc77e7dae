"""Test config: CPU backend with 8 virtual devices, x64 enabled.

Everything here must run before jax is imported anywhere, so this conftest
sets env vars at import time. The CPU is the default; tests marked `gpu`
run on a GPU when JAX_PLATFORMS names one:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_ON_CPU = os.environ["JAX_PLATFORMS"] == "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

import jax  # noqa: E402

# XLA_FLAGS may already be frozen by an earlier jax import, so ask for the
# 8 virtual CPU devices at the config level too.
jax.config.update("jax_num_cpu_devices", 8)
if _ON_CPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFERENCE_PATH = "/root/reference"


def _load_reference_module(relpath, name):
    """Import a reference module with unavailable deps stubbed (cachetools)."""
    import types
    import importlib.util

    if "cachetools" not in sys.modules:
        ct = types.ModuleType("cachetools")

        class LRUCache(dict):
            def __init__(self, maxsize=0):
                super().__init__()
                self.maxsize = maxsize

        ct.LRUCache = LRUCache
        sys.modules["cachetools"] = ct

    import matplotlib
    matplotlib.use("Agg")

    path = os.path.join(REFERENCE_PATH, relpath)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    # register before exec so the reference's ProcessPoolExecutor args
    # (bound methods) stay picklable
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="session")
def reference_nmc():
    if not os.path.exists(os.path.join(REFERENCE_PATH, "NMC/nmc.py")):
        pytest.skip("reference repo not available")
    return _load_reference_module("NMC/nmc.py", "ref_nmc")


@pytest.fixture(scope="session")
def reference_npt():
    if not os.path.exists(os.path.join(REFERENCE_PATH, "NPT/npt.py")):
        pytest.skip("reference repo not available")
    return _load_reference_module("NPT/npt.py", "ref_npt")


@pytest.fixture(scope="session")
def reference_icm():
    if not os.path.exists(os.path.join(REFERENCE_PATH, "NPT/apt_ICM.py")):
        pytest.skip("reference repo not available")
    return _load_reference_module("NPT/apt_ICM.py", "ref_apt_icm")


@pytest.fixture()
def rng():
    return np.random.default_rng(1234)


def random_sk(rng, n):
    J = rng.normal(size=(n, n))
    J = 0.5 * (J + J.T)
    np.fill_diagonal(J, 0.0)
    h = rng.normal(size=n)
    return J, h
