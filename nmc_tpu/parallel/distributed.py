"""Multi-host (DCN) execution support.

The reference scales across cores of ONE machine with a fork-based process
pool (/root/reference/NPT/npt.py:616-640); its cross-machine story is "run
more copies by hand". Here the equivalent is JAX's multi-process runtime:
every host calls :func:`initialize`, meshes are built over the GLOBAL
device set (every device of every host), and the existing
shard_map programs (parallel/sharded_pt.py, parallel/ensemble.py) run
unchanged — they are mesh-agnostic by construction; only host-side gathers
need the :func:`host_gather` helper because sharded arrays spanning other
hosts are not locally addressable.

Launch pattern (one process per host / per slice):

    NMC_TPU_COORDINATOR=host0:8476 NMC_TPU_NUM_PROCESSES=2 \
    NMC_TPU_PROCESS_ID=0 python -m nmc_tpu npt ...   # on host 0
    NMC_TPU_COORDINATOR=host0:8476 NMC_TPU_NUM_PROCESSES=2 \
    NMC_TPU_PROCESS_ID=1 python -m nmc_tpu npt ...   # on host 1

Nothing here autodetects a cluster: give the coordinator address, the
process count and the process id (arguments or env vars), as the CPU
multi-process tests in tests/test_distributed.py do for a 2-process x
4-device mesh.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Join the multi-process JAX runtime; returns True when distributed.

    Arguments fall back to NMC_TPU_COORDINATOR / NMC_TPU_NUM_PROCESSES /
    NMC_TPU_PROCESS_ID env vars; with none set this is a no-op (single
    process). Safe to call twice (second call is ignored).
    """
    import jax

    # Platform forcing must happen at the CONFIG level before any backend
    # initializes.
    plat = os.environ.get("NMC_TPU_PLATFORM")
    if plat:
        jax.config.update("jax_platforms", plat)
    ncpu = os.environ.get("NMC_TPU_NUM_CPU_DEVICES")
    if ncpu:
        jax.config.update("jax_num_cpu_devices", int(ncpu))

    coordinator_address = coordinator_address or os.environ.get(
        "NMC_TPU_COORDINATOR")
    if num_processes is None and "NMC_TPU_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["NMC_TPU_NUM_PROCESSES"])
    if process_id is None and "NMC_TPU_PROCESS_ID" in os.environ:
        process_id = int(os.environ["NMC_TPU_PROCESS_ID"])
    if coordinator_address is None:
        return False
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
    except RuntimeError as e:
        if "already initialized" not in str(e):
            raise
    return True


def initialize_from_env() -> bool:
    """CLI hook: join the distributed runtime iff the env vars are set."""
    return initialize()


def is_multiprocess() -> bool:
    import jax
    return jax.process_count() > 1


def global_mesh(axis_name: str = "replica"):
    """1-D mesh over ALL global devices (every host must build the same)."""
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()), (axis_name,))


def host_gather(x) -> np.ndarray:
    """np.asarray that also works for arrays sharded across OTHER hosts
    (gathers via an allgather collective; all hosts must call it)."""
    if getattr(x, "is_fully_addressable", True):
        return np.asarray(x)
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(x, tiled=True))
