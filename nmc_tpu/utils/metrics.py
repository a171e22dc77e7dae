"""Metrics, structured logging and profiling helpers.

The reference's observability is print statements and wall-clock deltas
(/root/reference/NPT/npt.py:619,682-683, apt_preprocessor.py:152,194-195).
Here runs emit structured records (JSONL) — energy traces, sigma_E, swap
acceptance per pair, cluster sizes, attempts/sec — and profiling wraps
jax.profiler so device traces can be captured around any section.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

logger = logging.getLogger("nmc_tpu")


def _to_jsonable(v):
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


@dataclasses.dataclass
class MetricsLogger:
    """Append-only JSONL metrics sink + in-memory aggregation."""

    path: Optional[str] = None
    echo: bool = False
    records: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    def log(self, kind: str, **fields):
        rec = {"kind": kind, "t": time.time()}
        rec.update({k: _to_jsonable(v) for k, v in fields.items()})
        self.records.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if self.echo:
            logger.info("%s %s", kind, {k: v for k, v in rec.items()
                                        if k not in ("kind", "t")})
        return rec

    def of_kind(self, kind: str) -> List[Dict[str, Any]]:
        return [r for r in self.records if r["kind"] == kind]

    # convenience wrappers used by the drivers ---------------------------
    def sweep_stats(self, *, phase: str, num_sweeps: int, num_chains: int,
                    num_spins: int, seconds: float, min_energy: float):
        attempts = num_sweeps * num_chains * num_spins
        return self.log("sweeps", phase=phase, num_sweeps=num_sweeps,
                        num_chains=num_chains, num_spins=num_spins,
                        seconds=seconds,
                        attempts_per_sec=attempts / max(seconds, 1e-12),
                        min_energy=min_energy)

    def swap_stats(self, *, round_index: int, pairs, accepted,
                   energies=None):
        return self.log("swap", round_index=round_index, pairs=pairs,
                        accepted=accepted, energies=energies)

    def apt_rung(self, *, rung: int, beta: float, sigma_E: float,
                 seconds: float):
        return self.log("apt_rung", rung=rung, beta=beta, sigma_E=sigma_E,
                        seconds=seconds)

    def cluster_stats(self, *, cycle: int, sizes):
        return self.log("clusters", cycle=cycle, sizes=sizes,
                        total=int(np.sum(sizes)) if len(sizes) else 0)


@contextlib.contextmanager
def timed(metrics: Optional[MetricsLogger], kind: str, **fields) -> Iterator[dict]:
    """Time a section; logs `kind` with a `seconds` field on exit."""
    box: Dict[str, Any] = {}
    t0 = time.perf_counter()
    try:
        yield box
    finally:
        box["seconds"] = time.perf_counter() - t0
        if metrics is not None:
            metrics.log(kind, seconds=box["seconds"],
                        **{k: v for k, v in {**fields, **box}.items()
                           if k != "seconds"})


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a jax.profiler device trace around a section."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def flips_per_second(num_sweeps: int, num_chains: int, num_spins: int,
                     seconds: float) -> float:
    return num_sweeps * num_chains * num_spins / max(seconds, 1e-12)
