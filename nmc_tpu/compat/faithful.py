"""Reference-faithful host-side sequential MCMC (validation path).

A fresh numpy implementation of the reference's sequential random-scan
heat-bath kernel (/root/reference/NMC/nmc.py:28-91), including the
state-keyed LRU local-field memoization (/root/reference/NMC/nmc.py:73-84).
Used for cross-validation of the device engine's statistics and for the
`use_hash_table` code path on hosts; NOT a performance path. RNG is
numpy's Generator (the reference uses the legacy global RNG seeded at
import, /root/reference/NMC/nmc.py:10 — exact bit-reproduction across RNG
families is impossible, so fidelity is statistical; see docs/DEVIATIONS.md).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import numpy as np


class LRUFieldCache:
    """LRU cache: full spin-state bytes -> local-field vector J@m + h.

    Mirrors cachetools.LRUCache(maxsize=10000) keyed by tuple(m)
    (/root/reference/NMC/nmc.py:73-84,480-484). Keys are raw state bytes,
    which hash faster than tuples.
    """

    def __init__(self, maxsize: int = 10_000):
        self.maxsize = maxsize
        self._data: OrderedDict[bytes, np.ndarray] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def lookup(self, m: np.ndarray) -> Optional[np.ndarray]:
        key = m.tobytes()
        if key in self._data:
            self._data.move_to_end(key)
            self.hits += 1
            return self._data[key]
        self.misses += 1
        return None

    def store(self, m: np.ndarray, fields: np.ndarray) -> None:
        key = m.tobytes()
        self._data[key] = fields
        self._data.move_to_end(key)
        while len(self._data) > self.maxsize:
            self._data.popitem(last=False)

    def __len__(self) -> int:
        return len(self._data)


def mcmc_sequential(
    num_sweeps: int,
    m_start: np.ndarray,
    beta: float,
    J: np.ndarray,
    h: np.ndarray,
    *,
    anneal: bool = False,
    sweeps_per_beta: int = 1,
    initial_beta: float = 0.0,
    hash_table: Optional[LRUFieldCache] = None,
    use_hash_table: bool = False,
    rng: Optional[np.random.Generator] = None,
    incremental: bool = True,
    uniforms: Optional[np.ndarray] = None,   # [num_sweeps, N] override
    scan_order: str = "random",              # 'random' | 'fixed'
) -> np.ndarray:
    """Sequential random-scan heat-bath Gibbs, returning M [N, num_sweeps].

    Semantics of /root/reference/NMC/nmc.py:28-91 (random per-sweep scan
    order, anneal ramp indexing, heat-bath rule sign(tanh(beta*x)-2u+1)),
    with one host-side improvement: `incremental=True` maintains the local
    fields with O(deg) updates per flip instead of recomputing J@m per spin
    — identical trajectories draw-for-draw, O(N) times faster.

    `uniforms`/`scan_order='fixed'` let callers inject the exact random
    draws and the 0..N-1 scan order, enabling draw-for-draw trajectory
    equality checks against the device engine (tests/test_faithful.py).
    """
    if rng is None:
        rng = np.random.default_rng(0)
    J = np.asarray(J.toarray() if hasattr(J, "toarray") else J, dtype=np.float64)
    h = np.asarray(h, dtype=np.float64).reshape(-1)
    m = np.asarray(m_start, dtype=np.float64).reshape(-1).copy()
    N = m.shape[0]
    M = np.zeros((N, num_sweeps))

    num_betas = max(num_sweeps // sweeps_per_beta, 1)
    if anneal:
        beta_vals = np.linspace(initial_beta, beta, num_betas)

    use_cache = use_hash_table and hash_table is not None
    phi = None
    if incremental and not use_cache:
        phi = J @ m + h

    beta_idx = 0
    for jj in range(num_sweeps):
        if anneal:
            if jj % sweeps_per_beta == 0 and beta_idx < num_betas - 1:
                beta_idx += 1
            beta_jj = beta_vals[beta_idx]
        else:
            beta_jj = beta

        order = np.arange(N) if scan_order == "fixed" else rng.permutation(N)
        for pos, kk in enumerate(order):
            if use_cache:
                x = hash_table.lookup(m)
                if x is None:
                    x = J @ m + h
                    hash_table.store(m.copy(), x)
                x_kk = x[kk]
            elif phi is not None:
                x_kk = phi[kk]
            else:
                x_kk = (J @ m + h)[kk]

            u = (uniforms[jj, pos] if uniforms is not None
                 else rng.random())
            new = np.sign(np.tanh(beta_jj * x_kk) - 2.0 * u + 1.0)
            if phi is not None and new != m[kk]:
                phi += (new - m[kk]) * J[:, kk]
            m[kk] = new
        M[:, jj] = m
    return M
