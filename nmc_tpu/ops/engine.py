"""SweepEngine: user-facing wrapper around the blocked Gibbs kernel.

Owns the device copies of a BlockedProblem and exposes batched sweep runs in
ORIGINAL spin order (permutation/padding handled internally). One engine is
shared by every algorithm driver (models/nmc.py, models/npt.py, models/apt.py,
models/apt_icm.py) — the reference instead carries four duplicated MCMC
methods (/root/reference/NMC/nmc.py:28, /root/reference/NPT/npt.py:47,
/root/reference/NPT/apt_preprocessor.py:33, /root/reference/NPT/apt_ICM.py:52).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.energy import local_fields
from ..core.problem import (BlockedProblem, IsingProblem, block_problem,
                            block_sparse_tiles, tile_columns)
from .sweeps import (SweepResult, anneal_schedule, choose_sweep_impl,
                     sweep_fn)


class EngineResult(NamedTuple):
    """Sweep outputs gathered back to original spin order."""
    m: np.ndarray | jax.Array          # [R, n]
    m_best: np.ndarray | jax.Array     # [R, n]
    e_best: np.ndarray | jax.Array     # [R]
    energies: np.ndarray | jax.Array   # [T, R]
    M: Optional[np.ndarray | jax.Array]  # [T, R, n] if recorded


class SweepEngine:
    def __init__(
        self,
        problem: IsingProblem,
        *,
        block_size: int = 128,
        groups: Optional[list] = None,
        use_coloring: bool = False,
        within_block: str = "sequential",
        block_order: str = "fixed",
        dtype=jnp.float32,
        precision: str = "highest",
        backend: str = "auto",   # 'auto' | 'xla' | 'triton'
                                 # (ops.sweeps.choose_sweep_impl)
        sparse_phi: bool = False,  # XLA path: block-sparse phi update
                                   # over the nonzero column tiles
    ):
        self.problem = problem
        self.dtype = dtype
        self.block_order = block_order
        self.precision = precision
        self.backend = backend
        np_dtype = np.dtype(jnp.dtype(dtype).name)
        if use_coloring and groups is None:
            from .coloring import color_groups
            groups = color_groups(problem.J)
        self.blocked: BlockedProblem = block_problem(
            problem, block_size=block_size, groups=groups, dtype=np_dtype,
        )
        # Colored layouts make the all-at-once block update exact Gibbs.
        self.within_block = "jacobi" if self.blocked.colored else within_block
        # validates `backend` now: an explicit 'triton' the kernel cannot
        # serve raises here rather than at the first run
        self.impl = self._impl(record_m=False)
        self.sparse_tiles = None
        if sparse_phi:
            col_idx, J_tiles = block_sparse_tiles(self.blocked)
            self.sparse_tiles = (jnp.asarray(col_idx),
                                 jnp.asarray(J_tiles))
        b = self.blocked
        self.col_idx, self.counts = tile_columns(
            b.J_rows.reshape(b.n_pad, b.n_pad), b.block_size)
        self.J_rows = jnp.asarray(b.J_rows)
        self.J_diag = jnp.asarray(b.J_diag)
        self.h = jnp.asarray(b.h)
        self.J_full = self.J_rows.reshape(b.n_pad, b.n_pad)
        self.active = jnp.asarray(b.active)
        self._inv_perm = jnp.asarray(b.inv_perm)

    # ---- layout helpers -------------------------------------------------
    @property
    def n(self) -> int:
        return self.blocked.n

    @property
    def n_pad(self) -> int:
        return self.blocked.n_pad

    def to_blocked(self, x, fill=0.0) -> jax.Array:
        """[..., n] original order -> [..., n_pad] blocked layout."""
        x = jnp.asarray(x, dtype=self.dtype)
        shape = x.shape[:-1] + (self.n_pad,)
        out = jnp.full(shape, fill, dtype=self.dtype)
        return out.at[..., self._inv_perm].set(x)

    def to_blocked_mask(self, mask) -> jax.Array:
        mask = jnp.asarray(mask, dtype=bool)
        out = jnp.zeros(mask.shape[:-1] + (self.n_pad,), dtype=bool)
        return out.at[..., self._inv_perm].set(mask)

    def from_blocked(self, x) -> jax.Array:
        """[..., n_pad] blocked layout -> [..., n] original order."""
        return jnp.asarray(x)[..., self._inv_perm]

    def init_states(self, key, num_replicas: int) -> jax.Array:
        """Random +-1 states, blocked layout [R, n_pad] (+1 on padding)."""
        u = jax.random.uniform(key, (num_replicas, self.n_pad), dtype=self.dtype)
        m = jnp.where(u < 0.5, -1.0, 1.0).astype(self.dtype)
        return jnp.where(self.active, m, 1.0)

    def fields(self, m_blocked) -> jax.Array:
        return local_fields(self.J_full, self.h, m_blocked,
                            precision=self.precision)

    def _impl(self, record_m: bool) -> str:
        return choose_sweep_impl(
            self.backend, colored=self.blocked.colored,
            block_size=self.blocked.block_size, dtype=self.dtype,
            block_order=self.block_order, record_m=record_m)

    # ---- main entry ------------------------------------------------------
    def run(
        self,
        m_start,                 # [R, n] original order, or [R, n_pad] if blocked_input
        key,
        num_sweeps: int,
        beta,                    # scalar | [T] per-sweep schedule
        *,
        anneal: bool = False,
        sweeps_per_beta: int = 1,
        initial_beta: float = 0.0,
        beta_spin=None,          # [n] | [R, n] per-spin beta multiplier (heating)
        beta_replica=None,       # [R] per-replica beta multiplier (PT)
        update_mask=None,        # [n] | [R, n] bool; False = frozen
        record_m: bool = False,
        blocked_input: bool = False,
        blocked_output: bool = False,
        phi0=None,
    ) -> EngineResult | SweepResult:
        m0 = jnp.asarray(m_start, dtype=self.dtype)
        if m0.ndim == 1:
            m0 = m0[None, :]
        if not blocked_input:
            m0 = jnp.where(self.active, self.to_blocked(m0), 1.0)
        R = m0.shape[0]

        if anneal:
            beta_sweep = anneal_schedule(num_sweeps, float(beta),
                                         float(initial_beta), sweeps_per_beta,
                                         dtype=self.dtype)
        else:
            beta_sweep = jnp.asarray(beta, dtype=self.dtype)

        if beta_replica is not None:
            if beta_spin is not None:
                raise ValueError("pass beta_spin or beta_replica, not both")
            bs = jnp.asarray(beta_replica, self.dtype).reshape(R, 1)
        elif beta_spin is None:
            bs = jnp.ones((), dtype=self.dtype)
        else:
            bs = jnp.asarray(beta_spin, dtype=self.dtype)
            if not blocked_input:
                bs = self.to_blocked(jnp.broadcast_to(bs, (R, self.n)), fill=1.0)

        if update_mask is None:
            mask = self.active
        else:
            mask = jnp.asarray(update_mask, dtype=bool)
            if not blocked_input:
                mask = self.to_blocked_mask(jnp.broadcast_to(mask, (R, self.n)))
            mask = mask & self.active

        phi = self.fields(m0) if phi0 is None else phi0

        impl = self.impl if not record_m else self._impl(record_m=True)
        res = sweep_fn(impl, self.col_idx, self.counts)(
            self.J_rows, self.J_diag, self.h, m0, phi, key,
            beta_sweep, bs, mask, self.sparse_tiles,
            num_sweeps=num_sweeps,
            within_block=self.within_block,
            block_order=self.block_order,
            record_m=record_m,
            precision=self.precision,
        )
        if blocked_output:
            return res
        return EngineResult(
            m=self.from_blocked(res.m),
            m_best=self.from_blocked(res.m_best),
            e_best=res.e_best,
            energies=res.energies,
            M=self.from_blocked(res.M) if res.M is not None else None,
        )
