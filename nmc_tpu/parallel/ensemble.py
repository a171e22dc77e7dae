"""Instance-ensemble parallelism: many problems, one SPMD program.

The reference has no in-code ensemble mode — users launch one process per
instance file (SURVEY.md section 2.2). Here an ensemble of same-size Ising
instances is a leading `instance` axis sharded over the mesh, with
replicas vmapped inside each shard: BASELINE.json config 5
("100 SK-1000 instances x 64 replicas sharded over the devices").

Each instance runs an independent parallel-tempering chain set; swaps are
beta-label permutations (parallel/swaps.py) computed per instance inside
the same jitted program, so the step involves ZERO cross-instance
communication — it scales linearly over chips by construction.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.problem import IsingProblem, block_problem
from ..ops.sweeps import layout_sweeps
from .swaps import metropolis_label_swap


@dataclasses.dataclass
class EnsembleConfig:
    num_replicas: int = 16
    sweeps_per_round: int = 32
    num_swapping_pairs: int = 4
    block_size: int = 128
    within_block: str = "sequential"
    precision: str = "highest"
    dtype: str = "float32"


class EnsembleState(NamedTuple):
    m: jax.Array             # [I, R, n_pad] sharded over 'instance'
    beta_to_slot: jax.Array  # [I, R]
    slot_to_beta: jax.Array  # [I, R]
    best_e: jax.Array        # [I] best energy seen per instance
    best_m: jax.Array        # [I, n_pad]
    key: jax.Array
    round_index: jax.Array


class EnsemblePT:
    """Sharded ensemble of independent PT runs (one per instance)."""

    def __init__(
        self,
        problems: Sequence[IsingProblem],
        beta_list: Sequence[float],
        cfg: EnsembleConfig = EnsembleConfig(),
        mesh: Optional[Mesh] = None,
        axis_name: str = "instance",
    ):
        self.cfg = cfg
        self.axis = axis_name
        ns = {p.n for p in problems}
        if len(ns) != 1:
            raise ValueError("ensemble instances must share the same size")
        self.I = len(problems)
        self.beta_np = np.asarray(beta_list, dtype=np.float64)
        self.R = self.beta_np.shape[0]

        if mesh is None:
            mesh = Mesh(np.array(jax.devices()), (axis_name,))
        self.mesh = mesh
        self.n_dev = mesh.shape[axis_name]
        if self.I % self.n_dev != 0:
            raise ValueError(
                f"{self.I} instances must divide over {self.n_dev} devices")

        dtype = jnp.dtype(cfg.dtype)
        np_dtype = np.dtype(dtype.name)
        blocked = [block_problem(p, block_size=cfg.block_size, dtype=np_dtype)
                   for p in problems]
        self.blocked0 = blocked[0]
        self.n_pad = blocked[0].n_pad
        inst_sharding = NamedSharding(mesh, P(axis_name))
        self.J_rows = jax.device_put(
            jnp.stack([jnp.asarray(b.J_rows) for b in blocked]), inst_sharding)
        self.J_diag = jax.device_put(
            jnp.stack([jnp.asarray(b.J_diag) for b in blocked]), inst_sharding)
        self.h = jax.device_put(
            jnp.stack([jnp.asarray(b.h) for b in blocked]), inst_sharding)
        self.active = jnp.asarray(blocked[0].active)
        # the sweep stage goes through the one implementation choice
        # (ops.sweeps.choose_sweep_impl) over the family's union tiles
        self._sweeps = layout_sweeps(blocked, np_dtype)
        self.beta_list = jnp.asarray(self.beta_np, dtype)

        self._round_jit = jax.jit(self._build_round())

    def init_state(self, key, m0=None) -> EnsembleState:
        """Random +-1 start.  `m0` (optional, [I, C, n] ORIGINAL spin
        order, ascending energy — e.g. `ops.spectral.spectral_candidates`
        states) seeds the C coldest chains (largest beta = highest slot
        index at init) per instance, best candidate coldest; the
        remaining R-C chains stay random."""
        k_m, key = jax.random.split(key)
        u = jax.random.uniform(k_m, (self.I, self.R, self.n_pad),
                               dtype=self.h.dtype)
        m = jnp.where(u < 0.5, -1.0, 1.0).astype(self.h.dtype)
        if m0 is not None:
            m0 = self.blocked0.to_blocked(np.asarray(m0), fill=1.0)
            m0 = jnp.asarray(m0, self.h.dtype)
            C = m0.shape[1]
            if C > self.R:
                raise ValueError(f"m0 has {C} seeds > {self.R} replicas")
            m = m.at[:, self.R - C:, :].set(m0[:, ::-1, :])
        m = jnp.where(self.active, m, 1.0)
        m = jax.device_put(m, NamedSharding(self.mesh, P(self.axis)))
        ids = jnp.broadcast_to(jnp.arange(self.R, dtype=jnp.int32),
                               (self.I, self.R))
        return EnsembleState(
            m=m, beta_to_slot=ids, slot_to_beta=ids,
            best_e=jnp.full((self.I,), jnp.inf, self.h.dtype),
            best_m=jnp.ones((self.I, self.n_pad), self.h.dtype),
            key=key, round_index=jnp.int32(0),
        )

    def _build_round(self):
        cfg = self.cfg
        axis = self.axis
        R, n_pad = self.R, self.n_pad
        dtype = self.h.dtype

        def one_instance(J_rows, J_diag, h, m, b2s, s2b, best_e, best_m, key):
            beta_slot = self.beta_list[s2b].astype(dtype)[:, None]  # [R,1]
            phi = jnp.matmul(m, J_rows.reshape(n_pad, n_pad),
                             precision=cfg.precision) + h
            act = jnp.broadcast_to(self.active, (R, n_pad))
            k_sweep, k_swap = jax.random.split(key)
            res = self._sweeps(
                J_rows, J_diag, h, m, phi, k_sweep,
                jnp.ones((cfg.sweeps_per_round,), dtype),
                jnp.broadcast_to(beta_slot, (R, n_pad)), act,
                num_sweeps=cfg.sweeps_per_round,
                within_block=cfg.within_block, block_order="fixed",
                record_m=False, precision=cfg.precision,
            )
            e_slot = res.energies[-1]
            swap = metropolis_label_swap(
                k_swap, b2s, self.beta_list.astype(jnp.float32),
                e_slot.astype(jnp.float32), num_pairs=cfg.num_swapping_pairs)
            r_best = jnp.argmin(res.e_best)
            improved = res.e_best[r_best] < best_e
            best_e = jnp.where(improved, res.e_best[r_best], best_e)
            best_m = jnp.where(improved, res.m_best[r_best], best_m)
            return (res.m, swap.beta_to_slot, swap.slot_to_beta,
                    best_e, best_m)

        def _round(J_rows, J_diag, h, state: EnsembleState) -> EnsembleState:
            # problem data arrives as ARGUMENTS, not closure captures —
            # multi-process meshes forbid closing over arrays whose shards
            # live on other hosts
            keys = jax.vmap(
                lambda i: jax.random.fold_in(
                    jax.random.fold_in(state.key, state.round_index), i)
            )(jnp.arange(self.I))
            m, b2s, s2b, best_e, best_m = jax.vmap(one_instance)(
                J_rows, J_diag, h, state.m,
                state.beta_to_slot, state.slot_to_beta,
                state.best_e, state.best_m, keys)
            return EnsembleState(m=m, beta_to_slot=b2s, slot_to_beta=s2b,
                                 best_e=best_e, best_m=best_m, key=state.key,
                                 round_index=state.round_index + 1)

        return _round

    def round(self, state: EnsembleState) -> EnsembleState:
        return self._round_jit(self.J_rows, self.J_diag, self.h, state)

    def run(self, state: EnsembleState, num_rounds: int) -> EnsembleState:
        for _ in range(num_rounds):
            state = self.round(state)
        return state

    def best_states(self, state: EnsembleState) -> np.ndarray:
        """[I, n] best states per instance, original spin order.
        Multi-host safe: allgathers instance shards across processes."""
        from .distributed import host_gather
        return host_gather(state.best_m)[:, np.asarray(self.blocked0.inv_perm)]

    def best_energies(self, state: EnsembleState) -> np.ndarray:
        from .distributed import host_gather
        return host_gather(state.best_e)
