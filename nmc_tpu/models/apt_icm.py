"""APT + ICM — parallel tempering with Houdayer isoenergetic cluster moves.

Accelerator rebuild of /root/reference/NPT/apt_ICM.py. Per swap round the
reference runs a SERIAL double loop over num_replicas x 10 sub-replicas
(apt_ICM.py:197-213, `num_cores` accepted but unused); here all R*S chains
are one batch axis of a single jitted sweep call. The Houdayer move pairs
same-temperature sub-replicas at random, finds connected components of the
disagreement graph (spins with s1_i*s2_i = -1 over J-edges), and exchanges a
random cluster between partners, with Katzgraber's modification flipping all
of state_1 when the cluster exceeds N/2 spins (apt_ICM.py:216-246).

Reference quirks preserved by default (disable with faithful_quirks=False):
  * Houdayer operates on the FIRST sweep's state of each sub-replica block
    and its outcome is written only into the recorded M, never into the
    chain's continuation state (apt_ICM.py:225-246 vs 213) — so ICM moves
    do not propagate into subsequent dynamics;
  * num_subreplicas=10 and useKatzgraber=True are exposed (hardcoded at
    apt_ICM.py:177-178);
  * the final per-replica energy reads sub-replica 0's first
    num_sweeps_read_per_swap sweeps of the last round (apt_ICM.py:290-297);
  * normalization is the CALLER's job (apt_ICM.py:342-344), so
    normalize=False by default here.
With faithful_quirks=False the move uses final states and feeds back into
the chains (the physically intended ICM).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..core.problem import IsingProblem
from ..ops.clusters import (disagreement_clusters_adj,
                            houdayer_move_sparse)
from ..ops.engine import SweepEngine
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.metrics import MetricsLogger
from .npt import select_non_overlapping_pairs


@dataclasses.dataclass
class APTICMConfig:
    """Mirrors /root/reference/NPT/apt_ICM.py:145-146 kwargs + exposed constants."""
    num_sweeps_MCMC: int = 1000
    num_sweeps_read: int = 1000
    num_swap_attempts: int = 100
    num_swapping_pairs: int = 1
    num_subreplicas: int = 10
    use_katzgraber: bool = True
    use_hash_table: bool = False   # parity no-op (docs/DEVIATIONS.md)
    faithful_quirks: bool = True   # see module docstring
    normalize: bool = False        # reference expects pre-normalized J, h
    device_icm: Optional[bool] = None  # Houdayer move fully on device (one
                                   # vmapped call for all pairs; exact —
                                   # label propagation runs to fixed point).
                                   # None = auto: device above 2048 spins,
                                   # host (native C++ union-find) below.
    icm_label_iters: Optional[int] = None  # optional iteration CAP; None
                                           # runs to the fixed point
    record_last_round_m: bool = False  # keep the last round's per-sweep
                                       # history (reference M layout)
    # device execution knobs
    block_size: int = 128
    use_coloring: bool = False
    dtype: str = "float32"
    precision: str = "highest"
    # fault tolerance (mirrors NPTConfig; the drivers are feature-symmetric)
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 0      # snapshot every K swap rounds (0 = off)
    resume: bool = False
    # time-to-solution instrumentation (NORMALIZED units; see NPTConfig)
    target_energy: Optional[float] = None
    target_atol: float = 0.0


class APTICMResult(NamedTuple):
    Energy: np.ndarray          # [R] reference-semantics replica energies
    energy_trace: np.ndarray    # [R, read_per_swap] sub-replica-0 last round
    final_states: np.ndarray    # [R, S, n]
    M_history: Optional[np.ndarray]  # [R, S, per_swap, n] last round
                                     # (first column Houdayer-modified,
                                     # reference record semantics)
    min_energy: float
    best_state: np.ndarray      # [n]
    swap_counts: np.ndarray     # [num_swap_attempts]
    icm_moves: int              # Houdayer exchanges performed
    icm_flips: int              # Katzgraber full flips performed
    beta_list: np.ndarray
    rounds_completed: int = 0
    hit_round: Optional[int] = None
    hit_seconds: Optional[float] = None


import functools


@functools.partial(jax.jit, static_argnames=("num_iters", "use_katzgraber"))
def _houdayer_batch(src, dst, s1b, s2b, keys, *, num_iters, use_katzgraber):
    """All (replica, pair) Houdayer moves as ONE vmapped dispatch, using the
    O(nnz) edge-list label propagation (no [N, N] adjacency per pair)."""
    return jax.vmap(
        lambda a, b, k: houdayer_move_sparse(
            src, dst, a, b, k, num_iters=num_iters,
            use_katzgraber=use_katzgraber)
    )(s1b, s2b, keys)


def apt_icm_run(
    problem: IsingProblem,
    beta_list: Sequence[float],
    cfg: APTICMConfig = APTICMConfig(),
    key: Optional[jax.Array] = None,
    metrics: Optional["MetricsLogger"] = None,
) -> APTICMResult:
    t_entry = time.perf_counter()
    if key is None:
        key = jax.random.PRNGKey(0)
    beta_list = np.asarray(beta_list, dtype=np.float64).reshape(-1)
    R = beta_list.shape[0]
    S = cfg.num_subreplicas
    norm_prob = problem.normalized()[0] if cfg.normalize else problem
    n = norm_prob.n
    engine = SweepEngine(
        norm_prob, block_size=cfg.block_size, use_coloring=cfg.use_coloring,
        dtype=jnp.dtype(cfg.dtype), precision=cfg.precision,
    )

    per_swap = cfg.num_sweeps_MCMC // cfg.num_swap_attempts
    read_per_swap = max(cfg.num_sweeps_read // cfg.num_swap_attempts, 1)
    if per_swap < 1:
        raise ValueError("num_sweeps_MCMC // num_swap_attempts must be >= 1")

    key, k_init = jax.random.split(key)
    m_start = np.asarray(
        engine.from_blocked(engine.init_states(k_init, R * S)), dtype=np.float64
    ).reshape(R, S, n)
    device_icm = (cfg.device_icm if cfg.device_icm is not None
                  else norm_prob.n > 2048)
    if device_icm:
        from ..ops.lbp_sparse import EdgeGraph
        graph = EdgeGraph.from_dense(norm_prob.J)   # built once
        adjacency = None
    else:
        from .. import native
        adjacency = native.CSRAdjacency(norm_prob.J)  # built once
    host_rng = np.random.default_rng(np.asarray(jax.random.key_data(key)).ravel()[-1])

    # all R*S chains share one batched kernel; chain (r, s) runs at beta_list[r]
    beta_chain = np.repeat(beta_list, S)  # [R*S]
    all_pairs = [(i, i + 1) for i in range(1, R)]
    swap_counts = np.zeros(cfg.num_swap_attempts)
    icm_moves = icm_flips = 0
    best_e, best_state = np.inf, m_start[0, 0].copy()
    energies_round = np.zeros((R, S, per_swap))

    M_history = None
    start_round = 0
    if cfg.resume and cfg.checkpoint_path and os.path.exists(cfg.checkpoint_path):
        snap, step, extra = load_checkpoint(cfg.checkpoint_path)
        m_start = snap["m_start"]
        energies_round = snap["energies_round"]
        swap_counts = snap["swap_counts"]
        best_e = float(snap["best_e"])
        best_state = snap["best_state"]
        key = jnp.asarray(snap["key"])
        icm_moves = int(snap["icm_moves"])
        icm_flips = int(snap["icm_flips"])
        host_rng.bit_generator.state = extra["rng_state"]
        start_round = int(step)

    rounds_completed = start_round
    hit_round: Optional[int] = None
    hit_seconds: Optional[float] = None

    for round_i in range(start_round, cfg.num_swap_attempts):
        round_t0 = time.perf_counter()
        key, k_a, k_b = jax.random.split(key, 3)
        flat = m_start.reshape(R * S, n)
        record = (cfg.record_last_round_m
                  and round_i == cfg.num_swap_attempts - 1)

        # --- sweeps: 1 sweep (captures the 'first column' state), then rest
        res_a = engine.run(flat, k_a, num_sweeps=1, beta=1.0,
                           beta_replica=beta_chain)
        first_states = np.asarray(res_a.m, dtype=np.float64).reshape(R, S, n)
        e_first = np.asarray(res_a.energies)[0].reshape(R, S)
        if per_swap > 1:
            res_b = engine.run(np.asarray(res_a.m), k_b,
                               num_sweeps=per_swap - 1, beta=1.0,
                               beta_replica=beta_chain, record_m=record)
            final_states = np.asarray(res_b.m, dtype=np.float64).reshape(R, S, n)
            e_rest = np.asarray(res_b.energies).T.reshape(R, S, per_swap - 1)
            eb = np.asarray(res_b.e_best)
            if record:
                # [T-1, R*S, n] -> [R, S, T-1, n]
                hist_b = np.asarray(res_b.M).transpose(1, 0, 2).reshape(
                    R, S, per_swap - 1, n)
                M_history = np.concatenate(
                    [first_states[:, :, None, :], hist_b], axis=2)
        else:
            final_states = first_states.copy()
            e_rest = np.zeros((R, S, 0))
            eb = np.asarray(res_a.e_best)
            if record:
                M_history = first_states[:, :, None, :].copy()
        energies_round[:, :, 0] = e_first
        energies_round[:, :, 1:] = e_rest

        if eb.min() < best_e:
            ridx = int(eb.argmin())
            best_e = float(eb.min())
            src = np.asarray((res_b if per_swap > 1 else res_a).m_best)
            best_state = src[ridx].copy()

        # --- Houdayer move per replica -----------------------------------
        icm_states = first_states if cfg.faithful_quirks else final_states
        touched = []
        pairings = [host_rng.permutation(S) for _ in range(R)]
        if device_icm:
            # one jitted vmapped call covering every (replica, pair)
            key, k_icm = jax.random.split(key)
            ridx, jidx, kidx = [], [], []
            for r in range(R):
                for p in range(S // 2):
                    ridx.append(r)
                    jidx.append(int(pairings[r][2 * p]))
                    kidx.append(int(pairings[r][2 * p + 1]))
            P = len(ridx)
            s1b = jnp.asarray(icm_states[ridx, jidx], jnp.float32)
            s2b = jnp.asarray(icm_states[ridx, kidx], jnp.float32)
            keys = jax.random.split(k_icm, P)
            s1n, s2n, moved, flipped = _houdayer_batch(
                graph.src, graph.dst, s1b, s2b, keys,
                num_iters=cfg.icm_label_iters,
                use_katzgraber=cfg.use_katzgraber)
            icm_states[ridx, jidx] = np.asarray(s1n, np.float64)
            icm_states[ridx, kidx] = np.asarray(s2n, np.float64)
            icm_moves += int(np.asarray(moved).sum())
            icm_flips += int(np.asarray(flipped).sum())
            touched = list(zip(ridx, jidx)) + list(zip(ridx, kidx))
        else:
            for r in range(R):
                shuffled = pairings[r]
                for p in range(S // 2):
                    j, k_sub = int(shuffled[2 * p]), int(shuffled[2 * p + 1])
                    s1 = icm_states[r, j].copy()
                    s2 = icm_states[r, k_sub].copy()
                    clusters = disagreement_clusters_adj(adjacency, s1, s2)
                    if not clusters:
                        continue
                    cl = clusters[int(host_rng.integers(len(clusters)))]
                    if cfg.use_katzgraber and cl.size > n // 2:
                        s1 = -s1
                        icm_flips += 1
                    else:
                        s1[cl], s2[cl] = s2[cl].copy(), s1[cl].copy()
                        icm_moves += 1
                    icm_states[r, j] = s1
                    icm_states[r, k_sub] = s2
                    touched.append((r, j))
                    touched.append((r, k_sub))

        if touched:
            idx = np.array(touched)
            new_e = np.asarray(norm_prob.energy(icm_states[idx[:, 0], idx[:, 1]]))
            col = 0 if cfg.faithful_quirks else per_swap - 1
            energies_round[idx[:, 0], idx[:, 1], col] = new_e
            if M_history is not None:
                # the record's column gets the Houdayer-modified states
                # (reference writes the move into M only, apt_ICM.py:243-246)
                M_history[idx[:, 0], idx[:, 1], col] = \
                    icm_states[idx[:, 0], idx[:, 1]]
            if cfg.faithful_quirks and per_swap == 1:
                # first column IS the last column: the record feeds the swaps
                final_states = icm_states

        if not cfg.faithful_quirks:
            final_states = icm_states

        m_start = final_states.copy()
        last_e = energies_round[:, :, -1].copy()

        # --- PT swaps, one Metropolis test per sub-replica per pair ------
        selected = select_non_overlapping_pairs(
            all_pairs, cfg.num_swapping_pairs, host_rng)
        for s in range(S):
            for (sel, nxt) in selected:
                E_sel, E_nxt = last_e[sel - 1, s], last_e[nxt - 1, s]
                dB = beta_list[nxt - 1] - beta_list[sel - 1]
                if host_rng.random() < min(1.0, np.exp(dB * (E_nxt - E_sel))):
                    swap_counts[round_i] += 1
                    m_start[[sel - 1, nxt - 1], s] = m_start[[nxt - 1, sel - 1], s]
                    last_e[[sel - 1, nxt - 1], s] = last_e[[nxt - 1, sel - 1], s]

        rounds_completed = round_i + 1
        if metrics is not None:
            metrics.swap_stats(round_index=round_i,
                               pairs=[list(p) for p in selected],
                               accepted=int(swap_counts[round_i]),
                               energies=last_e[:, 0])
            metrics.sweep_stats(phase="icm_round", num_sweeps=per_swap,
                                num_chains=R * S, num_spins=n,
                                seconds=time.perf_counter() - round_t0,
                                min_energy=best_e)
        if cfg.target_energy is not None and np.isfinite(best_e):
            slack = 1e-3 * max(abs(cfg.target_energy), 1.0)
            if best_e <= cfg.target_energy + cfg.target_atol + slack:
                e64 = float(norm_prob.energy(best_state))
                if e64 <= cfg.target_energy + cfg.target_atol:
                    hit_round = round_i
                    hit_seconds = time.perf_counter() - t_entry
                    break
        if (cfg.checkpoint_path and cfg.checkpoint_every
                and (round_i + 1) % cfg.checkpoint_every == 0):
            save_checkpoint(
                cfg.checkpoint_path,
                {"m_start": m_start, "energies_round": energies_round,
                 "swap_counts": swap_counts, "best_e": best_e,
                 "best_state": best_state, "key": np.asarray(key),
                 "icm_moves": icm_moves, "icm_flips": icm_flips},
                step=round_i + 1,
                extra={"rng_state": host_rng.bit_generator.state,
                       "beta_list": beta_list},
            )

    trace = energies_round[:, 0, :read_per_swap]
    Energy = trace.min(axis=1)
    # exact float64 energy of the best state (device energies are float32)
    best_e = float(norm_prob.energy(best_state))
    return APTICMResult(
        Energy=Energy, energy_trace=trace, final_states=m_start,
        M_history=M_history,
        min_energy=best_e, best_state=best_state, swap_counts=swap_counts,
        icm_moves=icm_moves, icm_flips=icm_flips, beta_list=beta_list,
        rounds_completed=rounds_completed,
        hit_round=hit_round, hit_seconds=hit_seconds,
    )
