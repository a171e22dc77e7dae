"""NMC — Non-equilibrium (Nonlocal) Monte Carlo driver.

Accelerator rebuild of the reference's NMC class (/root/reference/NMC/nmc.py):
an initial annealed Gibbs run finds a good state m*, then cycles of
  (C)  heated-cluster sweeps  — backbone spins sample at beta/temp_x,
       everything else frozen,
  (NC) non-cluster sweeps     — backbone frozen, rest at beta,
  (ALL) full sweeps every `full_update_frequency` cycles,
with backbone clusters extracted from lambda-annealed convexified LBP
marginals. After each phase the chain restarts from its argmin-energy sweep.

Differences from the reference, by design (see module docstrings in ops/):
  * phases are mask/beta parametrizations of ONE jitted sweep kernel —
    no J/h copies, no +-10000 freeze biases
    (vs /root/reference/NMC/nmc.py:377-406);
  * many independent chains batch along the replica axis for free;
  * `use_hash_table` is accepted for API parity but is a no-op on device:
    the cached-local-field engine already does incrementally what the
    reference's LRU state-keyed table approximates
    (/root/reference/NMC/nmc.py:73-84) — see docs/DEVIATIONS.md.

Both cluster policies are supported: recompute LBP every cycle
(/root/reference/NMC/nmc.py:368-373) or once up front
(/root/reference/NPT/npt.py:397-414) via `clusters_once`.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.problem import IsingProblem
from ..ops.clusters import cluster_mask, find_clusters, flatten_clusters
from ..ops.engine import SweepEngine
from ..ops.lbp import (convexification_epsilon, lbp_convexified,
                       lbp_convexified_batch)
from ..utils.metrics import MetricsLogger


@dataclasses.dataclass
class NMCConfig:
    """Hyperparameters; names/defaults mirror /root/reference/NMC/nmc.py:442-446."""
    num_sweeps_initial: int = 10_000
    num_sweeps_per_NMC_phase: int = 10_000
    num_NMC_cycles: int = 10
    full_update_frequency: int = 1
    M_skip: int = 1
    temp_x: float = 20.0
    global_beta: float = 2.5
    lambda_start: float = 0.5
    lambda_end: float = 0.01
    lambda_reduction_factor: float = 0.9
    threshold_initial: float = 0.999999
    threshold_cutoff: float = 0.99999
    threshold_step: float = 0.01          # hardcoded at reference call site nmc.py:163
    max_iterations: int = 100
    tolerance: float = float(np.finfo(np.float64).eps)
    use_hash_table: bool = False          # parity no-op (docs/DEVIATIONS.md)
    clusters_once: bool = False           # False = nmc.py variant, True = npt.py variant
    sparse_lbp_threshold: int = 2048      # above this N, LBP runs on edge
                                          # messages (ops/lbp_sparse) instead
                                          # of dense [N,N] message matrices
    normalize: bool = True
    record_m: bool = True
    # device execution knobs
    num_chains: int = 1
    block_size: int = 128
    use_coloring: bool = False
    dtype: str = "float32"
    precision: str = "highest"


class NMCResult(NamedTuple):
    M_overall: Optional[np.ndarray]   # [T_rec, R, n] recorded states (M_skip applied)
    energy_overall: np.ndarray        # [T_total, R] per-sweep energies (full res)
    min_energy: np.ndarray            # [R]
    m_best: np.ndarray                # [R, n]
    m_final: np.ndarray               # [R, n] state after the last phase's last sweep
    all_clusters: np.ndarray          # flat cluster indices from the last extraction
    phase_labels: List[str]           # one label per phase segment ('C'/'NC'/'ALL')
    phase_lengths: List[int]          # sweeps per segment
    norm_factor: float


def _extract_clusters(problem: IsingProblem, m_star: np.ndarray,
                      cfg: NMCConfig, graph=None) -> np.ndarray:
    """Convexified LBP -> backbone clusters -> flat index array (host).

    Large instances (N > cfg.sparse_lbp_threshold) use edge-message LBP
    (O(nnz) per iteration) instead of dense [N, N] message matrices."""
    eps = convexification_epsilon(problem.J, problem.h)
    if problem.n > cfg.sparse_lbp_threshold:
        from ..ops.lbp_sparse import EdgeGraph, sparse_lbp_convexified
        if graph is None:
            graph = EdgeGraph.from_dense(problem.J)
        _, belief = sparse_lbp_convexified(
            graph, problem.h, cfg.global_beta, m_star, eps,
            lambda_start=cfg.lambda_start, lambda_end=cfg.lambda_end,
            lambda_reduction_factor=cfg.lambda_reduction_factor,
            tolerance=cfg.tolerance, max_iterations=cfg.max_iterations,
            return_belief=True,
        )
    else:
        out = lbp_convexified(
            jnp.asarray(problem.J), jnp.asarray(problem.h), cfg.global_beta,
            m_star, eps,
            lambda_start=cfg.lambda_start, lambda_end=cfg.lambda_end,
            lambda_reduction_factor=cfg.lambda_reduction_factor,
            tolerance=cfg.tolerance, max_iterations=cfg.max_iterations,
        )
        belief = out.belief
    # threshold a float64 reconstruction of the marginal: the reference
    # discriminates 7-nines thresholds on f64 marginals (nmc.py:163) but
    # an f32 device tanh saturates to 1.0 — tanh in f64 of the pre-tanh
    # belief restores the discrimination band (see ops/lbp.LBPResult)
    marginal = np.tanh(cfg.global_beta * np.asarray(belief, np.float64))
    clusters = find_clusters(problem.J, marginal, cfg.threshold_initial,
                             cfg.threshold_cutoff, cfg.threshold_step)
    return flatten_clusters(clusters)


def nmc_subroutine(
    engine: SweepEngine,
    problem: IsingProblem,       # normalized problem (engine built on it)
    m_star: np.ndarray,          # [R, n] current best states
    key: jax.Array,
    cfg: NMCConfig,
    all_clusters: Optional[np.ndarray] = None,
    metrics: Optional[MetricsLogger] = None,
) -> NMCResult:
    """The 3-phase NMC cycle loop (/root/reference/NMC/nmc.py:320-440)."""
    n = problem.n
    R = m_star.shape[0]
    clusters_provided = all_clusters is not None
    m_init = np.asarray(m_star, dtype=np.float64).reshape(R, n)
    m_star = m_init.copy()

    energy_segs, m_segs = [], []
    phase_labels: List[str] = []
    phase_lengths: List[int] = []
    best_m = m_init.copy()
    best_e = np.full(R, np.inf)

    m_final = m_init.copy()

    def run_phase(m_from, subkey, label, beta_spin=None, update_mask=None):
        nonlocal best_m, best_e, m_final
        res = engine.run(
            m_from, subkey, num_sweeps=cfg.num_sweeps_per_NMC_phase,
            beta=cfg.global_beta, beta_spin=beta_spin, update_mask=update_mask,
            record_m=cfg.record_m,
        )
        e = np.asarray(res.energies)             # [T, R]
        energy_segs.append(e)
        if cfg.record_m:
            m_segs.append(np.asarray(res.M)[::cfg.M_skip])
        phase_labels.append(label)
        phase_lengths.append(cfg.num_sweeps_per_NMC_phase)
        m_final = np.asarray(res.m)
        mb, eb = np.asarray(res.m_best), np.asarray(res.e_best)
        improved = eb < best_e
        best_m[improved] = mb[improved]
        best_e[improved] = eb[improved]
        return mb, eb  # argmin-of-phase restart state

    if clusters_provided or cfg.clusters_once:
        if not clusters_provided:
            all_clusters = _per_chain_clusters(problem, m_star, cfg)
        cl_mask = _stack_masks(n, R, all_clusters)

    for cycle in range(cfg.num_NMC_cycles):
        key, kc, knc, kall = jax.random.split(key, 4)
        if not (clusters_provided or cfg.clusters_once):
            all_clusters = _per_chain_clusters(problem, m_star, cfg)
            cl_mask = _stack_masks(n, R, all_clusters)
        if metrics is not None:
            metrics.cluster_stats(
                cycle=cycle,
                sizes=[int(c.size) for c in all_clusters]
                if isinstance(all_clusters, list)
                else [int(np.asarray(all_clusters).size)])

        # (C) heated clusters, frozen non-clusters
        beta_spin = np.where(cl_mask, 1.0 / cfg.temp_x, 1.0)
        m_init, _ = run_phase(m_init, kc, "C",
                              beta_spin=beta_spin, update_mask=cl_mask)

        # (NC) frozen clusters, normal temperature elsewhere
        m_init, _ = run_phase(m_init, knc, "NC", update_mask=~cl_mask)

        # (ALL) full update
        if cycle % cfg.full_update_frequency == 0:
            m_init, _ = run_phase(m_init, kall, "ALL")
            m_star = m_init.copy()

    energy_overall = np.concatenate(energy_segs, axis=0)
    M_overall = np.concatenate(m_segs, axis=0) if cfg.record_m else None
    # exact float64 energies of the best states (device energies are f32)
    best_e = np.asarray(problem.energy(best_m))
    flat_last = (all_clusters[0] if isinstance(all_clusters, list)
                 else np.asarray(all_clusters))
    return NMCResult(
        M_overall=M_overall,
        energy_overall=energy_overall,
        min_energy=best_e,
        m_best=best_m,
        m_final=m_final,
        all_clusters=flat_last,
        phase_labels=phase_labels,
        phase_lengths=phase_lengths,
        norm_factor=1.0,
    )


def _per_chain_clusters(problem, m_star, cfg) -> list:
    """Clusters per chain (list of flat index arrays, length R).

    The lambda-annealed LBP runs vmapped over chains (one dispatch per
    rung); the irregular threshold/growth pass stays host-side per chain.
    """
    R = m_star.shape[0]
    if R == 1 or problem.n > cfg.sparse_lbp_threshold:
        from ..ops.lbp_sparse import EdgeGraph
        graph = (EdgeGraph.from_dense(problem.J)
                 if problem.n > cfg.sparse_lbp_threshold else None)
        return [_extract_clusters(problem, m_star[r], cfg, graph=graph)
                for r in range(R)]
    eps = convexification_epsilon(problem.J, problem.h)
    _, beliefs = lbp_convexified_batch(
        jnp.asarray(problem.J), jnp.asarray(problem.h), cfg.global_beta,
        np.asarray(m_star, dtype=np.float64), eps,
        lambda_start=cfg.lambda_start, lambda_end=cfg.lambda_end,
        lambda_reduction_factor=cfg.lambda_reduction_factor,
        tolerance=cfg.tolerance, max_iterations=cfg.max_iterations,
        return_belief=True)
    # f64 marginal reconstruction for threshold discrimination (see
    # _extract_clusters)
    marginals = np.tanh(cfg.global_beta * np.asarray(beliefs, np.float64))
    return [
        flatten_clusters(find_clusters(
            problem.J, marginals[r], cfg.threshold_initial,
            cfg.threshold_cutoff, cfg.threshold_step))
        for r in range(R)
    ]


def _stack_masks(n, R, all_clusters) -> np.ndarray:
    if isinstance(all_clusters, list):
        return np.stack([cluster_mask(n, c) for c in all_clusters])
    return np.broadcast_to(cluster_mask(n, np.asarray(all_clusters)), (R, n)).copy()


def nmc_run(
    problem: IsingProblem,
    cfg: NMCConfig = NMCConfig(),
    key: Optional[jax.Array] = None,
    metrics: Optional[MetricsLogger] = None,
) -> NMCResult:
    """Full NMC solve (/root/reference/NMC/nmc.py:442-520): normalize,
    annealed warm-up to find m*, then the NMC cycle loop."""
    if key is None:
        key = jax.random.PRNGKey(0)
    norm_prob, norm_factor = (problem.normalized() if cfg.normalize
                              else (problem, 1.0))
    engine = SweepEngine(
        norm_prob, block_size=cfg.block_size, use_coloring=cfg.use_coloring,
        dtype=jnp.dtype(cfg.dtype), precision=cfg.precision,
    )
    key, k_init, k_warm, k_sub = jax.random.split(key, 4)
    m0 = engine.from_blocked(engine.init_states(k_init, cfg.num_chains))

    warm = engine.run(m0, k_warm, num_sweeps=cfg.num_sweeps_initial,
                      beta=cfg.global_beta, anneal=True, sweeps_per_beta=1,
                      initial_beta=0.0)
    m_star = np.asarray(warm.m_best)
    res = nmc_subroutine(engine, norm_prob, m_star, k_sub, cfg,
                         metrics=metrics)
    return res._replace(norm_factor=norm_factor)
