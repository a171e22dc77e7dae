"""APT preprocessor — adaptive inverse-temperature schedule generation.

Accelerator rebuild of /root/reference/NPT/apt_preprocessor.py: iteratively
grow a beta ladder from measured energy fluctuations. At each rung, `num_rng`
independent Gibbs chains run at the current beta (the reference forks one OS
process per chain, apt_preprocessor.py:160-176; here they are one batch axis
of a single jitted sweep kernel), sigma_E = mean-over-chains of
std-over-the-last-`num_sweeps_read`-sweeps of the energy
(apt_preprocessor.py:179), and the next rung is beta + alpha / sigma_E
(apt_preprocessor.py:154-156). The loop stops when sigma_E drops below
0.5 * min|J_ij != 0| (freeze-out, apt_preprocessor.py:146,151) or beta
exceeds beta_max (apt_preprocessor.py:182-184). Chains warm-start from their
previous final states (apt_preprocessor.py:149,166,176).

Artifacts (`beta_list_python.npy`, `sigma_list_python.npy`, per-iteration
energies) are written npy-compatible when `save_dir` is set — the beta list
is THE handoff consumed by NPT and APT_ICM (npt.py:725, apt_ICM.py:330).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.problem import IsingProblem
from ..ops.engine import SweepEngine
from ..utils.metrics import MetricsLogger


@dataclasses.dataclass
class APTConfig:
    """Mirrors /root/reference/NPT/apt_preprocessor.py:115-116 kwargs."""
    num_sweeps_MCMC: int = 1000
    num_sweeps_read: int = 1000
    num_rng: int = 100
    beta_start: float = 0.5
    alpha: float = 1.25
    sigma_E_val: float = 1000.0
    beta_max: float = 30.0
    use_hash_table: bool = True   # parity no-op (docs/DEVIATIONS.md)
    normalize: bool = True
    max_rungs: int = 10_000       # safety bound absent in the reference
    save_dir: Optional[str] = None  # e.g. "Results/data" for artifact parity
    # fault tolerance (mirrors NPTConfig; APT rungs are long, preemption
    # would otherwise lose the whole ladder)
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 0     # snapshot every K rungs (0 = off)
    resume: bool = False
    # device execution knobs
    block_size: int = 128
    use_coloring: bool = False
    dtype: str = "float32"
    precision: str = "highest"


class APTResult(NamedTuple):
    beta: List[float]        # the schedule (first entry = beta_start)
    sigma: List[float]       # sigma_E per accepted rung
    final_states: np.ndarray  # [num_rng, n] last chain states
    norm_factor: float


def apt_preprocess(
    problem: IsingProblem,
    cfg: APTConfig = APTConfig(),
    key: Optional[jax.Array] = None,
    engine: Optional[SweepEngine] = None,
    metrics: Optional[MetricsLogger] = None,
) -> APTResult:
    if key is None:
        key = jax.random.PRNGKey(0)
    norm_prob, norm_factor = (problem.normalized() if cfg.normalize
                              else (problem, 1.0))
    if engine is None:
        engine = SweepEngine(
            norm_prob, block_size=cfg.block_size,
            use_coloring=cfg.use_coloring, dtype=jnp.dtype(cfg.dtype),
            precision=cfg.precision,
        )
    if cfg.num_sweeps_MCMC <= 0:
        raise ValueError("num_sweeps_MCMC must be positive")
    if cfg.num_sweeps_read > cfg.num_sweeps_MCMC:
        raise ValueError("num_sweeps_read cannot exceed num_sweeps_MCMC")

    sigma_E_min = 0.5 * norm_prob.min_abs_nonzero_J()
    beta: List[float] = [float(cfg.beta_start)]
    sigma: List[float] = []
    sigma_E = float(cfg.sigma_E_val)

    if cfg.save_dir:
        os.makedirs(cfg.save_dir, exist_ok=True)

    key, k_init = jax.random.split(key)
    m = engine.from_blocked(engine.init_states(k_init, cfg.num_rng))

    rung = 1
    if cfg.resume and cfg.checkpoint_path and os.path.exists(cfg.checkpoint_path):
        from ..utils.checkpoint import load_checkpoint
        snap, step, _ = load_checkpoint(cfg.checkpoint_path)
        m = snap["m"]
        beta = [float(b) for b in snap["beta"]]
        sigma = [float(s) for s in snap["sigma"]]
        sigma_E = float(snap["sigma_E"])
        key = jnp.asarray(snap["key"])
        rung = int(step)

    while sigma_E > sigma_E_min and rung <= cfg.max_rungs:
        rung_t0 = time.perf_counter()
        if rung != 1:
            beta.append(beta[-1] + cfg.alpha / sigma_E)

        key, k_run = jax.random.split(key)
        res = engine.run(m, k_run, num_sweeps=cfg.num_sweeps_MCMC,
                         beta=beta[-1])
        m = np.asarray(res.m)
        energies = np.asarray(res.energies)          # [T, num_rng]
        window = energies[-cfg.num_sweeps_read:]      # [num_sweeps_read, R]
        sigma_E = float(np.mean(np.std(window, axis=0)))
        if metrics is not None:
            metrics.apt_rung(rung=rung, beta=beta[-1], sigma_E=sigma_E,
                             seconds=time.perf_counter() - rung_t0)

        if beta[-1] > cfg.beta_max:
            # reference logs and breaks BEFORE appending sigma
            # (/root/reference/NPT/apt_preprocessor.py:182-186)
            break

        sigma.append(sigma_E)
        if cfg.save_dir:
            np.save(os.path.join(cfg.save_dir, f"Energy_iter_{rung}.npy"),
                    window.T)  # reference layout: [num_rng, num_sweeps_read]
            np.save(os.path.join(cfg.save_dir, f"sigma_iter_{rung}.npy"),
                    sigma_E)
        rung += 1
        if (cfg.checkpoint_path and cfg.checkpoint_every
                and (rung - 1) % cfg.checkpoint_every == 0):
            from ..utils.checkpoint import save_checkpoint
            save_checkpoint(
                cfg.checkpoint_path,
                {"m": m, "beta": np.asarray(beta),
                 "sigma": np.asarray(sigma), "sigma_E": sigma_E,
                 "key": np.asarray(key)},
                step=rung)

    if cfg.save_dir:
        np.save(os.path.join(cfg.save_dir, "beta_list_python.npy"),
                np.asarray(beta))
        np.save(os.path.join(cfg.save_dir, "sigma_list_python.npy"),
                np.asarray(sigma))

    return APTResult(beta=beta, sigma=sigma, final_states=m,
                     norm_factor=norm_factor)
