"""Chimera-10k NMC end-to-end on one device: npt_run with NMC on the coldest replicas at
N=10368 (chimera C(36,36,4)) — sparse edge-message LBP for backbone
extraction, masked/heated colored sweeps, replica exchange.

Usage: python scripts/nmc_10k_end_to_end.py [rounds]
"""

import sys
import time

import numpy as np

sys.path.insert(0, "/root/repo")

import jax  # noqa: E402

from nmc_tpu import NPTConfig, npt_run  # noqa: E402
from nmc_tpu.io.generators import chimera_graph  # noqa: E402
from nmc_tpu.utils.compcache import enable_compilation_cache  # noqa: E402


def main():
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    enable_compilation_cache()
    prob = chimera_graph(36, 36, 4, seed=0).normalized()[0]
    print(f"N={prob.n}, nnz={int((np.asarray(prob.J) != 0).sum())}",
          flush=True)
    R = 32
    beta = np.geomspace(0.3, 16.0, R)
    doNMC = [False] * (R - 4) + [True] * 4
    sweeps_per_round = 96
    cfg = NPTConfig(
        num_sweeps_MCMC=sweeps_per_round * rounds,
        num_sweeps_read=sweeps_per_round * rounds,
        num_swap_attempts=rounds,
        num_swapping_pairs=8, num_cycles=2,
        global_beta=8.0, use_coloring=True,
        lambda_start=3.0, lambda_reduction_factor=0.5,
        max_iterations=30, tolerance=1e-7,
        record_last_round_m=False,
    )
    t0 = time.time()
    res = npt_run(prob, beta, doNMC, cfg, jax.random.PRNGKey(0))
    dt = time.time() - t0
    e = np.asarray(res.Energy)
    total_attempts = prob.n * sweeps_per_round * rounds * R
    print(f"{rounds} swap rounds (NMC on 4 coldest) in {dt:.1f}s; "
          f"best {res.min_energy:.2f}; ladder hottest {e.max():.0f} "
          f"coldest {e.min():.0f}; "
          f"{total_attempts / dt:.3g} attempts/s incl. LBP+compile",
          flush=True)


if __name__ == "__main__":
    main()
