"""nmc_tpu — Nonlocal Monte Carlo on accelerators, in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
usra-riacs/Nonlocal-Monte-Carlo (reference at /root/reference): NMC
(nonlocal Monte Carlo with LBP backbone clusters), the APT beta-schedule
preprocessor, NPT (replica exchange with NMC on selected replicas), and the
APT+ICM Houdayer baseline — built on one blocked heat-bath Gibbs sweep
kernel with cached local fields, batched replicas/chains, and
mesh-sharded ensembles.

Reference-compatible class shims (NMC, NPT, APT_preprocessor, APT_ICM) live
in nmc_tpu.compat.
"""

from .core.energy import energy, energy_from_fields, local_fields
from .core.problem import BlockedProblem, IsingProblem, block_problem
from .models.apt import APTConfig, APTResult, apt_preprocess
from .models.apt_icm import APTICMConfig, APTICMResult, apt_icm_run
from .models.nmc import NMCConfig, NMCResult, nmc_run, nmc_subroutine
from .models.npt import NPTConfig, NPTResult, npt_run
from .ops.coloring import color_groups, greedy_coloring, num_colors
from .ops.engine import SweepEngine
from .ops.lbp import (atanh_saturated, convexification_epsilon,
                      lbp_convexified, lbp_convexified_batch,
                      loopy_belief_propagation)
from .ops.clusters import (NeighborPlanes, build_neighbor_planes,
                           cluster_mask, disagreement_clusters,
                           find_clusters, flatten_clusters,
                           houdayer_move_device, houdayer_move_matmul,
                           houdayer_move_sparse)
from .ops.lbp_sparse import EdgeGraph, sparse_lbp, sparse_lbp_convexified
from .ops.presolve import Presolve, peel_leaves
from .ops.spectral import (SpectralResult, auto_subspace_dim,
                           difference_map_rounding,
                           difference_map_rounding_device,
                           spectral_candidates,
                           spectral_candidates_device, spectral_search)
from .exact import (exact_energy_bound, solve_exact_device,
                    solve_exact_enum, solve_exact_host)
from .exact_chimera import solve_exact_chimera
from .beam_chimera import (pad_to_chimera_grid, refine_strips,
                           solve_beam_chimera, solve_beam_chimera_multi)
from .beam_chimera_device import solve_beam_chimera_device
from .portfolio import SolveResult, SolveStage, portfolio_solve
from .refine import partition_crossover, refine_family, tree_refine_state
from .tree_moves import tree_refine

__version__ = "0.1.0"

__all__ = [
    "IsingProblem", "BlockedProblem", "block_problem",
    "energy", "energy_from_fields", "local_fields",
    "SweepEngine",
    "NMCConfig", "NMCResult", "nmc_run", "nmc_subroutine",
    "NPTConfig", "NPTResult", "npt_run",
    "APTConfig", "APTResult", "apt_preprocess",
    "APTICMConfig", "APTICMResult", "apt_icm_run",
    "loopy_belief_propagation", "lbp_convexified", "lbp_convexified_batch",
    "atanh_saturated", "convexification_epsilon",
    "EdgeGraph", "sparse_lbp", "sparse_lbp_convexified",
    "find_clusters", "flatten_clusters", "cluster_mask",
    "disagreement_clusters", "houdayer_move_device",
    "houdayer_move_sparse", "houdayer_move_matmul",
    "Presolve", "peel_leaves",
    "SolveResult", "SolveStage", "portfolio_solve",
    "tree_refine", "tree_refine_state", "refine_family",
    "partition_crossover",
    "solve_exact_host", "solve_exact_device", "solve_exact_enum", "exact_energy_bound", "solve_exact_chimera",
    "solve_beam_chimera", "solve_beam_chimera_multi",
    "solve_beam_chimera_device", "refine_strips", "pad_to_chimera_grid",
    "SpectralResult", "spectral_search", "spectral_candidates",
    "spectral_candidates_device", "auto_subspace_dim",
    "difference_map_rounding", "difference_map_rounding_device",
    "NeighborPlanes", "build_neighbor_planes",
    "greedy_coloring", "color_groups", "num_colors",
]
