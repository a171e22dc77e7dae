"""Mirror of the reference's NMC main() (/root/reference/NMC/nmc.py:644)
on a planted Wishart instance, through the package API."""
import jax
import numpy as np

from nmc_tpu import NMCConfig, nmc_run
from nmc_tpu.io.generators import wishart_planted
from nmc_tpu.utils.compcache import enable_compilation_cache
from nmc_tpu.utils.metrics import MetricsLogger

enable_compilation_cache()
problem, planted, gs_energy = wishart_planted(100, alpha=0.5, seed=0)
cfg = NMCConfig(num_sweeps_initial=10_000, num_sweeps_per_NMC_phase=10_000,
                num_NMC_cycles=10, temp_x=20, global_beta=3.0,
                lambda_start=3.0, tolerance=1e-8, max_iterations=300,
                num_chains=8, record_m=False)
res = nmc_run(problem, cfg, jax.random.PRNGKey(0),
              metrics=MetricsLogger(echo=True))
print(f"planted gs (raw): {gs_energy:.3f}")
print(f"found (raw):      {res.min_energy.min() * res.norm_factor:.3f}")
