"""Run the REFERENCE NMC (in-process, /root/reference) on chimera512
instances with its shipped chimera_example.py hyperparameters, and our
nmc_run with the same budget/params — the honest apples-to-apples check
of whether the chimera512 NMC gap (campaign: nmc 1/20 vs pt 8/20 vs icm
19/20) is an implementation artifact or a property of the algorithm+
parameters.

Budget: num_sweeps_initial=1e4 + 10 cycles x 3 phases x 1e4 = 3.1e5
sweeps, exactly the reference example's shape (chimera_example.py:55-62).
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, "/root/repo")
sys.path.insert(0, "/root/reference/NMC")

# force CPU so this diagnostic never contends with device campaign runs
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

FOLDER = ("/root/reference/NMC/examples/Chimera_droplet_instances/"
          "chimera512_spinglass_power")

PARAMS = dict(num_sweeps_initial=int(1e4),
              num_sweeps_per_NMC_phase=int(1e4),
              num_NMC_cycles=10, full_update_frequency=1, M_skip=1,
              temp_x=20, global_beta=3, lambda_start=3, lambda_end=0.01,
              lambda_reduction_factor=0.9, threshold_initial=0.9999999,
              threshold_cutoff=0.999999, max_iterations=100,
              tolerance=np.finfo(float).eps)


def load(inst):
    from nmc_tpu.io.loaders import load_chimera
    return load_chimera(os.path.join(FOLDER, f"{inst:03}.txt"))


def gs_raw(inst):
    from nmc_tpu.io.loaders import read_otn2d_groundstates
    gt = read_otn2d_groundstates(os.path.join(FOLDER,
                                              "groundstates_otn2d.txt"))
    return gt[f"{inst:03}.txt"][0]


def _stub_cachetools():
    # cachetools isn't installed here; the reference only needs LRUCache
    # (and only when use_hash_table=True, which we don't use)
    import types
    if "cachetools" not in sys.modules:
        ct = types.ModuleType("cachetools")

        class LRUCache(dict):
            def __init__(self, maxsize=0):
                super().__init__()
                self.maxsize = maxsize

        ct.LRUCache = LRUCache
        sys.modules["cachetools"] = ct


def run_reference(inst):
    _stub_cachetools()
    from nmc import NMC                      # /root/reference/NMC/nmc.py
    prob = load(inst)
    J = np.asarray(prob.J, dtype=np.float64)
    h = np.asarray(prob.h, dtype=np.float64).reshape(-1, 1)
    norm = np.max(np.abs(J))
    ref = NMC(J.copy(), h.copy())
    t0 = time.time()
    _, _, min_energy = ref.run(**PARAMS, use_hash_table=False)
    dt = time.time() - t0
    return float(min_energy) * norm, dt


def run_ours(inst, seed=0):
    import jax

    from nmc_tpu import NMCConfig, nmc_run
    prob = load(inst)
    norm = float(np.max(np.abs(prob.J)))
    cfg = NMCConfig(
        num_sweeps_initial=PARAMS["num_sweeps_initial"],
        num_sweeps_per_NMC_phase=PARAMS["num_sweeps_per_NMC_phase"],
        num_NMC_cycles=PARAMS["num_NMC_cycles"],
        full_update_frequency=PARAMS["full_update_frequency"],
        temp_x=PARAMS["temp_x"], global_beta=PARAMS["global_beta"],
        lambda_start=PARAMS["lambda_start"],
        lambda_end=PARAMS["lambda_end"],
        lambda_reduction_factor=PARAMS["lambda_reduction_factor"],
        threshold_initial=PARAMS["threshold_initial"],
        threshold_cutoff=PARAMS["threshold_cutoff"],
        max_iterations=PARAMS["max_iterations"],
        use_coloring=True, normalize=True,
    )
    t0 = time.time()
    res = nmc_run(prob, cfg, jax.random.PRNGKey(seed))
    dt = time.time() - t0
    return float(res.min_energy) * norm, dt


def main():
    insts = [int(a) for a in sys.argv[1:]] or [1, 2]
    ref_only = os.environ.get("REF_ONLY") == "1"
    for inst in insts:
        gt = gs_raw(inst)
        if not ref_only:
            ours, dt_o = run_ours(inst)
            print(f"inst {inst:03}: ours   {ours:.2f} vs gs {gt:.2f} "
                  f"(residual {ours - gt:.2f}, {dt_o:.0f}s)", flush=True)
        ref, dt_r = run_reference(inst)
        print(f"inst {inst:03}: ref    {ref:.2f} vs gs {gt:.2f} "
              f"(residual {ref - gt:.2f}, {dt_r:.0f}s)", flush=True)


if __name__ == "__main__":
    main()
