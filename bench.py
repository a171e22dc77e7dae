"""Benchmark: spin-flip attempt throughput of the colored sweep engine.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N,
   "device": {...}, "card": "<name, power limit>", "impl": "..."}

Headline metric (BASELINE.json): spin-flip attempts/s/device of
SweepEngine(use_coloring=True) with the implementation the program picks
(ops.sweeps.choose_sweep_impl) on a chimera instance — the shipped
chimera512 001.txt when the reference checkout is present, else a seeded
C_{8,8,4} (512 spins) — with 2048 replicas. `vs_baseline` is the speedup
over the reference's Python kernel (/root/reference/NMC/nmc.py:71-89,
per-spin full J@m + h), measured live on this host on the SAME instance.

Every timed window ends in block_until_ready plus a scalar fetch. Needs a
GPU: with no GPU it exits non-zero and prints no result.

    python bench.py [--quick] [--replicas R]
"""

import argparse
import json
import sys
import time

import numpy as np

CHIMERA512 = ("/root/reference/NMC/examples/Chimera_droplet_instances/"
              "chimera512_spinglass_power/001.txt")


def _flagship_problem():
    import os

    from nmc_tpu.io.generators import chimera_graph
    from nmc_tpu.io.loaders import load_chimera

    if os.path.exists(CHIMERA512):
        return load_chimera(CHIMERA512).normalized()[0]
    return chimera_graph(8, 8, seed=0).normalized()[0]


def measure_device(replicas=2048, sweeps=1024, iters=4, reps=5,
                   precision="highest"):
    import jax
    import jax.numpy as jnp

    from nmc_tpu.ops.engine import SweepEngine

    prob = _flagship_problem()
    engine = SweepEngine(prob, use_coloring=True, precision=precision)
    m = engine.init_states(jax.random.PRNGKey(0), replicas)

    def step(m, k):
        return engine.run(m, k, num_sweeps=sweeps, beta=2.0,
                          blocked_input=True, blocked_output=True).m

    m = step(m, jax.random.PRNGKey(1))
    float(jnp.sum(m))            # full sync after warmup/compile
    samples = []
    for rep in range(reps):
        t0 = time.perf_counter()
        for i in range(iters):
            m = step(m, jax.random.PRNGKey(2 + rep * iters + i))
        jax.block_until_ready(m)
        sync = float(jnp.sum(m))
        samples.append(time.perf_counter() - t0)
        if sync != sync:
            raise RuntimeError("non-finite states")
    dt = float(np.median(samples))
    attempts = iters * sweeps * replicas * prob.n   # true spins only
    return attempts / dt, engine.impl


def measure_reference_python(budget_s=2.0):
    """Reference kernel cost on the SAME flagship instance: per-spin
    full J@m + h (nmc.py:86), converted to attempts/sec."""
    from scipy.sparse import csr_matrix

    prob = _flagship_problem()
    n = prob.n
    rng = np.random.RandomState(0)
    Js = csr_matrix(np.asarray(prob.J))
    h = np.asarray(prob.h).reshape(n, 1)
    m = np.sign(rng.rand(n, 1) - 0.5)
    beta = 2.0
    t0 = time.perf_counter()
    attempts = 0
    while time.perf_counter() - t0 < budget_s:
        for kk in rng.permutation(n)[:256]:  # partial sweep is enough
            x = Js.dot(m) + h
            m[kk] = np.sign(np.tanh(beta * x[kk]) - 2 * rng.rand() + 1)
            attempts += 1
    dt = time.perf_counter() - t0
    return attempts / dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--replicas", type=int, default=None)
    args = ap.parse_args()

    import jax

    from nmc_tpu.utils.compcache import enable_compilation_cache
    from nmc_tpu.utils.device import card_name_power

    enable_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 2

    if args.quick:
        reps, sweeps, iters = 256, 64, 2
    else:
        reps, sweeps, iters = args.replicas or 2048, 1024, 4

    rate, impl = measure_device(replicas=reps, sweeps=sweeps, iters=iters)
    ref_rate = measure_reference_python(budget_s=1.5)
    print(json.dumps({
        "metric": "spin_flip_attempts_per_sec_per_device",
        "value": rate,
        "unit": "attempts/s",
        "vs_baseline": rate / ref_rate,
        "impl": impl,
        "card": card_name_power(),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
