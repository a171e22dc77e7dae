"""Multi-host (DCN) path validation: a REAL 2-process JAX runtime over
2 x 4 virtual CPU devices (subprocess-based — in-process tests cannot
exercise jax.distributed), running the same shard_map programs that scale
over pods (SURVEY.md section 2.3: the reference's process pool,
/root/reference/NPT/npt.py:616-640, replaced by jax.distributed + shard_map).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import json, os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_num_cpu_devices", 4)
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, {repo!r})
pid, nproc, port, what = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
from nmc_tpu.parallel import distributed
assert distributed.initialize(f"127.0.0.1:{{port}}".format(port=port),
                              num_processes=nproc, process_id=pid)
assert jax.process_count() == nproc
assert len(jax.devices()) == 4 * nproc
import numpy as np
from nmc_tpu.io.generators import random_sk, ea_2d

if what == "sharded_npt":
    from nmc_tpu.parallel.sharded_pt import ShardedNPT, ShardedNPTConfig
    prob, _ = random_sk(12, seed=5).normalized()
    cfg = ShardedNPTConfig(sweeps_per_phase=6, num_cycles=1,
                           num_swapping_pairs=2, lbp_mode="dense",
                           block_size=16)
    beta = np.geomspace(0.3, 3.0, 16)
    npt = ShardedNPT(prob, beta, [False] * 12 + [True] * 4, cfg,
                     mesh=distributed.global_mesh())
    state = npt.init_state(jax.random.PRNGKey(0))
    state, metrics = npt.run_scanned(state, 4)
    e, m = npt.best(state)
    out = {"best": float(e), "f64": float(prob.energy(m)),
           "accepted": int(np.asarray(metrics.accepted).sum())}
elif what == "ensemble":
    from nmc_tpu.parallel.ensemble import EnsemblePT, EnsembleConfig
    probs = [random_sk(10, seed=s).normalized()[0] for s in range(8)]
    pt = EnsemblePT(probs, np.geomspace(0.3, 3.0, 6),
                    EnsembleConfig(num_replicas=6, sweeps_per_round=5,
                                   num_swapping_pairs=1, block_size=16),
                    mesh=distributed.global_mesh(axis_name="instance"))
    state = pt.init_state(jax.random.PRNGKey(1))
    state = pt.run(state, 3)
    eb = pt.best_energies(state)
    out = {"best": [float(x) for x in eb]}
elif what == "ensemble_nmc":
    # the campaign engine across processes: full NPT+NMC rounds (LBP
    # backbone extraction + heated phases + label swaps) per instance
    # under a 2-process global mesh (the XLA sweep path on the CPU).
    from nmc_tpu.parallel.ensemble_nmc import EnsembleNMC
    from nmc_tpu.parallel.sharded_pt import ShardedNPTConfig
    probs = [ea_2d(6, seed=s).normalized()[0] for s in range(8)]
    # lbp_mode="sparse" (not dense): covers the instance-sharded edge
    # weights crossing the jit boundary as an ARGUMENT — closing over a
    # global array raises in multi-process meshes (caught round 3)
    cfg = ShardedNPTConfig(sweeps_per_phase=2, num_cycles=1,
                           num_swapping_pairs=2, use_coloring=True,
                           block_size=16, lbp_mode="sparse",
                           lbp_max_iterations=5)
    ens = EnsembleNMC(probs, np.geomspace(0.3, 3.0, 8),
                      [False] * 6 + [True] * 2, cfg,
                      mesh=distributed.global_mesh(axis_name="instance"))
    state = ens.init_state(jax.random.PRNGKey(2))
    state = ens.run_scanned(state, 2)
    eb, mb = ens.best(state)
    out = {"best": [float(x) for x in eb],
           "f64": [float(p.energy(mb[i])) for i, p in enumerate(probs)]}
elif what == "ensemble_hybrid":
    # hybrid ICM+NMC arm (disagreement-seeded heated phases) across
    # processes — XLA path (houdayer label propagation + masks in-jit)
    from nmc_tpu.parallel import EnsembleICM, EnsembleICMConfig
    probs = [random_sk(10, seed=s).normalized()[0] for s in range(8)]
    cfg = EnsembleICMConfig(sweeps_per_round=6, num_subreplicas=2,
                            num_swapping_pairs=1, block_size=16,
                            hybrid_cold=2, num_cycles=1)
    ens = EnsembleICM(probs, np.geomspace(0.3, 3.0, 6), cfg,
                      mesh=distributed.global_mesh(axis_name="instance"))
    state = ens.init_state(jax.random.PRNGKey(3))
    state = ens.run_scanned(state, 3)
    eb, mb = ens.best(state)
    out = {"best": [float(x) for x in eb]}
else:
    raise SystemExit("unknown target")
print("RESULT " + json.dumps(out), flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_two_process(what, timeout=240):
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    worker = _WORKER.replace("{repo!r}", repr(_REPO))
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", worker, str(i), "2", str(port), what],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        for i in range(2)
    ]
    outs = []
    for p in procs:
        so, se = p.communicate(timeout=timeout)
        assert p.returncode == 0, f"worker failed:\n{se[-3000:]}"
        line = [l for l in so.splitlines() if l.startswith("RESULT ")][-1]
        outs.append(json.loads(line[len("RESULT "):]))
    return outs


class TestTwoProcessMesh:
    def test_sharded_npt_two_processes(self):
        a, b = _run_two_process("sharded_npt")
        # both processes agree on the gathered global best (SPMD + allgather)
        assert a == b
        assert np.isfinite(a["best"])
        assert abs(a["best"] - a["f64"]) < 1e-3

    def test_ensemble_two_processes(self):
        a, b = _run_two_process("ensemble")
        assert a == b
        assert len(a["best"]) == 8
        assert all(np.isfinite(x) for x in a["best"])

    def test_ensemble_nmc_two_processes(self):
        # the campaign engine itself (EnsembleNMC) across processes
        a, b = _run_two_process("ensemble_nmc", timeout=540)
        assert a == b
        assert len(a["best"]) == 8
        for e, f in zip(a["best"], a["f64"]):
            assert np.isfinite(e)
            assert abs(e - f) < 1e-3

    def test_ensemble_hybrid_two_processes(self):
        a, b = _run_two_process("ensemble_hybrid")
        assert a == b
        assert len(a["best"]) == 8
        assert all(np.isfinite(x) for x in a["best"])
