"""Smoke test of the solvers on one NVIDIA GPU (or four, with --four).

    python chip_smoke.py            # every one-card phase
    python chip_smoke.py --four     # only the four-card comparison

Runs each phase in this one process, drives the package through the entry
points a user calls (SweepEngine, `nmc_tpu.cli.main`, the exact solvers,
ShardedNPT / EnsembleNMC), and checks every result against a float64 host
recomputation. Every instance is generated from a seed. Each phase prints
one JSON line; a failed check or a missing GPU exits non-zero before the
final line, which is exactly

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import tempfile
import time

import numpy as np

PHASES = ("device", "sweep", "npt_nmc", "icm", "planted", "exact")
# (chimera cells per side, replicas): today's bench shape and config 4 size
SWEEP_SHAPES = ((8, 2048), (26, 256))
SWEEPS = 1024
CONFIG4_CELLS = 26     # chimera C_{26,26,4}: 5408 spins (BASELINE config 4)
ICM_L = 16             # 16^3 EA glass: 4096 spins (BASELINE config 3)
PLANTED_N = 32
EXACT_N = 30
SK_N = 1000            # BASELINE config 5 instance size


class CheckFailed(RuntimeError):
    pass


class Report:
    """One JSON line per phase; a failed check fails the run."""

    def __init__(self, card: str):
        self.card = card

    def emit(self, phase: str, checks: dict, **info):
        ok = all(bool(v) for v in checks.values())
        print(json.dumps({"phase": phase, "ok": ok, "card": self.card,
                          "checks": {k: bool(v) for k, v in checks.items()},
                          **info}, default=float), flush=True)
        if not ok:
            bad = [k for k, v in checks.items() if not v]
            raise CheckFailed(f"phase {phase}: failed {bad}")


def energy64(J, h, m):
    m = np.asarray(m, np.float64)
    return -(0.5 * np.sum(m * (m @ J), axis=-1) + m @ h)


# ---------------------------------------------------------------- phases
def phase_device(rep, jax, tmp):
    dev = jax.devices()[0]
    rep.emit("device", {"platform_is_gpu": dev.platform == "gpu"},
             platform=dev.platform, kind=dev.device_kind,
             count=len(jax.devices()))


def _time_run(engine, m, num_sweeps, reps=3):
    import jax

    def run(k):
        return engine.run(m, jax.random.PRNGKey(k), num_sweeps=num_sweeps,
                          beta=2.0, blocked_input=True, blocked_output=True)

    t0 = time.perf_counter()
    res = run(1)
    jax.block_until_ready(res)
    compile_s = time.perf_counter() - t0
    samples = []
    for i in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run(2 + i))
        samples.append(time.perf_counter() - t0)
    return res, compile_s, float(np.median(samples))


def phase_sweep(rep, jax, tmp):
    from nmc_tpu.io.generators import chimera_graph
    from nmc_tpu.ops.engine import SweepEngine

    sweeps = SWEEPS
    for cells, R in SWEEP_SHAPES:
        prob = chimera_graph(cells, cells, seed=0).normalized()[0]
        gauss = chimera_graph(cells, cells, seed=0, pm=False).normalized()[0]
        checks, info = {}, {"n": prob.n, "replicas": R, "sweeps": sweeps}
        for backend in ("auto", "xla"):
            eng = SweepEngine(prob, use_coloring=True, backend=backend)
            b = eng.blocked
            J = b.J_rows.reshape(b.n_pad, b.n_pad).astype(np.float64)
            h = b.h.astype(np.float64)
            m0 = eng.init_states(jax.random.PRNGKey(0), R)
            res, compile_s, dt = _time_run(eng, m0, sweeps)
            m = np.asarray(res.m, np.float64)
            mb = np.asarray(res.m_best, np.float64)
            en = np.asarray(res.energies, np.float64)
            eb = np.asarray(res.e_best, np.float64)
            phi_err = float(np.abs(m @ J + h - np.asarray(res.phi)).max())
            e_ref, eb_ref = energy64(J, h, m), energy64(J, h, mb)
            rel = max(float(np.max(np.abs(en[-1] - e_ref) / np.abs(e_ref))),
                      float(np.max(np.abs(eb - eb_ref) / np.abs(eb_ref))))
            tag = eng.impl
            if backend == "auto":
                # the program's own pick on a GPU must be the kernel
                checks["auto_picks_triton"] = tag == "triton"
            checks[f"{tag}_padding_fixed"] = np.all(m[:, ~b.active] == 1)
            checks[f"{tag}_phi_1e-4"] = phi_err <= 1e-4
            checks[f"{tag}_energy_rel_1e-5"] = rel <= 1e-5
            checks[f"{tag}_best_is_min"] = np.allclose(en.min(0), eb)
            # frozen spins and per-spin heating (the NMC phase shape)
            frozen = np.arange(prob.n) % 7 == 0
            heat = np.where(np.arange(prob.n) % 5 == 0, 0.05, 1.0)
            mz = np.asarray(eng.from_blocked(m0))
            r2 = eng.run(mz, jax.random.PRNGKey(9), num_sweeps=64, beta=2.0,
                         update_mask=~frozen, beta_spin=heat)
            m2 = np.asarray(r2.m)
            checks[f"{tag}_frozen_fixed"] = np.array_equal(
                m2[:, frozen], mz[:, frozen])
            # TF32 drift, recorded only: +-1 couplings are exact in TF32,
            # so measure it on Gaussian couplings of the same graph
            drift = {}
            for prec in ("highest", "default"):
                eng_g = SweepEngine(gauss, use_coloring=True,
                                    backend=backend, precision=prec)
                bg = eng_g.blocked
                Jg = bg.J_rows.reshape(bg.n_pad, bg.n_pad).astype(np.float64)
                rg = eng_g.run(eng_g.init_states(jax.random.PRNGKey(0), R),
                               jax.random.PRNGKey(1), num_sweeps=sweeps,
                               beta=2.0, blocked_input=True,
                               blocked_output=True)
                mg = np.asarray(rg.m, np.float64)
                drift[prec] = float(np.abs(mg @ Jg + bg.h
                                           - np.asarray(rg.phi)).max())
            checks[f"{tag}_gaussian_phi_1e-4"] = drift["highest"] <= 1e-4
            info[tag] = {
                "attempts_per_s": sweeps * R * prob.n / dt,
                "seconds_per_run": dt, "first_call_s": compile_s,
                "phi_max_abs_err": phi_err, "energy_max_rel_err": rel,
                "gaussian_phi_max_abs_err": drift,
            }
            del eng, eng_g, res, rg
        rep.emit("sweep", checks, **info)


def _run_cli(argv):
    """Run `python -m nmc_tpu ...` in this process; returns its stdout."""
    from nmc_tpu.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    out = buf.getvalue()
    if rc not in (0, None):
        raise CheckFailed(f"cli {argv[0]} exited {rc}: {out[-2000:]}")
    return out


def _json_lines(out):
    recs = []
    for line in out.splitlines():
        line = line.strip()
        if line.startswith("{"):
            with contextlib.suppress(json.JSONDecodeError):
                recs.append(json.loads(line))
    return recs


def _random_mean(prob, count=1000, seed=0):
    rng = np.random.default_rng(seed)
    S = np.where(rng.random((count, prob.n)) < 0.5, -1.0, 1.0)
    return float(prob.energy(S).mean())


def phase_npt_nmc(rep, jax, tmp):
    """BASELINE config 4 through `python -m nmc_tpu sharded`: sweeps, LBP
    backbone extraction, NMC phases and replica swaps."""
    from nmc_tpu.io.generators import chimera_graph
    from nmc_tpu.io.loaders import load_wishart
    from nmc_tpu.io.writers import save_edgelist

    src = chimera_graph(CONFIG4_CELLS, CONFIG4_CELLS, seed=0)
    path, state_path = f"{tmp}/config4.txt", f"{tmp}/config4_best.txt"
    save_edgelist(path, src)
    t0 = time.perf_counter()
    out = _run_cli(["sharded", "--instance", path, "--format", "wishart",
                    "--coloring", "--replicas", "64", "--nmc-coldest", "5",
                    "--rounds", "4", "--chunk-rounds", "2",
                    "--sweeps-per-phase", "16", "--cycles", "1",
                    "--save-state", state_path])
    wall = time.perf_counter() - t0
    rec = _json_lines(out)[-1]
    prob = load_wishart(path).normalized()[0]
    best = np.loadtxt(state_path)
    e64 = float(prob.energy(best))
    e_rand = _random_mean(prob)
    rep.emit("npt_nmc", {
        "min_energy_finite": np.isfinite(rec["min_energy"]),
        "min_energy_is_f64_of_best_state":
            abs(rec["min_energy"] - e64) <= 1e-9 * max(1.0, abs(e64)),
        "below_random_mean": rec["min_energy"] < e_rand,
    }, n=prob.n, replicas=rec["replicas"], rounds=rec["rounds"],
        min_energy=rec["min_energy"], f64_energy=e64,
        random_state_mean_energy=e_rand, wall_s=wall)


def _host_min_labels(J, s1, s2):
    """Component-minimum labels of the disagreement graph (host)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components

    n = J.shape[0]
    diff = (s1 * s2) < 0
    adj = (J != 0) & diff[:, None] & diff[None, :]
    _, comp = connected_components(csr_matrix(adj), directed=False)
    labels = np.full(n, n, np.int64)
    idx = np.flatnonzero(diff)
    mins = {}
    for i in idx:
        mins.setdefault(comp[i], i)
    for i in idx:
        labels[i] = mins[comp[i]]
    return labels


def phase_icm(rep, jax, tmp):
    """BASELINE config 3 through `python -m nmc_tpu icm` (4096 spins: the
    Houdayer moves run on the device), plus the matmul label propagation
    bit-equal to host components at that size."""
    import jax.numpy as jnp

    from nmc_tpu.core.problem import block_problem, block_sparse_tiles
    from nmc_tpu.io.generators import ea_3d
    from nmc_tpu.io.loaders import load_wishart
    from nmc_tpu.io.writers import save_edgelist
    from nmc_tpu.ops.clusters import (build_neighbor_planes,
                                      disagreement_labels_matmul)
    from nmc_tpu.ops.coloring import color_groups

    src = ea_3d(ICM_L, seed=0)
    path, state_path = f"{tmp}/config3.txt", f"{tmp}/config3_best.txt"
    save_edgelist(path, src)
    t0 = time.perf_counter()
    out = _run_cli(["icm", "--instance", path, "--format", "wishart",
                    "--coloring", "--replicas", "8", "--sweeps", "64",
                    "--sweeps-read", "64", "--swap-attempts", "3",
                    "--subreplicas", "4", "--save-state", state_path])
    wall = time.perf_counter() - t0
    rec = _json_lines(out)[-1]
    prob = load_wishart(path).normalized()[0]
    e64 = float(prob.energy(np.loadtxt(state_path)))

    b = block_problem(prob, block_size=128, groups=color_groups(prob.J))
    col, tiles = block_sparse_tiles(b)
    planes = build_neighbor_planes(col, tiles)
    rng = np.random.default_rng(1)
    s1 = np.where(rng.random(b.n_pad) < 0.5, -1.0, 1.0)
    s2 = np.where(rng.random(b.n_pad) < 0.3, -s1, s1)
    s1, s2 = np.where(b.active, s1, 1.0), np.where(b.active, s2, 1.0)
    labels = jax.jit(lambda a, c: disagreement_labels_matmul(planes, a, c))
    dev = np.asarray(labels(jnp.asarray(s1, jnp.float32),
                            jnp.asarray(s2, jnp.float32)))
    host = _host_min_labels(b.J_rows.reshape(b.n_pad, b.n_pad), s1, s2)
    rep.emit("icm", {
        "min_energy_finite": np.isfinite(rec["min_energy"]),
        "min_energy_is_f64_of_best_state":
            abs(rec["min_energy"] - e64) <= 1e-4 * max(1.0, abs(e64)),
        "below_random_mean": rec["min_energy"] < _random_mean(prob),
        "matmul_labels_equal_host_components": np.array_equal(dev, host),
    }, n=prob.n, min_energy=rec["min_energy"], f64_energy=e64,
        icm_moves=rec["icm_moves"], disagreeing=int((s1 != s2).sum()),
        wall_s=wall)


def phase_planted(rep, jax, tmp):
    """Wishart planted instance through `python -m nmc_tpu npt`: the run
    must reach the planted ground-state energy."""
    from nmc_tpu.io.generators import wishart_planted
    from nmc_tpu.io.writers import save_edgelist

    prob, planted, gs = wishart_planted(PLANTED_N, 0.5, seed=3)
    path = f"{tmp}/planted.txt"
    save_edgelist(path, prob)
    t0 = time.perf_counter()
    out = _run_cli(["npt", "--instance", path, "--format", "wishart",
                    "--replicas", "16", "--nmc-coldest", "5",
                    "--sweeps", "1000", "--sweeps-read", "100",
                    "--swap-attempts", "10", "--cycles", "2"])
    rec = _json_lines(out)[-1]
    got = rec["min_energy_unnormalized"]
    rep.emit("planted", {"reaches_planted_ground_state":
                         abs(got - gs) <= 1e-6 * max(1.0, abs(gs))},
             n=prob.n, planted_energy=gs, min_energy_unnormalized=got,
             wall_s=time.perf_counter() - t0)


def phase_exact(rep, jax, tmp):
    """Device meet-in-the-middle tier against the host tier."""
    from nmc_tpu.exact import solve_exact_device, solve_exact_host
    from nmc_tpu.io.generators import random_sk

    prob = random_sk(EXACT_N, seed=5)
    t0 = time.perf_counter()
    e_d, s_d = solve_exact_device(prob)
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    e_h, s_h = solve_exact_host(prob)
    t_host = time.perf_counter() - t0
    rep.emit("exact", {
        "energy_rel_1e-9": abs(e_d - e_h) <= 1e-9 * max(1.0, abs(e_h)),
        "state_equal_up_to_flip":
            np.array_equal(s_d, s_h) or np.array_equal(s_d, -s_h),
    }, n=prob.n, device_energy=e_d, host_energy=e_h,
        device_s=t_dev, host_s=t_host)


def phase_four(rep, jax, tmp):
    """ShardedNPT on a 4-device replica mesh and EnsembleNMC over 4 devices,
    each against the same engine on one device with the same seed."""
    from jax.sharding import Mesh

    from nmc_tpu.io.generators import chimera_graph, random_sk
    from nmc_tpu.parallel import EnsembleNMC, ShardedNPT, ShardedNPTConfig

    devs = jax.devices()
    if len(devs) < 4:
        raise CheckFailed(f"--four needs 4 devices, found {len(devs)}")
    checks, info = {}, {}

    def spans(arr, k):
        return len({s.device for s in arr.addressable_shards}) == k

    prob = chimera_graph(CONFIG4_CELLS, CONFIG4_CELLS, seed=0).normalized()[0]
    R = 64
    betas = np.geomspace(0.25, 16.0, R)
    cfg = ShardedNPTConfig(sweeps_per_phase=16, num_cycles=1,
                           num_swapping_pairs=R // 4, use_coloring=True)
    for k in (4, 1):
        pt = ShardedNPT(prob, betas, [False] * (R - 5) + [True] * 5, cfg,
                        mesh=Mesh(np.array(devs[:k]), ("replica",)))
        st = pt.init_state(jax.random.PRNGKey(0))
        t0 = time.perf_counter()
        st, met = pt.run_scanned(st, 4)
        jax.block_until_ready(st.m)
        eb, mb = pt.best(st)
        b2s, s2b = np.asarray(st.beta_to_slot), np.asarray(st.slot_to_beta)
        checks[f"sharded_{k}dev_perm_valid"] = (
            sorted(b2s.tolist()) == list(range(R))
            and np.array_equal(s2b[b2s], np.arange(R)))
        checks[f"sharded_{k}dev_best_is_f64"] = abs(
            float(prob.energy(mb)) - eb) <= 1e-4 * max(1.0, abs(eb))
        checks[f"sharded_{k}dev_spans_{k}_devices"] = spans(st.m, k)
        info[f"sharded_{k}dev"] = {"best": eb,
                                   "s_4_rounds": time.perf_counter() - t0}
    checks["sharded_below_random_mean"] = max(
        info["sharded_4dev"]["best"], info["sharded_1dev"]["best"]) \
        < _random_mean(prob)

    probs = [random_sk(SK_N, seed=s).normalized()[0] for s in range(4)]
    ecfg = ShardedNPTConfig(sweeps_per_phase=8, num_cycles=1,
                            num_swapping_pairs=2, lbp_max_iterations=10)
    bests = {}
    for k in (4, 1):
        ens = EnsembleNMC(probs, np.geomspace(0.3, 3.0, 16),
                          [False] * 13 + [True] * 3, ecfg,
                          mesh=Mesh(np.array(devs[:k]), ("instance",)))
        st = ens.init_state(jax.random.PRNGKey(1))
        t0 = time.perf_counter()
        st = ens.run_scanned(st, 2)
        jax.block_until_ready(st.m)
        eb, mb = ens.best(st)
        b2s = np.asarray(st.beta_to_slot)
        checks[f"ensemble_{k}dev_perm_valid"] = all(
            sorted(r.tolist()) == list(range(16)) for r in b2s)
        checks[f"ensemble_{k}dev_best_is_f64"] = all(
            abs(float(p.energy(mb[i])) - eb[i]) <= 1e-4 * max(1, abs(eb[i]))
            for i, p in enumerate(probs))
        checks[f"ensemble_{k}dev_spans_{k}_devices"] = spans(st.m, k)
        bests[k] = eb
        info[f"ensemble_{k}dev"] = {"best": eb.tolist(),
                                    "s_2_rounds": time.perf_counter() - t0}
    # per-instance keys do not depend on the mesh, so the two runs draw
    # the same numbers; recorded, since reduction order may still differ
    info["ensemble_identical_to_one_device"] = bool(
        np.array_equal(bests[4], bests[1]))
    info["ensemble_max_abs_diff"] = float(np.abs(bests[4] - bests[1]).max())
    rep.emit("four", checks, **info)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card comparison")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated one-card phases to run")
    args = ap.parse_args(argv)

    try:
        import jax

        import nmc_tpu  # noqa: F401
        from nmc_tpu.utils.compcache import enable_compilation_cache
        from nmc_tpu.utils.device import card_name_power
    except ImportError as e:
        print(f"chip_smoke: cannot import the package: {e}", file=sys.stderr)
        return 2
    enable_compilation_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform!r})",
              file=sys.stderr)
        return 2
    card = card_name_power()
    print(f"card: {card}", flush=True)
    rep = Report(card)
    phases = {"device": phase_device, "sweep": phase_sweep,
              "npt_nmc": phase_npt_nmc, "icm": phase_icm,
              "planted": phase_planted, "exact": phase_exact,
              "four": phase_four}
    names = ["four"] if args.four else args.phases.split(",")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for name in names:
                t0 = time.perf_counter()
                phases[name](rep, jax, tmp)
                print(json.dumps({"phase_seconds": {
                    name: time.perf_counter() - t0}}), flush=True)
    except CheckFailed as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
