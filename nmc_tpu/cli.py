"""Command-line entry points.

The reference's L7 layer is hand-edited main() scripts loading J.npy/h.npy
(/root/reference/NMC/nmc.py:644-682, NPT/npt.py:720-795,
apt_preprocessor.py:234-261, apt_ICM.py:325-364) with no flags. Here each
solver is a subcommand with proper flags, instance-file loading for all
four dialects, JSONL metrics, and checkpointing:

    python -m nmc_tpu nmc  --instance path.txt --format wishart ...
    python -m nmc_tpu apt  --J J.npy --h h.npy ...
    python -m nmc_tpu npt  --beta-list beta_list_python.npy --nmc-coldest 5 ...
    python -m nmc_tpu icm  --beta-list beta_list_python.npy ...
    python -m nmc_tpu generate --kind sk --n 1000 --out inst.txt
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

# largest instance the meet-in-the-middle device tier takes
EXACT_DEVICE_MAX_N = 40


def _load_problem(args):
    from .core.problem import IsingProblem
    from .io import loaders

    if args.instance:
        fmt = args.format
        fn = {"wishart": loaders.load_wishart, "dcl": loaders.load_dcl,
              "chimera": loaders.load_chimera,
              "tree": loaders.load_contrived_tree}[fmt]
        return fn(args.instance)
    if args.J:
        J = np.load(args.J)
        h = np.load(args.h) if args.h else np.zeros(J.shape[0])
        return IsingProblem(J, h)
    raise SystemExit("provide --instance or --J/--h")


def _add_problem_args(p):
    p.add_argument("--instance", help="edge-list instance file")
    p.add_argument("--format", default="wishart",
                   choices=["wishart", "dcl", "chimera", "tree"])
    p.add_argument("--J", help="J.npy (dense matrix)")
    p.add_argument("--h", help="h.npy")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--metrics", help="JSONL metrics output path")
    p.add_argument("--block-size", type=int, default=128)
    p.add_argument("--coloring", action="store_true",
                   help="graph-colored blocks (sparse topologies)")
    p.add_argument("--save-state", help="write the best +-1 state here "
                                        "(npt, icm, sharded)")


def _save_state(args, state):
    if getattr(args, "save_state", None):
        np.savetxt(args.save_state, np.asarray(state), fmt="%+d")


def _metrics(args):
    from .utils.metrics import MetricsLogger
    return MetricsLogger(path=args.metrics, echo=True) if args.metrics else \
        MetricsLogger(echo=False)


def cmd_nmc(args):
    import jax
    from .models.nmc import NMCConfig, nmc_run

    prob = _load_problem(args)
    cfg = NMCConfig(
        num_sweeps_initial=args.sweeps_initial,
        num_sweeps_per_NMC_phase=args.sweeps_per_phase,
        num_NMC_cycles=args.cycles, global_beta=args.beta,
        temp_x=args.temp_x, lambda_start=args.lambda_start,
        num_chains=args.chains, block_size=args.block_size,
        use_coloring=args.coloring, record_m=False,
        tolerance=args.lbp_tolerance, max_iterations=args.lbp_iters,
    )
    res = nmc_run(prob, cfg, jax.random.PRNGKey(args.seed),
                  metrics=_metrics(args))
    out = {"min_energy": float(res.min_energy.min()),
           "min_energy_unnormalized": float(res.min_energy.min()
                                            * res.norm_factor),
           "num_chains": cfg.num_chains}
    print(json.dumps(out))


def cmd_apt(args):
    import jax
    from .models.apt import APTConfig, apt_preprocess

    prob = _load_problem(args)
    cfg = APTConfig(
        num_sweeps_MCMC=args.sweeps, num_sweeps_read=args.sweeps_read,
        num_rng=args.chains, beta_start=args.beta_start, alpha=args.alpha,
        beta_max=args.beta_max, save_dir=args.out_dir,
        block_size=args.block_size, use_coloring=args.coloring,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every, resume=args.resume,
    )
    res = apt_preprocess(prob, cfg, jax.random.PRNGKey(args.seed),
                         metrics=_metrics(args))
    print(json.dumps({"num_rungs": len(res.beta),
                      "beta": [round(b, 6) for b in res.beta]}))


def cmd_npt(args):
    import jax
    from .models.npt import NPTConfig, npt_run

    prob = _load_problem(args)
    beta_list = np.load(args.beta_list) if args.beta_list else \
        np.linspace(args.beta_start, args.beta_max, args.replicas)
    R = beta_list.shape[0]
    doNMC = [False] * (R - args.nmc_coldest) + [True] * args.nmc_coldest
    cfg = NPTConfig(
        num_sweeps_MCMC=args.sweeps, num_sweeps_read=args.sweeps_read,
        num_swap_attempts=args.swap_attempts,
        num_swapping_pairs=max(round(args.swap_fraction * R), 1),
        num_cycles=args.cycles, global_beta=args.beta,
        temp_x=args.temp_x, lambda_start=args.lambda_start,
        block_size=args.block_size, use_coloring=args.coloring,
        record_last_round_m=False,
        tolerance=args.lbp_tolerance, max_iterations=args.lbp_iters,
        checkpoint_path=args.checkpoint, checkpoint_every=args.checkpoint_every,
        resume=args.resume,
    )
    res = npt_run(prob, beta_list, doNMC, cfg, jax.random.PRNGKey(args.seed),
                  metrics=_metrics(args))
    _save_state(args, res.best_state)
    print(json.dumps({
        "Energy": [float(e) for e in res.Energy],
        "min_energy": res.min_energy,
        "min_energy_unnormalized": res.min_energy * res.norm_factor,
        "acceptance_rate": res.acceptance_rate,
    }))


def cmd_icm(args):
    import jax
    from .models.apt_icm import APTICMConfig, apt_icm_run

    prob = _load_problem(args).normalized()[0]
    beta_list = np.load(args.beta_list) if args.beta_list else \
        np.linspace(args.beta_start, args.beta_max, args.replicas)
    cfg = APTICMConfig(
        num_sweeps_MCMC=args.sweeps, num_sweeps_read=args.sweeps_read,
        num_swap_attempts=args.swap_attempts,
        num_subreplicas=args.subreplicas, block_size=args.block_size,
        use_coloring=args.coloring, device_icm=args.device_icm,
    )
    res = apt_icm_run(prob, beta_list, cfg, jax.random.PRNGKey(args.seed))
    _save_state(args, res.best_state)
    print(json.dumps({
        "Energy": [float(e) for e in res.Energy],
        "min_energy": res.min_energy,
        "icm_moves": res.icm_moves, "icm_flips": res.icm_flips,
    }))


def cmd_sharded(args):
    """Scan-fused mesh-sharded NPT (single chip, pod slice, or multi-host
    via the NMC_TPU_COORDINATOR env launch — parallel/distributed.py)."""
    import jax

    from .parallel.distributed import host_gather
    from .parallel.sharded_pt import ShardedNPT, ShardedNPTConfig

    prob = _load_problem(args).normalized()[0]
    beta_list = np.load(args.beta_list) if args.beta_list else \
        np.geomspace(args.beta_start, args.beta_max, args.replicas)
    R = beta_list.shape[0]
    doNMC = [False] * (R - args.nmc_coldest) + [True] * args.nmc_coldest
    cfg = ShardedNPTConfig(
        sweeps_per_phase=args.sweeps_per_phase, num_cycles=args.cycles,
        num_swapping_pairs=max(R // 4, 1), global_beta=args.beta,
        temp_x=args.temp_x, use_coloring=args.coloring,
        block_size=args.block_size,
    )
    npt = ShardedNPT(prob, beta_list, doNMC, cfg)
    state = npt.init_state(jax.random.PRNGKey(args.seed))
    rounds_done = 0
    while rounds_done < args.rounds:
        k = min(args.chunk_rounds, args.rounds - rounds_done)
        state, metrics = npt.run_scanned(state, k)
        rounds_done += k
        e_best, m_best = npt.best(state)
        if args.target_energy is not None and \
                float(prob.energy(m_best)) <= args.target_energy:
            break
    e_best, m_best = npt.best(state)
    accepted = host_gather(metrics.accepted)
    if jax.process_index() == 0:
        _save_state(args, m_best)
        print(json.dumps({
            "min_energy": float(prob.energy(m_best)),
            "rounds": rounds_done,
            "replicas": R, "devices": len(jax.devices()),
            "processes": jax.process_count(),
            "last_chunk_swap_accepts": int(np.asarray(accepted).sum()),
        }))


def cmd_evaluate(args):
    from . import evaluation as ev

    folder_fns = {"wishart": ev.wishart_folder_instances,
                  "chimera": ev.chimera_folder_instances,
                  "dcl": ev.dcl_folder_instances}
    instances = list(folder_fns[args.family](args.folder, limit=args.limit))
    solver = ev.make_pt_solver(
        num_replicas=args.replicas, beta_min=args.beta_start,
        beta_max=args.beta_max, sweeps=args.sweeps,
        swap_attempts=args.swap_attempts, block_size=args.block_size,
        use_coloring=args.coloring, nmc_coldest=args.nmc_coldest,
        key_seed=args.seed)
    report = ev.evaluate_solver(instances, solver, tolerance=args.tolerance)
    print(report.to_json())


def _detect_instance(path, kind, target):
    """(prob, target, kind, base): dialect inferred from sibling
    ground-truth files, target pulled through the evaluation generators
    so normalization bookkeeping matches the campaign's exactly."""
    import os

    from . import evaluation as ev
    from .io import loaders

    path = os.path.abspath(path)
    folder, base = os.path.split(path)
    if kind == "auto":
        if os.path.exists(os.path.join(folder, "gs_energies.txt")):
            kind = "wishart"
        elif os.path.exists(os.path.join(folder, "groundstates_otn2d.txt")):
            kind = "chimera"
        elif os.path.exists(path.replace(".txt", "_sol.txt")):
            kind = "dcl"
        else:
            kind = "wishart"
    prob = None
    if target is None:
        gens = {"wishart": ev.wishart_folder_instances,
                "chimera": ev.chimera_folder_instances,
                "dcl": ev.dcl_folder_instances,
                "contrived": ev.contrived_folder_instances}
        try:
            for nm, p_, gs in gens[kind](folder):
                if nm == base:
                    prob, target = p_, gs
                    break
        except (FileNotFoundError, OSError):
            pass
    if prob is None:
        fn = {"wishart": loaders.load_wishart, "dcl": loaders.load_dcl,
              "chimera": loaders.load_chimera,
              "contrived": loaders.load_contrived_tree}[kind]
        prob = fn(path)
    return prob, target, kind, base


def cmd_solve(args):
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from .portfolio import portfolio_solve

    prob, target, kind, base = _detect_instance(args.path, args.kind,
                                                args.target)

    arm = args.arm
    if arm == "auto":
        # measured family preferences (docs/BENCHMARKS.md campaign
        # tables): ICM dominates chimera droplets; the ICM+NMC hybrid is
        # the TTS winner on DCL; ICM + spectral seeding wins wishart-type
        arm = {"chimera": "icm", "dcl": "hybrid"}.get(kind, "icm")

    spectral = ("auto" if not (args.no_spectral or args.force_spectral)
                else bool(args.force_spectral))
    res = portfolio_solve(
        prob, target, name=base, arm=arm, sweeps=args.sweeps,
        seed=args.seed, presolve=not args.no_presolve,
        spectral=spectral, dm_starts=args.dm_starts,
        dm_iters=args.dm_iters, coloring=kind in ("chimera", "dcl"))

    def _j(x):   # strict JSON: non-finite -> null
        return (None if x is None
                or (isinstance(x, float) and not np.isfinite(x)) else x)

    rec = dict(
        name=res.name, n=res.n, kind=kind, energy_raw=_j(res.energy_raw),
        target_raw=_j(res.target_raw), hit=res.hit,
        wall_seconds=round(res.wall_seconds, 3),
        stages=[dict(stage=s.stage, energy_raw=_j(s.energy_raw),
                     wall_seconds=round(s.wall_seconds, 3), hit=s.hit,
                     **s.detail) for s in res.stages])
    line = json.dumps(rec, default=lambda o: None)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    if args.save_state:
        np.savetxt(args.save_state, res.state, fmt="%+d")
    return 0 if (res.hit or res.target_raw is None
                 or not np.isfinite(res.target_raw)) else 1


def cmd_refine(args):
    from .refine import refine_family, tree_refine_state

    if args.family:
        only = args.only.split(",") if args.only else None
        hits, total = refine_family(
            args.family, only=only,
            skip_covered=not args.include_covered,
            ils_seconds=args.ils_seconds,
            extra_random=args.extra_random,
            deadline=args.deadline, out=args.out)
        return 0 if total == 0 or hits else 1

    # single instance: --state seeds the descent
    prob, target, kind, base = _detect_instance(args.path, args.kind,
                                                args.target)
    s0 = np.sign(np.loadtxt(args.state).reshape(-1))
    e_raw, state, info = tree_refine_state(
        prob, s0, target_raw=target, ils_seconds=args.ils_seconds,
        extra_random=args.extra_random, deadline=args.deadline)
    rec = dict(name=base, kind=kind, energy_raw=e_raw,
               target_raw=target, **info)
    line = json.dumps(rec, default=lambda o: None)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    if args.save_state:
        np.savetxt(args.save_state, state, fmt="%+d")
    return 0 if info["hit"] in (True, None) else 1


def cmd_exact(args):
    """Exact ground state (meet-in-the-middle as matmuls) — the
    capability the reference lacks: it ships ground truths, this derives
    them. n <= 28 on the host, <= 40 on the device, chimera layouts
    beyond."""
    import time

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from .exact import solve_exact_device, solve_exact_host

    prob, target, kind, base = _detect_instance(args.path, args.kind,
                                                None)
    backend = args.backend
    if backend == "auto":
        if prob.n <= 28:
            backend = "host"
        elif prob.n <= EXACT_DEVICE_MAX_N:
            backend = "device"
        else:
            # beyond the MITM tiers' reach a chimera layout is the only
            # exact route (tropical DP, host-side, no accelerator)
            from .exact_chimera import chimera_layout
            try:
                chimera_layout(np.asarray(prob.J))
            except ValueError:
                raise SystemExit(
                    f"exact: n={prob.n} exceeds the meet-in-the-middle "
                    f"limit n <= {EXACT_DEVICE_MAX_N} and the instance "
                    f"has no chimera layout") from None
            backend = "chimera"
    t0 = time.perf_counter()
    if backend == "chimera":
        from .exact_chimera import solve_exact_chimera
        e, s = solve_exact_chimera(prob)
    elif backend == "host":
        e, s = solve_exact_host(prob)
    else:
        e, s = solve_exact_device(prob, block_a=args.block_a,
                                  block_b=args.block_b)
    wall = time.perf_counter() - t0
    rec = dict(name=base, n=prob.n, kind=kind, backend=backend,
               energy_raw=e, wall_seconds=round(wall, 3),
               shipped_target=target if (target is None
                                         or np.isfinite(target)) else None,
               matches_shipped=(None if target is None
                                or not np.isfinite(target)
                                else bool(abs(e - target)
                                          <= max(1e-6 * abs(target),
                                                 1e-9))))
    line = json.dumps(rec)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    if args.save_state:
        np.savetxt(args.save_state, s, fmt="%+d")
    return 0


def cmd_beam(args):
    """Deterministic tropical beam contraction (+ exact strip
    refinement) for chimera-raster instances — solves the families whose
    shipped truths are external tnac4o artifacts (reference ships
    groundstates_otn2d.txt but no solver; NMC/examples/
    Chimera_droplet_instances). DCL rasters are padded automatically."""
    import time

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from .beam_chimera import (pad_to_chimera_grid, refine_strips,
                               solve_chimera_pipeline)

    prob, target, kind, base = _detect_instance(args.path, args.kind,
                                                None)
    solve_prob, rows, cols, n_orig = pad_to_chimera_grid(prob)
    t0 = time.perf_counter()
    if args.device:
        from .beam_chimera_device import solve_beam_chimera_device
        e, s, info = solve_beam_chimera_device(solve_prob, rows=rows,
                                            cols=cols,
                                            beam=1 << args.beam)
        if args.refine:
            sub = (lambda sp, R, w: solve_beam_chimera_device(
                sp, rows=R, cols=w, beam=1 << max(4, args.beam - 1))[:2])
            e, s, moves = refine_strips(solve_prob, s, rows=rows,
                                        cols=cols,
                                        window=args.window or 8,
                                        sub_solver=sub)
            info = dict(info, strip_moves=moves)
    elif args.refine:
        e, s, info = solve_chimera_pipeline(
            solve_prob, rows=rows, cols=cols, beam=1 << args.beam,
            orientations=args.orientations, window=args.window)
    else:
        from .beam_chimera import solve_beam_chimera_multi
        e, s, info = solve_beam_chimera_multi(
            solve_prob, rows=rows, cols=cols, beam=1 << args.beam,
            orientations=args.orientations)
    wall = time.perf_counter() - t0
    e = float(prob.energy(np.asarray(s)[:n_orig]))
    tol = 1e-6 * max(1.0, abs(target)) if target is not None else None
    rec = dict(name=base, n=prob.n, kind=kind, rows=rows, cols=cols,
               beam=args.beam, energy_raw=e,
               exact=bool(info.get("exact", False)),
               strip_moves=info.get("strip_moves"),
               wall_seconds=round(wall, 3),
               shipped_target=target if (target is None
                                         or np.isfinite(target)) else None,
               reaches_shipped=(None if target is None
                                or not np.isfinite(target)
                                else bool(e <= target + tol)))
    line = json.dumps(rec)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    if args.save_state:
        np.savetxt(args.save_state, np.asarray(s)[:n_orig], fmt="%+d")
    return 0


def cmd_generate(args):
    from .io import generators, writers

    kind = args.kind
    if kind == "sk":
        prob = generators.random_sk(args.n, seed=args.seed)
        gs = None
    elif kind == "ea2d":
        prob = generators.ea_2d(args.L, seed=args.seed)
        gs = None
    elif kind == "ea3d":
        prob = generators.ea_3d(args.L, seed=args.seed)
        gs = None
    elif kind == "wishart":
        prob, t, gs = generators.wishart_planted(args.n, args.alpha,
                                                 seed=args.seed)
    elif kind == "contrived":
        prob, t, gs = generators.contrived_wishart_backbone(
            args.n, args.alpha, seed=args.seed)
    elif kind == "contrived-ref":
        # reference-faithful pipeline (contrived_instance_generator.py)
        prob = generators.contrived_wishart_backbone_reference(
            args.n, alpha=args.alpha, seed=args.seed)
        gs = None
    else:
        raise SystemExit(f"unknown kind {kind}")
    writers.save_edgelist(args.out, prob)
    print(json.dumps({"n": prob.n, "edges": prob.num_edges,
                      "gs_energy": gs, "out": args.out}))


def main(argv=None):
    # multi-host launch: joins the jax.distributed runtime when the
    # NMC_TPU_COORDINATOR/NUM_PROCESSES/PROCESS_ID env vars are set (a
    # no-op otherwise) — see parallel/distributed.py
    from .parallel.distributed import initialize_from_env
    initialize_from_env()
    ap = argparse.ArgumentParser(prog="nmc_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("nmc", help="single/multi-chain NMC solve")
    _add_problem_args(p)
    p.add_argument("--sweeps-initial", type=int, default=10_000)
    p.add_argument("--sweeps-per-phase", type=int, default=10_000)
    p.add_argument("--cycles", type=int, default=10)
    p.add_argument("--beta", type=float, default=2.5)
    p.add_argument("--temp-x", type=float, default=20.0)
    p.add_argument("--lambda-start", type=float, default=3.0)
    p.add_argument("--lbp-tolerance", type=float, default=1e-8)
    p.add_argument("--lbp-iters", type=int, default=200)
    p.add_argument("--chains", type=int, default=1)
    p.set_defaults(fn=cmd_nmc)

    p = sub.add_parser("apt", help="adaptive beta-schedule preprocessor")
    _add_problem_args(p)
    p.add_argument("--sweeps", type=int, default=1000)
    p.add_argument("--sweeps-read", type=int, default=1000)
    p.add_argument("--chains", type=int, default=100)
    p.add_argument("--beta-start", type=float, default=0.5)
    p.add_argument("--alpha", type=float, default=1.25)
    p.add_argument("--beta-max", type=float, default=30.0)
    p.add_argument("--out-dir", default="Results/data")
    p.add_argument("--checkpoint")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.set_defaults(fn=cmd_apt)

    p = sub.add_parser("npt", help="replica exchange with NMC replicas")
    _add_problem_args(p)
    p.add_argument("--beta-list", help="beta_list_python.npy from apt")
    p.add_argument("--replicas", type=int, default=16)
    p.add_argument("--beta-start", type=float, default=0.3)
    p.add_argument("--beta-max", type=float, default=5.0)
    p.add_argument("--nmc-coldest", type=int, default=5)
    p.add_argument("--sweeps", type=int, default=10_000)
    p.add_argument("--sweeps-read", type=int, default=100)
    p.add_argument("--swap-attempts", type=int, default=10)
    p.add_argument("--swap-fraction", type=float, default=0.3)
    p.add_argument("--cycles", type=int, default=10)
    p.add_argument("--beta", type=float, default=1 / 0.366838 * 5,
                   help="global_beta for NMC replicas")
    p.add_argument("--temp-x", type=float, default=20.0)
    p.add_argument("--lambda-start", type=float, default=3.0)
    p.add_argument("--lbp-tolerance", type=float, default=1e-8)
    p.add_argument("--lbp-iters", type=int, default=200)
    p.add_argument("--checkpoint", help="checkpoint .npz path")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.set_defaults(fn=cmd_npt)

    p = sub.add_parser("icm", help="APT + Houdayer ICM baseline")
    _add_problem_args(p)
    p.add_argument("--beta-list")
    p.add_argument("--replicas", type=int, default=8)
    p.add_argument("--beta-start", type=float, default=0.3)
    p.add_argument("--beta-max", type=float, default=5.0)
    p.add_argument("--sweeps", type=int, default=10_000)
    p.add_argument("--sweeps-read", type=int, default=1000)
    p.add_argument("--swap-attempts", type=int, default=100)
    p.add_argument("--subreplicas", type=int, default=10)
    p.add_argument("--device-icm", action="store_true", default=None,
                   help="Houdayer moves on device (default: auto above 2048 spins)")
    p.set_defaults(fn=cmd_icm)

    p = sub.add_parser("evaluate",
                       help="ground-truth hit-rate over a benchmark folder")
    p.add_argument("--folder", required=True)
    p.add_argument("--family", default="wishart",
                   choices=["wishart", "chimera", "dcl"])
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--replicas", type=int, default=12)
    p.add_argument("--beta-start", type=float, default=0.3)
    p.add_argument("--beta-max", type=float, default=4.0)
    p.add_argument("--sweeps", type=int, default=2000)
    p.add_argument("--swap-attempts", type=int, default=20)
    p.add_argument("--nmc-coldest", type=int, default=0)
    p.add_argument("--tolerance", type=float, default=1e-6)
    p.add_argument("--block-size", type=int, default=128)
    p.add_argument("--coloring", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("sharded",
                       help="mesh-sharded scan-fused NPT (multi-chip/-host)")
    _add_problem_args(p)
    p.add_argument("--beta-list")
    p.add_argument("--replicas", type=int, default=32)
    p.add_argument("--beta-start", type=float, default=0.25)
    p.add_argument("--beta-max", type=float, default=16.0)
    p.add_argument("--beta", type=float, default=2.5,
                   help="global_beta for NMC replicas")
    p.add_argument("--temp-x", type=float, default=20.0)
    p.add_argument("--rounds", type=int, default=100)
    p.add_argument("--chunk-rounds", type=int, default=50)
    p.add_argument("--sweeps-per-phase", type=int, default=64)
    p.add_argument("--cycles", type=int, default=3)
    p.add_argument("--nmc-coldest", type=int, default=0)
    p.add_argument("--target-energy", type=float, default=None,
                   help="stop when the f64 best energy reaches this "
                        "(normalized units)")
    p.set_defaults(fn=cmd_sharded)

    p = sub.add_parser(
        "campaign",
        help="batched solution-quality campaign over a benchmark family "
             "(per-instance time-to-solution vs shipped ground truths)")
    from .campaign import add_campaign_args, run_campaign
    add_campaign_args(p)
    p.set_defaults(fn=run_campaign)

    p = sub.add_parser(
        "solve",
        help="one-command staged portfolio solve of a single instance "
             "(presolve -> spectral/difference-map -> seeded MCMC); "
             "ground-truth target auto-detected from sibling files")
    p.add_argument("path", help="instance file (edge-list dialects)")
    p.add_argument("--kind", default="auto",
                   choices=["auto", "wishart", "chimera", "dcl",
                            "contrived"])
    p.add_argument("--target", type=float, default=None,
                   help="raw target energy (default: sibling gs files)")
    p.add_argument("--arm", default="auto",
                   choices=["auto", "icm", "nmc", "pt", "hybrid"],
                   help="MCMC fallback arm (auto = measured family "
                        "preference: chimera->icm, dcl->hybrid, else icm)")
    p.add_argument("--sweeps", type=int, default=200_000,
                   help="MCMC budget (0 = spectral stages only)")
    p.add_argument("--dm-starts", type=int, default=2048)
    p.add_argument("--dm-iters", type=int, default=3000)
    p.add_argument("--no-presolve", action="store_true")
    p.add_argument("--no-spectral", action="store_true",
                   help="skip the spectral stage (default: auto — dense "
                        "cores only)")
    p.add_argument("--force-spectral", action="store_true",
                   help="run the spectral stage even on sparse graphs")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save-state", help="write the best +-1 state here")
    p.add_argument("--out", help="append the JSON record here")
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU backend")
    p.set_defaults(fn=cmd_solve)

    p = sub.add_parser(
        "exact",
        help="EXACT ground state by meet-in-the-middle enumeration "
             f"(n <= {EXACT_DEVICE_MAX_N}, chimera layouts beyond) — "
             "independently verifies shipped ground truths")
    p.add_argument("path", help="instance file (edge-list dialects)")
    p.add_argument("--kind", default="auto",
                   choices=["auto", "wishart", "chimera", "dcl",
                            "contrived"])
    p.add_argument("--backend", default="auto",
                   choices=["auto", "host", "device", "chimera"])
    p.add_argument("--block-a", type=int, default=512)
    p.add_argument("--block-b", type=int, default=4096)
    p.add_argument("--save-state", help="write the ground state here")
    p.add_argument("--out", help="append the JSON record here")
    p.add_argument("--cpu", action="store_true")
    p.set_defaults(fn=cmd_exact)

    p = sub.add_parser(
        "beam",
        help="deterministic tropical beam contraction for chimera-"
             "raster instances (C4..C16, DCL) + exact strip refinement")
    p.add_argument("path", help="instance file (edge-list dialects)")
    p.add_argument("--kind", default="auto",
                   choices=["auto", "wishart", "chimera", "dcl",
                            "contrived"])
    p.add_argument("--beam", type=int, default=16,
                   help="log2 of the beam width")
    p.add_argument("--orientations", type=int, default=1)
    p.add_argument("--no-refine", dest="refine", action="store_false",
                   help="skip the strip-refinement stage")
    p.add_argument("--window", type=int, default=None,
                   help="refinement strip width in cells (default auto)")
    p.add_argument("--device", action="store_true",
                   help="run the int32 beam DP on the accelerator")
    p.add_argument("--save-state", help="write the best state here")
    p.add_argument("--out", help="append the JSON record here")
    p.add_argument("--cpu", action="store_true")
    p.set_defaults(fn=cmd_beam)

    p = sub.add_parser(
        "refine",
        help="deterministic induced-tree large-neighborhood descent "
             "(Selby-style exact DP over maximal induced cell trees + "
             "2x2-cell-block ILS kicks) over a family's remaining "
             "misses from the saved beam/campaign states, or a single "
             "instance from --state")
    p.add_argument("path", nargs="?", default=None,
                   help="single instance file (omit with --family)")
    p.add_argument("--family", default=None,
                   help="grid family (chimera*/dcl*): refine every "
                        "not-yet-covered instance from the state pools")
    p.add_argument("--only", help="comma-separated instance names")
    p.add_argument("--include-covered", action="store_true",
                   help="also refine instances another tier already hit")
    p.add_argument("--state", help="±1 state file seeding the single-"
                                   "instance descent")
    p.add_argument("--kind", default="auto",
                   choices=["auto", "chimera", "dcl"])
    p.add_argument("--target", type=float, default=None,
                   help="raw target energy (default: sibling gs files)")
    p.add_argument("--ils-seconds", type=float, default=60.0)
    p.add_argument("--extra-random", type=int, default=24)
    p.add_argument("--deadline", type=float, default=None)
    p.add_argument("--save-state", help="write the refined ±1 state here")
    p.add_argument("--out", help="append JSONL rows here")
    p.set_defaults(fn=cmd_refine)

    p = sub.add_parser("generate", help="write benchmark instances")
    p.add_argument("--kind", required=True,
                   choices=["sk", "ea2d", "ea3d", "wishart", "contrived",
                            "contrived-ref"])
    p.add_argument("--n", type=int, default=100)
    p.add_argument("--L", type=int, default=8)
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_generate)

    args = ap.parse_args(argv)
    from .utils.compcache import enable_compilation_cache
    enable_compilation_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
