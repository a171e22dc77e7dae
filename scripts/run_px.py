"""Partition-crossover composition tier over a family's open misses.

For every instance not yet covered by any tier that has BOTH a beam
state (results/beam_states/<family>) and a campaign best state
(results/best_states/<family>), computes the exactly-optimal
recombination of the two parents (nmc_tpu.refine.partition_crossover),
descends the offspring with the induced-tree tier, and appends a row to
results/px_<family>.jsonl (counted as the `px` coverage tier).
Improved states are written back to the beam pool (tmp+rename) so later
seeded runs start lower.

Usage: python scripts/run_px.py --family chimera2048
           [--ils-seconds 60] [--deadline E] [--only a.txt,b.txt]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", required=True)
    ap.add_argument("--ils-seconds", type=float, default=60.0)
    ap.add_argument("--only", default=None)
    ap.add_argument("--deadline", type=float, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import numpy as np

    from coverage_report import scan_family
    from nmc_tpu.beam_chimera import pad_to_chimera_grid
    from nmc_tpu.beam_chimera_device import quantize_problem
    from nmc_tpu.refine import (_family_instances, _int_energy,
                                grid_family_folders, partition_crossover,
                                tree_refine_state)

    folder = grid_family_folders()[args.family]
    out = args.out or f"results/px_{args.family}.jsonl"
    done = set()
    if os.path.exists(out):
        done = {json.loads(l)["name"] for l in open(out) if l.strip()}
    tiers = scan_family(args.family)
    covered = set().union(*tiers.values()) if tiers else set()
    only = set(args.only.split(",")) if args.only else None
    bdir = f"results/beam_states/{args.family}"
    cdir = f"results/best_states/{args.family}"

    it, truth_states = _family_instances(args.family, folder)
    hits = total = 0
    for name, prob, gs in it:
        if name in done or name in covered:
            continue
        if only is not None and name not in only:
            continue
        if args.deadline and time.time() > args.deadline:
            print("DEADLINE reached, stopping cleanly", flush=True)
            break
        pa, pb = os.path.join(bdir, name), os.path.join(cdir, name)
        if not (os.path.exists(pa) and os.path.exists(pb)):
            continue
        solve_prob, rows, cols, n_orig = pad_to_chimera_grid(prob)
        Jq, hq, q = quantize_problem(solve_prob)
        s_a = np.sign(np.loadtxt(pa).reshape(-1))[:n_orig]
        s_b = np.sign(np.loadtxt(pb).reshape(-1))[:n_orig]

        target_int = None
        truth_spins = (truth_states[name][1] if name in truth_states
                       else np.zeros(0))
        if truth_spins.size == n_orig:
            st = np.ones(solve_prob.n, np.int64)
            st[:n_orig] = truth_spins
            target_int = _int_energy(Jq, hq, st)
        elif gs is not None:
            target_int = int(round(gs * q))

        t0 = time.perf_counter()
        e_off, off, taken = partition_crossover(prob, s_a, s_b)
        disagreement = int(np.sum(s_a != s_b))
        # descend the offspring with the tree tier (also handles the
        # exact integer accounting and state write-back semantics)
        _, state, info = tree_refine_state(
            prob, off, target_int=target_int,
            ils_seconds=args.ils_seconds, seed=0,
            deadline=args.deadline)
        dt = time.perf_counter() - t0
        total += 1
        hits += bool(info["hit"])

        # persist any strict improvement to the beam/seed pool
        full = np.ones(solve_prob.n)
        full[:n_orig] = state
        e_int = info["e_int"]
        pool_best = None
        if os.path.exists(pa):
            s_old = np.ones(solve_prob.n)
            old = np.sign(np.loadtxt(pa).reshape(-1))
            s_old[:old.size] = old
            pool_best = _int_energy(Jq, hq, s_old)
        if pool_best is None or e_int < pool_best:
            np.savetxt(pa + ".tmp",
                       np.where(state >= 0, 1, -1).astype(np.int8),
                       fmt="%d")
            os.replace(pa + ".tmp", pa)

        rec = {"name": name, "family": args.family, "gs": gs,
               "stage": "px", "disagreement": disagreement,
               "components_taken": taken,
               "e_px_raw": e_off, **info,
               "seconds": round(dt, 2)}
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(f"{name}: d={disagreement} taken={taken} "
              f"e_int={info['e_int']} target={target_int} "
              f"hit={info['hit']} ({dt:.0f}s)", flush=True)
    print(f"SUMMARY {args.family} px: {hits}/{total} converted")
    return 0


if __name__ == "__main__":
    sys.exit(main())
