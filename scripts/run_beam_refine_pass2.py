"""Deterministic near-miss conversion for the beam tier (pass 2).

The r3 beam sweeps left misses whose median residual is 0.016-0.031 % —
a few excitation quanta (VERDICT r3 weak #5). This pass reloads each
miss's SAVED beam state and runs a deeper Selby-style strip descent than
the in-sweep refinement did: wider windows (droplets wider than the
window survive pass 1's window-8 strips in both orientations), extra
stride offsets, and more passes. Pure refinement — no re-beam of the
full instance — so a converted miss is a deterministic ground-state
re-derivation (matches the shipped truth in exact integer arithmetic,
same criterion as scripts/run_beam_chimera_device.py).

Output rows go to results/beam_device_<family>_brw<window>.jsonl — the
`beam_device_<fam>_b*` pattern scripts/coverage_report.py already scans as
the deterministic beam tier.

Host-only by default (numpy strip DP; safe to run while a device run
owns the accelerator); --device switches the strip sub-solver to the
jitted device beam.

Usage:
  python scripts/run_beam_refine_pass2.py --family chimera2048
      [--window 10] [--refine-beam 16] [--max-passes 40] [--device]
      [--skip-covered] [--only a.txt,b.txt] [--deadline E]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from run_beam_chimera import FAMILIES  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", required=True, choices=sorted(FAMILIES))
    ap.add_argument("--beam", type=int, default=16,
                    help="pass-1 beam exponent (locates states/results)")
    ap.add_argument("--window", type=int, default=10)
    ap.add_argument("--stride", type=int, default=None,
                    help="strip stride (default window//3: more offsets "
                         "than pass 1's window//2)")
    ap.add_argument("--refine-beam", type=int, default=16)
    ap.add_argument("--max-passes", type=int, default=40)
    ap.add_argument("--device", action="store_true",
                    help="use the jitted device beam as strip sub-solver")
    ap.add_argument("--skip-covered", action="store_true")
    ap.add_argument("--only", default=None)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--deadline", type=float, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import numpy as np

    from nmc_tpu.beam_chimera import pad_to_chimera_grid, refine_strips
    from nmc_tpu.beam_chimera_device import quantize_problem
    from nmc_tpu.evaluation import (chimera_folder_instances,
                                    dcl_folder_instances)
    from nmc_tpu.io.loaders import read_otn2d_groundstates

    sub_solver = None
    if args.device:
        from nmc_tpu.beam_chimera_device import solve_beam_chimera_device
        from nmc_tpu.utils.compcache import enable_compilation_cache
        enable_compilation_cache()
        sub_solver = (lambda sub, R, w: solve_beam_chimera_device(
            sub, rows=R, cols=w, beam=1 << args.refine_beam)[:2])

    pass1 = f"results/beam_device_{args.family}_b{args.beam}.jsonl"
    sdir = f"results/beam_states/{args.family}"
    out = args.out or (f"results/beam_device_{args.family}"
                       f"_brw{args.window}.jsonl")
    if not os.path.exists(pass1):
        print(f"no pass-1 results at {pass1}; nothing to refine")
        return 0

    misses = set()
    for line in open(pass1):
        r = json.loads(line)
        if r.get("hit") is False and os.path.exists(
                os.path.join(sdir, r["name"])):
            misses.add(r["name"])
    done = set()
    if os.path.exists(out):
        done = {json.loads(line)["name"] for line in open(out)}
    misses -= done
    if args.only:
        misses &= set(args.only.split(","))
    if args.skip_covered:
        from coverage_report import scan_family
        tiers = scan_family(args.family)
        covered = set().union(*tiers.values()) if tiers else set()
        misses -= covered
    misses = sorted(misses)[:args.limit]
    if not misses:
        print(f"{args.family}: no uncovered refinable beam misses")
        return 0
    print(f"{args.family}: pass-2 refine (window={args.window}) on "
          f"{len(misses)} beam misses", flush=True)

    if args.family.startswith("dcl"):
        it = dcl_folder_instances(FAMILIES[args.family])
        truth_states = {}
    else:
        it = chimera_folder_instances(FAMILIES[args.family])
        truth_states = read_otn2d_groundstates(
            os.path.join(FAMILIES[args.family], "groundstates_otn2d.txt"))

    def int_energy(Jq, hq, s):
        si = s.astype(np.int64)
        return int(-(si @ Jq @ si) // 2 - hq @ si)

    hits = total = 0
    for name, prob, gs in it:
        if name not in misses:
            continue
        if args.deadline and time.time() > args.deadline:
            print("DEADLINE reached, stopping cleanly")
            break
        solve_prob, rows, cols, n_orig = pad_to_chimera_grid(prob)
        Jq, hq, q = quantize_problem(solve_prob)
        truth_spins = (truth_states[name][1] if name in truth_states
                       else np.zeros(0))
        if truth_spins.size == n_orig:
            st = np.ones(solve_prob.n, np.int64)
            st[:n_orig] = truth_spins
            target_int = int_energy(Jq, hq, st)
        elif gs is not None:
            target_int = int(round(gs * q))
        else:
            target_int = None

        s0 = np.ones(solve_prob.n)
        s0[:n_orig] = np.sign(np.loadtxt(
            os.path.join(sdir, name)).reshape(-1))
        e_int0 = int_energy(Jq, hq, np.where(s0 >= 0, 1, -1))
        stop = ((target_int / q) + 0.5 / q
                if target_int is not None else None)
        t0 = time.perf_counter()
        e, s, moves = refine_strips(
            solve_prob, s0, rows=rows, cols=cols, window=args.window,
            stride=args.stride or max(1, args.window // 3),
            max_passes=args.max_passes, refine_beam=1 << args.refine_beam,
            sub_solver=sub_solver, stop_at=stop)
        dt = time.perf_counter() - t0
        e_int = int_energy(Jq, hq, np.where(s >= 0, 1, -1))
        hit = (None if target_int is None else bool(e_int <= target_int))
        total += 1
        hits += bool(hit)
        if e_int < e_int0:
            # persist ANY strictly-improved state, not only full hits:
            # the state dir doubles as the beamseed-ICM seed pool, and a
            # lower-energy deterministic seed shortens that tier's TTS
            # even when the strip descent stops short of the truth.
            os.makedirs(sdir, exist_ok=True)
            # tmp+rename: this script runs under deadline gates that can
            # kill it mid-write, and a truncated state file crashes every
            # later seeded run at --init file (wrong spin count)
            dst = os.path.join(sdir, name)
            np.savetxt(dst + ".tmp",
                       np.where(s[:n_orig] >= 0, 1, -1).astype(np.int8),
                       fmt="%d")
            os.replace(dst + ".tmp", dst)
        rec = {"name": name, "family": args.family,
               "beam": args.beam, "window": args.window,
               "e_int_start": e_int0,
               "energy": float(prob.energy(s[:n_orig])), "e_int": e_int,
               "q": q, "gs": gs, "target_int": target_int, "hit": hit,
               "better": (target_int is not None and e_int < target_int),
               "moves": moves, "seconds": round(dt, 2),
               "stage": "refine_pass2"}
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(f"{name}: e_int={e_int} target={target_int} hit={hit} "
              f"moves={moves} ({dt:.0f}s)", flush=True)
    print(f"SUMMARY {args.family} refine pass2 window={args.window}: "
          f"{hits}/{total} converted")
    return 0


if __name__ == "__main__":
    sys.exit(main())
