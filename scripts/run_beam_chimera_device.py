"""Device beam sweep of a chimera family with integer-exact hit checks
and (optionally) windowed beam refinement of misses.

Per instance:
  1. jitted int32 beam DP on the device (beam_chimera_device), orientation 0;
  2. on miss, Selby-style window-8 strip descent where each strip is
     re-solved by the SAME device beam (a C8-scale sub-problem);
  3. on miss, the transposed orientation + refinement again.

Hit criterion is exact integer arithmetic: both our state's energy and
the shipped truth state's energy are evaluated in 1/q units (q=75 for
the droplet families) against the SNAPPED couplings — no print-rounding
ambiguity. One JSONL line per instance; resumable.

Usage:
  python scripts/run_beam_chimera_device.py --family chimera2048
      [--beam 17] [--refine-beam 16] [--no-refine] [--orientations 2]
      [--limit K] [--deadline E] [--out ...] [--save-states DIR]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from run_beam_chimera import FAMILIES  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", required=True, choices=sorted(FAMILIES))
    ap.add_argument("--beam", type=int, default=17)
    ap.add_argument("--refine-beam", type=int, default=16)
    ap.add_argument("--no-refine", action="store_true")
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--orientations", type=int, default=2)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--only", default=None,
                    help="comma-separated instance names (e.g. the "
                         "2^16 sweep's near-misses for a 2^17 pass)")
    ap.add_argument("--deadline", type=float, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--save-states", default=None)
    args = ap.parse_args(argv)

    import numpy as np

    from nmc_tpu.beam_chimera import (_orient, pad_to_chimera_grid,
                                      refine_strips)
    from nmc_tpu.beam_chimera_device import (quantize_problem,
                                          solve_beam_chimera_device)
    from nmc_tpu.core.problem import IsingProblem
    from nmc_tpu.evaluation import (chimera_folder_instances,
                                    dcl_folder_instances)
    from nmc_tpu.io.loaders import read_otn2d_groundstates
    from nmc_tpu.utils.compcache import enable_compilation_cache

    enable_compilation_cache()

    out = args.out or f"results/beam_device_{args.family}_b{args.beam}.jsonl"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    done = set()
    if os.path.exists(out):
        with open(out) as f:
            done = {r["name"] for r in map(json.loads, f)
                    if "energy" in r}       # error records retry

    folder = FAMILIES[args.family]
    if args.family.startswith("dcl"):
        it = dcl_folder_instances(folder, limit=args.limit)
        truth_states = {}
    else:
        it = chimera_folder_instances(folder, limit=args.limit)
        truth_states = read_otn2d_groundstates(
            os.path.join(folder, "groundstates_otn2d.txt"))

    def int_energy(Jq, hq, s):
        si = s.astype(np.int64)
        return int(-(si @ Jq @ si) // 2 - hq @ si)

    sub_solver = (None if args.no_refine else
                  (lambda sub, R, w: solve_beam_chimera_device(
                      sub, rows=R, cols=w,
                      beam=1 << args.refine_beam)[:2]))

    only = set(args.only.split(",")) if args.only else None
    total = hits = 0
    for name, prob, gs in it:
        if name in done:
            continue
        if only is not None and name not in only:
            continue
        if args.deadline and time.time() > args.deadline:
            print("DEADLINE reached, stopping cleanly")
            break
        solve_prob, rows, cols, n_orig = pad_to_chimera_grid(prob)
        Jq, hq, q = quantize_problem(solve_prob)
        target_int = None
        truth_spins = (truth_states[name][1] if name in truth_states
                       else np.zeros(0))
        if truth_spins.size == n_orig:
            st = np.ones(solve_prob.n, np.int64)
            st[:n_orig] = truth_spins
            target_int = int_energy(Jq, hq, st)
        elif gs is not None:
            # truth files for the big families print energies only (no
            # spin vector); print rounding is <= 0.005 -> q*0.005 < 0.5,
            # so the integer target is still exact
            target_int = int(round(gs * q))

        t0 = time.perf_counter()
        stages = []
        best_e, best_s, best_int = None, None, None
        J = np.asarray(solve_prob.J, np.float64)
        h = np.asarray(solve_prob.h, np.float64)
        err = None
        for k in range(max(1, min(2, args.orientations))):
            try:
                if k == 0:
                    op, R, C = solve_prob, rows, cols
                    perm = np.arange(solve_prob.n)
                else:
                    J2, h2, perm, R, C = _orient(J, h, rows, cols,
                                                 True, False)
                    op = IsingProblem(J2, h2)
                e, s2, info = solve_beam_chimera_device(op, rows=R, cols=C,
                                                     beam=1 << args.beam)
                stages.append({"stage": f"beam_o{k}", "e": e})
                moves = 0
                hit_now = (target_int is not None
                           and int(round(e * q)) <= target_int)
                if not args.no_refine and not hit_now:
                    stop = (target_int / q) + 0.5 / q \
                        if target_int is not None else None
                    e, s2, moves = refine_strips(
                        op, s2, rows=R, cols=C, window=args.window,
                        sub_solver=sub_solver, stop_at=stop)
                    stages.append({"stage": f"refine_o{k}", "e": e,
                                   "moves": moves})
                s = np.empty_like(s2)
                s[perm] = s2
                e_int = int_energy(Jq, hq, s)
                if best_int is None or e_int < best_int:
                    best_e, best_s, best_int = \
                        float(prob.energy(s[:n_orig])), s[:n_orig], e_int
                if target_int is not None and best_int <= target_int:
                    break
            except Exception as ex:            # noqa: BLE001
                err = f"{type(ex).__name__}: {ex}"[:300]
                stages.append({"stage": f"beam_o{k}", "error": err})
                break
        dt = time.perf_counter() - t0
        if best_s is None:
            print(f"{name}: ERROR {err} ({dt:.0f}s)", flush=True)
            with open(out, "a") as f:
                f.write(json.dumps({"name": name, "family": args.family,
                                    "beam": args.beam, "error": err,
                                    "seconds": round(dt, 2)}) + "\n")
            total += 1
            continue
        if args.save_states:
            # tmp+rename (a deadline-gate kill mid-write must not corrupt
            # the seed pool) and never clobber a BETTER state another
            # tier (tree refine, a wider beam) already parked there
            os.makedirs(args.save_states, exist_ok=True)
            dst = os.path.join(args.save_states, name)
            write = True
            if os.path.exists(dst):
                s_old = np.ones(solve_prob.n, np.int64)
                old = np.sign(np.loadtxt(dst).reshape(-1)).astype(np.int64)
                s_old[:old.size] = old
                write = best_int < int_energy(Jq, hq, s_old)
            if write:
                np.savetxt(dst + ".tmp", best_s.astype(np.int8), fmt="%d")
                os.replace(dst + ".tmp", dst)
        hit = (None if target_int is None else bool(best_int <= target_int))
        total += 1
        hits += bool(hit)
        rec = {"name": name, "family": args.family, "beam": args.beam,
               "energy": best_e, "e_int": best_int, "q": q,
               "gs": gs, "target_int": target_int, "hit": hit,
               "better": (target_int is not None
                          and best_int < target_int),
               "seconds": round(dt, 2), "stages": stages}
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(f"{name}: e_int={best_int} target={target_int} hit={hit} "
              f"({dt:.0f}s)", flush=True)
    print(f"SUMMARY {args.family} device beam=2^{args.beam}: "
          f"{hits}/{total} ground states")


if __name__ == "__main__":
    main()
