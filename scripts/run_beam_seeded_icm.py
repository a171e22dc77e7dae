"""Beam-seeded ICM on a family's beam-solver misses.

Reads results/beam_device_<family>_b<beam>.jsonl, collects the instances
the deterministic beam missed (that have saved states), and runs the
batched EnsembleICM campaign arm with those states seeding the coldest
chains (--init file): MCMC starts inside the beam's basin — typically
within 0.1% of the truth — instead of at infinite temperature. The
chimera512 evidence says beam and ICM misses are complementary
(beam 81/100, ICM 93/100, union 100/100); this composes them per
instance instead of per family.

Usage:
  python scripts/run_beam_seeded_icm.py --family chimera1152
      [--beam 16] [--sweeps 5000000] [--deadline E]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", required=True)
    ap.add_argument("--beam", type=int, default=16)
    ap.add_argument("--sweeps", type=int, default=5_000_000)
    ap.add_argument("--replicas", type=int, default=32)
    ap.add_argument("--beta-max", type=float, default=32.0)
    ap.add_argument("--init-chains", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--save-best-states", default="auto", metavar="DIR",
                    help="checkpoint improving best states per chunk "
                         "(campaign --save-best-states pass-through). "
                         "Default 'auto' = results/best_states/<family>: "
                         "the beamseed runs sit 1-2 integer units above "
                         "truth for thousands of rounds, and those "
                         "states are exactly what the strip refiner and "
                         "later re-seeded runs need; 'off' disables")
    ap.add_argument("--skip-covered", action="store_true",
                    help="drop misses some other tier/run already hit "
                         "(rescans all result artifacts)")
    args = ap.parse_args(argv)

    beam_out = f"results/beam_device_{args.family}_b{args.beam}.jsonl"
    sdir = f"results/beam_states/{args.family}"
    if not os.path.exists(beam_out):
        print(f"no beam results at {beam_out}; nothing to seed")
        return 0
    misses = []
    for line in open(beam_out):
        r = json.loads(line)
        if r.get("hit") is False and os.path.exists(
                os.path.join(sdir, r["name"])):
            misses.append(r["name"])
    misses = sorted(set(misses))
    if args.skip_covered:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from coverage_report import scan_family
        tiers = scan_family(args.family)
        covered = set().union(*tiers.values()) if tiers else set()
        dropped = [m for m in misses if m in covered]
        misses = [m for m in misses if m not in covered]
        if dropped:
            print(f"{args.family}: skipping {len(dropped)} already-covered "
                  f"beam misses: {','.join(dropped)}")
    if not misses:
        print(f"{args.family}: beam left no seedable misses")
        return 0
    print(f"{args.family}: seeding ICM on {len(misses)} beam misses",
          flush=True)

    from nmc_tpu.campaign import main as campaign_main
    out = args.out or (f"results/campaign/{args.family}_icm_beamseed_"
                       f"{args.sweeps // 1000}k.jsonl")
    cargs = ["--family", args.family, "--instances", "101",
             "--only", ",".join(misses),
             "--replicas", str(args.replicas),
             "--beta-max", str(args.beta_max),
             "--chunk-rounds", "25", "--arm", "icm", "--subreplicas", "2",
             "--init", "file", "--init-states", sdir,
             "--init-chains", str(args.init_chains),
             "--seed", str(args.seed), "--trace",
             "--sweeps", str(args.sweeps), "--out", out]
    if args.save_best_states == "auto":
        args.save_best_states = f"results/best_states/{args.family}"
    if args.save_best_states and args.save_best_states != "off":
        cargs += ["--save-best-states", args.save_best_states]
    campaign_main(cargs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
