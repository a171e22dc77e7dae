"""Emit the round-5 chimera2048 seeded-ICM tier lists.

Reads the beam sweep rows + current any-tier coverage and prints two
comma-separated instance lists:

  near: uncovered beam misses with integer residual <= --near-cut
        (the convertible tier — gets the 10M-sweep seeded budget)
  far:  the remaining uncovered misses with saved states (gets the
        shorter record-keeping budget)

Usage: python scripts/r5_tier_lists.py [--near-cut 150] [--family ...]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default="chimera2048")
    ap.add_argument("--beam", type=int, default=16)
    ap.add_argument("--near-cut", type=int, default=150)
    args = ap.parse_args()

    from coverage_report import scan_family
    tiers = scan_family(args.family)
    covered = set().union(*tiers.values()) if tiers else set()

    res = {}
    for line in open(f"results/beam_device_{args.family}_b{args.beam}.jsonl"):
        r = json.loads(line)
        if "e_int" in r and r.get("target_int") is not None:
            res[r["name"]] = r["e_int"] - r["target_int"]

    sdir = f"results/beam_states/{args.family}"
    near, far = [], []
    for name, d in sorted(res.items()):
        if name in covered or not os.path.exists(os.path.join(sdir, name)):
            continue
        (near if d <= args.near_cut else far).append(name)
    print("NEAR", len(near), ",".join(near))
    print("FAR", len(far), ",".join(far))


if __name__ == "__main__":
    main()
