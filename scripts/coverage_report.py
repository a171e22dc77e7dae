"""Consolidated any-tier ground-truth coverage over the shipped families.

The reference ships exact (or tnac4o/DCL-constructed) ground truths for
100 instances in each chimera droplet family and each DCL grid
(/root/reference/NMC/examples/Chimera_droplet_instances/*,
/root/reference/NMC/examples/DCL_instances/*). This report scans every
per-instance result artifact in results/ — the deterministic tiers
(exact tropical DP, beam contraction) and every stochastic campaign arm
(ICM / PT / NMC / hybrid, all seeds/budgets) — and reports, per family:

  * hits per tier (distinct instances),
  * the ANY-TIER union (an instance counts once if any tier's
    f64-re-verified / exact-integer hit matched the shipped truth),
  * which instances remain unsolved.

Writes results/any_tier_coverage.json and prints a markdown table for
docs/BENCHMARKS.md. Wishart coverage (8300/8300) has its own artifacts
(results/exact_verify_small.jsonl, results/campaign/spectral_dm*/,
results/inst18_enum_proof.json) and is quoted in the JSON as a pointer
rather than rescanned here.

Usage: python scripts/coverage_report.py
"""
import glob
import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REF = "/root/reference/NMC/examples"
FAMILIES = {
    "chimera128": f"{REF}/Chimera_droplet_instances/chimera128_spinglass_power",
    "chimera512": f"{REF}/Chimera_droplet_instances/chimera512_spinglass_power",
    "chimera1152": f"{REF}/Chimera_droplet_instances/chimera1152_spinglass_power",
    "chimera2048": f"{REF}/Chimera_droplet_instances/chimera2048_spinglass_power",
    "dcl8": f"{REF}/DCL_instances/C8",
    "dcl16": f"{REF}/DCL_instances/C16",
}


def shipped_instances(folder):
    return sorted(f for f in os.listdir(folder)
                  if re.fullmatch(r"\d+\.txt", f))


def _iter_jsonl(path):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def scan_family(fam):
    tiers = {}

    def add(tier, name):
        tiers.setdefault(tier, set()).add(name)

    # deterministic exact tier (tropical DP; chimera128 only)
    p = f"results/exact_verify_{fam}.jsonl"
    if os.path.exists(p):
        for r in _iter_jsonl(p):
            if r.get("match"):
                add("exact", r["name"])

    # deterministic beam tier
    for p in glob.glob(f"results/beam_device_{fam}_b*.jsonl"):
        for r in _iter_jsonl(p):
            if r.get("hit"):
                add("beam", r["name"])

    # deterministic induced-tree descent tier (nmc_tpu/tree_moves.py)
    for p in glob.glob(f"results/tree_refine_{fam}*.jsonl"):
        for r in _iter_jsonl(p):
            if r.get("hit"):
                add("tree", r["name"])

    # partition-crossover composition tier (nmc_tpu/refine.py:
    # exact recombination of beam x campaign best states + tree descent)
    for p in glob.glob(f"results/px_{fam}*.jsonl"):
        for r in _iter_jsonl(p):
            if r.get("hit"):
                add("px", r["name"])

    # stochastic campaign arms (all seeds/budgets, incl. crash partials)
    for p in (glob.glob(f"results/campaign/{fam}_*.jsonl")
              + glob.glob(f"results/campaign/{fam}_*.jsonl.partial")):
        stem = os.path.basename(p).split(".jsonl")[0]
        m = re.match(rf"{fam}_([a-z_]+?)(?:_|$)", stem)
        tier = m.group(1) if m else "campaign"
        for r in _iter_jsonl(p):
            if r.get("hit"):
                add(tier, r["name"])
    return tiers


def wishart_surface():
    """Per-(N, alpha, arm) MCMC hardness-surface cells recorded so far
    (results/campaign/wishart_n*_a*_<arm>.jsonl — the seg6 fill writes
    one file per cell). Returns {cell: {"instances": I, "hits": H}}."""
    cells = {}
    for p in glob.glob("results/campaign/wishart_n*_a*_*.jsonl"):
        m = re.match(r"wishart_n(\d+)_a([\d.]+)_([a-z_]+)\.jsonl",
                     os.path.basename(p))
        if not m:
            continue
        rows = [r for r in _iter_jsonl(p) if r.get("name")]
        if rows:
            cells[f"N{m.group(1)}_a{m.group(2)}_{m.group(3)}"] = {
                "instances": len({r["name"] for r in rows}),
                "hits": sum(1 for r in rows if r.get("hit")),
            }
    return cells


def main():
    report = {}
    rows = []
    for fam, folder in FAMILIES.items():
        shipped = shipped_instances(folder)
        tiers = scan_family(fam)
        union = set().union(*tiers.values()) if tiers else set()
        union &= set(shipped)
        unsolved = sorted(set(shipped) - union)
        report[fam] = {
            "shipped": len(shipped),
            "tiers": {t: sorted(v) for t, v in sorted(tiers.items())},
            "any_tier": len(union),
            "unsolved": unsolved,
        }
        tier_txt = ", ".join(f"{t} {len(v)}"
                             for t, v in sorted(tiers.items(),
                                                key=lambda kv: -len(kv[1])))
        rows.append((fam, len(shipped), tier_txt, len(union)))

    report["wishart"] = {
        "shipped": 8300,
        "any_tier": 8300,
        "note": ("166 folders x 50 instances; spectral+DM 8297, remaining "
                 "3 via holdout campaign + exact branch-and-bound "
                 "(results/exact_verify_small.jsonl, "
                 "results/campaign/spectral_dm*/, "
                 "results/inst18_enum_proof.json)"),
        "mcmc_surface": wishart_surface(),
    }

    os.makedirs("results", exist_ok=True)
    with open("results/any_tier_coverage.json", "w") as f:
        json.dump(report, f, indent=1)

    print("| family | shipped | per-tier hits | any-tier |")
    print("|---|---|---|---|")
    for fam, n, tier_txt, u in rows:
        print(f"| {fam} | {n} | {tier_txt} | **{u}/{n}** |")
    print("| wishart (all folders) | 8300 | spectral+DM 8297, "
          "MCMC+exact close the rest | **8300/8300** |")


if __name__ == "__main__":
    main()
