"""Regenerate the generated section of the docs of record.

Reruns scripts/coverage_report.py (refreshing
results/any_tier_coverage.json from the raw per-instance artifacts) and
rewrites the any-tier scoreboard between the COVERAGE-BEGIN/END markers
in BOTH docs/BENCHMARKS.md and README.md. The docs of record cannot
drift from the artifact: they ARE the artifact.

Usage: python scripts/update_benchmarks.py
"""

import io
import os
import sys
from contextlib import redirect_stdout

COV_BEGIN = "<!-- COVERAGE-BEGIN (generated by scripts/update_benchmarks.py) -->"
COV_END = "<!-- COVERAGE-END -->"
DOC = "docs/BENCHMARKS.md"
README = "README.md"


def _splice(path, begin, end, body):
    doc = open(path).read()
    if begin not in doc or end not in doc:
        raise SystemExit(f"{path} is missing the {begin} / {end} markers")
    pre = doc.split(begin)[0]
    post = doc.split(end, 1)[1]
    with open(path, "w") as f:
        f.write(pre + begin + "\n" + body.rstrip() + "\n" + end + post)


def coverage_section():
    """Rebuild results/any_tier_coverage.json and render it as the
    scoreboard table + per-family unsolved remainders."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__))))
    import coverage_report
    buf = io.StringIO()
    with redirect_stdout(buf):
        coverage_report.main()
    table = buf.getvalue().rstrip()

    import json
    rep = json.load(open("results/any_tier_coverage.json"))
    unsolved_lines = []
    for fam, d in rep.items():
        uns = d.get("unsolved")
        if uns:
            unsolved_lines.append(
                f"  - {fam}: {len(uns)} open — {', '.join(uns)}")
    surface = rep.get("wishart", {}).get("mcmc_surface", {})
    lines = [
        "",
        "Scoreboard regenerated from `results/any_tier_coverage.json` "
        "(rebuilt by `scripts/coverage_report.py` from every "
        "per-instance result artifact in `results/` at doc-generation "
        "time — the table below cannot drift from the raw rows):",
        "",
        table,
        "",
    ]
    if unsolved_lines:
        lines += ["Open instances (every family not at 100%):", ""]
        lines += unsolved_lines
        lines += [""]
    if surface:
        inst = sum(c["instances"] for c in surface.values())
        lines += [f"Wishart MCMC hardness-surface cells recorded: "
                  f"{len(surface)} (N, α, arm) cells / {inst} "
                  f"instance-runs (`wishart.mcmc_surface` in the JSON).",
                  ""]
    return "\n".join(lines)


def main():
    cov = coverage_section()
    _splice(DOC, COV_BEGIN, COV_END, cov)
    _splice(README, COV_BEGIN, COV_END, cov)
    print("coverage section regenerated into "
          f"{DOC} and {README} from results/any_tier_coverage.json")

if __name__ == "__main__":
    main()
