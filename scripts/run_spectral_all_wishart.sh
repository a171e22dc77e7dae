#!/bin/bash
# Spectral arm over EVERY shipped wishart_planting folder (161 in
# NPT/examples/wishart_small + 5 in NMC/examples/contrived_wishart_backbone)
# — host-only (no accelerator), ~ms per instance. One JSONL row file per folder
# under results/campaign/spectral_all/.
set -e
cd /root/repo
OUT=results/campaign/spectral_all
mkdir -p "$OUT"
for f in /root/reference/NPT/examples/wishart_small/wishart_planting_N_* \
         /root/reference/NMC/examples/contrived_wishart_backbone/wishart_planting_N_*; do
  base=$(basename "$f")                      # wishart_planting_N_40_alpha_0.20
  case "$f" in */contrived_wishart_backbone/*) tag="cwb_$base";; *) tag="$base";; esac
  out="$OUT/${tag}.spectral.jsonl"
  [ -s "$out" ] && continue
  timeout 280 python -m nmc_tpu campaign --folder "$f" --kind wishart \
    --instances 100 --arm spectral --spectral-polish 40 \
    --out "$out" >/dev/null 2>&1 || echo "FAILED $base"
done
python3 - <<'PY'
import json, glob
tot = hit = 0
rows = []
for f in sorted(glob.glob("results/campaign/spectral_all/*.jsonl")):
    recs = [json.loads(l) for l in open(f)]
    tot += len(recs); hit += sum(r["hit"] for r in recs)
    rows.append((f.split("/")[-1], sum(r["hit"] for r in recs), len(recs)))
print(f"TOTAL {hit}/{tot} over {len(rows)} folders")
worst = sorted(rows, key=lambda r: r[1]/max(r[2],1))[:10]
print("worst folders:", worst)
PY
echo SPECTRAL_ALL_DONE
