#!/bin/bash
# Crack the 3 standing wishart misses (of 8300 shipped instances):
#   data/holdout_n50: cwb N=50 inst_4, inst_18
#   data/holdout_n38: wishart_small N=38 alpha=0.21 inst_13
# Stage A: an order-of-magnitude bigger difference-map sweep (16384 starts
#          x 6000 iters, 8 seeds) — the stage that cracked the other
#          float/degenerate misses at 2048x3000.
# Stage B: spectral-seeded deep ICM (2M sweeps), 4 seeds.
# CPU-only (needs no accelerator); stops per folder once every instance hits.
set -u
cd "$(dirname "$0")/.."
OUT=results/campaign
mkdir -p "$OUT"

CWB=/root/reference/NPT/examples/contrived_wishart_backbone/wishart_planting_N_50_alpha_0.20
WSM=/root/reference/NPT/examples/wishart_small/wishart_planting_N_38_alpha_0.21
if [ ! -s data/holdout_n50/gs_energies.txt ]; then
  mkdir -p data/holdout_n50 data/holdout_n38
  cp "$CWB"/wishart_planting_N_50_alpha_0.20_inst_4.txt \
     "$CWB"/wishart_planting_N_50_alpha_0.20_inst_18.txt data/holdout_n50/
  grep -h "inst_4\.txt\|inst_18\.txt" "$CWB"/gs_energies.txt \
     > data/holdout_n50/gs_energies.txt
  cp "$WSM"/wishart_planting_N_38_alpha_0.21_inst_13.txt data/holdout_n38/
  grep -h "inst_13\.txt" "$WSM"/gs_energies.txt > data/holdout_n38/gs_energies.txt
fi

hits_all() {  # hits_all <jsonl...> <n_expected> -> exit 0 if every instance hit
  python - "$@" <<'EOF'
import json, sys
paths, n = sys.argv[1:-1], int(sys.argv[-1])
hit = set()
for p in paths:
    try:
        for line in open(p):
            r = json.loads(line)
            if r.get("hit"):
                hit.add(r["name"])
    except FileNotFoundError:
        pass
sys.exit(0 if len(hit) >= n else 1)
EOF
}

run_folder() {  # run_folder <folder> <tag> <n_inst>
  local folder=$1 tag=$2 n=$3
  local files=()
  echo "=== Stage A (DM XL) on $tag ==="
  for s in 0 1 2 3 4 5 6 7; do
    local f="$OUT/${tag}_dmxl_s${s}.jsonl"
    files+=("$f")
    [ -s "$f" ] || python -m nmc_tpu campaign --cpu --folder "$folder" \
      --kind wishart --arm spectral --presolve \
      --spectral-dm 16384 --spectral-dm-iters 6000 --spectral-polish 16 \
      --seed "$s" --out "$f" || true
    hits_all "${files[@]}" "$n" && { echo "$tag: ALL HIT (stage A)"; return 0; }
  done
  echo "=== Stage B (deep seeded ICM) on $tag ==="
  for s in 0 1 2 3; do
    local f="$OUT/${tag}_icm2M_s${s}.jsonl"
    files+=("$f")
    [ -s "$f" ] || python -m nmc_tpu campaign --cpu --folder "$folder" \
      --kind wishart --arm icm --init spectral --init-chains 4 --presolve \
      --spectral-dm 4096 --spectral-dm-iters 3000 \
      --replicas 16 --beta-min 0.25 --beta-max 32 --sweeps 2000000 \
      --swap-attempts 400 --seed "$s" --out "$f" || true
    hits_all "${files[@]}" "$n" && { echo "$tag: ALL HIT (stage B)"; return 0; }
  done
  echo "$tag: still missing after both stages"
  return 1
}

run_folder data/holdout_n38 holdout_n38 1
run_folder data/holdout_n50 holdout_n50 2
echo DONE
