#!/bin/bash
# Tail item: chimera1152 hybrid arm at the round-2 matched 1.6M budget
# (ICM got 2/20 there; does disagreement-seeded NMC heating help at the
# SAME budget?). Runs only if the wishart surface leaves deadline room.
set -x
cd /root/repo
OUT=results/campaign

rem=$(( ${DEADLINE:-9999999999} - $(date +%s) ))
if [ "$rem" -lt 600 ]; then echo "DEADLINE: skip hybrid 1152"; exit 0; fi
t=5400; [ "$rem" -lt "$t" ] && t=$rem

timeout "$t" \
  python -m nmc_tpu campaign --family chimera1152 --instances 20 \
  --replicas 32 --beta-max 32 --chunk-rounds 25 \
  --arm hybrid --subreplicas 2 --nmc-cold 6 --temp-x 20 --trace \
  --sweeps 1600000 --out $OUT/chimera1152_hybrid_1600k.jsonl \
  || echo "run failed/cut (continuing)"

echo "HYBRID 1152 DONE"
