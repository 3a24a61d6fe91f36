#!/bin/bash
# Run cells of the benchmark one after another on this machine's card and
# keep each run's output under <out_dir>:
#   benchmark/tools/cells.sh <out_dir> <seconds> <workload>:<seed>:<trace> ...
out=$1; seconds=$2; shift 2
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit,clocks.sm --format=csv,noheader | tee -a "$out/card.txt"
for spec in "$@"; do
  IFS=: read -r w s t <<<"$spec"
  f="$out/$w.$s.$t.$(date +%s%N)"
  start=$(date +%s)
  timeout 400 python3 benchmark/run.py --workload "$w" --seed "$s" --seconds "$seconds" --trace "$t" \
    >"$f.out" 2>"$f.err"
  rc=$?
  echo "$w seed=$s trace=$t rc=$rc wall=$(( $(date +%s) - start ))s"
  tail -n 1 "$f.out" | cut -c1-1200
  tail -n 4 "$f.err" | cut -c1-300
done
