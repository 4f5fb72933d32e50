#!/usr/bin/env bash
# Serve the same fixed-batch run from two checkouts of the repository, in
# turns, on one card:
#
#     bash tools/ab_serve.sh PARENT_DIR CHANGE_DIR [PAIRS] [serve CLI args...]
#
# PARENT_DIR and CHANGE_DIR are trees unpacked with `git archive` (each
# builds its own kernels under its own build/).  Runs parent, change, change,
# parent, ... for PAIRS pairs (default 2) of `python -m
# repro_torch.launch.serve` with the given arguments (default: exact,
# batch 4, prompt 1024, 32 new tokens), and prints the card's name and
# power limit, then one line per run with its prefill seconds, decode tok/s
# and step p50/p99.
set -euo pipefail
parent=$(cd "$1" && pwd)
change=$(cd "$2" && pwd)
pairs=${3:-2}
shift $(( $# < 3 ? $# : 3 ))
args=("$@")
if [ ${#args[@]} -eq 0 ]; then
  args=(--arch tinyllama-1.1b --cache-policy exact --batch 4 --prompt-len 1024 --gen 32)
fi
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
stats=$(mktemp)
trap 'rm -f "$stats"' EXIT
for ((i = 0; i < pairs; i++)); do
  if ((i % 2 == 0)); then order=(parent change); else order=(change parent); fi
  for side in "${order[@]}"; do
    dir=$parent
    [ "$side" = change ] && dir=$change
    (cd "$dir" && PYTHONPATH=src python3 -m repro_torch.launch.serve "${args[@]}" \
        --stats-json "$stats" > /dev/null)
    python3 - "$side" "$stats" <<'PY'
import json, sys
d = json.load(open(sys.argv[2]))
print(f"{sys.argv[1]:6s} prefill_s {d['prefill_s']} tok_per_s {d['tok_per_s']} "
      f"step_p50_ms {d['decode_step_p50_ms']} step_p99_ms {d['decode_step_p99_ms']}")
PY
  done
done
