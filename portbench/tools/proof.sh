#!/bin/bash
# The runs a bound and the correctness readings are set from, for one cell
# in one call: two sets over the same seeds (--trace 0), then traced runs
# on other seeds. Each run's last line is appended to OUT/<cell>.jsonl with
# its set and seed; its standard error's end goes to OUT/<cell>.err.
# Usage: bash portbench/tools/proof.sh CELL SECONDS "SEEDS" "TRACED_SEEDS" OUT
CELL=$1; S=$2; SEEDS=$3; TRACED=$4; OUT=${5:-build/portbench_runs}
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee -a "$OUT/$CELL.err"
one() {  # set seed trace
  local t0=$(date +%s)
  python3 portbench/run.py --workload "$CELL" --seed "$2" --seconds "$S" \
    --trace "$3" > "$OUT/.last.out" 2> "$OUT/.last.err"
  local rc=$? t1=$(date +%s)
  echo "== $CELL set $1 seed $2 trace $3 rc $rc wall $((t1 - t0))" >> "$OUT/$CELL.err"
  tail -n 14 "$OUT/.last.err" | cut -c1-600 >> "$OUT/$CELL.err"
  python3 - "$1" "$2" "$3" "$rc" "$((t1 - t0))" "$OUT/.last.out" >> "$OUT/$CELL.jsonl" <<'PY'
import json, sys
s, seed, tr, rc, wall, path = sys.argv[1:]
lines = open(path).read().splitlines()
try:
    res = json.loads(lines[-1])
except (IndexError, ValueError):
    res = None
print(json.dumps(dict(set=s, seed=int(seed), trace=int(tr), rc=int(rc),
                      wall=int(wall), result=res)))
PY
  echo "$CELL set $1 seed $2 trace $3 rc $rc wall $((t1 - t0))"
}
for set in A B; do
  for seed in $SEEDS; do one $set $seed 0; done
done
for seed in $TRACED; do one T $seed 1; done
