"""Spreads and medians of the runs ``proof.sh`` recorded, as the bounds of
``BENCHMARK.json`` are set from them: for each metric of each set, the
interquartile range over the median (``statistics.quantiles(n=4)``), and
the numbers the reference compared, largest first.

    python3 portbench/tools/spread.py build/portbench_runs/pile10k.drop.jsonl
"""
import json
import statistics
import sys


def spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(path):
    rows = [json.loads(line) for line in open(path)]
    sets = {}
    for r in rows:
        sets.setdefault(r["set"], []).append(r)
    for name, runs in sorted(sets.items()):
        ok = [r for r in runs if r["result"]]
        print(f"set {name}: {len(runs)} runs, rc {[r['rc'] for r in runs]}, "
              f"correct {[r['result']['correct'] for r in ok]}, "
              f"failed {[r['result']['failed'] for r in ok]}, "
              f"wall {[r['wall'] for r in runs]}")
        metrics = sorted({m for r in ok for m in r["result"]["metrics"]})
        for m in metrics:
            v = [r["result"]["metrics"][m]["value"] for r in ok
                 if m in r["result"]["metrics"]]
            line = f"  {m}: median {statistics.median(v):.6g}"
            if len(v) >= 4:
                line += f", spread {100 * spread(v):.3f}%"
            print(line + f", values {[round(x, 5) for x in v]}")
        checks = sorted({c for r in ok for c in r["result"]["check"]})
        for c in checks:
            v = [r["result"]["check"][c]["value"] for r in ok]
            print(f"  check {c}: max {max(v)!r} limit "
                  f"{ok[0]['result']['check'][c]['limit']!r} values {v}")
        for r in ok:
            d = r["result"]["device"]
            print(f"  seed {r['seed']}: peak {d['memory_peak_bytes']}, "
                  f"attempted {r['result']['attempted']}"
                  + (f", busy {d['busy_s']:.4f} of {d['window_s']:.4f} s"
                     if "busy_s" in d else ""))


if __name__ == "__main__":
    for p in sys.argv[1:]:
        print(p)
        main(p)
