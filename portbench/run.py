"""The benchmark of edyn_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload pile65k.drop --seed 7 \
        --seconds 40 --trace 0

Reads the cell from ``BENCHMARK.json`` (its configuration, traffic mix,
metrics and limits, each a file under ``portbench/`` found by name), runs
it on this machine's card and prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted`` and ``failed`` frames,
``metrics`` (the end-to-end ones, or with ``--trace 1`` the per-layer
ones), ``device``, with ``--trace 1`` ``breakdown``, and last ``check``,
each number compared with its limit (also the last lines of standard
error). Exits non-zero, printing no result, without a card (or fewer
than the cell asks for), without the program, or when JAX or the JAX
package was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[0:0] = [HERE, ROOT]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    from harness import runner, spec
    try:
        cell = spec.load_cell(a.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count: "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 3
    lines = []
    result = runner.run_cell(cell, a.seed, a.seconds, bool(a.trace),
                             "cuda", T0, log=lines.append)
    found = runner.forbidden_modules()
    if found:
        print(f"portbench: JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
