#!/usr/bin/env python3
"""What recording the step's spans and counters costs a benchmark cell, and
how its spans tile the traced frames, on one GPU, in one process.

    python3 scripts/torch_trace_cost.py --workload pile10k.drop \
        [--seconds 51] [--seeds 11 12] [--traced 13] [--enabled 14]

Runs the cell (``portbench``'s untraced run, its check included) once per
seed with tracing off and once inside ``utils.profile.enable()`` (spans and
counters on, no profiler), in turns off, on, then on, off for the next
seed. With ``--traced SEED``, one more window traced as the benchmark's
``--trace 1`` traces it (no check): each span's device ms a traced frame,
the phases' sum against the ``step`` span, and the median traced frame on
the host clock; with ``--enabled SEED`` the same of a whole window with
tracing on and no profiler. Prints a line a run, then one JSON line.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0:0] = [ROOT, os.path.join(ROOT, "portbench")]
PHASES = ("aabbs", "broadphase", "manifold_slots", "narrowphase", "islands",
          "rows", "solve")


def tiling(cell, seed: int, seconds: float, traced: bool) -> dict:
    """One window, its end traced (``traced``) or all of it recorded under
    ``profile.enable()``: the spans a recorded frame, their sum against the
    step's extent, and the median recorded frame's host time."""
    import torch
    from edyn_tpu_torch.utils import profile
    from harness import runner, window
    run_window = window.run

    def from_the_start(drive, seconds, seed, sampled, on_start, tracer):
        def start():
            profile.reset()     # the warm-up's steps are not the window's
            on_start()
        return run_window(drive, seconds, seed, sampled, start, tracer)

    window.run = from_the_start
    try:
        with contextlib.nullcontext() if traced else profile.enable():
            run = runner.measure(cell, seed, seconds, traced,
                                 torch.device("cuda"), time.perf_counter())
    finally:
        window.run = run_window
    rec = profile.recorded()
    n = rec["steps"]
    frames = run.trace["frames"] if traced else len(run.win.frame_s)
    ms = {k: v["device_ms"] / n for k, v in rec["spans"].items()}
    step = rec["spans"]["step"]
    return dict(seed=seed, traced=traced, frames=frames, recorded_steps=n,
                spans_ms=ms,
                phases_and_glue_ms=sum(ms[p] for p in PHASES)
                + step["self_ms"] / n,
                step_ms=ms["step"], step_host_ms=step["host_ms"] / n,
                median_frame_ms=1e3 * statistics.median(
                    run.win.frame_s[-frames:]),
                counters={k: v / n for k, v in rec["counters"].items()
                          if not k.startswith("host_syncs.")})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[11, 12])
    ap.add_argument("--traced", type=int, default=None)
    ap.add_argument("--enabled", type=int, default=None)
    a = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_trace_cost: no CUDA device", file=sys.stderr)
        return 1
    from edyn_tpu_torch.utils import profile
    from harness import runner, spec
    cell = spec.load_cell(a.workload)
    runs = []
    for k, seed in enumerate(a.seeds):
        for on in ((False, True) if k % 2 == 0 else (True, False)):
            profile.reset()
            t0 = time.perf_counter()
            with profile.enable() if on else contextlib.nullcontext():
                res = runner.run_cell(cell, seed, a.seconds, False, "cuda",
                                      t0, log=lambda line: None)
            rec = profile.recorded()
            runs.append(dict(seed=seed, tracing=on, correct=res["correct"],
                             frames=res["attempted"],
                             recorded=rec["steps"],
                             metrics={m: v["value"]
                                      for m, v in res["metrics"].items()}))
            print(json.dumps(runs[-1]), flush=True)
    out = dict(workload=a.workload, seconds=a.seconds,
               card=runner.power_limit(), runs=runs)
    for key, seed in (("traced", a.traced), ("enabled", a.enabled)):
        if seed is not None:
            out[key] = tiling(cell, seed, a.seconds, key == "traced")
            print(json.dumps(out[key]), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
