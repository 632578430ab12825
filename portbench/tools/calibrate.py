"""The readings the limits of a cell's ``correct`` are set from: for each
seed, one run's set-up and window as the benchmark makes them, then the
numbers the reference compares for the program and, on the first
``--control`` seeds, for the control (the reference computed in
bfloat16 in the program's place), on the first ``--witness`` seeds for the
witness (the same in float64: what rounding alone moves), on the same
frames. One JSON line a seed. With ``--start`` only the start is read:
each seed's world built as a run builds it, and ``start_bodies_differ``
for the program, the control and the witness.

    python3 portbench/tools/calibrate.py --workload pile10k.drop \
        --seconds 40 --control 3 --seeds 11 12 13 14
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[0:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--witness", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--start", action="store_true")
    a = ap.parse_args()
    import torch
    from harness import runner, spec
    cell = spec.load_cell(a.workload)
    device = torch.device(a.device)
    if a.start:
        return starts(cell, a.seeds, device)
    for i, seed in enumerate(a.seeds):
        t0 = time.perf_counter()
        run = runner.measure(cell, seed, a.seconds, False, device, t0)
        out = dict(workload=cell.name, seed=seed,
                   frames=len(run.win.frame_s), failed=run.win.failed,
                   checked=[s.frame for s in run.win.checked()],
                   program=runner.check(cell, run, device))
        if i < a.control:
            out["control"] = runner.check(cell, run, device, control=True)
        if i < a.witness:
            out["witness"] = runner.check(cell, run, device, witness=True)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        del run


def starts(cell, seeds, device):
    import numpy as np
    import edyn_tpu_torch as et
    from harness import scene, traffic
    from reference import semantics
    g = cell.config["settings"]["gravity"]
    for seed in seeds:
        t0 = time.perf_counter()
        desc = scene.describe(cell.config["scene"], seed)
        world, _ = traffic.make_world(et, cell.config, desc, device, None)
        built = {f: getattr(world.state, f).cpu().numpy()
                 for f in semantics.START_FIELDS}
        del world
        out = dict(workload=cell.name, seed=seed, **{
            mode: semantics.start(desc, g, built, dtype)
            for mode, dtype in (("program", np.float64),
                                ("control", "bfloat16"),
                                ("witness", np.float32))})
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
