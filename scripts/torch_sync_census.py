#!/usr/bin/env python3
"""The step's host syncs on one GPU: the program's own count
(``utils.profile``'s ``host_syncs``, site by site) against what
``torch.cuda.set_sync_debug_mode("warn")`` reports, step by step and file
by file.

    python3 scripts/torch_sync_census.py [--bodies 10000] [--settle 150]
                                         [--steps 20] [--seed 7]

Lands ``mixed_pile(--bodies)`` for ``--settle`` steps, then runs
``--steps`` steps of ``physics_step`` with tracing on and every warning
kept; then 5 steps under the sweep broadphase, and 5 of the world put to
sleep with its 100 highest bodies woken. Needs a CUDA device; prints one
JSON line at the end.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import sys
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# the modules whose ``host`` calls count the step's syncs
MODULES = ("simulation.stepper", "collision.broadphase", "collision.manifold",
           "collision.narrowphase", "collision.kernels.box_box",
           "dynamics.islands", "dynamics.position", "dynamics.solver",
           "dynamics.scatter", "constraints.joints")


def counted_by_file() -> collections.Counter:
    """Installs a wrapper around each module's ``host`` that also counts
    the calls' syncs by the caller's file; returns that count."""
    import importlib
    from edyn_tpu_torch.utils import profile
    by_file = collections.Counter()

    def host(site, value=None, n=1):
        if getattr(profile._local, "rec", None) is not None:
            by_file[os.path.relpath(sys._getframe(1).f_code.co_filename,
                                    ROOT)] += n
        return profile.host(site, value, n)
    for name in MODULES:
        importlib.import_module(f"edyn_tpu_torch.{name}").host = host
    return by_file


def census(world, steps: int, by_file) -> dict:
    """``steps`` steps of ``world``: the warnings and the counter, a step
    each, and both by file."""
    import torch
    from edyn_tpu_torch.simulation.stepper import physics_step
    from edyn_tpu_torch.utils import profile
    st, warned, counted = world.state, [], []
    warned_files = collections.Counter()
    by_file.clear()
    sites = collections.Counter()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for _ in range(steps):
            profile.reset()
            with warnings.catch_warnings(record=True) as got:
                warnings.simplefilter("always")
                with profile.enable():
                    st = physics_step(st, world.settings, world.meta)
            syncs = [w for w in got if "synchroniz" in str(w.message)]
            warned.append(len(syncs))
            warned_files.update(os.path.relpath(w.filename, ROOT)
                                for w in syncs)
            c = profile.recorded()["counters"]
            counted.append(c.get("host_syncs", 0))
            sites.update({k[len("host_syncs."):]: v for k, v in c.items()
                          if k.startswith("host_syncs.")})
    finally:
        torch.cuda.set_sync_debug_mode(0)
    world.state = st
    files = sorted(set(warned_files) | set(by_file))
    return dict(warned=warned, counted=counted,
                files={f: [warned_files[f], by_file[f]] for f in files},
                sites=dict(sorted(sites.items())))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bodies", type=int, default=10_000)
    ap.add_argument("--settle", type=int, default=150)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=7)
    a = ap.parse_args()

    import subprocess
    import torch
    if not torch.cuda.is_available():
        print("torch_sync_census: no CUDA device", file=sys.stderr)
        return 1
    import edyn_tpu_torch as et
    from edyn_tpu_torch.utils.scenes import mixed_pile

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    by_file = counted_by_file()
    builder, ids = mixed_pile(n_bodies=a.bodies, seed=a.seed)
    world = et.make_world(builder, et.Settings())
    world.step(a.settle)
    out = dict(gpu=gpu, torch=torch.__version__, bodies=a.bodies,
               settle=a.settle)
    out["landed"] = census(world, a.steps, by_file)
    world.meta = dataclasses.replace(world.meta, broadphase_mode="sweep")
    out["sweep"] = census(world, 5, by_file)
    world.meta = dataclasses.replace(world.meta, broadphase_mode="auto")
    world.put_to_sleep()
    pos = world.state.pos[:, 1].cpu()
    world.wake_set(set(sorted(ids, key=lambda i: -float(pos[i]))[:100]))
    out["asleep"] = census(world, 5, by_file)
    for k in ("landed", "sweep", "asleep"):
        r = out[k]
        print(f"{k}: warnings a step {r['warned']}, counted {r['counted']}")
        for f, (w, c) in r["files"].items():
            print(f"  {f}: warned {w}, counted {c}"
                  + ("" if w == c else "  <- differs"))
        print("  sites: " + ", ".join(f"{s} {v}"
                                      for s, v in r["sites"].items()))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
