#!/usr/bin/env python3
"""Steps/s of the port's main path on two checkouts, in one process, on one
GPU.

    python3 scripts/torch_step_ab.py --other DIR [--bodies 10000]
                                     [--steps 120] [--pairs 10]
                                     [--block 10] [--device cuda]

``DIR`` is another checkout of this repo (for example the parent commit,
unpacked with ``git archive`` into a directory ``.gitignore`` lists). Its
``edyn_tpu_torch`` is imported beside this checkout's under another module
name, so both run in one process on one card, each building its kernels
into its own checkout. Each package builds ``mixed_pile(--bodies)`` at the
Settings defaults and steps it ``--steps`` times from the drop through
``World.step_n``, as ``chip_smoke.py`` phase 3 does: steps/s over all
steps and over the last 20, ``--pairs`` pairs of drops, which side runs
first alternating. Then the last two worlds, landed, step ``--block``
steps at a time, ``--pairs`` pairs of blocks in the same alternation:
ms/step of each block. For each, the medians, the other checkout's
interquartile spread and the pairs this checkout won. Every drop also
hashes each leaf of its end state, so the two checkouts' steps can be
seen to be bit-equal or not.

Prints one JSON line at the end.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(root: str, name: str):
    """``root``'s edyn_tpu_torch imported as module ``name``."""
    init = os.path.join(root, "edyn_tpu_torch", "__init__.py")
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[os.path.dirname(init)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def leaves(x):
    import torch
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for k in sorted(x):
            yield from leaves(x[k])
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from leaves(getattr(x, f.name))


def sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def drop(pkg, bodies: int, steps: int, dev):
    """``pkg``'s pile stepped ``steps`` times from the drop: (world,
    record)."""
    scenes = importlib.import_module(pkg.__name__ + ".utils.scenes")
    world = pkg.make_world(scenes.mixed_pile(n_bodies=bodies, seed=0)[0],
                           pkg.Settings(), device=dev)
    sync(dev)
    first = max(1, steps - 20)
    t0 = time.perf_counter()
    world.step_n(first)
    sync(dev)
    t1 = time.perf_counter()
    world.step_n(steps - first)
    sync(dev)
    t2 = time.perf_counter()
    h = hashlib.sha256()
    for t in leaves(world.state):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return world, dict(steps_per_s=steps / (t2 - t0),
                       last_steps_per_s=(steps - first) / (t2 - t1),
                       state_hash=h.hexdigest()[:16])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, help="the other checkout")
    ap.add_argument("--bodies", type=int, default=10_000)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--block", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    import torch
    dev = torch.device(a.device)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip() if dev.type == "cuda" \
        else "cpu"
    print(f"gpu: {gpu}", flush=True)
    pkgs = {"other": load(os.path.abspath(a.other), "edyn_tpu_torch_other"),
            "this": load(HERE, "edyn_tpu_torch_this")}
    for name, pkg in pkgs.items():
        drop(pkg, a.bodies, 2, dev)   # kernel builds and first uses
    drops = {name: [] for name in pkgs}
    landed = {name: [] for name in pkgs}
    worlds = {}

    def turns(i):
        return ("other", "this") if i % 2 == 0 else ("this", "other")
    for i in range(a.pairs):
        for name in turns(i):
            worlds[name], rec = drop(pkgs[name], a.bodies, a.steps, dev)
            drops[name].append(rec)
            print(f"drop {name}: {rec}", flush=True)
    for i in range(a.pairs):
        for name in turns(i):
            sync(dev)
            t0 = time.perf_counter()
            worlds[name].step_n(a.block)
            sync(dev)
            landed[name].append(1e3 * (time.perf_counter() - t0) / a.block)
    for name in pkgs:
        print(f"landed {name} ms/step: {landed[name]}", flush=True)

    def summary(other, this, higher_wins: bool) -> dict:
        q = statistics.quantiles(other, n=4)
        won = sum((t > o) if higher_wins else (t < o)
                  for o, t in zip(other, this))
        return dict(median_other=statistics.median(other),
                    median_this=statistics.median(this),
                    spread_other=q[2] - q[0], this_won=won, pairs=len(this))
    hashes = {r["state_hash"] for v in drops.values() for r in v}
    print(json.dumps(dict(
        gpu=gpu, bodies=a.bodies, steps=a.steps, block=a.block,
        drops=drops, landed_ms_per_step=landed,
        drop_steps_per_s=summary(
            [r["steps_per_s"] for r in drops["other"]],
            [r["steps_per_s"] for r in drops["this"]], True),
        landed=summary(landed["other"], landed["this"], False),
        bit_equal=len(hashes) == 1)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
