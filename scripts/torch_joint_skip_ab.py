#!/usr/bin/env python3
"""The joint passes' type skip against the full masked evaluation, on one
GPU, in one process.

    python3 scripts/torch_joint_skip_ab.py [--ragdolls 768] [--settle 120]
                                           [--steps 10]

Builds ``chip_smoke.ragdoll_pile(--ragdolls)`` with
``chip_smoke.ragdoll_settings``, settles it for ``--settle`` steps, then
times ``--steps`` steps four times, in turns full, skip, skip, full: "skip"
with ``SceneMeta.joint_types`` as ``make_world`` derives it (the joint
passes leave out the sections of types no valid joint has), "full" with
every joint type in it (the full masked evaluation; held bit-equal to the
skip by ``tests/test_torch_joints.py``). Each turn gives the per-span
ms/step (``joint_rows``, ``joint_velocity``, ``joint_positions``, ...)
and the device's busy share and kernels per step of
``scripts/torch_step_profile.py``. Needs a CUDA device; prints one JSON
line at the end.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ragdolls", type=int, default=768)
    ap.add_argument("--settle", type=int, default=120)
    ap.add_argument("--steps", type=int, default=10)
    a = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_joint_skip_ab: no CUDA device", file=sys.stderr)
        return 1
    import edyn_tpu_torch as et
    from chip_smoke import ragdoll_pile, ragdoll_settings
    from edyn_tpu_torch.constraints.joints import JointType
    from scripts.torch_step_profile import phase_times, profile

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    world = et.make_world(ragdoll_pile(et, a.ragdolls)[0],
                          ragdoll_settings())
    world.step_n(a.settle)
    types = {"skip": world.meta.joint_types, "full": frozenset(JointType)}
    turns = []
    for mode in ("full", "skip", "skip", "full"):
        world.meta = dataclasses.replace(world.meta, joint_types=types[mode])
        phases = phase_times(world, a.steps)
        prof = profile(world, a.steps)
        prof.pop("top")
        turns.append(dict(mode=mode, phases_ms_per_step=phases, **prof))
        print(f"{mode}: step {phases['step']:.3f} ms (joint rows "
              f"{phases['joint_rows']:.3f}, joint velocity solve "
              f"{phases['joint_velocity']:.3f}, joint positions "
              f"{phases['joint_positions']:.3f}); under the profiler "
              f"{prof['wall_ms_per_step']:.3f} ms/step, device busy "
              f"{prof['device_ms_per_step']:.3f} ms/step, "
              f"{prof['kernel_launches_per_step']:.0f} kernels/step",
              flush=True)
    print(json.dumps({"gpu": gpu, "ragdolls": a.ragdolls,
                      "settle": a.settle, "steps": a.steps,
                      "skip_types": sorted(t.name for t in types["skip"]),
                      "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
