#!/usr/bin/env python3
"""Where the time of one step of the PyTorch port goes, on one GPU.

    python3 scripts/torch_step_profile.py [--bodies 10000] [--settle 120]
                                          [--steps 10]
    python3 scripts/torch_step_profile.py --scene ragdolls [--ragdolls 768]
    python3 scripts/torch_step_profile.py --scene terrain [--bodies 10000]
    python3 scripts/torch_step_profile.py --scene asleep [--bodies 10000]

Steps ``mixed_pile(--bodies)`` (or, with ``--scene ragdolls``,
``chip_smoke.ragdoll_pile(--ragdolls)`` with ``chip_smoke.ragdoll_settings``,
whose joint phases are timed on their own; or, with ``--scene terrain``,
``rich_scene(--bodies)``, the trimesh terrain with hinge chains) for
``--settle`` steps (or, with ``--scene asleep``, runs ``bench.py``'s
protocol on ``mixed_pile(--bodies)`` through ``chip_smoke.asleep_path``
and takes the mostly-asleep world it ends with, ``--settle`` ignored),
then times ``--steps`` steps twice:

1. with each phase function of the stepper wrapped in a timer that
   synchronises the device before and after it, giving milliseconds per
   step for every phase (the rest of the step is the glue between them),
   and inside the narrowphase each bucket class on its own row;
2. under ``torch.profiler`` without the timers, giving the device's busy
   share of the wall time and the kernels that take the most device time.

Needs a CUDA device; prints one JSON line at the end.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _timed(table, name, fn):
    import torch

    def wrapper(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        table[name] += time.perf_counter() - t0
        return out
    return wrapper


def phase_times(world, steps: int) -> dict:
    """ms per step of each phase, with synchronising timers installed on the
    stepper's phase functions for the duration of the run; the
    narrowphase's bucket classes are rows of their own ("narrowphase:
    <class>"), parts of the narrowphase row."""
    import torch
    from edyn_tpu_torch.collision import narrowphase as nph
    from edyn_tpu_torch.constraints import joints
    from edyn_tpu_torch.dynamics import islands, scatter, solver
    from edyn_tpu_torch.dynamics import solver_kernels as sk
    from edyn_tpu_torch.simulation import stepper

    table = collections.defaultdict(float)
    patches = [
        (stepper, "compute_aabbs", "aabbs"),
        (stepper, "find_pairs", "broadphase"),
        (stepper, "find_pairs_sweep", "broadphase"),
        (stepper, "update_slots", "manifold slots"),
        (stepper, "update_contacts_sharded", "narrowphase"),
        (islands, "update_sleep", "islands and sleep"),
        (solver, "build_contact_rows", "contact rows"),
        (sk, "pack_rows_t", "pack row table"),
        (solver, "solve_restitution_sharded", "restitution (K3a, K3b)"),
        (solver, "refresh_contact_rhs", "rhs refresh"),
        (solver, "warm_start_sharded", "warm start"),
        (solver, "solve_contacts_sharded", "velocity iterations (K1)"),
        (solver, "solve_contacts_planned", "velocity iterations (K1)"),
        (scatter, "for_step", "scatter plan"),
        (stepper, "solve_positions_sharded", "position iterations (K2)"),
        (joints, "build_joint_rows", "joint rows"),
        (joints, "warm_start_joints", "joint warm start"),
        (joints, "solve_joints_once", "joint velocity solve"),
        (joints, "solve_joint_positions", "joint positions"),
    ]
    names = {getattr(nph, k): k[2:] for k in dir(nph) if k.startswith("B_")}
    buckets = collections.defaultdict(float)
    run_bucket = nph._run_bucket

    def timed_bucket(bucket, *a, **k):
        return _timed(buckets, f"narrowphase: {names[bucket]}",
                      run_bucket)(bucket, *a, **k)
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    saved += [(nph, "_run_bucket", run_bucket),
              (nph, "collide_support_unified", nph.collide_support_unified)]
    for mod, attr, name in patches:
        setattr(mod, attr, _timed(table, name, getattr(mod, attr)))
    nph._run_bucket = timed_bucket
    nph.collide_support_unified = _timed(
        buckets, "narrowphase: UNIFIED (K4)", nph.collide_support_unified)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        world.step(steps)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    out = {k: 1e3 * v / steps for k, v in table.items()}
    out["glue"] = 1e3 * total / steps - sum(out.values())
    out["step"] = 1e3 * total / steps
    out.update({k: 1e3 * v / steps for k, v in buckets.items()})
    return out


def profile(world, steps: int) -> dict:
    """Device busy share and the top kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        world.step(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                return getattr(e, attr)
        return 0.0

    # device events only (kernels, copies, fills): an aten op's entry
    # repeats the device time of the kernels it launched
    kernels = [(e.key, dev_us(e), e.count) for e in prof.key_averages()
               if e.device_type != DeviceType.CPU and dev_us(e) > 0]
    busy = sum(t for _, t, _ in kernels) * 1e-6
    kernels.sort(key=lambda x: -x[1])
    return dict(wall_ms_per_step=1e3 * wall / steps,
                device_ms_per_step=1e3 * busy / steps,
                device_busy_share=busy / wall,
                kernel_launches_per_step=sum(c for _, _, c in kernels) / steps,
                top=[dict(name=k[:80], ms_per_step=t * 1e-3 / steps,
                          calls_per_step=c / steps)
                     for k, t, c in kernels[:15]])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bodies", type=int, default=10_000)
    ap.add_argument("--settle", type=int, default=120)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--scene", choices=("pile", "ragdolls", "terrain",
                                        "asleep"),
                    default="pile")
    ap.add_argument("--ragdolls", type=int, default=768)
    a = ap.parse_args()

    import subprocess
    import torch
    if not torch.cuda.is_available():
        print("torch_step_profile: no CUDA device", file=sys.stderr)
        return 1
    import edyn_tpu_torch as et
    from edyn_tpu_torch.utils.scenes import mixed_pile, rich_scene

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    if a.scene == "asleep":
        from chip_smoke import asleep_path
        _, _, _, world, _ = asleep_path(a.bodies, torch.device("cuda"))
        a.settle = None
    else:
        if a.scene == "ragdolls":
            from chip_smoke import ragdoll_pile, ragdoll_settings
            builder, _ = ragdoll_pile(et, a.ragdolls)
            settings = ragdoll_settings()
        elif a.scene == "terrain":
            builder, _ = rich_scene(n_bodies=a.bodies)
            settings = et.Settings()
        else:
            builder, _ = mixed_pile(n_bodies=a.bodies, seed=0)
            settings = et.Settings()
        world = et.make_world(builder, settings)
        world.step_n(a.settle)
    phases = phase_times(world, a.steps)
    for k, v in sorted(phases.items(), key=lambda kv: -kv[1]):
        print(f"{k:28s} {v:9.3f} ms/step")
    prof = profile(world, a.steps)
    print(f"wall {prof['wall_ms_per_step']:.3f} ms/step, device busy "
          f"{prof['device_ms_per_step']:.3f} ms/step "
          f"({100 * prof['device_busy_share']:.1f}%), "
          f"{prof['kernel_launches_per_step']:.0f} kernels/step")
    for k in prof["top"]:
        print(f"  {k['ms_per_step']:8.3f} ms/step {k['calls_per_step']:7.1f} "
              f"calls/step  {k['name']}")
    print(json.dumps({"gpu": gpu, "scene": a.scene,
                      "bodies": world.state.capacity,
                      "joints": int(world.state.joints.valid.sum()),
                      "settle": a.settle,
                      "steps": a.steps, "phases_ms_per_step": phases,
                      "profile": prof}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
