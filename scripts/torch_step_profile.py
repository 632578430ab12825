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
then times ``--steps`` steps three times:

1. with the step's spans recorded (``edyn_tpu_torch.utils.profile``),
   giving each phase's device milliseconds per step, the narrowphase's
   bucket classes and the solve's loops as spans of their own (the step's
   own time outside its phases is ``glue``);
2. under ``torch.profiler``, giving the device's idle time per step by
   the span the host was in at each gap;
3. under ``torch.profiler`` again, giving the device's busy share of the
   wall time and the kernels that take the most device time.

Needs a CUDA device; prints one JSON line at the end.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def phase_times(world, steps: int) -> dict:
    """ms per step of each span of the step (``utils.profile``: device
    extents, ``step`` the whole step, ``glue`` its own time outside its
    phases), from ``steps`` steps with tracing on; then, from ``steps``
    more under ``torch.profiler``, the device's idle time per step put
    down to the innermost span the stepping thread was in at each gap's
    middle (``idle: <span>``; ``idle: (outside the step)`` between
    steps)."""
    import torch
    from edyn_tpu_torch.utils import profile as spans
    from torch.profiler import ProfilerActivity

    spans.reset()
    torch.cuda.synchronize()
    with spans.enable():
        world.step(steps)
    rec = spans.recorded()
    out = {k: v["device_ms"] / steps for k, v in rec["spans"].items()}
    out["glue"] = rec["spans"]["step"]["self_ms"] / steps
    spans.reset()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        world.step(steps)
        torch.cuda.synchronize()
    spans.reset()
    for k, ns in idle_by_span(prof.profiler.kineto_results.events(),
                              set(rec["spans"])).items():
        out[f"idle: {k}"] = ns * 1e-6 / steps
    return out


def idle_by_span(events, names) -> dict:
    """Nanoseconds with nothing on the device, from the first span's start
    to the last one's end, by the innermost span (a ``record_function`` of
    a name in ``names``, on the thread of the ``step`` spans) running at
    each gap's middle."""
    dev, marks = [], []
    for e in events:
        if "CUDA" in str(e.device_type()):
            if e.name() not in names:
                dev.append((e.start_ns(), e.end_ns()))
        elif e.name() in names:
            marks.append((e.start_ns(), e.end_ns(), e.name(),
                          e.start_thread_id()))
    tid = next(m[3] for m in marks if m[2] == "step")
    marks = sorted((m for m in marks if m[3] == tid),
                   key=lambda m: (m[0], -m[1]))
    w0 = min(m[0] for m in marks)
    w1 = max(m[1] for m in marks)
    dev.sort()
    gaps, reach = [], w0
    for lo, hi in dev:
        if lo > reach and reach < w1:
            gaps.append((reach, min(lo, w1)))
        reach = max(reach, hi)
    if reach < w1:
        gaps.append((reach, w1))
    # the gaps in the order of their middles, the spans in start order,
    # the spans open at a middle on a stack (they nest)
    out: dict = {}
    stack, j = [], 0
    for lo, hi in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (lo + hi) // 2
        while j < len(marks) and marks[j][0] <= mid:
            while stack and stack[-1][1] < marks[j][0]:
                stack.pop()
            stack.append(marks[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        inner = stack[-1][2] if stack else "(outside the step)"
        out[inner] = out.get(inner, 0) + hi - lo
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def profile(world, steps: int) -> dict:
    """Device busy share and the top kernels by device time (the step's
    spans, recorded under the profiler, are the device's annotations, not
    its work: left out)."""
    import torch
    from edyn_tpu_torch.utils import profile as spans
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    spans.reset()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        world.step(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    names = set(spans.recorded()["spans"])
    spans.reset()

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                return getattr(e, attr)
        return 0.0

    # device events only (kernels, copies, fills): an aten op's entry
    # repeats the device time of the kernels it launched
    kernels = [(e.key, dev_us(e), e.count) for e in prof.key_averages()
               if e.device_type != DeviceType.CPU and dev_us(e) > 0
               and e.key not in names]
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
