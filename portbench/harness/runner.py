"""One run of one cell: set-up, the measured window, the reference's check,
and the result's line.

Set-up (``setup_s``, from the process's start to the window's first
frame): import, the scene, the program's world (its CUDA libraries are
built at their first launch, inside the checkout, and cached there), the
configuration's seating steps, the mix's prelude and warm-up. Then the
window. Then, with the program's world freed and the device's memory peak
read, the reference checks the start and the sampled frames.
"""
from __future__ import annotations

import gc
import subprocess
import time
from types import SimpleNamespace

import numpy as np

from . import spec, trace as trace_mod, window as window_mod


def card(device) -> dict:
    import torch
    if device.type != "cuda":
        return dict(platform="cpu", kind="cpu")
    return dict(platform="gpu", kind=torch.cuda.get_device_name(device))


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def launch_counts() -> dict:
    """The program's own count of its kernel launches, by kernel, summed
    over devices and shards."""
    from edyn_tpu_torch.utils import cuda_lib
    out: dict = {}
    for per in cuda_lib.DEVICE_LAUNCHES.values():
        for k, v in per.items():
            out[k] = out.get(k, 0) + v
    return out


def measure(cell: spec.Cell, seed: int, seconds: float, trace: bool,
            device, t0: float) -> SimpleNamespace:
    """Set-up and the window of one run; the program's world freed after
    it, its built state and the window's samples kept for the check."""
    import torch
    import edyn_tpu_torch as et
    from edyn_tpu_torch.utils import cuda_lib
    from . import traffic

    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else \
        (lambda: None)
    if cell.config.get("dtype", "float32") != "float32":
        raise ValueError("only float32 configurations are run")
    spans: dict = {}
    drive = traffic.Drive(et, cell.config, cell.traffic, seed, device, spans,
                          sync, cell.bench_dir)
    drive.warm(seed)
    gc.collect()
    sync()
    meta = drive.world.meta
    marks: dict = {}

    def on_start():
        marks["setup_s"] = time.perf_counter() - t0

    sampled = int(cell.traffic.get("check", {}).get("sampled_frames", 2))
    tracer = None
    if trace:
        tracer = trace_mod.Tracer(
            float(cell.traffic.get("trace", {}).get("from", 0.0)),
            on_start=cuda_lib.reset_device_launches)
    win = window_mod.run(drive, seconds, seed, sampled, on_start, tracer,
                         launch_counts)
    out = SimpleNamespace(
        win=win, launches=launch_counts(),
        peak=torch.cuda.max_memory_allocated(device) if cuda else 0,
        built=drive.built, desc=drive.desc, spans=spans,
        setup_s=marks["setup_s"], n_bodies=drive.world.state.capacity,
        es=drive.world.state.pos.element_size(),
        with_sr=bool(meta.has_spin_roll))
    drive = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    out.trace = None
    if trace:
        t0 = time.perf_counter()
        out.trace = trace_mod.reduce(tracer.results, win.launch_marks)
        out.trace.update(stop_s=tracer.stop_s,
                         reduce_s=time.perf_counter() - t0)
        tracer.results = None
    return out


def check(cell: spec.Cell, run: SimpleNamespace, device,
          control: bool = False, witness: bool = False) -> dict:
    """The numbers the references compare (see ``reference.compare`` and
    ``reference.semantics``): the program's; with ``control`` the bfloat16
    references'; with ``witness`` the float32 semantics' and the float64
    step-by-step reference's."""
    import torch
    from reference import compare, semantics
    st = cell.config["settings"]
    frames = [(semantic_input(s.pre), s.host,
               tuple(v.cpu().numpy() for v in s.post_vel))
              for s in run.win.checked()]
    dtype = "bfloat16" if control else np.float32 if witness else np.float64
    numbers = semantics.check(run.desc, st["gravity"], st["fixed_dt"],
                              frames, dtype)
    numbers.update(semantics.start(
        run.desc, st["gravity"], {f: getattr(run.built, f).cpu().numpy()
                                  for f in semantics.START_FIELDS}, dtype))
    del frames
    ref_world = compare.reference_world(cell.config, run.desc, device,
                                        cell.bench_dir)
    numbers.update(compare.check_frames(run.win.samples, ref_world,
                                        control, witness))
    if control or witness:
        numbers["start_leaves_differ"] = compare.leaves_differ(
            compare.cast(ref_world.state,
                         torch.bfloat16 if control else torch.float64),
            ref_world.state)
    else:
        numbers["start_leaves_differ"] = compare.leaves_differ(
            run.built, ref_world.state)
    return numbers


def semantic_input(pre) -> dict:
    """The fields of a state before a step that ``reference.semantics``
    reads, on the host."""
    return {f: getattr(pre, f).cpu().numpy()
            for f in window_mod.SEMANTIC_FIELDS}


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, t0: float, log=print) -> dict:
    """The result's line (a dict) of one run; ``log`` takes the lines that
    go to standard error."""
    import torch
    from reference import compare
    device = torch.device(device)
    cuda = device.type == "cuda"
    run = measure(cell, seed, seconds, trace, device, t0)
    t_check = time.perf_counter()
    numbers = check(cell, run, device)
    correct, verdict = compare.verdict(numbers, cell.limits)
    check_s = time.perf_counter() - t_check
    win = run.win
    checked = [s.frame for s in win.checked()]
    win.samples = win.first = run.built = None

    ctx = SimpleNamespace(
        frames=len(win.frame_s), frame_s=np.asarray(win.frame_s),
        window_s=win.seconds, setup_s=run.setup_s, spans=run.spans,
        trace=run.trace, launches=run.launches, n_bodies=run.n_bodies,
        live_rows=win.live_rows,
        es=run.es, with_sr=run.with_sr, config=cell.config)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = spec.metric_reader(m["name"], cell.bench_dir)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    dev = card(device)
    dev.update(count=cell.chips if cuda else 1,
               memory_peak_bytes=int(run.peak))
    result = dict(correct=bool(correct), attempted=len(win.frame_s),
                  failed=win.failed, metrics=metrics, device=dev)
    if run.trace is not None:
        dev.update(busy_s=run.trace["busy_s"],
                   window_s=run.trace["window_s"])
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["check"] = verdict

    log(f"portbench {cell.name} seed {seed}: {len(win.frame_s)} frames in "
        f"{win.seconds:.3f} s, failed {win.failed}, set-up "
        f"{run.setup_s:.3f} s (" + ", ".join(
            f"{k} {v:.3f} s" for k, v in run.spans.items())
        + f"), frames checked {checked} (free bodies "
        f"{numbers['free_bodies']}, free groups {numbers['free_groups']}, "
        f"quiet bodies {numbers['quiet_bodies']}), check {check_s:.1f} s")
    if win.overflow_frames:
        log(f"frames that dropped work (frame, overflow): "
            f"{win.overflow_frames}")
    if cuda:
        log(f"card: {power_limit()}")
    if run.trace is not None:
        traced = {k: len(v) for k, v in run.trace["kernels"].items()}
        log(f"traced the last {run.trace['window_s']:.3f} s "
            f"({run.trace['frames']} frames): profiler stop "
            f"{run.trace['stop_s']:.1f} s, reduction "
            f"{run.trace['reduce_s']:.1f} s")
        log("solver kernels, traced launches against the program's count: "
            + ", ".join(f"{k} {traced[k]}/{run.launches.get(k, 0)}"
                        for k in traced))
    for name, c in verdict.items():
        ok = c["value"] is not None and c["value"] <= c["limit"]
        log(f"check {name} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if ok else 'FAILED'}")
    return result


def forbidden_modules(names=("jax", "jaxlib", "flax", "edyn_tpu")) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``names``, compared whole."""
    import sys
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in names)
