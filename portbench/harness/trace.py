"""The device trace of a ``--trace 1`` run, reduced in memory.

``torch.profiler`` (CUPTI) records the end of the window (``Tracer``;
the window below is that traced part): the device's kernels,
copies and sets, and the host's operators and CUDA runtime calls. Nothing
is written to disk. ``reduce`` turns the events into what the per-layer
metrics and the result's ``breakdown`` read:

- ``busy_s``: the union of the device's operations inside the window;
- ``window_s``: the window's length, from the annotation around it;
- ``device_events``: kernels, copies and sets inside the window;
- ``device_ops``: seconds by operation name, most first;
- ``idle_gaps``: seconds of the window with nothing on the device, by the
  innermost host operation running at each gap's middle (the main
  thread's operators and the CUDA runtime's calls; gaps under
  ``SHORT_GAP_NS`` together as one entry);
- ``kernels``: for each kernel named in ``KERNELS``, its launches as
  (frame, nanoseconds) in the order they ran. With ``marks`` (the
  program's launch counts after each traced frame, as ``window.run``
  keeps them) the frame is the one whose launches the program counted it
  among: the n-th launch of a kernel belongs to the first frame after
  which the program had counted more than n. That reads no clock: the
  profiler puts the device's events and the host's annotations on one
  time line, and the two can disagree by more than the launch's distance
  to a frame's edge. Without ``marks``, the frame whose annotation
  (``FRAME_MARK``) holds the launch's start.

The benchmark's own device work in the window (the live-row counts of
``window.run``, annotated ``ROWS_MARK``) is left out of every number.
"""
from __future__ import annotations

import re

import numpy as np

DEVICE_ACTIVITIES = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_ACTIVITIES = {"cpu_op", "cuda_runtime", "cuda_driver"}
WINDOW_MARK = "portbench.window"
FRAME_MARK = "portbench.frame"
ROWS_MARK = "portbench.rows"
SHORT_GAP_NS = 10_000
NAME_CHARS = 120
# the solver kernels the per-layer metrics reckon, by the program's name
# of their launch count
KERNELS = {"solve_iteration_fused": "vel_fused_kernel",
           "restitution_iteration_fused": "rest_fused_kernel",
           "ngs_iteration_fused": "ngs_fused_kernel",
           "relvel_fused": "relvel_fused_kernel",
           "segment_sum": "segment_sum_kernel"}
_KERNEL_RE = {k: re.compile(rf"\b{v}\b") for k, v in KERNELS.items()}


class Tracer:
    """``torch.profiler`` over the end of a window, started by
    ``window.run`` once the window's share ``start_at`` has passed, and
    stopped after its last frame; ``results`` holds the profiler's
    events, ``stop_s`` the seconds the stop took."""

    def __init__(self, start_at: float, on_start=lambda: None):
        self.start_at, self.on_start = start_at, on_start
        self.prof = self.mark = self.results = None
        self.stop_s = 0.0

    def start(self):
        import torch
        self.on_start()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(
            activities=acts, record_shapes=False, with_stack=False,
            profile_memory=False)
        self.prof.__enter__()
        self.mark = torch.profiler.record_function(WINDOW_MARK)
        self.mark.__enter__()

    def stop(self):
        import time
        self.mark.__exit__(None, None, None)
        t0 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.results = self.prof.profiler.kineto_results
        self.stop_s = time.perf_counter() - t0
        self.prof = None


def _short(name: str) -> str:
    """A device or host operation's name without the namespaces and
    qualifiers common to all, cut to ``NAME_CHARS``."""
    for noise in ("void ", "at::native::binary_internal::", "at::native::",
                  "(anonymous namespace)::", "std::"):
        name = name.replace(noise, "")
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def activity(e) -> str:
    """An event's kind: the profiler's activity type where this version
    of PyTorch gives it; else from the device it ran on and its name
    (device events are kernels, copies and sets; host events named
    ``cu...`` are CUDA runtime or driver calls)."""
    get = getattr(e, "activity_type", None)
    if get is not None:
        return get()
    name = e.name()
    note = getattr(e, "is_user_annotation", None)
    if name.startswith("portbench.") or (note is not None and note()):
        return ("gpu_user_annotation" if "CUDA" in str(e.device_type())
                else "user_annotation")
    if "CUDA" in str(e.device_type()):
        return "kernel"
    if name.startswith("cu"):
        return "cuda_runtime"
    return "cpu_op"


def _intervals(evs) -> tuple:
    lo = np.array(sorted(e.start_ns() for e in evs), np.int64)
    hi = np.array(sorted(e.end_ns() for e in evs), np.int64)
    return lo, hi


def reduce(results, marks=None) -> dict:
    """The reduction of a traced window (``Tracer.results``); ``marks``,
    where given, the program's launch counts by kernel after each traced
    frame, counted from the trace's start."""
    events = results.events()
    w0 = w1 = None
    dev, host, frames, rows = [], [], [], []
    main_tid = None
    for e in events:
        act = activity(e)
        if act in DEVICE_ACTIVITIES:
            dev.append(e)
        elif act in HOST_ACTIVITIES:
            host.append(e)
        elif act == "user_annotation":
            name = e.name()
            if name == FRAME_MARK:
                frames.append(e)
            elif name == ROWS_MARK:
                rows.append(e)
            elif name == WINDOW_MARK:
                w0, w1 = e.start_ns(), e.end_ns()
                main_tid = e.start_thread_id()
    if w0 is None:
        raise RuntimeError(f"no {WINDOW_MARK!r} annotation in the trace")
    # the benchmark's own launches: runtime calls inside its annotations
    r_lo, r_hi = _intervals(rows)
    own = set()
    for e in host:
        if len(r_lo) and e.name().startswith("cu"):
            t = e.start_ns()
            i = np.searchsorted(r_lo, t, side="right") - 1
            if i >= 0 and t <= r_hi[i]:
                own.add(e.correlation_id())
    own.discard(0)
    dev = [e for e in dev if e.correlation_id() not in own
           and e.linked_correlation_id() not in own]

    starts = np.fromiter((e.start_ns() for e in dev), np.int64, len(dev))
    ends = np.fromiter((e.end_ns() for e in dev), np.int64, len(dev))
    inside = (ends > w0) & (starts < w1)
    idx = np.nonzero(inside)[0]
    s, t = np.clip(starts[idx], w0, w1), np.clip(ends[idx], w0, w1)
    order = np.argsort(s, kind="stable")
    s, t = s[order], t[order]
    # union of the device's intervals, and the gaps between them
    reach = np.maximum.accumulate(t) if len(t) else t
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > reach[:-1]
    m_start = s[new]
    m_end = np.append(reach[np.nonzero(new)[0][1:] - 1], reach[-1:]) \
        if len(s) else s
    busy = int((m_end - m_start).sum())
    gap_lo = np.concatenate([[w0], m_end])
    gap_hi = np.concatenate([m_start, [w1]])
    keep = gap_hi > gap_lo
    gap_lo, gap_hi = gap_lo[keep], gap_hi[keep]

    f_lo, f_hi = _intervals(frames)
    ops: dict = {}
    kernels = {k: [] for k in KERNELS}
    for i in idx:
        e = dev[i]
        name = e.name()
        dur = int(ends[i] - starts[i])
        ops[name] = ops.get(name, 0) + dur
        if "fused_kernel" in name or "segment_sum_kernel" in name:
            for k, rx in _KERNEL_RE.items():
                if rx.search(name):
                    f = int(np.searchsorted(f_lo, starts[i], "right")) - 1
                    ok = f >= 0 and starts[i] <= f_hi[f]
                    kernels[k].append((f if ok else None, dur,
                                       int(starts[i])))
                    break

    for k, launches in kernels.items():
        launches.sort(key=lambda fs: fs[2])
        if marks is not None:
            counted = np.array([m.get(k, 0) for m in marks], np.int64)
            frame = np.searchsorted(counted, np.arange(len(launches)),
                                    "right")
            launches[:] = [(int(f) if f < len(counted) else None, d, t)
                           for f, (_, d, t) in zip(frame, launches)]
        kernels[k] = [(f, d) for f, d, _ in launches]

    idle = _name_gaps(host, main_tid, gap_lo, gap_hi)
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    return dict(
        busy_s=busy * 1e-9, window_s=(w1 - w0) * 1e-9,
        device_events=int(len(idx)), frames=len(frames),
        device_ops=[[_short(n), v * 1e-9] for n, v in top],
        idle_gaps=[[_short(n), v * 1e-9] for n, v in idle[:10]],
        kernels=kernels)


def _name_gaps(host, tid, lo, hi) -> list:
    """Idle nanoseconds by the innermost host operation of thread ``tid``
    running at each gap's middle, most first."""
    short = hi - lo < SHORT_GAP_NS
    out = {"(gaps under 10 us)": int((hi - lo)[short].sum())}
    lo, hi = lo[~short], hi[~short]
    mids = (lo + hi) // 2
    evs = sorted(((e.start_ns(), e.end_ns(), e.name()) for e in host
                  if e.start_thread_id() == tid
                  or e.name().startswith("cu")), key=lambda x: x[0])
    stack, j = [], 0
    for g in np.argsort(mids, kind="stable"):
        mid = mids[g]
        while j < len(evs) and evs[j][0] <= mid:
            while stack and stack[-1][1] < evs[j][0]:
                stack.pop()
            stack.append(evs[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "(host between operations)"
        out[name] = out.get(name, 0) + int(hi[g] - lo[g])
    return sorted(((n, v) for n, v in out.items() if v),
                  key=lambda kv: -kv[1])
