"""The measured window: frames back to back for ``seconds`` seconds on the
host clock, each timed from its start to the end of its read-back.

A frame failed when its step dropped work (any of the state's overflow
counters nonzero: pairs, narrowphase candidates, contact rows, sweep
window alarms, manifold slots; or the world grew a capacity, which the
program does after a step that dropped work, clearing the counters) or
its read-back is not finite.

In a traced run the window's end is traced (``trace.Tracer``): each
traced frame is annotated (``trace.FRAME_MARK``), and after its timed
part the live contact rows of its step are counted on the device
(``roofline.live_rows``, annotated ``trace.ROWS_MARK``, read after the
window): the solver kernels' roofline reckons with them; and the
program's launch counts after each traced frame are kept (``counts``), by
which the trace's launches are given their frames (``trace.reduce``).

For the correctness check, the window keeps the last frame and
``sampled_frames`` others drawn from the seed, uniformly over however many
frames the window holds (reservoir sampling): for each, the state before
the step (the program's states are immutable, so this is a reference, not
a copy), the velocities after it and the frame's read-back. It also keeps
the window's first frame for the independent check
(``reference.semantics``), with only the pre-step fields that check reads.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

from types import SimpleNamespace

import numpy as np

from . import roofline, scene, trace as trace_mod


@dataclasses.dataclass
class Sample:
    frame: int
    pre: object        # the program's state before the frame's step
    meta: object       # the program's SceneMeta at the step
    post_vel: tuple    # (linvel, angvel) after the step, on the device
    host: np.ndarray   # the frame's read-back, [N,7]


@dataclasses.dataclass
class Window:
    frame_s: list
    seconds: float
    failed: int
    samples: list
    overflow_frames: list
    live_rows: list      # traced runs: live contact rows of each traced frame
    first: Sample = None  # the window's first frame (pose, velocities, asleep)
    launch_marks: list = None  # traced runs: ``counts()`` after each frame

    def checked(self) -> list:
        """Every frame kept for a check, the first one first."""
        return [self.first] + [s for s in self.samples
                               if s.frame != self.first.frame]


# the fields of the state before a step that ``reference.semantics`` reads
SEMANTIC_FIELDS = ("pos", "orn", "linvel", "angvel", "asleep",
                   "sleep_timer")


def sampling_rng(seed: int) -> np.random.Generator:
    return scene.rng_for(int(seed) * 7919 + 17)


def run(drive, seconds: float, seed: int, sampled_frames: int,
        on_start=lambda: None, tracer=None, counts=None) -> Window:
    """The window; with ``tracer`` (a ``trace.Tracer``) its part after the
    share ``tracer.start_at`` is traced, and ``counts()``, where given (the
    program's launch counts by kernel), is read after each traced frame."""
    import torch
    rng = sampling_rng(seed)
    reservoir: list = []
    last = first = None
    frame_s, failed, overflow_frames, rows, marks = [], 0, [], [], []

    def mark(name):
        return (torch.profiler.record_function(name) if traced
                else contextlib.nullcontext())

    on_start()
    t_start = time.perf_counter()
    deadline = t_start + seconds
    traced = False
    k = 0
    while True:
        if tracer is not None and not traced and \
                time.perf_counter() >= t_start + tracer.start_at * seconds:
            tracer.start()
            traced = True
        t0 = time.perf_counter()
        with mark(trace_mod.FRAME_MARK):
            pre, post, host, grew = drive.frame(k)
            ovf = post.overflow.cpu().numpy()
        bad = grew or bool(ovf.any()) or not bool(np.isfinite(host).all())
        t1 = time.perf_counter()
        frame_s.append(t1 - t0)
        if traced:
            if counts is not None:
                marks.append(counts())
            with mark(trace_mod.ROWS_MARK):
                rows.append(roofline.live_rows(post))
        if bad:
            failed += 1
            if len(overflow_frames) < 20:
                overflow_frames.append([k, ovf.tolist(), bool(grew)])
        s = Sample(k, pre, drive.world.meta, (post.linvel, post.angvel),
                   host)
        if k == 0:
            first = Sample(k, SimpleNamespace(**{
                f: getattr(pre, f) for f in SEMANTIC_FIELDS}),
                s.meta, s.post_vel, host)
        if k < sampled_frames:
            reservoir.append(s)
        else:
            j = int(rng.integers(0, k + 1))
            if j < sampled_frames:
                reservoir[j] = s
        last = s
        k += 1
        if t1 >= deadline:
            break
    seconds_run = t1 - t_start
    if traced:
        tracer.stop()
    samples = [s for s in reservoir if s.frame != last.frame] + [last]
    live = torch.stack(rows).cpu().tolist() if rows else []
    return Window(frame_s, seconds_run, failed, samples, overflow_frames,
                  live, first, marks if counts is not None else None)
