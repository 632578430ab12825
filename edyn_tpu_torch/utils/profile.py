"""Observability: the step's spans and counters, and the world counters
(counterpart of ``edyn_tpu/utils/profile.py``; reference: the EDYN_PROFILE_*
macro timers and the profile_counters ctx struct,
util/profile_util.hpp:10-27, context/profile.hpp:8-27).

One system, inside the step, that never synchronises the device:

- ``span(name, **attrs)`` marks a phase of ``physics_step`` (the names are
  the stepper's: ``step`` at the root, then ``aabbs``, ``broadphase``,
  ``manifold_slots``, ``narrowphase`` and its buckets, ``islands``,
  ``rows``, ``solve`` and its loops). A recorded span keeps its name, its
  parent, the step's number (shared by all of one step's spans), ``attrs``
  (small counts, such as a bucket's ``pairs``) and three clocks: its host
  edges from ``time.time_ns``, the clock ``torch.profiler`` stamps its
  events with; a ``torch.cuda.Event`` at each edge on the step's stream,
  its extent on the device (on the CPU the host extent stands for it); and,
  while a profiler records, a ``torch.profiler.record_function`` of its
  name, so the span sits in the trace beside the kernels it launched.
- ``count(name, n)`` adds to a counter; ``host(site, value)`` counts one
  host read of a device value (``bool()``, ``int()``, ``.item()``,
  ``.cpu()``, ``.tolist()``, ``torch.nonzero``, a boolean-mask index, a
  host tensor copied to the device: each waits for the stream) as
  ``host_syncs`` and ``host_syncs.<site>``.

On and off: a step is recorded while ``enable()`` is in force or while a
torch profiler records; ``physics_step`` decides once, at its start
(``step``), so a step is recorded whole or not at all. Outside a recorded
step a span costs one test of a thread-local and a counter call nothing
more. Each thread keeps its own span stack (an ``AsyncSimulation`` and a
client's extrapolation worker step from their own threads); one lock
guards the totals.

A finished step's events are folded into per-name totals once
``Event.query()`` says they are done, so memory stays bounded over a long
run. ``recorded()`` waits for the device once, at read time: the steps
recorded, each span name's summed host, device and self milliseconds (self:
its extent minus its children's), its count and attrs, the counters, and
the last step's spans. ``reset()`` clears it all.

The world counters (``counters``) are read from a state on the host,
outside any step.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time

import numpy as np
import torch

_lock = threading.Lock()
_local = threading.local()      # .rec: the thread's recorded step, if any
_enabled = 0                    # depth of ``enable()``
_numbers = 0                    # steps numbered so far
_pending: collections.deque = collections.deque()   # steps not yet folded
_events: dict = {}              # device -> spare timing events
_totals: dict = {}
_counters: collections.Counter = collections.Counter()
_steps = 0
_last = None                    # the last folded step
# a span: [name, parent, host t0, host t1, event 0, event 1, attrs]
NAME, PARENT, T0, T1, E0, E1, ATTRS = range(7)


@contextlib.contextmanager
def enable():
    """Record every step started inside (any thread's)."""
    global _enabled
    with _lock:
        _enabled += 1
    try:
        yield
    finally:
        with _lock:
            _enabled -= 1


def tracing() -> bool:
    """Whether a step started now is recorded."""
    return _enabled > 0 or torch.autograd._profiler_enabled()


class _Step:
    """One recorded step of one thread."""

    def __init__(self, device):
        global _numbers
        with _lock:
            _numbers += 1
            self.number = _numbers
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.current_stream(device) if self.cuda \
            else None
        self.device = self.stream.device if self.cuda else device
        self.profiler = torch.autograd._profiler_enabled()
        self.spans, self.stack = [], []
        self.counts = collections.Counter()

    def event(self):
        if not self.cuda:
            return None
        try:
            ev = _events[self.device].pop()
        except (KeyError, IndexError):
            ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        return ev


class _Span:
    __slots__ = ("rec", "name", "attrs", "rf")

    def __init__(self, rec, name, attrs):
        self.rec, self.name, self.attrs, self.rf = rec, name, attrs, None

    def __enter__(self):
        rec = self.rec
        if rec.profiler:
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        parent = rec.stack[-1] if rec.stack else -1
        rec.stack.append(len(rec.spans))
        rec.spans.append([self.name, parent, time.time_ns(), 0,
                          rec.event(), None, self.attrs])
        return self

    def __exit__(self, *exc):
        rec = self.rec
        s = rec.spans[rec.stack.pop()]
        s[E1] = rec.event()
        s[T1] = time.time_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class _StepSpan(_Span):
    """The root span ``step``: the thread's recording starts and ends with
    it."""

    def __init__(self, device):
        super().__init__(_Step(device), "step", {})

    def __enter__(self):
        _local.rec = self.rec
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        _local.rec = None
        with _lock:
            _pending.append(self.rec)
            _fold(wait=False)
        return False


_OFF = contextlib.nullcontext()


def step(device):
    """The root span of one ``physics_step`` on ``device``: the step is
    recorded when ``tracing()`` holds at its start (a step inside a
    recorded step is part of it)."""
    if getattr(_local, "rec", None) is not None or not tracing():
        return _OFF
    return _StepSpan(torch.device(device))


def span(name: str, **attrs):
    """A phase of the recorded step running on this thread (nothing
    outside one)."""
    rec = getattr(_local, "rec", None)
    if rec is None:
        return _OFF
    return _Span(rec, name, attrs)


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` of the recorded step."""
    rec = getattr(_local, "rec", None)
    if rec is not None:
        rec.counts[name] += n


def host(site: str, value=None, n: int = 1):
    """``value``, returned as it is, after ``n`` host syncs at ``site``:
    wrap each expression of the step that waits for the device (or call it
    with no value beside a statement that does)."""
    rec = getattr(_local, "rec", None)
    if rec is not None:
        rec.counts["host_syncs"] += n
        rec.counts["host_syncs." + site] += n
    return value


def _fold(wait: bool):
    """Fold the pending steps whose device events are done (all of them
    with ``wait``) into the totals; under ``_lock``."""
    global _steps, _last
    while _pending:
        rec = _pending[0]
        if rec.cuda:
            end = rec.spans[0][E1]
            if wait:
                end.synchronize()
            elif not end.query():
                return
        _pending.popleft()
        spans = rec.spans
        if rec.cuda:
            ref, used = spans[0][E0], []
            for s in spans:
                used += s[E0:E1 + 1]
                s[E0] = round(ref.elapsed_time(s[E0]) * 1e6)
                s[E1] = round(ref.elapsed_time(s[E1]) * 1e6)
            _events.setdefault(rec.device, []).extend(used)
        else:
            t = spans[0][T0]
            for s in spans:
                s[E0], s[E1] = s[T0] - t, s[T1] - t
        child = [0] * len(spans)
        for s in spans:
            if s[PARENT] >= 0:
                child[s[PARENT]] += s[E1] - s[E0]
        for i, s in enumerate(spans):
            tot = _totals.get(s[NAME])
            if tot is None:
                tot = _totals[s[NAME]] = dict(count=0, host_ns=0,
                                              device_ns=0, self_ns=0,
                                              attrs=collections.Counter())
            dev = s[E1] - s[E0]
            tot["count"] += 1
            tot["host_ns"] += s[T1] - s[T0]
            tot["device_ns"] += dev
            tot["self_ns"] += dev - child[i]
            tot["attrs"].update(s[ATTRS])
        _counters.update(rec.counts)
        _steps += 1
        _last = rec


def recorded() -> dict:
    """What the recorded steps left, after one wait for the device:
    ``steps``; ``spans``, by name: ``count``, ``host_ms``, ``device_ms``,
    ``self_ms`` (sums over the steps) and ``attrs`` (summed); ``counters``;
    ``last``, the last step's spans in the order they started, each with
    its parent's index (-1 at the root), its host edges in ns on the
    profiler's clock and its device edges in ns from the step's start."""
    with _lock:
        _fold(wait=True)
        return dict(
            steps=_steps,
            spans={name: dict(count=t["count"], host_ms=t["host_ns"] * 1e-6,
                              device_ms=t["device_ns"] * 1e-6,
                              self_ms=t["self_ns"] * 1e-6,
                              attrs=dict(t["attrs"]))
                   for name, t in _totals.items()},
            counters=dict(_counters),
            last=[] if _last is None else [
                dict(name=s[NAME], parent=s[PARENT], step=_last.number,
                     host_t0_ns=s[T0], host_t1_ns=s[T1],
                     device_t0_ns=s[E0], device_t1_ns=s[E1],
                     attrs=dict(s[ATTRS])) for s in _last.spans])


def reset():
    """Forget every recorded step."""
    global _steps, _last
    with _lock:
        _pending.clear()
        _totals.clear()
        _counters.clear()
        _steps = 0
        _last = None


@dataclasses.dataclass
class ProfileCounters:
    """reference: context/profile.hpp profile_counters."""
    num_bodies: int = 0
    num_awake: int = 0
    num_manifolds: int = 0
    num_contact_points: int = 0
    num_constraints: int = 0
    num_islands: int = 0
    # capacity-overflow counters from the last step (0 = nothing truncated)
    dropped_broadphase_pairs: int = 0
    dropped_narrowphase_candidates: int = 0
    dropped_contact_rows: int = 0
    broadphase_window_alarms: int = 0
    dropped_manifold_slots: int = 0


def counters(state) -> ProfileCounters:
    host = lambda t: t.cpu().numpy()
    valid = host(state.valid)
    dyn = host(state.is_dynamic)
    asleep = host(state.asleep)
    labels = host(state.island_id)[dyn & valid]
    ovf = host(state.overflow)
    return ProfileCounters(
        num_bodies=int(valid.sum()),
        num_awake=int((dyn & ~asleep).sum()),
        num_manifolds=int(host(state.contacts.valid).sum()),
        num_contact_points=int(host(state.contacts.point_valid).sum()),
        num_constraints=int(host(state.joints.valid).sum()),
        num_islands=len(np.unique(labels)) if len(labels) else 0,
        dropped_broadphase_pairs=int(ovf[0]),
        dropped_narrowphase_candidates=int(ovf[1]),
        dropped_contact_rows=int(ovf[2]),
        broadphase_window_alarms=int(ovf[3]),
        dropped_manifold_slots=int(ovf[4]) if ovf.shape[0] > 4 else 0,
    )
