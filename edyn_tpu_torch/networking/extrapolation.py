"""Client-side extrapolation (counterpart of
``edyn_tpu/networking/extrapolation.py``).

Reference: the extrapolation worker thread
(include/edyn/networking/extrapolation/extrapolation_worker.hpp:27-104,
src impl :291-542) owns a private registry and replays a snapshot forward
from packet time to the present, applying input history, under a time limit.

Here the "worker with its own registry" is the same step run over a scratch
copy of the world's state (every step and setter builds new tensors, so the
live state is untouched). Inputs are replayed by writing the input
history's component records between steps. The replay calls
``physics_step`` directly, as the JAX package does: it does not grow the
world's capacities (``World._maybe_grow``), so run it on a world whose
widths already hold its pairs.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..core.state import KIND_STATIC
from ..replication.snapshot import RegistrySnapshot, apply_snapshot
from ..simulation.stepper import physics_step

MAX_EXTRAPOLATION_STEPS = 20  # reference: execution time limit analogue


def _freeze_outside_islands(world, state, snap, emap):
    """Freeze every dynamic body outside the snapshot entities' islands:
    they become static environment for the replay (reference: the
    extrapolation worker imports and steps only the snapshot's islands,
    extrapolation_worker.cpp:291; here the restriction is mask-based)."""
    if emap is None:
        local = np.asarray(snap.entities, np.int64)
    else:
        local = np.array(
            [emap.to_local(int(e)) if emap.has_remote(int(e)) else -1
             for e in snap.entities], np.int64)
        local = local[local >= 0]
    if len(local) == 0:
        return state
    # exact transitive membership (robust to the post-reset label
    # fragmentation window of compute_islands)
    from ..dynamics.islands import exact_island_mask
    members = exact_island_mask(world.state, local)
    keep = members | ~world.state.is_dynamic
    k3 = keep[:, None]
    return dataclasses.replace(
        state,
        kind=torch.where(keep, state.kind, KIND_STATIC),
        mass_inv=torch.where(keep, state.mass_inv, 0.0),
        inertia_inv=torch.where(keep[:, None, None], state.inertia_inv, 0.0),
        linvel=torch.where(k3, state.linvel, 0.0),
        angvel=torch.where(k3, state.angvel, 0.0))


def extrapolate(world, snap: RegistrySnapshot, emap,
                snapshot_local_time: float, now: float, input_history=None,
                max_steps: int = MAX_EXTRAPOLATION_STEPS,
                islands_only: bool = True,
                time_limit: Optional[float] = None,
                action_history=None, action_handler=None):
    """Returns (state, steps_done, timed_out): a scratch state advanced from
    the snapshot's time to ~now. The caller merges the result into the live
    world (process_extrapolation_result analogue). With ``islands_only`` the
    replay only simulates the snapshot's islands; everything else is frozen
    as static environment.

    ``time_limit`` bounds the replay by WALL CLOCK like the reference's
    execution time limit (extrapolation_worker.cpp:475-480), checked after
    every completed device step; on expiry the replay stops where it is and
    ``timed_out`` is True."""
    dt = world.settings.fixed_dt
    num_steps = max(0, int(math.floor((now - snapshot_local_time) / dt)))
    timed_out = num_steps > max_steps
    num_steps = min(num_steps, max_steps)

    state = apply_snapshot(world.state, snap, emap)
    if islands_only:
        state = _freeze_outside_islands(world, state, snap, emap)
    t = snapshot_local_time
    t_start = time.perf_counter()
    steps_done = 0
    for _ in range(num_steps):
        if input_history is not None:
            state = input_history.apply(state, t, dt)
        if action_history is not None and action_handler is not None:
            # replay discrete actions at their recorded times (reference:
            # the extrapolation worker re-executes action_history)
            state = action_history.apply(state, t, dt, action_handler)
        state = physics_step(state, world.settings, world.meta)
        t += dt
        steps_done += 1
        if time_limit is not None:
            if state.pos.is_cuda:
                torch.cuda.synchronize(state.pos.device)
            if time.perf_counter() - t_start > time_limit:
                timed_out = timed_out or steps_done < num_steps
                break
    return state, steps_done, timed_out


class ExtrapolationWorker:
    """Dedicated extrapolation thread (reference:
    extrapolation_worker.hpp:27-104: its own registry + message-driven
    replay off the main thread).

    Requests are LATEST-WINS (a newer server snapshot obsoletes a pending
    replay, matching the reference's republishing behavior); results are
    polled by the client on its next update. The replay runs under the
    wall-clock ``time_limit``.

    The thread launches its kernels on PyTorch's current stream, which for
    a thread that sets none is the device's default stream, the one the
    main thread uses: its steps and the main thread's reads are ordered.
    An exception ends the thread, as in the JAX package; it is kept in
    ``error``. ``replays``, ``timeouts`` and ``steps`` count the finished
    replays, those that timed out, and their steps."""

    def __init__(self, world, time_limit: float = 0.1,
                 max_steps: int = MAX_EXTRAPOLATION_STEPS):
        self.world = world
        self.time_limit = time_limit
        self.max_steps = max_steps
        self.error: Optional[Exception] = None
        self.replays = 0
        self.timeouts = 0
        self.steps = 0
        self._cv = threading.Condition()
        self._request = None
        self._result = None
        self._running = True
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="edyn-extrapolation")
        self._thread.start()

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def submit(self, snap, emap, snapshot_local_time: float, now: float,
               input_history=None, action_history=None, action_handler=None):
        with self._cv:
            self._request = (snap, emap, snapshot_local_time, now,
                             input_history, action_history, action_handler)
            self._cv.notify()

    def poll(self):
        """(snap, state, steps, timed_out) of the most recently finished
        replay, or None. Clears the slot."""
        with self._cv:
            r, self._result = self._result, None
        return r

    def stop(self):
        with self._cv:
            self._running = False
            self._cv.notify()
        self._thread.join(timeout=5.0)

    def _run(self):
        try:
            self._serve()
        except Exception as exc:  # kept for the owner; the thread ends
            self.error = exc

    def _serve(self):
        while True:
            with self._cv:
                while self._running and self._request is None:
                    self._cv.wait()
                if not self._running:
                    return
                req, self._request = self._request, None
            snap, emap, t_snap, now, hist, a_hist, a_fn = req
            state, steps, timed_out = extrapolate(
                self.world, snap, emap, t_snap, now, hist,
                max_steps=self.max_steps, time_limit=self.time_limit,
                action_history=a_hist, action_handler=a_fn)
            with self._cv:
                self._result = (snap, state, steps, timed_out)
                self.replays += 1
                self.timeouts += bool(timed_out)
                self.steps += steps
