"""Asynchronous simulation: a background thread owns the stepping loop
(counterpart of ``edyn_tpu/simulation/async_worker.py``).

Reference: execution_mode::asynchronous: stepper_async (main-thread proxy,
src/edyn/simulation/stepper_async.cpp:25-390) + simulation_worker (dedicated
thread with its own registry and PID-paced loop,
src/edyn/simulation/simulation_worker.cpp:62-497), exchanging registry-op
diffs via the message dispatcher.

Here the worker thread runs the same step on the device (the device is the
"worker registry"); the main thread reads the latest published state (the
step and the setters build new tensors, so publishing is a reference swap:
no diffing or entity remapping) and enqueues mutations (impulses, spawns,
setting changes) that the worker applies between steps, where the
reference applies imported registry ops.

The worker calls ``physics_step`` directly, as the JAX package does: it
does not grow the world's capacities (``World._maybe_grow``), so start it
on a world whose widths already hold its pairs, and read
``world.overflow_counters()`` after. Its kernels go to PyTorch's current
stream, for a thread that sets none the device's default stream, which the
main thread uses too: the worker's steps and the main thread's reads are
ordered. An exception ends the thread, as in the JAX package; it is kept
in ``error``.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

import numpy as np

from ..simulation.stepper import physics_step


class AsyncSimulation:
    def __init__(self, world, pre_step_callback: Optional[Callable] = None,
                 post_step_callback: Optional[Callable] = None):
        self.world = world
        self._published = world.state
        self._ops: "queue.Queue[Callable]" = queue.Queue()
        self._lock = threading.Lock()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._paused = False
        self.pre_step_callback = pre_step_callback
        self.post_step_callback = post_step_callback
        self.steps_done = 0
        self._ray_requests: list = []
        self._ray_lock = threading.Lock()
        self.raycast_batches = 0  # batched device raycasts issued
        self.error: Optional[Exception] = None

    # -- lifecycle (reference: stepper_async ctor / simulation_worker::start)
    def start(self):
        self._running = True
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="edyn-sim-worker")
        self._thread.start()
        return self

    def stop(self):
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def set_paused(self, paused: bool):
        self._paused = paused

    # -- main-thread API ------------------------------------------------
    @property
    def state(self):
        """Latest published state (a snapshot: later steps build new
        tensors)."""
        with self._lock:
            return self._published

    def enqueue(self, op: Callable):
        """op(world) runs on the worker thread between steps (the reference's
        registry-op import point, simulation_worker.cpp:170-287)."""
        self._ops.put(op)

    def apply_impulse(self, i, impulse, rel=(0.0, 0.0, 0.0)):
        self.enqueue(lambda w: w.apply_impulse(i, impulse, rel))

    def set_settings(self, **kw):
        """reference: refresh_settings re-broadcast to the worker."""
        self.enqueue(lambda w: w.set_settings(**kw))

    def raycast_async(self, p0, p1, callback: Callable):
        """Async raycast: queued requests are COALESCED into one batched
        device raycast between steps, then callbacks run on the worker
        thread (reference: stepper_async::raycast -> msg::raycast_request ->
        the worker's raycast_service, which also batches all queued rays
        through shared broad/narrow phases, raycast_service.cpp:118). The
        JAX package pads a batch to a power of two to bound its compiled
        programs; the port runs eagerly and casts the rays as they are."""
        with self._ray_lock:
            self._ray_requests.append((p0, p1, callback))

    def _flush_raycasts(self):
        with self._ray_lock:
            reqs, self._ray_requests = self._ray_requests, []
        if not reqs:
            return
        p0 = np.asarray([r[0] for r in reqs], dtype=np.float64)
        p1 = np.asarray([r[1] for r in reqs], dtype=np.float64)
        self.raycast_batches += 1
        out = self.world.raycast(p0, p1)
        if len(reqs) == 1:
            out = {k: np.asarray(v)[None] for k, v in out.items()}
        for k, (_, _, cb) in enumerate(reqs):
            cb({"fraction": float(out["fraction"][k]),
                "entity": int(out["entity"][k]),
                "normal": out["normal"][k],
                "feature": int(out["feature"][k]),
                "sub_index": int(out["sub_index"][k]),
                "child_index": int(out["child_index"][k])})

    def query_aabb_async(self, lo, hi, callback: Callable, **kw):
        """Async AABB region query (reference: collision/query_aabb.hpp
        async API)."""
        self.enqueue(lambda w: callback(w.query_aabb(lo, hi, **kw)))

    # -- worker loop (reference: simulation_worker::run, PID-paced) -----
    def _run(self):
        try:
            self._loop()
        except Exception as exc:  # kept for the owner; the thread ends
            self.error = exc

    def _loop(self):
        dt = self.world.settings.fixed_dt
        next_time = time.perf_counter()
        while self._running:
            # apply queued ops
            while True:
                try:
                    op = self._ops.get_nowait()
                except queue.Empty:
                    break
                op(self.world)
                dt = self.world.settings.fixed_dt
            self._flush_raycasts()

            now = time.perf_counter()
            if self._paused or now < next_time:
                time.sleep(min(max(next_time - now, 0.0), dt))
                continue
            if self.pre_step_callback:
                self.pre_step_callback(self.world)
            self.world.state = physics_step(self.world.state,
                                            self.world.settings,
                                            self.world.meta)
            if self.post_step_callback:
                self.post_step_callback(self.world)
            self.steps_done += 1
            with self._lock:
                self._published = self.world.state
            next_time += dt
            # fell behind: resync instead of spiraling (reference:
            # simulation_worker.cpp:384-397 step cap)
            if now - next_time > 10 * dt:
                next_time = now
