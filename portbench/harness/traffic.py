"""The one generator of every traffic mix: a configuration's world, built
through the program's public API, driven frame by frame as a mix's data
file (``traffic/<mix>.json``) says.

Every mix is a closed loop: each frame starts when the last one has
ended. A mix's keys:

- ``prelude``: set-up operations in order, each {"op": ...}:
  ``{"op": "step", "n": k}`` steps the world k times;
  ``{"op": "sleep_and_relaunch", "count": c, "height": h, "spacing": s,
  "settle_steps": k}`` is ``bench.py``'s mostly-asleep protocol: every
  body put to sleep, the c highest moved h metres above the pile on a grid
  of pitch s and woken, 2 steps, k steps, all asleep again, the c woken,
  1 step;
- ``episode_frames``: 0 for one trajectory from the end of the prelude;
  n > 0 to restore the world to that point every n frames (a device
  snapshot: the program's state is immutable, so the restore is a
  reference);
- ``warm``: {"pile_bodies": n, "pile_steps": k, "frames": f}: before the
  window, a small world of the same configuration, about n bodies of its
  scene (the scene's ``small``), is stepped k times (so every kernel of a
  landed world has run once), then the cell's world is stepped f frames
  and put back where it was;
- ``check``: {"sampled_frames": k}: how many frames of the window, drawn
  from the seed, the reference checks besides the last one;
- ``trace``: {"from": f}: a ``--trace 1`` run starts the profiler once
  the share f of the window has passed and traces the rest (the profiler
  itself takes some seconds to start).

A frame is one ``World.step()``, the calls the mix makes between steps
(none yet), and a read-back of every body's position and orientation to
the host.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from . import scene, spec

OPS = ("step", "sleep_and_relaunch")


def settings_of(pkg, config: dict):
    return pkg.Settings(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in config["settings"].items()})


def make_world(pkg, config: dict, desc: dict, device, spans: dict | None,
               sync=lambda: None, bench_dir=spec.BENCH_DIR):
    """``pkg``'s world of ``desc`` under ``config``: the scene's builder
    (found under ``bench_dir``), then ``make_world`` (timed into
    ``spans["make_world"]``), then the configuration's capacities and
    broadphase. Returns (world, ids)."""
    w = config["world"]
    t0 = time.perf_counter()
    b, ids = scene.build(pkg, desc, bench_dir)
    if spans is not None:
        spans["builder"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    world = pkg.make_world(b, settings_of(pkg, config),
                           max_pairs=w["max_pairs"], device=device)
    world.meta = dataclasses.replace(
        world.meta, max_rows=w["max_rows"], bucket_cap=w["bucket_cap"],
        broadphase_mode=w["broadphase_mode"], sweep_window=w["sweep_window"])
    sync()
    if spans is not None:
        spans["make_world"] = time.perf_counter() - t0
    return world, ids


def seat(world, config: dict):
    """The configuration's seating steps: ``seat_dense_steps`` steps under
    the dense broadphase, which seat the carried admission boxes, before
    its own broadphase takes over."""
    n = config["world"].get("seat_dense_steps", 0)
    if n:
        mode = world.meta.broadphase_mode
        world.meta = dataclasses.replace(world.meta, broadphase_mode="dense")
        world.step(n)
        world.meta = dataclasses.replace(world.meta, broadphase_mode=mode)


def sleep_and_relaunch(world, ids, count: int, height: float,
                       spacing: float, settle_steps: int):
    """``bench.py``'s mostly-asleep set-up (the same order of calls)."""
    import torch
    world.put_to_sleep()
    st = world.state
    pos = st.pos.cpu().numpy()
    ids_arr = np.asarray(ids, np.int64)
    act = ids_arr[np.argsort(-pos[ids_arr, 1], kind="stable")[:count]]
    top = float(pos[st.is_dynamic.cpu().numpy()][:, 1].max())
    g = int(np.ceil(np.sqrt(count)))
    newpos = pos.copy()
    for k, e in enumerate(act):
        newpos[e] = ((k % g) * spacing - g * spacing / 2,
                     top + height + (k // g) * spacing,
                     (k // g) * spacing - g * spacing / 2)
    world.state = dataclasses.replace(
        st, pos=torch.as_tensor(newpos, dtype=st.pos.dtype,
                                device=st.pos.device))
    world.wake_set(set(act.tolist()))
    world.step(2)
    world.step(settle_steps)
    world.put_to_sleep()
    world.wake_set(set(act.tolist()))
    world.step(1)


def run_prelude(world, ids, traffic: dict):
    for op in traffic.get("prelude", []):
        kind = op["op"]
        if kind == "step":
            world.step(op["n"])
        elif kind == "sleep_and_relaunch":
            sleep_and_relaunch(world, ids, op["count"], op["height"],
                               op["spacing"], op["settle_steps"])
        else:
            raise ValueError(f"unknown prelude op {kind!r} (have {OPS})")


def readback(state) -> np.ndarray:
    """Every body's position and orientation on the host, [N,7]: what a
    renderer or a dataset writer takes each frame. Ends the frame on the
    host clock (the copy waits for the step)."""
    import torch
    return torch.cat([state.pos, state.orn], 1).cpu().numpy()


class Drive:
    """The program's world of one cell and seed, through its traffic."""

    def __init__(self, pkg, config: dict, traffic: dict, seed: int, device,
                 spans: dict, sync=lambda: None, bench_dir=spec.BENCH_DIR):
        self.pkg, self.config, self.traffic = pkg, config, traffic
        self.device, self.sync, self.bench_dir = device, sync, bench_dir
        self.desc = scene.describe(config["scene"], seed, bench_dir)
        self.world, self.ids = make_world(pkg, config, self.desc, device,
                                          spans, sync, bench_dir)
        # the built world, before any step: the reference's start check
        self.built = self.world.state
        self.spans = spans
        t0 = time.perf_counter()
        seat(self.world, config)
        sync()
        spans["seat"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_prelude(self.world, self.ids, traffic)
        sync()
        spans["prelude"] = time.perf_counter() - t0
        self.start = self.world.state
        self.start_meta = self.world.meta
        self.episode = int(traffic.get("episode_frames", 0))
        sync()

    def warm(self, seed: int):
        """The mix's warm-up (see the module's docstring)."""
        t0 = time.perf_counter()
        warm = self.traffic.get("warm", {})
        n = warm.get("pile_bodies", 0)
        if n:
            # the configuration's broadphase at the small world's own
            # capacities (16 pairs a body, the port's default)
            cfg = dict(self.config,
                       scene=scene.small(self.config["scene"], n,
                                         self.bench_dir),
                       world=dict(self.config["world"], max_pairs=32 * n,
                                  max_rows=32 * n, bucket_cap=16 * n))
            small, _ = make_world(
                self.pkg, cfg, scene.describe(cfg["scene"], seed,
                                              self.bench_dir),
                self.device, None, bench_dir=self.bench_dir)
            seat(small, cfg)
            small.step(warm.get("pile_steps", 0))
            readback(small.state)
            del small
        for k in range(warm.get("frames", 0)):
            self.frame(k)
        self.restore()
        self.sync()
        self.spans["warm"] = time.perf_counter() - t0

    def restore(self):
        self.world.state = self.start
        self.world.meta = self.start_meta

    def frame(self, k: int):
        """Frame k of the window: (state before the step, state after it,
        host read-back, whether the step grew the world's capacities). At
        the start of an episode the world is first put back to the end of
        the prelude."""
        if self.episode and k and k % self.episode == 0:
            self.restore()
        pre, meta = self.world.state, self.world.meta
        self.world.step()
        post = self.world.state
        # a step that dropped work grows the world and clears its counters
        return pre, post, readback(post), self.world.meta is not meta
