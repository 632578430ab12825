"""Presentation interpolation & discontinuity smoothing (counterpart of
``edyn_tpu/simulation/presentation.py``).

Reference: sys/update_presentation.cpp:19-55 (present_position/orientation =
transform extrapolated to ``time - presentation_delay``, plus accumulated
network discontinuity offsets decayed per step) and the adaptive presentation
delay of the async stepper (stepper_async.cpp:240-277). The transforms are
extrapolated on the world's device and copied to the host once per call.
"""
from __future__ import annotations

import numpy as np

from ..math import quat

DISCONTINUITY_DECAY = 0.9  # per fixed step


TIME_DIFF_SAMPLES = 20  # sliding window for delay adaptation


class Presentation:
    """Host-side presentation state for rendering: smoothed transforms at an
    arbitrary render time between fixed steps.

    The presentation delay ADAPTS to observed step jitter (reference:
    stepper_async::calculate_presentation_delay, stepper_async.cpp:240-277):
    it tracks the average + mean-absolute-deviation of (render time -
    simulation time), rounds up to a fixed_dt boundary, and slews toward
    that target — fast when the delay must grow (avoid extrapolation, which
    jitters), slower when shrinking. Pass ``adaptive=False`` for a fixed
    delay."""

    def __init__(self, world, presentation_delay: float = 0.0,
                 adaptive: bool = True):
        self.world = world
        self.presentation_delay = presentation_delay
        self.adaptive = adaptive
        N = world.state.capacity
        self.disc_pos = np.zeros((N, 3), np.float32)
        self.disc_angle = np.zeros((N, 3), np.float32)  # axis*angle offsets
        self._diffs = np.zeros((TIME_DIFF_SAMPLES,), np.float64)
        self._n_diffs = 0
        self._adjusting = False
        self._last_observe = None

    def add_discontinuity(self, indices, dpos, dangle=None):
        """Accumulate offsets after a state snap (reference:
        networking/comp/discontinuity.hpp)."""
        self.disc_pos[indices] += dpos
        if dangle is not None:
            self.disc_angle[indices] += dangle

    def on_step(self):
        self.disc_pos *= DISCONTINUITY_DECAY
        self.disc_angle *= DISCONTINUITY_DECAY

    def observe(self, current_time: float):
        """Feed one render-frame observation (current_time on the same clock
        as ``state.sim_time``) into the delay adaptation
        (calculate_presentation_delay, stepper_async.cpp:240-277)."""
        if not self.adaptive:
            return
        elapsed = (0.0 if self._last_observe is None
                   else max(current_time - self._last_observe, 0.0))
        self._last_observe = current_time
        dt = self.world.settings.fixed_dt
        diff = min(current_time - float(self.world.state.sim_time), 1.0)
        self._diffs = np.roll(self._diffs, -1)
        self._diffs[-1] = diff
        self._n_diffs = min(self._n_diffs + 1, TIME_DIFF_SAMPLES)
        window = self._diffs[-self._n_diffs:]
        avg = float(window.mean())
        dev = float(np.abs(window - avg).mean())
        target = np.ceil((avg + dev) / dt) * dt
        err = target - self.presentation_delay
        if not self._adjusting:
            self._adjusting = abs(err) > dt
        if self._adjusting:
            rate = 5.0 if err > 0 else 2.0
            self.presentation_delay += err * min(rate * elapsed, 1.0)
            # snap onto the boundary once close: the target flickers between
            # adjacent fixed_dt boundaries under jitter, and re-adjustment
            # only triggers on a >1*dt error, so the snap is stable
            if abs(target - self.presentation_delay) < 0.25 * dt:
                self.presentation_delay = target
                self._adjusting = False

    def transforms(self, render_time: float):
        """(positions [N,3], orientations [N,4]) at render_time: the fixed-step
        state extrapolated by velocity over the sub-step remainder, plus
        decaying discontinuity offsets."""
        st = self.world.state
        dt_frac = float(render_time - float(st.sim_time)
                        - self.presentation_delay)
        dt_frac = float(np.clip(dt_frac, -1.0 / 30.0, 1.0 / 30.0))
        # host read: both columns, once per call
        pos = (st.pos + st.linvel * dt_frac).cpu().numpy() + self.disc_pos
        orn = quat.integrate(st.orn, st.angvel, dt_frac).cpu().numpy()
        return pos, orn
