"""World: the user-facing handle around the state and the step (counterpart
of ``edyn_tpu/core/world.py``; reference: include/edyn/edyn.hpp:66-150 and
the fixed-timestep accumulator, stepper_sequential.cpp:45-65)."""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..config import Settings
from ..constraints.joints import JointType, types_present
from ..simulation.stepper import SceneMeta, physics_step
from .builder import WorldBuilder
from .device import resolve_device
from .state import WorldState, grow_contact_table


def _pairs_for(n_bodies: int) -> int:
    # 16 pairs per body covers the settled mixed pile's measured demand
    # (14.2/body) with headroom; grow-on-overflow is the backstop
    return max(256, min(16 * n_bodies, 1 << 19))


def derive_meta(state: WorldState, max_pairs: Optional[int] = None,
                **kw) -> SceneMeta:
    """The static scene facts of a freshly built state (host read)."""
    valid = state.valid.cpu().numpy()
    stypes = state.shape_type.cpu().numpy()
    present = frozenset(int(t) for t in np.unique(stypes[valid]))
    if max_pairs is None:
        max_pairs = _pairs_for(int(valid.sum()))
    max_pairs = min(max_pairs, state.contacts.key.shape[0])
    kw.setdefault("bucket_cap", max(512, max_pairs // 2))
    kw.setdefault("max_rows", max_pairs)
    has_sr = bool((state.spin_friction.cpu().numpy()[valid] > 0).any()
                  or (state.roll_friction.cpu().numpy()[valid] > 0).any()
                  or (state.mix_table.vals.cpu().numpy()[:, 2:4] > 0).any())
    kw.setdefault("has_spin_roll", has_sr)
    kw.setdefault("has_joints", bool(state.joints.valid.any()))
    kw.setdefault("joint_types", types_present(state.joints))
    return SceneMeta(types_present=present, max_pairs=max_pairs, **kw)


class World:
    """Owns the state and drives the step."""

    GROW_FACTOR = 1.3

    def __init__(self, state: WorldState, settings: Settings = Settings(),
                 meta: Optional[SceneMeta] = None):
        self.state = state
        self.settings = settings
        self.meta = meta or derive_meta(state)
        self._accumulator = 0.0
        self._last_time: Optional[float] = None
        # grow-on-overflow: a step that dropped pairs, candidates or rows
        # bumps the capacity before the next step. The JAX package checks
        # after each step_n batch and every 16th step() only, because
        # reading its counters stalls the device; the port's stepper syncs
        # every step anyway. A 10k-body pile that lands needs ~19 pairs a
        # body, more than the 16 of _pairs_for: checked once per batch, it
        # dropped floor contacts for tens of steps and bodies fell through
        # the floor.
        self.auto_grow = True

    @property
    def device(self):
        return self.state.device

    # -- stepping -------------------------------------------------------
    def step(self, n: int = 1):
        """Advance n fixed-dt steps."""
        for _ in range(n):
            self.state = physics_step(self.state, self.settings, self.meta)
            if self.auto_grow:
                self._maybe_grow()
        return self

    def step_n(self, n: int):
        """Advance n fixed-dt steps (the JAX package's single-program batch;
        the port steps from the host either way, so this is ``step``)."""
        return self.step(n)

    def _maybe_grow(self):
        """Any nonzero drop counter of the last step bumps the matching
        capacity by GROW_FACTOR; live state is padded, never rebuilt. Window
        alarms (overflow[3]) do not trigger growth."""
        ovf = self.state.overflow.cpu().numpy()
        if ovf[[0, 1, 2, 4]].max() <= 0:
            return False
        meta = self.meta
        changes = {}
        if ovf[0] > 0 or ovf[4] > 0:
            new_pairs = -(-int(meta.max_pairs * self.GROW_FACTOR) // 128) * 128
            changes["max_pairs"] = new_pairs
            if meta.max_rows is not None:
                changes["max_rows"] = max(meta.max_rows,
                                          min(new_pairs, meta.max_rows * 2))
            if meta.bucket_cap is not None:
                changes["bucket_cap"] = max(meta.bucket_cap, new_pairs // 2)
            st = self.state
            # the carried pair list is the truncated one: recompute it
            self.state = dataclasses.replace(
                st,
                bp_carry_ok=torch.zeros_like(st.bp_carry_ok),
                contacts=grow_contact_table(st.contacts, new_pairs),
                edge_pointed=torch.cat([
                    st.edge_pointed,
                    torch.zeros((new_pairs - meta.max_pairs,),
                                dtype=torch.bool, device=st.device)]))
        if ovf[1] > 0 and meta.bucket_cap is not None:
            changes["bucket_cap"] = -(-int(max(
                changes.get("bucket_cap", meta.bucket_cap),
                meta.bucket_cap * self.GROW_FACTOR)) // 128) * 128
        if ovf[2] > 0 and meta.max_rows is not None:
            changes["max_rows"] = -(-int(max(
                changes.get("max_rows", meta.max_rows),
                meta.max_rows * self.GROW_FACTOR)) // 128) * 128
        if not changes:
            return False
        self.meta = dataclasses.replace(meta, **changes)
        self.state = dataclasses.replace(
            self.state, overflow=torch.zeros_like(self.state.overflow))
        return True

    def update(self, elapsed: Optional[float] = None):
        """Variable-rate update with the fixed-dt accumulator and the
        max-steps cap."""
        now = time.perf_counter()
        if elapsed is None:
            elapsed = 0.0 if self._last_time is None else now - self._last_time
        self._last_time = now
        if self.settings.paused:
            return self
        self._accumulator += elapsed
        num = int(self._accumulator // self.settings.fixed_dt)
        num = min(num, self.settings.max_steps_per_update)
        self._accumulator -= num * self.settings.fixed_dt
        return self.step(num)

    def set_settings(self, **kw):
        self.settings = self.settings.replace(**kw)
        return self

    # -- accessors ------------------------------------------------------
    def position(self, i):
        return self.state.pos[i].cpu().numpy()

    def orientation(self, i):
        return self.state.orn[i].cpu().numpy()

    def linvel(self, i):
        return self.state.linvel[i].cpu().numpy()

    def angvel(self, i):
        return self.state.angvel[i].cpu().numpy()

    def apply_torque_impulse(self, i, torque_impulse):
        """Add the world-space inverse inertia times ``torque_impulse`` to
        body i's angular velocity and wake it (reference:
        rigidbody_apply_torque_impulse)."""
        st = self.state
        t = torch.as_tensor(np.asarray(torque_impulse, np.float32),
                            device=st.device)
        angvel = st.angvel.clone()
        angvel[i] += st.inertia_world_inv()[i] @ t
        asleep = st.asleep.clone()
        asleep[i] = False
        timer = st.sleep_timer.clone()
        timer[i] = 0.0
        self.state = dataclasses.replace(st, angvel=angvel, asleep=asleep,
                                         sleep_timer=timer)
        return self

    # -- runtime constraints (reference: make_constraint on a live registry,
    # util/constraint_util.hpp; constraints are destroyable entities) -------
    def _add_joint(self, **kw) -> int:
        """Write a joint into a free slot of the joint table. Ducks as
        ``WorldBuilder._add_joint``, so every ``constraints.api`` factory
        works on a live world: ``et.make_hinge_constraint(world, a, b,
        ...)``. The world needs spare slots
        (``make_world(max_joints=...)``)."""
        jt = self.state.joints
        free = torch.nonzero(~jt.valid).flatten()
        if free.numel() == 0:
            raise ValueError("joint table full: build the world with a "
                             "larger max_joints")
        i = int(free[0])
        params = np.zeros((jt.params.shape[1],), np.float64)
        p = np.asarray(kw.get("params", ()), np.float64)
        params[:len(p)] = p

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float64).astype(
                np.float32), device=self.device)

        # a new table: earlier states keep theirs
        jt = dataclasses.replace(jt, **{f.name: getattr(jt, f.name).clone()
                                        for f in dataclasses.fields(jt)})
        jt.jtype[i] = int(kw["jtype"])
        jt.body_a[i] = int(kw["body_a"])
        jt.body_b[i] = int(kw["body_b"])
        jt.valid[i] = True
        jt.pivot_a[i] = f32(kw.get("pivot_a", (0, 0, 0)))
        jt.pivot_b[i] = f32(kw.get("pivot_b", (0, 0, 0)))
        jt.frame_a[i] = f32(kw.get("frame_a", (0, 0, 0, 1)))
        jt.frame_b[i] = f32(kw.get("frame_b", (0, 0, 0, 1)))
        jt.params[i] = f32(params)
        jt.impulses[i] = 0.0
        jt.angle[i] = 0.0
        self.state = dataclasses.replace(self.state, joints=jt)
        # (destroy_joint keeps the type: a superset skips nothing it needs)
        self.meta = dataclasses.replace(
            self.meta, has_joints=True,
            joint_types=self.meta.joint_types | {JointType(int(kw["jtype"]))})
        # a new graph edge wakes both islands (island_manager on_construct)
        self.wake_up(int(kw["body_a"]))
        self.wake_up(int(kw["body_b"]))
        self._reset_island_stability()
        return i

    def destroy_joint(self, j: int):
        """Invalidate a joint and wake its islands (reference: destroying a
        constraint entity wakes the island, island_manager.cpp:74-98)."""
        jt = self.state.joints
        self.wake_up(int(jt.body_a[j]))
        self.wake_up(int(jt.body_b[j]))
        valid, jtype, imp = (jt.valid.clone(), jt.jtype.clone(),
                             jt.impulses.clone())
        valid[j] = False
        jtype[j] = 0
        imp[j] = 0.0
        self.state = dataclasses.replace(
            self.state, joints=dataclasses.replace(
                jt, valid=valid, jtype=jtype, impulses=imp))
        self._reset_island_stability()
        return self

    def _reset_island_stability(self):
        """Island-graph edges or pair eligibility changed outside the step:
        the next steps recompute the island labels (the steady-state label
        skip restarts) and re-enumerate the pairs (no pair-list carry)."""
        st = self.state
        self.state = dataclasses.replace(
            st,
            island_stable_steps=torch.zeros_like(st.island_stable_steps),
            labels_stable=torch.zeros_like(st.labels_stable),
            bp_carry_ok=torch.zeros_like(st.bp_carry_ok))

    def wake_up(self, i):
        """Wake the body's whole island (reference: wake_up_island), with
        membership from an exact host-side union-find over the live contact
        and joint edges, not the on-device labels (those fragment for 1-2
        steps after each re-seed)."""
        from ..dynamics.islands import exact_island_mask
        st = self.state
        members = exact_island_mask(st, [int(i)])
        self.state = dataclasses.replace(
            st,
            asleep=torch.where(members, False, st.asleep),
            sleep_timer=torch.where(members, 0.0, st.sleep_timer))
        return self

    def is_asleep(self, i) -> bool:
        return bool(self.state.asleep[i])

    def origin(self, i):
        """Shape-origin world position."""
        return self.state.origin_pos()[i].cpu().numpy()

    def overflow_counters(self) -> dict:
        """Last-step capacity-truncation counters (all zero = nothing was
        silently dropped)."""
        ovf = self.state.overflow.cpu().numpy()
        return {"broadphase_pairs": int(ovf[0]),
                "narrowphase_candidates": int(ovf[1]),
                "contact_rows": int(ovf[2]),
                "broadphase_window_alarms": int(ovf[3]),
                "manifold_slots": int(ovf[4])}


def make_world(builder: WorldBuilder, settings: Settings = Settings(),
               capacity: Optional[int] = None,
               max_pairs: Optional[int] = None,
               max_joints: Optional[int] = None, device=None) -> World:
    """Finalize a builder into a stepping world on ``device`` (default
    ``cuda``). The manifold table is sized to max_pairs; the joint table to
    max_joints (default: the builder's joints), so spare slots take
    runtime joints."""
    dev = resolve_device(device)
    if max_pairs is None:
        max_pairs = _pairs_for(len(builder.defs))
    if builder.default_gravity is None:
        builder.default_gravity = np.asarray(settings.gravity, np.float64)
    state = builder.finalize(capacity=capacity, max_manifolds=max_pairs,
                             max_joints=max_joints, device=dev)
    return World(state, settings, derive_meta(state, max_pairs))
