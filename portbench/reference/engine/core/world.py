"""World: the handle around the state and the step (counterpart of
``edyn_tpu/core/world.py``; reference: include/edyn/edyn.hpp:66-150): the
reference keeps ``make_world``, ``derive_meta`` and stepping with the
capacities' growth, none of the runtime API."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import Settings
from ..constraints.joints import types_present
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

    # -- accessors ------------------------------------------------------
    # -- mutators (reference: util/rigidbody.cpp) -----------------------
    # -- queries and events ---------------------------------------------
    # -- sleep ------------------------------------------------------------
    # -- runtime constraints (reference: make_constraint on a live registry,
    # util/constraint_util.hpp; constraints are destroyable entities) -------
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
