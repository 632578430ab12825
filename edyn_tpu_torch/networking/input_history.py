"""Timestamped input history as pure DATA records (reference:
include/edyn/networking/util/input_state_history.hpp:19-232 — a serialized
ring of timestamped input-component snapshots — and action_history,
Design.md:367-379).

Each entry names a component and carries (entities, values) arrays, so the
whole history serializes to bytes (networking/wire.py), crosses the wire
inside ``InputSnapshot`` packets, merges server-side, and replays during
extrapolation — nothing is a closure.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class InputRecord:
    """One timestamped write of an input component: scatter ``values`` into
    component ``component`` at rows ``entities`` (reference:
    input_state_history::element, input_state_history.hpp:24-40)."""
    timestamp: float
    component: str            # built-in name or registered user component
    entities: np.ndarray      # [K] int32 (remote ids on the wire)
    values: np.ndarray        # [K, ...] matching the component column

    def key(self):
        return (self.timestamp, self.component,
                tuple(np.asarray(self.entities).tolist()))


@dataclasses.dataclass
class InputHistory:
    """Time-sorted ring of InputRecords over a sliding window (reference:
    input_state_history keeps a bounded timestamped list)."""
    window: float = 2.0
    entries: List[InputRecord] = dataclasses.field(default_factory=list)

    def record(self, rec: InputRecord):
        bisect.insort(self.entries, rec, key=lambda e: e.timestamp)
        cutoff = rec.timestamp - self.window
        while self.entries and self.entries[0].timestamp < cutoff:
            self.entries.pop(0)

    def since(self, t: float) -> List[InputRecord]:
        lo = bisect.bisect_left(self.entries, t, key=lambda e: e.timestamp)
        return self.entries[lo:]

    def apply(self, state, t: float, dt: float, emap=None):
        """Write every record inside [t, t+dt) into the state (reference:
        input_state_history_reader::import_each). ``emap`` remaps wire
        entity ids to local rows when replaying a remote client's stream."""
        from ..replication.snapshot import set_component
        lo = bisect.bisect_left(self.entries, t, key=lambda e: e.timestamp)
        hi = bisect.bisect_left(self.entries, t + dt,
                                key=lambda e: e.timestamp)
        for rec in self.entries[lo:hi]:
            ent = np.asarray(rec.entities, np.int64)
            if emap is not None:
                ent = np.array(
                    [emap.to_local(int(e)) if emap.has_remote(int(e)) else -1
                     for e in ent], np.int64)
            keep = ent >= 0
            if not keep.any():
                continue
            state = set_component(state, rec.component, ent[keep],
                                  np.asarray(rec.values)[keep])
        return state

    def merge_remote(self, records: List[InputRecord]):
        """Server-side merge of a client's uploaded records (reference:
        action_history merged server-side; duplicate re-sends — the loss
        tolerance mechanism — are dropped by key)."""
        seen = {e.key() for e in self.entries}
        for rec in records:
            if rec.key() not in seen:
                self.record(rec)


@dataclasses.dataclass
class ActionRecord:
    """One timestamped discrete action targeting an entity (reference:
    comp/action_history.hpp — opaque per-entity action payloads with
    timestamps, as opposed to continuous input STATE)."""
    timestamp: float
    entity: int               # remote id on the wire
    payload: np.ndarray

    def key(self):
        return (self.timestamp, self.entity,
                np.asarray(self.payload).tobytes())


@dataclasses.dataclass
class ActionHistory:
    """Time-sorted ring of ActionRecords (reference: action_history — kept
    alongside the input history, merged server-side, replayed during
    extrapolation)."""
    window: float = 2.0
    entries: List[ActionRecord] = dataclasses.field(default_factory=list)

    def record(self, rec: ActionRecord):
        bisect.insort(self.entries, rec, key=lambda e: e.timestamp)
        cutoff = rec.timestamp - self.window
        while self.entries and self.entries[0].timestamp < cutoff:
            self.entries.pop(0)

    def since(self, t: float) -> List[ActionRecord]:
        lo = bisect.bisect_left(self.entries, t, key=lambda e: e.timestamp)
        return self.entries[lo:]

    def apply(self, state, t: float, dt: float, handler, emap=None):
        """Execute every action inside [t, t+dt) through ``handler(state,
        entity, payload) -> state`` (reference: the registered
        import_action function, networking_external.hpp)."""
        lo = bisect.bisect_left(self.entries, t, key=lambda e: e.timestamp)
        hi = bisect.bisect_left(self.entries, t + dt,
                                key=lambda e: e.timestamp)
        for rec in self.entries[lo:hi]:
            e = int(rec.entity)
            if emap is not None:
                if not emap.has_remote(e):
                    continue
                e = emap.to_local(e)
            state = handler(state, e, rec.payload)
        return state

    def merge_remote(self, records: List[ActionRecord]):
        seen = {e.key() for e in self.entries}
        for rec in records:
            if rec.key() not in seen:
                self.record(rec)
