"""Authoritative network server (counterpart of
``edyn_tpu/networking/server.py``; reference:
src/edyn/networking/sys/server_side.cpp:1-769: clock sync, playout-delay
jitter buffer, ownership-checked snapshot import, interest management,
snapshot export, client entity registration).

Transport-agnostic like the reference: the app supplies a ``send(client_id,
packet)`` callable; ``receive``/``update`` drive everything else. Columns
the server reads on the host (the body kinds, the valid mask) are copied
from the device once per call, not once per entity.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, Optional

import numpy as np

from ..core.builder import Material, RigidBodyDef
from ..replication.entity_map import EntityMap
from ..replication.snapshot import (
    CREATION_COMPONENTS, TRANSIENT_COMPONENTS, apply_snapshot, extract_snapshot,
)
from . import packets as pk
from .input_history import ActionHistory, ActionRecord, InputHistory
from .interest import InterestState

PLAYOUT_DELAY_MULTIPLIER = 1.2  # reference: server_side.cpp:513-541
MAX_PLAYOUT_DELAY = 1.0
SNAPSHOT_RATE = 20.0  # Hz
RELIABLE_SNAPSHOT_RATE = 1.0  # Hz — reliable (general) component re-send


@dataclasses.dataclass
class RemoteClient:
    """reference: networking/comp/remote_client.hpp:21."""
    id: int
    send: Callable
    entity_map: EntityMap = dataclasses.field(default_factory=EntityMap)
    owned: set = dataclasses.field(default_factory=set)
    interest: InterestState = dataclasses.field(default_factory=InterestState)
    latency: float = 0.0
    playout_delay: float = 0.05
    # temporary ownership (reference: remote_client.hpp:43-46): when True,
    # snapshot state is accepted for any entity in an island reachable ONLY
    # by this client (Design.md "Temporary ownership")
    allow_full_ownership: bool = True
    last_snapshot_time: float = -1e9
    snapshot_rate: float = SNAPSHOT_RATE
    # merged input stream (reference: server-side action_history merge)
    input_history: InputHistory = dataclasses.field(
        default_factory=InputHistory)
    input_applied: set = dataclasses.field(default_factory=set)
    action_history: ActionHistory = dataclasses.field(
        default_factory=ActionHistory)
    action_applied: set = dataclasses.field(default_factory=set)
    last_reliable_time: float = -1e9


class NetworkServer:
    def __init__(self, world):
        self.world = world
        self.clients: Dict[int, RemoteClient] = {}
        # jitter buffer: (due_time, seq, client_id, packet)
        self._timed: list = []
        self._seq = 0
        # per-component replication policies (reference:
        # server_snapshot_exporter; replication/exporter.py)
        from ..replication.exporter import policy_from_world
        self.policy = policy_from_world(world)
        # asset registry: id -> def dict; entity -> asset id (reference:
        # asset_ref / asset_entry, networking/comp/asset_ref.hpp:16)
        self.assets: Dict[int, dict] = {}
        self.entity_asset: Dict[int, int] = {}
        # discrete-action executor (reference: the registered import_action
        # function, networking_external.hpp): same fn as the clients'
        self.action_handler = None
        # host copy of the kind column, refreshed when the column changes
        self._kind_col = None
        self._kind_host = None

    # -- assets ----------------------------------------------------------
    def register_asset(self, asset_id: int, def_: RigidBodyDef):
        self.assets[asset_id] = def_to_dict(def_)

    def spawn_asset(self, asset_id: int, **overrides) -> int:
        """Instantiate a registered asset; clients that know the asset get
        only the asset id + transient state (sync-before-instantiate,
        Design.md:333-347)."""
        d = _def_from_dict(self.assets[asset_id])
        d = dataclasses.replace(d, networked=True, **overrides)
        e = self.world.spawn(d)
        self.entity_asset[e] = asset_id
        return e

    def register_action_handler(self, fn):
        """``fn(state, entity, payload) -> state`` (reference:
        import_action, networking_external.hpp)."""
        self.action_handler = fn
        return self

    # -- lifecycle ------------------------------------------------------
    def register_client(self, client_id: int, send: Callable,
                        interest_half_extents=(50.0, 50.0, 50.0),
                        allow_full_ownership: bool = True) -> RemoteClient:
        c = RemoteClient(id=client_id, send=send,
                         allow_full_ownership=allow_full_ownership)
        c.interest = InterestState(half_extents=interest_half_extents)
        self.clients[client_id] = c
        c.send(pk.ServerSettings(
            fixed_dt=self.world.settings.fixed_dt,
            gravity=self.world.settings.gravity,
            playout_delay_multiplier=PLAYOUT_DELAY_MULTIPLIER,
            allow_full_ownership=allow_full_ownership))
        return c

    # -- receive --------------------------------------------------------
    def receive(self, client_id: int, packet, now: float):
        c = self.clients[client_id]
        if isinstance(packet, pk.TimeRequest):
            # respond immediately (reference: server clock sync path)
            c.send(pk.TimeResponse(timestamp=now, id=packet.id,
                                   origin_time=packet.timestamp))
            c.latency = max(c.latency, 0.0)
        elif isinstance(packet, pk.ClientCreatedEntity):
            self._handle_create(c, packet, now)
        elif isinstance(packet, pk.ClientDestroyedEntity):
            for rem in packet.entities:
                if c.entity_map.has_remote(rem):
                    loc = c.entity_map.to_local(rem)
                    if loc in c.owned:
                        self.world.destroy(loc)
                        c.owned.discard(loc)
                        c.entity_map.erase_local(loc)
        elif isinstance(packet, pk.TransientSnapshot):
            # jitter buffer: process at packet_time + playout delay
            # (reference: server_process_timed_packets, server_side.cpp:309-319)
            latency = max(now - packet.timestamp, 0.0)
            c.latency = 0.8 * c.latency + 0.2 * latency
            new_delay = min(c.latency * PLAYOUT_DELAY_MULTIPLIER,
                            MAX_PLAYOUT_DELAY)
            # apply + announce only on significant change (reference:
            # server_side.cpp:537-541, 6% hysteresis -> set_playout_delay)
            if abs(new_delay - c.playout_delay) > c.playout_delay * 0.06:
                c.playout_delay = new_delay
                c.send(pk.SetPlayoutDelay(timestamp=now, delay=new_delay))
            due = packet.timestamp + c.playout_delay
            self._seq += 1
            heapq.heappush(self._timed, (due, self._seq, client_id, packet))
        elif isinstance(packet, pk.InputSnapshot):
            # dedup-merge; replayed at playout time in update() (reference:
            # server_side.cpp:603-616 action dispatch)
            c.input_history.merge_remote(packet.records)
        elif isinstance(packet, pk.ActionPacket):
            # merge, dedup by key (re-sends are the loss tolerance); replay
            # happens at playout time in update()
            c.action_history.merge_remote([
                ActionRecord(timestamp=t, entity=int(packet.entity),
                             payload=np.asarray(v))
                for t, v in packet.actions])
        elif isinstance(packet, pk.QueryEntity):
            # reply with the requested component pools (reference:
            # packet/query_entity.hpp -> packet/entity_response.hpp; the
            # per-entity component lists are unioned into one snapshot)
            # host read: the valid mask, once
            valid = self.world.state.valid.cpu().numpy()
            ents, comps = set(), set()
            for e, cs in packet.queries:
                if 0 <= int(e) < len(valid) and valid[int(e)]:
                    ents.add(int(e))
                    comps.update(cs)
            snap = extract_snapshot(self.world.state, sorted(ents),
                                    tuple(sorted(comps)), timestamp=now)
            c.send(pk.EntityResponse(timestamp=now, id=packet.id,
                                     snapshot=snap))
        elif isinstance(packet, pk.SetAabbOfInterest):
            lo = np.asarray(packet.lo, np.float64)
            hi = np.asarray(packet.hi, np.float64)
            c.interest.center = 0.5 * (lo + hi)
            c.interest.half_extents = 0.5 * (hi - lo)
        elif isinstance(packet, pk.AssetRequest):
            known = {i: self.assets[i] for i in packet.ids if i in self.assets}
            if known:
                c.send(pk.AssetResponse(timestamp=now, assets=known))

    def _handle_create(self, c: RemoteClient, packet: pk.ClientCreatedEntity,
                       now: float):
        """Instantiate client-created entities; reply with the entity map
        (reference: server_side.cpp client entity registration)."""
        pairs = []
        for rem, dd in zip(packet.entities, packet.defs):
            d = _def_from_dict(dd)
            d.networked = True
            loc = self.world.spawn(d)
            c.entity_map.insert(rem, loc)
            c.owned.add(loc)
            pairs.append((rem, loc))
        c.send(pk.UpdateEntityMap(timestamp=now, pairs=pairs))

    # -- update ---------------------------------------------------------
    def update(self, now: float):
        # 1. drain due timed packets with ownership checks
        while self._timed and self._timed[0][0] <= now:
            _, _, cid, packet = heapq.heappop(self._timed)
            c = self.clients.get(cid)
            if c is None:
                continue
            snap = packet.snapshot
            # ownership: a client may move entities it owns, plus — under
            # temporary ownership — every entity in an island only IT can
            # reach (reference: server_snapshot_importer.hpp:27-28,152
            # is_only_reachable_client; Design.md "Temporary ownership")
            allowed = self._allowed_entities(c)
            self.world.state = apply_snapshot(
                self.world.state, snap, c.entity_map, only_entities=allowed)
            self.world.wake_set(c.owned)

        # 1b. replay due input records with ownership restriction — a client
        # only steers the input columns of rows it owns (reference:
        # server_side.cpp ownership checks + input replay). Records are
        # tracked by key so a late arrival (loss + re-send) still applies.
        for c in self.clients.values():
            hi = now - c.playout_delay
            applied = False
            for rec in c.input_history.entries:
                if rec.timestamp >= hi:
                    break
                key = rec.key()
                if key in c.input_applied:
                    continue
                c.input_applied.add(key)
                ent = np.asarray(rec.entities, np.int64)
                keep = np.array([int(e) in c.owned for e in ent], bool)
                if keep.any():
                    from ..replication.snapshot import set_component
                    self.world.state = set_component(
                        self.world.state, rec.component, ent[keep],
                        np.asarray(rec.values)[keep])
                    applied = True
            # actions replay the same way, ownership-checked, through the
            # registered handler (reference: server_side.cpp:603-616)
            if self.action_handler is not None:
                for rec in c.action_history.entries:
                    if rec.timestamp >= hi:
                        break
                    key = rec.key()
                    if key in c.action_applied:
                        continue
                    c.action_applied.add(key)
                    if int(rec.entity) in c.owned:
                        self.world.state = self.action_handler(
                            self.world.state, int(rec.entity), rec.payload)
                        applied = True
                if len(c.action_applied) > 4 * max(
                        len(c.action_history.entries), 64):
                    live = {r.key() for r in c.action_history.entries}
                    c.action_applied &= live
            # bound the applied-key set to the history window
            if len(c.input_applied) > 4 * max(len(c.input_history.entries), 64):
                live = {r.key() for r in c.input_history.entries}
                c.input_applied &= live
            if applied:
                self.world.wake_set(c.owned)

        # 2. per-client interest + snapshot export (component sets chosen by
        # the per-component policy table — reference snapshot exporters)
        transient_comps = tuple(self.policy.transient)
        reliable_comps = tuple(self.policy.reliable)
        creation_comps = tuple(self.policy.creation)
        for c in self.clients.values():
            entered, exited = c.interest.update(self.world.state)
            if entered:
                owners = {e: cid for cid, cl in self.clients.items()
                          for e in cl.owned if e in entered}
                plain = sorted(e for e in entered
                               if e not in self.entity_asset)
                asset_backed = sorted(e for e in entered
                                      if e in self.entity_asset)
                if plain:
                    snap = extract_snapshot(self.world.state, plain,
                                            creation_comps, timestamp=now)
                    c.send(pk.EntityEntered(timestamp=now, snapshot=snap,
                                            owners=owners))
                if asset_backed:
                    # asset entities ship only the asset id + live state;
                    # the client instantiates from its asset copy
                    snap = extract_snapshot(
                        self.world.state, asset_backed,
                        transient_comps + reliable_comps, timestamp=now)
                    c.send(pk.EntityEntered(
                        timestamp=now, snapshot=snap, owners=owners,
                        assets={e: self.entity_asset[e]
                                for e in asset_backed}))
            if exited:
                c.send(pk.EntityExited(timestamp=now,
                                       entities=sorted(exited)))
            if now - c.last_snapshot_time >= 1.0 / c.snapshot_rate:
                c.last_snapshot_time = now
                ent = sorted(e for e in c.interest.current
                             if self._is_dynamic(e))
                if ent:
                    snap = extract_snapshot(self.world.state, ent,
                                            transient_comps, timestamp=now)
                    c.send(pk.TransientSnapshot(timestamp=now, snapshot=snap))
            if now - c.last_reliable_time >= 1.0 / RELIABLE_SNAPSHOT_RATE:
                c.last_reliable_time = now
                ent = sorted(c.interest.current)
                if ent and reliable_comps:
                    snap = extract_snapshot(self.world.state, ent,
                                            reliable_comps, timestamp=now)
                    c.send(pk.GeneralSnapshot(timestamp=now, snapshot=snap))

    def _host_kind(self):
        """The kind column on the host, copied once per column."""
        col = self.world.state.kind
        if self._kind_col is not col:
            self._kind_col, self._kind_host = col, col.cpu().numpy()
        return self._kind_host

    def _is_dynamic(self, e: int) -> bool:
        return bool(self._host_kind()[e] == 0)

    def _allowed_entities(self, c: RemoteClient) -> set:
        """Entities whose procedural state client ``c`` may set: its owned
        entities plus, under temporary ownership, every dynamic entity in an
        island reachable only through ``c`` (no other client's entity in the
        island) — reference is_only_reachable_client
        (server_snapshot_importer.hpp:152, Design.md "Temporary ownership")."""
        allowed = set(c.owned)
        if not (c.allow_full_ownership and c.owned):
            return allowed
        from ..dynamics.islands import exact_island_mask
        st = self.world.state
        mine = exact_island_mask(st, sorted(c.owned)).cpu().numpy()
        others = set()
        for c2 in self.clients.values():
            if c2.id != c.id:
                others |= c2.owned
        if others:
            contested = exact_island_mask(st, sorted(others)).cpu().numpy()
        else:
            contested = np.zeros_like(mine)
        dyn = self._host_kind() == 0
        allowed |= {int(e) for e in np.where(mine & ~contested & dyn)[0]}
        return allowed


def _def_from_dict(d: dict) -> RigidBodyDef:
    from ..shapes import params as sh
    shape = None
    sd = d.get("shape")
    if sd is not None:
        cls = getattr(sh, sd["type"])
        shape = cls(**{k: v for k, v in sd.items() if k != "type"})
    mat = Material(**d["material"]) if d.get("material") else None
    kw = {k: v for k, v in d.items() if k not in ("shape", "material")}
    return RigidBodyDef(shape=shape, material=mat, **kw)


def def_to_dict(d: RigidBodyDef) -> dict:
    shape = None
    if d.shape is not None:
        shape = {"type": type(d.shape).__name__}
        shape.update({k: (list(v) if isinstance(v, (tuple, list, np.ndarray)) else v)
                      for k, v in dataclasses.asdict(d.shape).items()})
    out = dataclasses.asdict(d)
    out["shape"] = shape
    out["material"] = dataclasses.asdict(d.material) if d.material else None
    for k in ("position", "orientation", "linvel", "angvel"):
        out[k] = list(np.asarray(out[k], np.float64))
    if out.get("center_of_mass") is not None:
        out["center_of_mass"] = list(np.asarray(out["center_of_mass"],
                                                np.float64))
    out.pop("inertia", None)
    out.pop("gravity", None)
    return out
