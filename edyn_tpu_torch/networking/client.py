"""Network client (counterpart of ``edyn_tpu/networking/client.py``;
reference: src/edyn/networking/sys/client_side.cpp:1-948: clock sync,
created/destroyed entity packets, snapshot handling with
extrapolation-or-snap, discontinuity accumulation, input history upload).

The entities of one ``EntityEntered`` packet are spawned in one batched
write of each column (``_spawn_batch_from_pools``), equal to spawning them
one by one as the JAX client does; the columns the client reads on the
host are copied from the device once per call.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..core.builder import RigidBodyDef
from ..replication.entity_map import EntityMap
from ..replication.snapshot import (
    TRANSIENT_COMPONENTS, RegistrySnapshot, apply_snapshot, extract_snapshot,
)
from . import packets as pk
from .clock_sync import ClockSync
from .extrapolation import extrapolate
from .input_history import (ActionHistory, ActionRecord,
                            InputHistory, InputRecord)
from .server import _def_from_dict, def_to_dict

CLOCK_SYNC_INTERVAL = 1.0
SNAPSHOT_RATE = 30.0  # client input/state upload rate
INPUT_RESEND_WINDOW = 0.5  # seconds of history re-sent per upload


class NetworkClient:
    def __init__(self, world, send: Callable, enable_extrapolation: bool = True,
                 background_extrapolation: bool = True,
                 extrapolation_time_limit: float = 0.1):
        self.world = world
        self.send = send
        self.clock = ClockSync()
        self.entity_map = EntityMap()   # remote(server) -> local
        self.owned: set = set()          # local entities created by this client
        self.input_history = InputHistory()
        # discrete actions (reference: action_history + the registered
        # import-action function, networking_external.hpp)
        self.action_history = ActionHistory()
        self.action_handler = None
        self.enable_extrapolation = enable_extrapolation
        # snapshot replays run on a dedicated thread with a wall-clock budget
        # (reference: extrapolation_worker, created lazily on first use);
        # background_extrapolation=False keeps the legacy inline replay
        self.background_extrapolation = background_extrapolation
        self.extrapolation_time_limit = extrapolation_time_limit
        self._extrap_worker = None
        self.server_settings: Optional[pk.ServerSettings] = None
        self._last_clock_sync = -1e9
        self._last_snapshot = -1e9
        self._pending_created: Dict[int, RigidBodyDef] = {}
        # discontinuity offsets for presentation smoothing (reference:
        # comp/discontinuity.hpp — position offset + orientation offset)
        self.disc_pos = np.zeros((world.state.capacity, 3), np.float32)
        self.disc_orn = np.zeros((world.state.capacity, 4), np.float32)
        self.disc_orn[:, 3] = 1.0
        # local asset registry + entities waiting on an asset sync
        # (reference: asset_ref sync-before-instantiate, Design.md:333-347)
        self.assets: Dict[int, dict] = {}
        self._pending_assets: Dict[int, list] = {}  # asset id -> [(srv, pools)]
        self._requested_assets: set = set()
        self._query_seq = 0
        # query_entity replies by request id (reference: entity_response)
        self.query_responses: Dict[int, object] = {}
        # server-announced playout delay (reference: server_side.cpp:541 ->
        # client ctx.server_playout_delay)
        self.server_playout_delay = 0.0
        # cached temporary-ownership companion set (refreshed at 4 Hz)
        self._companions: set = set()
        self._companions_time = -1e9

    def register_asset(self, asset_id: int, def_: RigidBodyDef):
        self.assets[asset_id] = def_to_dict(def_)

    def set_aabb_of_interest(self, lo, hi):
        """Replace this client's server-side interest box (reference:
        packet/set_aabb_of_interest.hpp)."""
        self.send(pk.SetAabbOfInterest(lo=tuple(float(x) for x in lo),
                                       hi=tuple(float(x) for x in hi)))

    def query_entity(self, queries) -> int:
        """Ask the server for specific components of specific SERVER-side
        entities (reference: packet/query_entity.hpp). ``queries`` is a list
        of (server_entity, [component names]). Returns the request id; the
        reply lands in ``self.query_responses[id]`` (and is also applied to
        local copies of non-owned entities)."""
        self._query_seq += 1
        qid = self._query_seq
        self.send(pk.QueryEntity(id=qid, queries=[
            (int(e), list(cs)) for e, cs in queries]))
        return qid

    # -- actions ---------------------------------------------------------
    def register_action_handler(self, fn):
        """``fn(state, entity, payload) -> state`` executes one action
        (reference: the import_action function registered via
        register_networked_components, networking_external.hpp). The SAME
        function must be registered on the server."""
        self.action_handler = fn
        return self

    def record_action(self, now: float, entity: int, payload):
        """Execute an action locally NOW (prediction), keep it in the
        action history for extrapolation replay, and upload it inside the
        next update (reference: action_history recording, Design.md:367-379)."""
        assert self.action_handler is not None, "register_action_handler first"
        payload = np.asarray(payload)
        self.world.state = self.action_handler(self.world.state, int(entity),
                                               payload)
        self.action_history.record(ActionRecord(
            timestamp=now, entity=int(entity), payload=payload))

    # -- inputs ---------------------------------------------------------
    def record_input(self, now: float, component: str, entities, values):
        """Record an input-component write: applied locally NOW (prediction),
        kept in the history for extrapolation replay, and uploaded to the
        server inside the next InputSnapshot (reference: client_side.cpp
        input history export :368-388)."""
        from ..replication.snapshot import set_component
        ent = np.asarray(entities, np.int64)
        self.world.state = set_component(self.world.state, component,
                                         ent, values)
        # history keeps LOCAL time + LOCAL ids (extrapolation replays with
        # local step times); the upload remaps both (see update())
        self.input_history.record(InputRecord(
            timestamp=now, component=component,
            entities=ent.astype(np.int32), values=np.asarray(values)))

    # -- local entity creation -----------------------------------------
    def create_entity(self, def_: RigidBodyDef) -> int:
        """Spawn locally and announce to the server (reference: client_side
        created-entities packet)."""
        def_ = dataclasses.replace(def_, networked=True)
        idx = self.world.spawn(def_)
        self.owned.add(idx)
        self._pending_created[idx] = def_
        return idx

    # -- per-frame update ----------------------------------------------
    def update(self, now: float):
        # apply any finished background extrapolation first (reference:
        # extrapolation results imported at the top of client update)
        self._poll_extrapolation()
        if now - self._last_clock_sync >= CLOCK_SYNC_INTERVAL:
            self._last_clock_sync = now
            self.send(self.clock.make_request(now))

        if self._pending_created:
            ents = sorted(self._pending_created)
            self.send(pk.ClientCreatedEntity(
                timestamp=now, entities=ents,
                defs=[def_to_dict(self._pending_created[e]) for e in ents]))
            self._pending_created.clear()

        if self.owned and now - self._last_snapshot >= 1.0 / SNAPSHOT_RATE:
            self._last_snapshot = now
            export = set(self.owned)
            # temporary ownership: also upload procedural state of island
            # companions — the server accepts them only while this client is
            # the island's sole owner (reference:
            # client_snapshot_exporter.hpp:199-210, Design.md "Temporary
            # ownership"); disabled when the server says so
            if self.server_settings is None \
                    or self.server_settings.allow_full_ownership:
                # the exact island walk is a host union-find over all edges —
                # refresh the companion set at 4 Hz, not every upload tick
                if now - self._companions_time >= 0.25:
                    self._companions_time = now
                    from ..dynamics.islands import exact_island_mask
                    st = self.world.state
                    mine = exact_island_mask(
                        st, sorted(self.owned)).cpu().numpy()
                    dyn = st.kind.cpu().numpy() == 0
                    self._companions = {int(e)
                                        for e in np.where(mine & dyn)[0]}
                export |= self._companions
            snap = extract_snapshot(self.world.state, sorted(export),
                                    TRANSIENT_COMPONENTS,
                                    timestamp=self.clock.to_remote(now))
            # entities sent under their server-side ids
            snap.entities = np.array(
                [self.entity_map.to_remote(int(e)) if self.entity_map.has_local(int(e))
                 else -1 for e in snap.entities], np.int32)
            keep = snap.entities >= 0
            snap.entities = snap.entities[keep]
            snap.pools = {k: v[keep] for k, v in snap.pools.items()}
            if len(snap.entities):
                self.send(pk.TransientSnapshot(
                    timestamp=self.clock.to_remote(now), snapshot=snap))
            # upload the recent input window (re-sent each time — overlap is
            # the loss tolerance, deduped server-side; Design.md:373)
            recent = self.input_history.since(now - INPUT_RESEND_WINDOW)
            wire_recs = []
            for r in recent:
                ent = np.array(
                    [self.entity_map.to_remote(int(e))
                     if self.entity_map.has_local(int(e)) else -1
                     for e in r.entities], np.int32)
                keep = ent >= 0
                if keep.any():
                    wire_recs.append(InputRecord(
                        timestamp=self.clock.to_remote(r.timestamp),
                        component=r.component, entities=ent[keep],
                        values=np.asarray(r.values)[keep]))
            if wire_recs:
                self.send(pk.InputSnapshot(
                    timestamp=self.clock.to_remote(now), records=wire_recs))
            # upload recent actions, grouped per entity, under server-side
            # ids and remote time (same loss-tolerant re-send window)
            by_entity = {}
            for r in self.action_history.since(now - INPUT_RESEND_WINDOW):
                if self.entity_map.has_local(int(r.entity)):
                    by_entity.setdefault(
                        self.entity_map.to_remote(int(r.entity)), []).append(
                        (self.clock.to_remote(r.timestamp), r.payload))
            for rem, acts in sorted(by_entity.items()):
                self.send(pk.ActionPacket(
                    timestamp=self.clock.to_remote(now), entity=rem,
                    actions=acts))

        # decay discontinuities (reference: update_presentation.cpp:19-55);
        # orientation offsets nlerp toward identity
        self.disc_pos *= 0.9
        self.disc_orn[:, :3] *= 0.9
        self.disc_orn /= np.linalg.norm(self.disc_orn, axis=1, keepdims=True)

    # -- receive --------------------------------------------------------
    def receive(self, packet, now: float):
        if isinstance(packet, pk.TimeResponse):
            self.clock.process_response(packet, now)
        elif isinstance(packet, pk.TimeRequest):
            # clock sync is bidirectional (reference: client_side.cpp:809-814
            # answers the server's time requests)
            self.send(pk.TimeResponse(timestamp=now, id=packet.id,
                                      origin_time=packet.timestamp))
        elif isinstance(packet, pk.ServerSettings):
            self.server_settings = packet
            self.world.set_settings(fixed_dt=packet.fixed_dt,
                                    gravity=tuple(packet.gravity))
        elif isinstance(packet, pk.UpdateEntityMap):
            for rem, srv in packet.pairs:
                # ours: rem is OUR local id, srv is the server-side id
                self.entity_map.insert(srv, rem)
        elif isinstance(packet, pk.EntityEntered):
            self._handle_entered(packet)
        elif isinstance(packet, pk.EntityExited):
            gone = []
            for srv in packet.entities:
                if self.entity_map.has_remote(srv):
                    loc = self.entity_map.to_local(srv)
                    if loc not in self.owned:
                        gone.append(loc)
                    self.entity_map.erase_local(loc)
            if gone:
                # one write of each column for the packet's bodies, as
                # World.destroy writes them one by one
                from ..core.spawn import destroy_rigidbody
                self.world.state = destroy_rigidbody(
                    self.world.state, torch.as_tensor(
                        gone, dtype=torch.long, device=self.world.device))
                self.world._reset_island_stability()
        elif isinstance(packet, pk.TransientSnapshot):
            self._handle_snapshot(packet, now)
        elif isinstance(packet, pk.GeneralSnapshot):
            # reliable component state for non-owned entities
            snap = packet.snapshot
            keep = np.array(
                [not (self.entity_map.has_remote(int(e)) and
                      self.entity_map.to_local(int(e)) in self.owned)
                 for e in snap.entities], bool)
            from ..replication.snapshot import RegistrySnapshot as _RS
            self.world.state = apply_snapshot(
                self.world.state,
                _RS(entities=snap.entities[keep],
                    pools={k: v[keep] for k, v in snap.pools.items()},
                    timestamp=snap.timestamp),
                self.entity_map)
        elif isinstance(packet, pk.EntityResponse):
            self.query_responses[packet.id] = packet.snapshot
            # apply to local copies of non-owned entities, like a
            # GeneralSnapshot (owned entities stay client-authoritative)
            snap = packet.snapshot
            keep = np.array(
                [not (self.entity_map.has_remote(int(e)) and
                      self.entity_map.to_local(int(e)) in self.owned)
                 for e in snap.entities], bool)
            from ..replication.snapshot import RegistrySnapshot as _RS
            self.world.state = apply_snapshot(
                self.world.state,
                _RS(entities=snap.entities[keep],
                    pools={k: v[keep] for k, v in snap.pools.items()},
                    timestamp=snap.timestamp),
                self.entity_map)
        elif isinstance(packet, pk.SetPlayoutDelay):
            # server-announced jitter-buffer delay (reference:
            # client_side.cpp:804-807 ctx.server_playout_delay) — server
            # state is this much staler than its timestamps suggest, so
            # extrapolation targets now + delay
            self.server_playout_delay = float(packet.delay)
        elif isinstance(packet, pk.AssetResponse):
            for aid, dd in packet.assets.items():
                self.assets[int(aid)] = dd
                for srv, pools in self._pending_assets.pop(int(aid), []):
                    self._instantiate_asset(int(aid), srv, pools)

    def _handle_entered(self, packet: pk.EntityEntered):
        """Instantiate server entities locally (reference:
        client_side.cpp entity_entered handler). Asset-backed entities spawn
        from the local asset copy, requesting the asset first when unknown.
        The plain ones are spawned in batches: each batch takes the first
        free slots in packet order, as one-by-one spawns would, and is
        written before an asset body claims a slot."""
        snap = packet.snapshot
        want_assets = []
        batch = []   # (server id, packet row) of plain entities
        batched = set()

        def flush():
            if not batch:
                return
            rows = np.asarray([r for _, r in batch], np.int64)
            state, slots = _spawn_batch_from_pools(
                self.world.state, {k: v[rows] for k, v in snap.pools.items()},
                len(rows), self.world.settings.pool_convex_rows)
            self.world.state = state
            for (srv, _), loc in zip(batch, slots):
                self.entity_map.insert(srv, loc)
            batch.clear()
            batched.clear()

        for row, srv in enumerate(snap.entities):
            srv = int(srv)
            if self.entity_map.has_remote(srv) or srv in batched:
                continue
            aid = packet.assets.get(srv)
            if aid is None:
                batch.append((srv, row))
                batched.add(srv)
                continue
            flush()
            pools = {k: v[row] for k, v in snap.pools.items()}
            if aid in self.assets:
                self._instantiate_asset(aid, srv, pools)
            else:
                self._pending_assets.setdefault(aid, []).append((srv, pools))
                if aid not in self._requested_assets:
                    self._requested_assets.add(aid)
                    want_assets.append(aid)
        flush()
        if want_assets:
            self.send(pk.AssetRequest(ids=sorted(want_assets)))

    def _instantiate_asset(self, asset_id: int, srv: int, pools: dict):
        if self.entity_map.has_remote(srv):
            return
        d = _def_from_dict(self.assets[asset_id])
        loc = self.world.spawn(dataclasses.replace(d, networked=True))
        self.entity_map.insert(srv, loc)
        # overlay the live component state shipped with entity_entered
        from ..replication.snapshot import set_component
        for name, val in pools.items():
            self.world.state = set_component(self.world.state, name,
                                             np.asarray([loc]), val[None])

    def _handle_snapshot(self, packet: pk.TransientSnapshot, now: float):
        """Apply a server state snapshot: extrapolate from packet time to the
        present, else snap (reference: client_side.cpp:712-735)."""
        snap = packet.snapshot
        local_time = self.clock.to_local(packet.timestamp)
        # never let the server override entities we own (client prediction)
        ent_keep = np.array([not (self.entity_map.has_remote(int(e)) and
                                  self.entity_map.to_local(int(e)) in self.owned)
                             for e in snap.entities], bool)
        snap = RegistrySnapshot(entities=snap.entities[ent_keep],
                                pools={k: v[ent_keep] for k, v in snap.pools.items()},
                                timestamp=snap.timestamp)
        if len(snap.entities) == 0:
            return
        if self.enable_extrapolation and now - local_time > self.world.settings.fixed_dt:
            if self.background_extrapolation:
                # hand the replay to the worker thread and return immediately
                # (reference: extrapolation worker request,
                # client_side.cpp:712-735 -> extrapolation_worker.hpp:27);
                # the result merges on a later update() via
                # _poll_extrapolation
                if self._extrap_worker is None:
                    from .extrapolation import ExtrapolationWorker
                    self._extrap_worker = ExtrapolationWorker(
                        self.world, time_limit=self.extrapolation_time_limit)
                self._extrap_worker.submit(snap, self.entity_map, local_time,
                                           now, self.input_history,
                                           self.action_history,
                                           self.action_handler)
                return
            old_pos, old_orn = self._host_transforms()
            state, steps, timed_out = extrapolate(
                self.world, snap, self.entity_map, local_time, now,
                self.input_history,
                time_limit=self.extrapolation_time_limit,
                action_history=self.action_history,
                action_handler=self.action_handler)
            self._merge_extrapolation(snap, state)
            self._accumulate_discontinuity(old_pos, old_orn)
        else:
            old_pos, old_orn = self._host_transforms()
            self.world.state = apply_snapshot(self.world.state, snap,
                                              self.entity_map)
            # accumulate discontinuity = old - new for presentation smoothing
            self._accumulate_discontinuity(old_pos, old_orn)

    def _merge_extrapolation(self, snap, state):
        """Merge extrapolated transforms of snapshot entities into the live
        world (process_extrapolation_result analogue). A background replay
        can finish after some of its entities exited; those are skipped
        (the JAX client raises KeyError there, ROADMAP R16)."""
        local = np.array([self.entity_map.to_local(int(e))
                          for e in snap.entities
                          if self.entity_map.has_remote(int(e))], np.int32)
        if not len(local):
            return
        merged = extract_snapshot(state, local, TRANSIENT_COMPONENTS)
        self.world.state = apply_snapshot(self.world.state, merged)
        self.world.wake_set(set(local.tolist()))

    def _poll_extrapolation(self):
        if self._extrap_worker is None:
            return
        res = self._extrap_worker.poll()
        if res is None:
            return
        snap, state, steps, timed_out = res
        old_pos, old_orn = self._host_transforms()
        self._merge_extrapolation(snap, state)
        self._accumulate_discontinuity(old_pos, old_orn)

    def close(self):
        """Stop the background extrapolation worker, if one was started."""
        if self._extrap_worker is not None:
            self._extrap_worker.stop()
            self._extrap_worker = None

    def _host_transforms(self):
        # host read: the position and orientation columns, once each
        st = self.world.state
        return st.pos.cpu().numpy(), st.orn.cpu().numpy()

    def _accumulate_discontinuity(self, old_pos, old_orn):
        """offset += old - new, so offset + new == old at the instant of the
        snap (reference: discontinuity_accumulator merge_component,
        comp/discontinuity.hpp:21-24: quaternion offsets compose by
        multiplication)."""
        from ..math import quat as q
        new_pos, new_orn = self._host_transforms()
        self.disc_pos += old_pos - new_pos
        t = torch.from_numpy
        step_off = q.mul(t(old_orn), q.conjugate(t(new_orn)))
        self.disc_orn = q.normalize(q.mul(t(self.disc_orn),
                                          step_off)).numpy().astype(
                                              np.float32)

    def presentation_position(self, i: int):
        """Smoothed position (reference: present_position + discontinuity)."""
        # host read: body i's row
        return self.world.state.pos[i].cpu().numpy() + self.disc_pos[i]

    def presentation_orientation(self, i: int):
        """Smoothed orientation (reference: present_orientation +
        discontinuity orientation_offset)."""
        from ..math import quat as q
        orn = self.world.state.orn[i].cpu()
        return q.normalize(q.mul(torch.from_numpy(self.disc_orn[i]),
                                 orn)).numpy()


def _write_pools(state, idx, pools: dict):
    """``state`` with every pool's rows written at the slots ``idx`` (a
    long tensor) and those slots made valid, one write a column."""
    from ..core.convert import leaf_to_tensor
    from ..replication.snapshot import COMPONENT_COLUMNS
    from ..replication.snapshot import set_component
    valid = state.valid.clone()
    valid[idx] = True
    state = dataclasses.replace(state, valid=valid)
    for name, val in pools.items():
        attr = COMPONENT_COLUMNS.get(name)
        if attr is None:
            # a user component with a transient or reliable policy: the JAX
            # client raises KeyError here (ROADMAP R14)
            state = set_component(state, name, idx.cpu().numpy(), val)
            continue
        col = getattr(state, attr).clone()
        col[idx] = leaf_to_tensor(attr, np.asarray(val), col.device).to(
            col.dtype)
        state = dataclasses.replace(state, **{attr: col})
    return state


def _pool_convex_rows(state, slots):
    """``state`` with the convex-table rows of ``slots`` written from their
    shape columns (ROADMAP R13; a polyhedron's from the world's own
    polyhedron table at its ``shape_index``). Meshes and compounds, which
    no runtime spawn takes, keep their rows."""
    from ..core.spawn import update_convex_rows
    from ..shapes.convex import shape_convex_data
    from ..shapes.params import ShapeType
    idx = torch.as_tensor(slots, dtype=torch.long, device=state.device)
    # host read: the new rows' shape columns, and the polyhedron table
    stype = state.shape_type[idx].cpu().numpy()
    sparams = state.shape_params[idx].cpu().numpy()
    sindex = state.shape_index[idx].cpu().numpy()
    skip = (ShapeType.MESH, ShapeType.PAGED_MESH, ShapeType.COMPOUND)
    poly = None
    if (stype == ShapeType.POLYHEDRON).any():
        p = state.poly
        poly = types.SimpleNamespace(**{
            f.name: getattr(p, f.name).cpu().numpy()
            for f in dataclasses.fields(p)})
    rows, datas = [], []
    for k, slot in enumerate(slots):
        if int(stype[k]) in skip:
            continue
        rows.append(slot)
        datas.append(shape_convex_data(int(stype[k]), sparams[k], poly,
                                       int(sindex[k])))
    if not rows:
        return state
    return dataclasses.replace(state, convex=update_convex_rows(
        state.convex, rows, datas))


def _spawn_from_pools(state, pools: dict, convex_rows: bool = False):
    """Create a body slot directly from snapshot component pools (one
    entity's rows). ``convex_rows`` also writes the slot's convex-table
    row (``Settings.pool_convex_rows``; ROADMAP R13)."""
    from ..core.spawn import find_free_slot
    i = find_free_slot(state)
    idx = torch.as_tensor([i], dtype=torch.long, device=state.device)
    state = _write_pools(state, idx, {k: np.asarray(v)[None]
                                      for k, v in pools.items()})
    if convex_rows:
        state = _pool_convex_rows(state, [i])
    return state, i


def _spawn_batch_from_pools(state, pools: dict, n: int,
                            convex_rows: bool = False):
    """Create ``n`` bodies from pools of ``n`` rows each, in the first ``n``
    free slots: the state and slots that ``n`` calls of
    ``_spawn_from_pools`` give, in one write of each column."""
    # host read: the free slots
    free = torch.nonzero(~state.valid).flatten()[:n]
    if free.numel() < n:
        raise RuntimeError("world at capacity: rebuild with a larger "
                           "capacity")
    state = _write_pools(state, free, pools)
    slots = free.cpu().tolist()
    if convex_rows:
        state = _pool_convex_rows(state, slots)
    return state, slots
