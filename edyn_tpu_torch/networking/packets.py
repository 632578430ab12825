"""Packet types (reference: include/edyn/networking/packet/edyn_packet.hpp:29-47
— the 16-type variant — and should_send_reliably :80-88). The library
produces/consumes packets; the application provides the transport, exactly
like the reference (README.md:169)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from ..replication.snapshot import RegistrySnapshot


@dataclasses.dataclass
class Packet:
    timestamp: float = 0.0


@dataclasses.dataclass
class ClientCreatedEntity(Packet):
    """Client informs server of entities it created
    (reference: packet::create_entity from client)."""
    entities: List[int] = dataclasses.field(default_factory=list)
    defs: List[dict] = dataclasses.field(default_factory=list)  # rigidbody defs


@dataclasses.dataclass
class ClientDestroyedEntity(Packet):
    entities: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class EntityEntered(Packet):
    """Server tells client about entities entering its AABB of interest,
    with full component pools (reference: packet::entity_entered). Entities
    instantiated from a shared asset carry the asset id instead of creation
    pools (reference: asset_ref sync-before-instantiate, Design.md:333-347)."""
    snapshot: Optional[RegistrySnapshot] = None
    owners: Dict[int, int] = dataclasses.field(default_factory=dict)
    assets: Dict[int, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class AssetRequest(Packet):
    """Client asks for asset definitions it doesn't have locally
    (reference: packet::asset_request)."""
    ids: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class AssetResponse(Packet):
    """Asset id -> rigidbody def dict (reference: packet::asset_sync)."""
    assets: Dict[int, dict] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class EntityExited(Packet):
    entities: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class UpdateEntityMap(Packet):
    """remote->local pairs so the peer can translate entity ids
    (reference: packet::update_entity_map)."""
    pairs: List[tuple] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class TransientSnapshot(Packet):
    """Unreliable, continuously re-sent state (reference:
    packet::transient_snapshot -> registry_snapshot)."""
    snapshot: Optional[RegistrySnapshot] = None


@dataclasses.dataclass
class GeneralSnapshot(Packet):
    """Reliable snapshot of non-transient components
    (reference: packet::general_snapshot)."""
    snapshot: Optional[RegistrySnapshot] = None


@dataclasses.dataclass
class TimeRequest(Packet):
    id: int = 0


@dataclasses.dataclass
class TimeResponse(Packet):
    id: int = 0
    origin_time: float = 0.0


@dataclasses.dataclass
class ServerSettings(Packet):
    fixed_dt: float = 1 / 60
    gravity: tuple = (0.0, -9.8, 0.0)
    playout_delay_multiplier: float = 1.2
    # temporary ownership: client may set procedural state of every entity in
    # islands it is the only reachable client of (reference:
    # remote_client.hpp:43-46, server_side.cpp:341)
    allow_full_ownership: bool = True


@dataclasses.dataclass
class SetPlayoutDelay(Packet):
    delay: float = 0.0


@dataclasses.dataclass
class ActionPacket(Packet):
    """Timestamped action stream (reference: packet::registry_snapshot with
    action_history; Design.md:367-379)."""
    entity: int = -1
    actions: List[tuple] = dataclasses.field(default_factory=list)  # (time, payload)


@dataclasses.dataclass
class InputSnapshot(Packet):
    """Client -> server upload of recent input-component records (reference:
    input_state_history serialized inside registry_snapshot packets,
    networking/util/input_state_history.hpp:19-232). Unreliable; re-sends of
    overlapping windows are deduped server-side, which is the loss-tolerance
    mechanism (Design.md:373)."""
    entity: int = -1                 # owning client's primary entity (info)
    records: List[Any] = dataclasses.field(default_factory=list)  # InputRecord


@dataclasses.dataclass
class QueryEntity(Packet):
    """Client -> server: request specific components of specific entities
    (reference: packet/query_entity.hpp). ``queries`` is a list of
    (entity, [component names])."""
    id: int = 0
    queries: List[tuple] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class EntityResponse(Packet):
    """Server -> client reply to QueryEntity (reference:
    packet/entity_response.hpp): one snapshot carrying the requested pools."""
    id: int = 0
    snapshot: Any = None


@dataclasses.dataclass
class SetAabbOfInterest(Packet):
    """Client -> server: replace my interest box (reference:
    packet/set_aabb_of_interest.hpp)."""
    lo: tuple = (-50.0, -50.0, -50.0)
    hi: tuple = (50.0, 50.0, 50.0)


RELIABLE_TYPES = (ClientCreatedEntity, ClientDestroyedEntity, EntityEntered,
                  EntityExited, UpdateEntityMap, GeneralSnapshot,
                  ServerSettings, SetPlayoutDelay, AssetRequest, AssetResponse,
                  SetAabbOfInterest, QueryEntity, EntityResponse)


def should_send_reliably(packet: Packet) -> bool:
    """reference: edyn_packet.hpp:80-88."""
    return isinstance(packet, RELIABLE_TYPES)
