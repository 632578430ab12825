"""Bidirectional remote<->local entity (slot index) map
(reference: include/edyn/replication/entity_map.hpp)."""
from __future__ import annotations


class EntityMap:
    def __init__(self):
        self.rem2loc: dict[int, int] = {}
        self.loc2rem: dict[int, int] = {}

    def insert(self, remote: int, local: int):
        self.rem2loc[remote] = local
        self.loc2rem[local] = remote

    def to_local(self, remote: int) -> int:
        return self.rem2loc[remote]

    def to_remote(self, local: int) -> int:
        return self.loc2rem[local]

    def has_remote(self, remote: int) -> bool:
        return remote in self.rem2loc

    def has_local(self, local: int) -> bool:
        return local in self.loc2rem

    def erase_local(self, local: int):
        remote = self.loc2rem.pop(local, None)
        if remote is not None:
            self.rem2loc.pop(remote, None)

    def __len__(self):
        return len(self.rem2loc)
