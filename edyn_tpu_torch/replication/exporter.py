"""Per-component snapshot fidelity policies.

Reference: client_snapshot_exporter / server_snapshot_exporter
(include/edyn/networking/util/client_snapshot_exporter.hpp:1-342,
server_snapshot_exporter.hpp) — each component type declares HOW it
replicates: continuously re-sent unreliable state (transient), reliable
on-change state (general), creation-only data, or client->server input.
Here that's a policy table keyed by component name; user components
registered via WorldBuilder.register_component join it with their own
policy (reference: register_external_components network_fidelity).
"""
from __future__ import annotations

from typing import Dict, Iterable, List

# policies
TRANSIENT = "transient"   # unreliable, re-sent continuously (pos/vel)
RELIABLE = "reliable"     # reliable, sent on change at a low rate
CREATION = "creation"     # only inside entity_entered / create packets
INPUT = "input"           # client-owned input stream (input history)

DEFAULT_POLICIES: Dict[str, str] = {
    "position": TRANSIENT,
    "orientation": TRANSIENT,
    "linvel": TRANSIENT,
    "angvel": TRANSIENT,
    "mass_inv": CREATION,
    "inertia_inv": CREATION,
    "center_of_mass": RELIABLE,
    "restitution": RELIABLE,
    "friction": RELIABLE,
    "spin_friction": RELIABLE,
    "roll_friction": RELIABLE,
    "stiffness": RELIABLE,
    "damping": RELIABLE,
    "has_material": RELIABLE,
    "gravity": RELIABLE,
    "kind": RELIABLE,
    "group": RELIABLE,
    "mask": RELIABLE,
    "shape_type": CREATION,
    "shape_params": CREATION,
    "shape_index": CREATION,
    "sleeping_disabled": RELIABLE,
    "networked": CREATION,
}


class SnapshotPolicy:
    """Component -> policy table, extensible with user components."""

    def __init__(self, overrides: Dict[str, str] | None = None):
        self.policies = dict(DEFAULT_POLICIES)
        if overrides:
            self.policies.update(overrides)

    def register(self, name: str, policy: str):
        assert policy in (TRANSIENT, RELIABLE, CREATION, INPUT), policy
        self.policies[name] = policy

    def components(self, policy: str) -> List[str]:
        return [n for n, p in self.policies.items() if p == policy]

    @property
    def transient(self) -> List[str]:
        return self.components(TRANSIENT)

    @property
    def reliable(self) -> List[str]:
        return self.components(RELIABLE)

    @property
    def creation(self) -> List[str]:
        # everything except pure input columns instantiates a body remotely
        return [n for n, p in self.policies.items() if p != INPUT]

    @property
    def input(self) -> List[str]:
        return self.components(INPUT)


def policy_from_world(world) -> SnapshotPolicy:
    """Build the policy table for a world, folding in its user components
    (marked via register_component(..., replicate=...))."""
    pol = SnapshotPolicy()
    specs = getattr(world, "user_component_policies", None) or {}
    for name, p in specs.items():
        pol.register(name, p)
    return pol
