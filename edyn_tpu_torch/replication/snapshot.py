"""Registry snapshots: per-component pools over a set of entities
(counterpart of ``edyn_tpu/replication/snapshot.py``).

Reference: registry_snapshot / pool_snapshot
(include/edyn/networking/packet/registry_snapshot.hpp:19-37,
include/edyn/networking/util/pool_snapshot.hpp). A pool is a numpy slice of
one state column: export gathers the entities' rows on the device and
copies only those to the host; import writes the rows into a copy of the
column (so a kept ``WorldState`` stays as it was), remapping entities
through an ``EntityMap``. Pools leave the port in the JAX package's dtypes
(collision group and mask as uint32, ``core/convert.py``), so a snapshot
encodes to the same bytes in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..core.convert import leaf_to_numpy, leaf_to_tensor
from .entity_map import EntityMap

# component registry: name -> state attribute (column arrays indexed by body)
COMPONENT_COLUMNS = {
    "position": "pos",
    "orientation": "orn",
    "linvel": "linvel",
    "angvel": "angvel",
    "mass_inv": "mass_inv",
    "inertia_inv": "inertia_inv",
    "center_of_mass": "com",
    "restitution": "restitution",
    "friction": "friction",
    "spin_friction": "spin_friction",
    "roll_friction": "roll_friction",
    "stiffness": "stiffness",
    "damping": "damping",
    "has_material": "has_material",
    "gravity": "gravity",
    "kind": "kind",
    "group": "group",
    "mask": "mask",
    "shape_type": "shape_type",
    "shape_params": "shape_params",
    "shape_index": "shape_index",
    "sleeping_disabled": "sleeping_disabled",
    "networked": "networked",
    # reference: roll_direction is a networked_comp (networked_comp.hpp:61)
    "roll_direction": "roll_axis",
}

# the transient set re-sent continuously (reference: transient components in
# client/server_snapshot_exporter: transforms and velocities)
TRANSIENT_COMPONENTS = ("position", "orientation", "linvel", "angvel")
# everything needed to instantiate a body remotely (reference: entity_entered
# packet carrying full component pools)
CREATION_COMPONENTS = tuple(COMPONENT_COLUMNS)


def get_component(state, name: str):
    """Column for a component name: built-in registry first, then user
    components registered via WorldBuilder.register_component (reference:
    register_external_components, replication/register_external.hpp:28)."""
    attr = COMPONENT_COLUMNS.get(name)
    if attr is not None:
        return getattr(state, attr)
    user = getattr(state, "user", None) or {}
    if name in user:
        return user[name]
    raise KeyError(f"unknown component {name!r}")


def _attr(name: str):
    """The field name that selects a column's representation (None for a
    user component)."""
    return COMPONENT_COLUMNS.get(name)


def _rows(col, entities):
    return torch.as_tensor(np.asarray(entities, np.int64), device=col.device)


def set_component(state, name: str, entities, values):
    """Scatter ``values`` into component ``name`` at rows ``entities``.
    Returns the updated state; the column written is a new tensor."""
    col = get_component(state, name)
    idx = _rows(col, entities)
    if not isinstance(values, torch.Tensor):
        values = leaf_to_tensor(_attr(name), np.asarray(values), col.device)
    new = col.clone()
    new[idx] = values.to(device=col.device, dtype=col.dtype)
    attr = COMPONENT_COLUMNS.get(name)
    if attr is not None:
        return dataclasses.replace(state, **{attr: new})
    user = dict(state.user)
    user[name] = new
    return dataclasses.replace(state, user=user)


@dataclasses.dataclass
class RegistrySnapshot:
    """entities are REMOTE indices from the producer's registry; pools map
    component name -> [len(entities), ...] arrays."""
    entities: np.ndarray
    pools: Dict[str, np.ndarray]
    timestamp: float = 0.0


def extract_snapshot(state, entities: Iterable[int],
                     components: Iterable[str] = TRANSIENT_COMPONENTS,
                     timestamp: float = 0.0) -> RegistrySnapshot:
    ent = np.asarray(list(entities), np.int32)
    pools = {}
    for name in components:
        col = get_component(state, name)
        pools[name] = leaf_to_numpy(_attr(name), col[_rows(col, ent)])
    return RegistrySnapshot(entities=ent, pools=pools, timestamp=timestamp)


def apply_snapshot(state, snap: RegistrySnapshot,
                   emap: Optional[EntityMap] = None,
                   only_entities: Optional[set] = None):
    """Write snapshot pools into the state. Remote entities are remapped via
    ``emap`` (identity when None). Returns the updated state.

    NaN/Inf payloads are rejected per entity, as the JAX package does (the
    reference discards the whole packet, Design.md:381-383; per-entity
    rejection keeps the valid rows of a partly corrupt snapshot, and no
    non-finite value reaches the state either way)."""
    if len(snap.entities) == 0:
        return state
    if emap is None:
        local = snap.entities
        keep = np.ones(len(local), bool)
    else:
        local = np.array([emap.to_local(int(e)) if emap.has_remote(int(e))
                          else -1 for e in snap.entities], np.int32)
        keep = local >= 0
    if only_entities is not None:
        keep &= np.isin(local, list(only_entities))

    for name, pool in snap.pools.items():
        pool = np.asarray(pool)
        ok = keep.copy()
        if np.issubdtype(pool.dtype, np.floating):
            flat = pool.reshape(len(pool), -1)
            ok &= np.isfinite(flat).all(axis=1)
        if not ok.any():
            continue
        state = set_component(state, name, local[ok], pool[ok])
    return state
