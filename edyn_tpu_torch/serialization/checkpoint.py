"""World checkpointing (counterpart of
``edyn_tpu/serialization/checkpoint.py``).

The reference has no world checkpointing, only per-component serialize()
functions (SURVEY §5.4). A world is one structure of tensors, so a
checkpoint is its leaves in one ``.npz``, under the JAX package's keys
(``pos``, ``contacts/key``, ``user/<name>``) and in its dtypes (pair keys
uint32 with uint32 max as the invalid key, collision group and mask
uint32; ``core/convert.py`` maps them): a JAX checkpoint loads into the
port and a port checkpoint into the JAX package.

The scene widths of a world (``SceneMeta.max_pairs``, ``bucket_cap``,
``max_rows``) are host state that the JAX package's checkpoint does not
hold. A world whose manifold table grew has a table wider than the widths
``derive_meta`` gives a fresh state, so ``save_world(meta=...)`` also
writes the widths into the file's JSON header (which the JAX loader
ignores), and ``resume_world`` builds a ``World`` with them: it then steps
as the saved world would have.
"""
from __future__ import annotations

import dataclasses
import io
import json
from typing import Optional

import numpy as np

from ..config import Settings
from ..core.convert import state_from_numpy, state_to_numpy
from ..core.state import ContactTable, WorldState

# v2: r2 state additions (com, overflow counters, user dict, compound
#     child_type/params, convex disc_r/disc_axis, contact material scales,
#     joint angle, params 20->60).
# v3: contact keys int32 -> uint32, roll_axis column.
# v4: carried fat broadphase boxes (bp_aabb_min/max), backfillable from v3.
# v5: slot-stable manifold table (contacts/sort_key|sort_slot|sort_pvalid,
#     rebuilt from contacts/key on load), overflow counter 4 -> 5, island
#     steady-skip tracking (edge_pointed/labels_stable/island_stable_steps:
#     zero defaults just disengage the skip until the world re-stabilizes).
# v6: broadphase pair-list carry flag (bp_carry_ok: a zero default just
#     re-enumerates pairs on the first step after load).
FORMAT_VERSION = 6
MIN_SUPPORTED_VERSION = 3

_U32_MAX = np.iinfo(np.uint32).max

# Leaves added after v3, backfilled with self-healing defaults when loading
# an older checkpoint: fn(template_leaf, file_dict) -> array, on the file's
# representation (uint32 keys). The broadphase admission boxes are
# recomputed every step, so reversed bounds self-heal; the manifold sort
# view is rebuilt from the saved key column (v3/v4 tables were key-sorted,
# but an argsort is correct either way).
_BACKFILL = {
    "bp_aabb_min": lambda leaf, d: np.full(leaf.shape, 1e30, leaf.dtype),
    "bp_aabb_max": lambda leaf, d: np.full(leaf.shape, -1e30, leaf.dtype),
    "contacts/sort_key": lambda leaf, d: np.sort(d["contacts/key"]),
    "contacts/sort_slot": lambda leaf, d: np.where(
        np.sort(d["contacts/key"]) == _U32_MAX,
        leaf.shape[0], np.argsort(d["contacts/key"], kind="stable")
    ).astype(np.int32),
    "contacts/sort_pvalid": lambda leaf, d: np.asarray(
        d["contacts/valid"])[np.argsort(d["contacts/key"], kind="stable")],
    "overflow": lambda leaf, d: np.concatenate(
        [np.asarray(d["overflow"], leaf.dtype),
         np.zeros(leaf.shape[0] - d["overflow"].shape[0], leaf.dtype)]),
    "edge_pointed": lambda leaf, d: np.zeros(leaf.shape, leaf.dtype),
    "labels_stable": lambda leaf, d: np.zeros(leaf.shape, leaf.dtype),
    "island_stable_steps": lambda leaf, d: np.zeros(leaf.shape, leaf.dtype),
    "bp_carry_ok": lambda leaf, d: np.zeros(leaf.shape, leaf.dtype),
}
# the side tables' leaves take their shapes from the file, as the JAX
# loader's template does
_FILE_TABLES = ("poly", "mesh", "convex", "compound", "mix_table")
# the scene widths written beside the format
_WIDTHS = ("max_pairs", "bucket_cap", "max_rows")


def _flatten(tree: dict) -> dict:
    """A state's numpy tree as {path: array}, paths joined by "/"; the
    user components follow ``mix_table`` in name order, where the JAX
    package's tree flattening puts them."""
    out = {}
    for name, val in tree.items():
        if name == "user":
            continue
        if isinstance(val, dict):
            out.update({f"{name}/{k}": v for k, v in val.items()})
        else:
            out[name] = val
        if name == "mix_table":
            out.update({f"user/{k}": tree["user"][k]
                        for k in sorted(tree["user"])})
    return out


def _settings_dict(settings: Settings) -> dict:
    """The settings as the JAX package writes them. The port's own fields
    are written only when they differ from their defaults, so a file of a
    world on the default settings loads into the JAX package."""
    out = {}
    for f in dataclasses.fields(settings):
        v = getattr(settings, f.name)
        if f.name in Settings.PORT_ONLY and v == f.default:
            continue
        out[f.name] = list(v) if isinstance(v, tuple) else v
    return out


def save_world(path_or_file, state: WorldState,
               settings: Optional[Settings] = None, meta=None):
    """Serialize the whole world (and optionally its settings and, from a
    ``SceneMeta``, its scene widths) to an .npz."""
    arrays = _flatten(state_to_numpy(state))
    head = {"format": FORMAT_VERSION}
    if settings is not None:
        head["settings"] = _settings_dict(settings)
    if meta is not None:
        head["widths"] = {k: getattr(meta, k) for k in _WIDTHS}
    arrays["__meta__"] = np.frombuffer(json.dumps(head).encode(),
                                       dtype=np.uint8)
    np.savez_compressed(path_or_file, **arrays)


def _read(path_or_file):
    """(arrays, header) of a checkpoint; refuses an unsupported format."""
    data = np.load(path_or_file)
    head = (json.loads(bytes(data["__meta__"]).decode())
            if "__meta__" in data else {})
    fmt = head.get("format", 0)
    if fmt < MIN_SUPPORTED_VERSION or fmt > FORMAT_VERSION:
        raise ValueError(
            f"checkpoint format {fmt} unsupported (this build reads "
            f"{MIN_SUPPORTED_VERSION}..{FORMAT_VERSION}); re-save the world "
            f"with the version that wrote it")
    return {k: data[k] for k in data.files if k != "__meta__"}, head


def _leaf_specs(state: WorldState) -> dict:
    """{path: (shape, numpy dtype)} of a state's leaves in the file's
    representation, read without copying the tensors."""
    from ..core.convert import leaf_to_numpy
    specs = {}

    def spec(name, t):
        # the dtype the leaf takes in the file (one element converted)
        dt = leaf_to_numpy(name, t.reshape(-1)[:1].to("cpu")).dtype
        return tuple(t.shape), dt

    for f in dataclasses.fields(state):
        val = getattr(state, f.name)
        if f.name == "user":
            specs.update({f"user/{k}": spec(None, v) for k, v in val.items()})
        elif dataclasses.is_dataclass(val):
            specs.update({f"{f.name}/{g.name}": spec(g.name,
                                                     getattr(val, g.name))
                          for g in dataclasses.fields(val)})
        else:
            specs[f.name] = spec(f.name, val)
    return specs


def _structural_specs(data: dict) -> dict:
    """{path: (shape, dtype)} of a state rebuilt from the file alone: the
    capacities (bodies, manifold slots, joints) and the side tables come
    from the file, the other leaves' shapes from the capacities, the
    dtypes from the file (the JAX package's)."""
    N = data["pos"].shape[0]
    M = data["contacts/key"].shape[0]
    zero = ContactTable.zeros(M, "meta")
    specs = {}
    for f in dataclasses.fields(WorldState):
        if f.name == "user":
            continue
        if f.name in _FILE_TABLES or f.name == "joints":
            specs.update({k: (v.shape, v.dtype) for k, v in data.items()
                          if k.startswith(f.name + "/")})
        elif f.name == "contacts":
            for g in dataclasses.fields(ContactTable):
                key = f"contacts/{g.name}"
                dt = data[key].dtype if key in data else {
                    "sort_key": np.dtype(np.uint32),
                    "sort_slot": np.dtype(np.int32),
                    "sort_pvalid": np.dtype(bool)}[g.name]
                specs[key] = (tuple(getattr(zero, g.name).shape), dt)
        elif f.name in data:
            specs[f.name] = (data[f.name].shape, data[f.name].dtype)
    # leaves the file may lack (older formats)
    specs.update({
        "bp_aabb_min": ((N, 3), np.dtype(np.float32)),
        "bp_aabb_max": ((N, 3), np.dtype(np.float32)),
        "overflow": ((5,), np.dtype(np.int32)),
        "edge_pointed": ((M,), np.dtype(bool)),
        "labels_stable": ((), np.dtype(bool)),
        "island_stable_steps": ((), np.dtype(np.int32)),
        "bp_carry_ok": ((), np.dtype(bool))})
    specs.update({k: (v.shape, v.dtype) for k, v in data.items()
                  if k.startswith("user/")})
    return specs


def _unflatten(flat: dict) -> dict:
    tree = {"user": {}}
    for path, v in flat.items():
        head, _, rest = path.partition("/")
        if rest:
            tree.setdefault(head, {})[rest] = v
        else:
            tree[head] = v
    return tree


def _load(path_or_file, template, device):
    data, head = _read(path_or_file)
    settings = None
    if "settings" in head:
        s = dict(head["settings"])
        if "gravity" in s:
            s["gravity"] = tuple(s["gravity"])
        settings = Settings(**s)
    specs = (_leaf_specs(template) if template is not None
             else _structural_specs(data))
    flat = {}
    for key, (shape, dtype) in specs.items():
        leaf = np.zeros(shape, dtype)
        if key in _BACKFILL and (key not in data
                                 or data[key].shape != leaf.shape):
            flat[key] = np.asarray(_BACKFILL[key](leaf, data), dtype)
            continue
        arr = data[key]
        if arr.shape != leaf.shape:
            raise ValueError(f"{key}: {arr.shape} != {leaf.shape}")
        flat[key] = arr.astype(dtype, copy=False)
    return state_from_numpy(_unflatten(flat), device), settings, head


def load_world(path_or_file, template: Optional[WorldState] = None,
               device=None):
    """Restore (state, settings|None) on ``device`` (``cuda`` unless the
    caller names one). With ``template`` the arrays are validated against
    an existing world's leaves; without it the state is rebuilt from the
    file (capacities come from the file)."""
    return _load(path_or_file, template, device)[:2]


def resume_world(path_or_file, device=None):
    """A ``World`` from a checkpoint (a path, a file or bytes), on
    ``device``, with the saved settings (default ``Settings()``) and scene
    widths (``derive_meta``'s when the file holds none)."""
    from ..core.world import World, derive_meta
    if isinstance(path_or_file, (bytes, bytearray)):
        path_or_file = io.BytesIO(path_or_file)
    state, settings, head = _load(path_or_file, None, device)
    return World(state, settings or Settings(),
                 derive_meta(state, **head.get("widths", {})))


def world_to_bytes(state: WorldState, settings: Optional[Settings] = None,
                   meta=None) -> bytes:
    buf = io.BytesIO()
    save_world(buf, state, settings, meta)
    return buf.getvalue()


def world_from_bytes(blob: bytes, template: Optional[WorldState] = None,
                     device=None):
    return load_world(io.BytesIO(blob), template, device)
