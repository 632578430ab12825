"""Carrying a world state across packages as numpy.

``tree`` is a nested dict of numpy arrays with the field names of
``edyn_tpu.core.state.WorldState`` (sub-tables ``contacts``, ``joints``,
``poly``, ``mesh``, ``convex``, ``compound``, ``mix_table`` as nested
dicts, and ``user``, the user components by name), in the JAX package's
dtypes: pair keys uint32 with uint32 max as the invalid key, collision
group/mask uint32, floats at the world's scalar dtype (float32, or float64
from the JAX package's x64 mode, which keeps some tables at float32). A
state built from a tree takes one float dtype, that of its ``pos`` leaf, for
every float leaf. The caller flattens the JAX state; this module never sees
a JAX type.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import numpy_dtype

from ..shapes.compound import CompoundTable
from ..shapes.convex import ConvexTable
from ..shapes.mesh import MeshTable
from .state import (
    INVALID_KEY, ContactTable, JointTable, MixTable, PolyTable, WorldState,
)
from .world import resolve_device

JAX_INVALID_KEY = np.uint32(np.iinfo(np.uint32).max)
_SUBTABLES = {"contacts": ContactTable, "joints": JointTable,
              "poly": PolyTable, "mesh": MeshTable, "convex": ConvexTable,
              "compound": CompoundTable, "mix_table": MixTable}
_KEY_FIELDS = ("key", "sort_key")
_BIT_FIELDS = ("group", "mask")


def leaf_to_tensor(name, x, device, dtype=None):
    """One leaf of the tree as the port's tensor: ``name`` is its field
    name (the key and bit fields change representation; None for a user
    component). A float leaf takes ``dtype`` when one is given, else keeps
    its own."""
    x = np.asarray(x)
    if name in _KEY_FIELDS:
        k = x.astype(np.int64)
        k[x == JAX_INVALID_KEY] = INVALID_KEY
        x = k
    elif name in _BIT_FIELDS:
        x = x.astype(np.int64)
    elif dtype is not None and x.dtype.kind == "f":
        x = x.astype(numpy_dtype(dtype))
    return torch.as_tensor(np.array(x, order="C"), device=device)


def leaf_to_numpy(name, t):
    """One tensor as the tree's numpy leaf, in the JAX package's dtype
    (inverse of ``leaf_to_tensor``)."""
    x = t.detach().cpu().numpy()
    if name in _KEY_FIELDS:
        k = np.where(x == INVALID_KEY, np.int64(JAX_INVALID_KEY), x)
        return k.astype(np.uint32)
    if name in _BIT_FIELDS:
        return x.astype(np.uint32)
    return x


def _check_keys(cls, tree):
    want = {f.name for f in dataclasses.fields(cls)}
    got = set(tree)
    if cls is WorldState:
        got.add("user")  # optional: no user components
    if want != got:
        raise KeyError(f"{cls.__name__}: missing {sorted(want - got)}, "
                       f"unexpected {sorted(got - want)}")


def state_from_numpy(tree: dict, device=None) -> WorldState:
    """Build a WorldState on ``device`` from a numpy tree: ``cuda`` unless
    the caller names a device (raises without a GPU, as ``make_world``
    does). Every float leaf but the user components takes the dtype of
    ``tree["pos"]``: a float64 tree is a float64 world."""
    device = resolve_device(device)
    _check_keys(WorldState, tree)
    fdt = (torch.float64 if np.asarray(tree["pos"]).dtype == np.float64
           else torch.float32)
    kw = {}
    for name, val in tree.items():
        if name == "user":
            kw[name] = {k: leaf_to_tensor(None, v, device)
                        for k, v in val.items()}
        elif name in _SUBTABLES:
            cls = _SUBTABLES[name]
            _check_keys(cls, val)
            kw[name] = cls(**{k: leaf_to_tensor(k, v, device, fdt)
                              for k, v in val.items()})
        else:
            kw[name] = leaf_to_tensor(name, val, device, fdt)
    return WorldState(**kw)


def state_to_numpy(state: WorldState) -> dict:
    """The numpy tree of a WorldState (inverse of ``state_from_numpy``)."""
    out = {}
    for f in dataclasses.fields(state):
        val = getattr(state, f.name)
        if f.name == "user":
            out[f.name] = {k: leaf_to_numpy(None, v) for k, v in val.items()}
        elif f.name in _SUBTABLES:
            out[f.name] = {g.name: leaf_to_numpy(g.name, getattr(val, g.name))
                           for g in dataclasses.fields(val)}
        else:
            out[f.name] = leaf_to_numpy(f.name, val)
    return out
