"""Multi-device sharding of the world step (counterpart of
``edyn_tpu/parallel/sharding.py``).

The JAX package shards every table along its leading (entity/pair) axis
over a 1-D ``jax.sharding.Mesh`` and jits the step with those shardings;
GSPMD inserts the collectives. The port keeps that model, one program
over a mesh, in one process: a ``Mesh`` is an ordered tuple of
``torch.device``s (repeats allowed, so k shards may share one card). The
step (``simulation.stepper.physics_step`` under ``SceneMeta.shard_mesh``)
takes the whole state on the home device (shard 0's), runs the dense
broadphase, the narrowphase (K4) and the solver's rows (K3b, K3a, K1, K2)
per shard on each shard's device, from the shard's contiguous range of
bodies, slots and rows, and meets the shards' body-space sums in ordered
chains (``solver.chain_index_sum``). The result is the unsharded step's,
bit for bit.

Between steps the state stays whole on the home device: every step
builds its shards' slices from it, so slices kept between steps would be
gathered and split again each step. ``state_shardings`` gives the JAX
package's per-leaf rule, and ``shard_state`` / ``gather_state`` convert a
state to that layout (a sharded leaf as k contiguous slices, one on each
mesh device; a replicated leaf whole on each) and back.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.device import resolve_device
from ..utils.profile import span
from .collectives import Mesh, gather, ranges, to_device

BODY_AXIS = "b"
REPLICATED = None


def make_mesh(devices=None, hop_each_shard: bool = False) -> Mesh:
    """A mesh over ``devices`` (any ``torch.device``s or names, repeats
    allowed: ``make_mesh(["cpu"] * 8)``, ``make_mesh(["cuda:0"] * 4)``);
    by default every CUDA device, raising without one as
    ``core.device.resolve_device`` does. ``hop_each_shard``: see
    ``Mesh``."""
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    # "cuda" names the current card, as a tensor's device never does
    devices = tuple(torch.device("cuda", torch.cuda.current_device())
                    if d.type == "cuda" and d.index is None else d
                    for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devices, hop_each_shard)


def _leaf_spec(leaf, n: int):
    if isinstance(leaf, torch.Tensor) and leaf.dim() >= 1 \
            and leaf.shape[0] >= n and leaf.shape[0] % n == 0:
        return BODY_AXIS
    return REPLICATED


def _map(fn, tree, *rest):
    """``fn`` over the tensors of a state tree (and the same places of
    ``rest``); dataclasses and dicts are rebuilt, other leaves kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name),
                         *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    return tree


def state_shardings(mesh: Mesh, state):
    """Per leaf of ``state``: ``BODY_AXIS`` where its leading axis is at
    least the mesh size and divisible by it (the leaf is split along it),
    else ``REPLICATED`` (None): scalars, small side tables. The tree has
    the state's structure, the JAX package's rule (sharding.py:30-41)."""
    n = mesh.size
    return _map(lambda leaf: _leaf_spec(leaf, n), state)


@dataclasses.dataclass
class ShardedState:
    """A state over a mesh: ``parts[s]`` is the state's structure on
    ``mesh.devices[s]``, holding shard s's slice of every sharded leaf and
    the whole of every replicated one."""
    mesh: Mesh
    specs: object
    parts: list


def shard_state(mesh: Mesh, state, specs=None) -> ShardedState:
    """Split ``state`` over ``mesh`` by ``specs`` (default
    ``state_shardings``): shard s holds rows ``ranges(n, k)[s]`` of each
    sharded leaf, on its device (a slice that stays on the state's device
    is a view, no copy)."""
    specs = state_shardings(mesh, state) if specs is None else specs
    parts = []
    with span("split"):
        for s, dev in enumerate(mesh.devices):
            def part(leaf, spec, s=s, dev=dev):
                if spec == BODY_AXIS:
                    r0, r1 = ranges(leaf.shape[0], mesh.size)[s]
                    leaf = leaf[r0:r1]
                return leaf.to(dev)
            parts.append(_map(part, state, specs))
    return ShardedState(mesh, specs, parts)


def gather_state(sharded: ShardedState, device=None):
    """The whole state on ``device`` (default the mesh's home device):
    sharded leaves concatenated in shard order, replicated ones from shard
    0."""
    device = sharded.mesh.home if device is None else torch.device(device)

    def walk(spec, parts):
        first = parts[0]
        if isinstance(first, torch.Tensor):
            if spec == BODY_AXIS:
                return gather(parts, device)
            return first.to(device)
        if isinstance(first, dict):
            return {k: walk(spec[k], [p[k] for p in parts]) for k in first}
        if dataclasses.is_dataclass(first):
            return dataclasses.replace(first, **{
                f.name: walk(getattr(spec, f.name),
                             [getattr(p, f.name) for p in parts])
                for f in dataclasses.fields(first)})
        return first

    return walk(sharded.specs, sharded.parts)


def make_sharded_step(mesh: Mesh, state, settings, meta):
    """Returns (step_fn, device_state): ``step_fn(device_state)`` runs one
    full physics step sharded over the mesh and returns the next state.
    ``device_state`` is ``state`` on the mesh's home device, where the
    step keeps it whole. The capacities are ``meta``'s: the sharded step
    does not grow the world."""
    from ..simulation.stepper import physics_step
    meta = dataclasses.replace(meta, shard_mesh=mesh)

    def step_fn(st):
        return physics_step(st, settings, meta)

    return step_fn, to_device(state, mesh.home)
