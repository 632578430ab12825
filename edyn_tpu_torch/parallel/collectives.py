"""The mesh and what GSPMD's collectives do for the JAX package's sharded
step, as plain tensor ops and copies between the mesh's devices (no
process group): contiguous shard ranges and gathers onto one device. The
ordered chain that adds every shard's terms into one body-space sum lives
beside ``index_sum``, whose order of summation it follows
(``dynamics.solver.chain_index_sum``).

Inside a recorded step the gathers of several slices, the splits and the
chains are spans of ``utils.profile`` (``gather``, ``split``, ``chain``).
"""
from __future__ import annotations

import dataclasses

import torch

from ..utils import cuda_lib
from ..utils.profile import span


def ranges(n: int, k: int) -> list:
    """``k`` contiguous ranges ``(start, stop)`` covering ``range(n)`` in
    order, their sizes differing by at most one (the first ones larger)."""
    base, extra = divmod(n, k)
    out, start = [], 0
    for s in range(k):
        stop = start + base + (1 if s < extra else 0)
        out.append((start, stop))
        start = stop
    return out


def to_device(tree, device, skip=()):
    """A tree of tensors (dataclasses, dicts) with every tensor on
    ``device``; fields named in ``skip`` stay as they are. A tensor already
    there is the same tensor."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device, skip) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: to_device(getattr(tree, f.name), device, skip)
            for f in dataclasses.fields(tree) if f.name not in skip})
    return tree


def replicas(state, mesh) -> list:
    """The body state on each shard's device: the state itself where it
    lies there, else a copy without the manifold table (``contacts``,
    ``edge_pointed``), which the shards take by slot range."""
    return [state if d == state.device else
            to_device(state, d, skip=("contacts", "edge_pointed"))
            for d in mesh.devices]


def gather(parts, device):
    """The shards' slices concatenated in shard order on ``device`` (one
    slice is returned as it is, moved if it lies elsewhere; several are a
    span ``gather``)."""
    if len(parts) == 1:
        return parts[0].to(device)
    with span("gather"):
        return torch.cat([p.to(device) for p in parts])


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the axis ``"b"``: shard s runs on ``devices[s]``
    (repeats allowed); ``home``, shard 0's device, holds the whole state
    of a sharded step. The unsharded step runs over ``Mesh((device,))``.

    ``hop_each_shard`` (for tests): every shard's part of a body-space sum
    is a hop of its own, as on distinct cards, even where shards share a
    device (by default the parts on one device are added in one call)."""
    devices: tuple
    hop_each_shard: bool = False

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self):
        return self.devices[0]

    def scope(self, s: int):
        """Shard s's work: its device current, its launches counted as
        its own (``cuda_lib.DEVICE_LAUNCHES``)."""
        return cuda_lib.shard_scope(s, self.devices[s])
