"""The scatter plan of the card's solver loops, built once a step.

On the card the velocity iterations (K1), the restitution inner
iterations (K3a) and the position iterations (K2) run as two launches: the
fused kernel, which reads each row's endpoint deltas from the [N,8] body
table by index and writes the row's two update terms ([8] rows: lin 0:3 |
ang 3:6 | two zeros) into a terms buffer, and ``segment_sum``, which adds
each body's run of terms (``solver_kernels``). The plan says where each
term goes: the terms of the step's endpoint list,
``cat([a_0 ... a_{k-1}, b_0 ... b_{k-1}])`` over the k shards
(``solver.chain_upd_t``'s order), sorted stably by target body, so each
body's terms lie together in row order, a-halves first, which is the
order ``solver.index_sum`` adds them in (it sorts the same targets
stably, every call). The rows do not change within a step, so one sort
serves the restitution pre-pass, all the velocity iterations and all the
position iterations. The restitution pre-pass's outer passes (K3b) read
the velocities by the same endpoints and write no terms: each shard's
kernel raises the shard's early-exit flag (``Targets.flag``) to the
pass's generation number (``ScatterPlan.next_generation``), which the
host reads once a pass (``ScatterPlan.raised``).

Two kinds of term are left out: those of invalid rows, and those into a
body with zero inverse mass and zero inverse inertia (a static plane, a
kinematic body). Both are zero in every component: the kernels multiply
them by a zero valid flag or a zero inverse mass and inertia. A zero term
changes no sum of ``index_sum`` (it skips them), and leaving them out
keeps one thread from walking the ground plane's tens of thousands. K2
gates on ``valid & ~soft``, a subset of the valid rows: a soft row keeps
its positions and writes zero terms there, which the segment sum skips
as ``index_sum`` does. Every kept position is written by every fused
iteration, so the buffers are never zeroed between loops.

Parts on one device are one hop, one ``segment_sum`` into the deltas in
place; with ``Mesh.hop_each_shard``, or shards on several cards, the hops
chain as ``solver.chain_index_sum``'s do (the running sum handed on, x
added at the end). Either way the result equals the unfused path's
(``solver.chain_upd_t``) bit for bit.

The CPU step keeps the unfused path (gather, plain versions,
``index_add``), whose order of summation (x itself travelling) is the
CPU's: ``for_step`` gives no plan there.
"""
from __future__ import annotations

import dataclasses

import torch

from ..parallel.collectives import Mesh
from ..utils.profile import host, span
from . import solver_kernels as sk


@dataclasses.dataclass
class Hop:
    """One ``segment_sum`` call: the terms of consecutive parts of the
    endpoint list on one device."""
    terms: torch.Tensor     # [E, 8], E the parts' endpoints, zeros at first
    offsets: torch.Tensor   # [N + 1] int32: body b's terms, in order
    shard: int              # the first part's shard (its device and count)


@dataclasses.dataclass
class Targets:
    """Where one shard's fused kernel reads and writes."""
    ab: torch.Tensor        # [2Rp] int32: the rows' a, then b endpoints
    pos: torch.Tensor       # [2Rp] int32: each term's row in its buffer, -1
    terms_a: torch.Tensor   # the a-half's hop buffer
    terms_b: torch.Tensor   # the b-half's hop buffer (may be terms_a)
    flag: torch.Tensor      # [1] int32: the last generation with a live row


def movable(state) -> torch.Tensor:
    """[N] bool: bodies with a nonzero inverse mass or inverse inertia,
    the only ones the solver's terms can move. The local inverse inertia
    is zero exactly where the world one, R I^-1 R^T, is."""
    N = state.capacity
    return (state.mass_inv != 0) | torch.any(
        state.inertia_inv.reshape(N, 9) != 0, dim=1)


@dataclasses.dataclass
class ScatterPlan:
    """Where the shards' fused K1, K3a and K2 write their terms, and the
    hops that add them (see the module's note)."""
    hops: list      # [Hop]
    shards: list    # [Targets], one per shard
    generation: int = 0     # the last restitution pass's number

    @classmethod
    def build(cls, packs, moves, mesh: Mesh):
        """The plan of the shards' packed tables ``packs``
        (``solver.ShardPack``), terms into the bodies ``moves`` [N] bool
        only."""
        N, k = moves.shape[0], len(packs)
        parts = [(s, 0) for s in range(k)] + [(s, 1) for s in range(k)]
        groups = []     # consecutive parts on one device, as chain_index_sum
        for s, half in parts:
            dev = packs[s].device
            if groups and groups[-1][0] == dev and not mesh.hop_each_shard:
                groups[-1][1].append((s, half))
            else:
                groups.append((dev, [(s, half)]))
        hops, where = [], {}
        for dev, members in groups:
            with mesh.scope(members[0][0]):
                idx = torch.cat([packs[s].ab_p[half * packs[s].Rp:
                                               (half + 1) * packs[s].Rp]
                                 for s, half in members])
                valid = torch.cat([packs[s].tbl[55] > 0.5
                                   for s, _ in members])
                keep = valid & moves.to(dev)[idx]
                key = torch.where(keep, idx, N)
                skey, order = torch.sort(key, stable=True)
                rank = torch.empty_like(order)
                rank[order] = torch.arange(order.shape[0], device=dev)
                pos = torch.where(keep, rank, -1).to(torch.int32)
                offsets = torch.searchsorted(
                    skey, torch.arange(N + 1, device=dev)).to(torch.int32)
                terms = packs[members[0][0]].tbl.new_zeros((idx.shape[0], 8))
            hops.append(Hop(terms, offsets, members[0][0]))
            start = 0
            for s, half in members:
                where[s, half] = (len(hops) - 1,
                                  pos[start:start + packs[s].Rp])
                start += packs[s].Rp
        shards = []
        for s, p in enumerate(packs):
            (ha, pa), (hb, pb) = where[s, 0], where[s, 1]
            flag = torch.zeros((1,), dtype=torch.int32, device=p.device)
            shards.append(Targets(p.ab_p.to(torch.int32), torch.cat([pa, pb]),
                                  hops[ha].terms, hops[hb].terms, flag))
        return cls(hops, shards)

    def next_generation(self) -> int:
        """A number no earlier pass over this plan's flags used (they start
        at 0)."""
        self.generation += 1
        return self.generation

    def raised(self, gen: int, home) -> bool:
        """Whether a shard's K3b raised its flag to ``gen``: the flags
        read on the host in one copy."""
        flags = [t.flag for t in self.shards]
        if len(flags) > 1:
            flags = [torch.cat([f.to(home) for f in flags])]
        return gen in host("scatter.raised", flags[0].tolist())

    def add(self, d, mesh: Mesh):
        """The body deltas ``d`` [N,8] plus every term the shards' fused
        kernels wrote this iteration, in ``solver.index_sum``'s order: one
        hop adds into d in place; several chain the running sum and add d
        at the end. Returns the deltas on the home device. A span
        ``chain`` over more than one shard, as ``solver.chain_upd_t``."""
        if len(self.shards) == 1 and len(self.hops) == 1:
            return self._sum(d, mesh)
        with span("chain"):
            return self._sum(d, mesh)

    def _sum(self, d, mesh: Mesh):
        if len(self.hops) == 1:
            h = self.hops[0]
            with mesh.scope(h.shard):
                return sk.segment_sum(h.terms, h.offsets,
                                      x=d.to(h.terms.device)).to(mesh.home)
        acc = None
        for h in self.hops:
            with mesh.scope(h.shard):
                acc = sk.segment_sum(
                    h.terms, h.offsets,
                    start=None if acc is None else acc.to(h.terms.device))
        return (d.to(acc.device) + acc).to(mesh.home)


def for_step(state, packs, mesh: Mesh):
    """The plan of a step's solve phase on the card; None on the CPU, whose
    step keeps the unfused path."""
    if mesh.home.type != "cuda":
        return None
    return ScatterPlan.build(packs, movable(state), mesh)


def body_table(dvw) -> torch.Tensor:
    """[N,6] deltas as the fused kernels' [N,8] body table (a new tensor:
    the segment sums write into it)."""
    return torch.nn.functional.pad(dvw, (0, 2))
