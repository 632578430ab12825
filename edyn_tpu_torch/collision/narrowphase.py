"""Narrowphase: contact generation over the manifold pair list by bucket
class, then the merge into the persistent manifolds (counterpart of
``edyn_tpu/collision/narrowphase.py``; reference: narrowphase.cpp:21-109).

Buckets: UNIFIED (any convex pair, support-mapped SAT), BOXBOX (box pair,
face clipping), PLANE (convex vs plane), MESH (convex vs static triangle
mesh, one support-SAT sub-pair per candidate triangle) and the compound
classes COMP_CONVEX, COMP_PLANE, COMP_COMP and COMP_MESH (one sub-pair per
child). Every bucket but UNIFIED-on-CUDA is plain PyTorch on both devices,
as the JAX package keeps them in XLA; each runs over the live prefix of its
compacted selection in chunks of at most ``CHUNK`` sub-pairs.

The UNIFIED bucket runs by the device, as in the JAX package, whose
``_use_pallas(None)`` runs its Pallas kernel on a TPU and its jnp path
elsewhere:
- on CUDA it is ONE call of K4 (``unified_kernel.collide_support_unified``,
  the counterpart of ``collide_support_pallas``) over the live prefix of the
  compacted selection, reading the transposed side table: a per-body
  pre-pass, a counting sort of the pairs by class and the per-pair kernel;
- on the CPU it is ``support_sat.collide_support`` (the port of the jnp
  path), in ``CHUNK``-pair chunks that bound its temporaries, so a CPU step
  computes what the JAX package's CPU step computes.
K4's plain version (``collide_support_plain``) is held against the JAX
kernel by the tests and against K4 by ``chip_smoke.py``; no step runs it.

The merge of the fresh points into the carried manifolds runs by the
device too: on CUDA one launch of the merge kernel
(``merge_kernel.merge_fresh``) over every slot, on the CPU its plain
version (``merge_fresh_plain``: ``manifold.merge_points``).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..config import CONTACT_BREAKING_THRESHOLD
from ..core.state import KIND_STATIC
from ..parallel.collectives import Mesh, gather, ranges, replicas, to_device
from ..shapes.params import ShapeType
from ..utils.profile import count, host, span
from .kernels import box_box
from .kernels.compound import (
    collide_compound_compound, collide_compound_convex, collide_compound_mesh,
    collide_compound_plane,
)
from .kernels.merge_kernel import merge_fresh
from .kernels.mesh import collide_convex_mesh
from .kernels.plane_unified import collide_convex_plane
from .kernels.support import pack_side_table, side_from_packed
from .kernels.support_sat import collide_support
from .kernels.unified_kernel import collide_support_unified, pack_side_table_t

S = ShapeType
# bucket classes (the JAX package's numbers; its B_CYLPLANE = 3 is never
# present: its _classes_present does not return it)
B_UNIFIED, B_BOXBOX, B_PLANE, B_MESH = 0, 1, 2, 4
B_COMP_CONVEX, B_COMP_PLANE, B_COMP_COMP, B_COMP_MESH = 5, 6, 7, 8
# each class's name in its span (``narrowphase.<CLASS>``) and counter
# (``bucket_pairs.<CLASS>``)
CLASS_NAMES = {B_UNIFIED: "UNIFIED", B_BOXBOX: "BOXBOX", B_PLANE: "PLANE",
               B_MESH: "MESH", B_COMP_CONVEX: "COMP_CONVEX",
               B_COMP_PLANE: "COMP_PLANE", B_COMP_COMP: "COMP_COMP",
               B_COMP_MESH: "COMP_MESH"}
CONVEX_TYPES = (S.SPHERE, S.BOX, S.CAPSULE, S.CYLINDER, S.POLYHEDRON)
MESH_TYPES = (S.MESH, S.PAGED_MESH)
SUPPORTED_TYPES = frozenset(S)
# support-SAT sub-pairs per call of a plain bucket (a mesh pair is CAP
# sub-pairs, a compound pair one per child): bounds the [K, axes, verts, 3]
# temporaries
CHUNK = 32768


def _is_convex(t):
    out = torch.zeros_like(t, dtype=torch.bool)
    for c in CONVEX_TYPES:
        out |= t == c
    return out


def _is_mesh(t):
    return (t == S.MESH) | (t == S.PAGED_MESH)


def classify(ta, tb):
    """(bucket_class, swap); swap puts the convex or compound body first
    for the plane, mesh and compound classes. Other combinations get class
    -1."""
    cls = torch.full(ta.shape, -1, dtype=torch.int32, device=ta.device)
    put = lambda where, c, cls: torch.where(where, torch.full_like(cls, c),
                                            cls)
    conv_a, conv_b = _is_convex(ta), _is_convex(tb)
    mesh_a, mesh_b = _is_mesh(ta), _is_mesh(tb)
    comp_a, comp_b = ta == S.COMPOUND, tb == S.COMPOUND
    plane_a, plane_b = ta == S.PLANE, tb == S.PLANE
    cls = put(conv_a & conv_b, B_UNIFIED, cls)
    cls = put((ta == S.BOX) & (tb == S.BOX), B_BOXBOX, cls)
    cls = put((plane_a & conv_b) | (conv_a & plane_b), B_PLANE, cls)
    cls = put((mesh_a & conv_b) | (conv_a & mesh_b), B_MESH, cls)
    cls = put((comp_a & conv_b) | (conv_a & comp_b), B_COMP_CONVEX, cls)
    cls = put((comp_a & plane_b) | (plane_a & comp_b), B_COMP_PLANE, cls)
    cls = put(comp_a & comp_b, B_COMP_COMP, cls)
    cls = put((comp_a & mesh_b) | (mesh_a & comp_b), B_COMP_MESH, cls)
    swap = ((plane_a & conv_b) | (mesh_a & conv_b) | (conv_a & comp_b)
            | (plane_a & comp_b) | (mesh_a & comp_b))
    return cls, swap


def _classes_present(types_present: frozenset):
    """The bucket classes that can occur given the shape types."""
    conv = [t for t in types_present if t in CONVEX_TYPES]
    mesh = any(t in types_present for t in MESH_TYPES)
    out = []
    if conv:
        out.append(B_UNIFIED)
    if S.BOX in types_present:
        out.append(B_BOXBOX)
    if S.PLANE in types_present and conv:
        out.append(B_PLANE)
    if mesh and conv:
        out.append(B_MESH)
    if S.COMPOUND in types_present:
        if conv:
            out.append(B_COMP_CONVEX)
        if S.PLANE in types_present:
            out.append(B_COMP_PLANE)
        out.append(B_COMP_COMP)
        if mesh:
            out.append(B_COMP_MESH)
    return out


def _bucket_cap(bucket, cap, M):
    if bucket == B_UNIFIED:
        return min(2 * cap, M)
    return max(512, cap // 4)


def sub_pairs(bucket, state) -> int:
    """Support-SAT sub-pairs a pair of the bucket expands into: candidate
    triangles of a mesh pair, children of a compound pair."""
    tris = state.mesh.grid.shape[-1]
    ch = state.compound.child_row.shape[1]
    return {B_MESH: tris, B_COMP_CONVEX: ch, B_COMP_PLANE: ch,
            B_COMP_COMP: ch * ch, B_COMP_MESH: ch * tris}.get(bucket, 1)


def _run_bucket(bucket, state, ka, kb, A, B, threshold, has_cyl,
                tri_cull: bool = False):
    if bucket == B_UNIFIED:
        return collide_support(A, B, threshold, rim_axes=has_cyl)
    if bucket == B_BOXBOX:
        return box_box.collide_box_box(A.pos, A.orn, A.params,
                                       B.pos, B.orn, B.params, threshold)
    if bucket == B_PLANE:
        return collide_convex_plane(A, B, threshold)
    if bucket == B_MESH:
        box = ((state.aabb_min[ka], state.aabb_max[ka]) if tri_cull
               else None)
        return collide_convex_mesh(A, B, threshold, state.mesh,
                                   state.shape_index[kb], rim_axes=has_cyl,
                                   cull_box=box)
    if bucket == B_COMP_CONVEX:
        return collide_compound_convex(state, ka, kb, A, B, threshold)
    if bucket == B_COMP_PLANE:
        return collide_compound_plane(state, ka, kb, A, B, threshold)
    if bucket == B_COMP_MESH:
        return collide_compound_mesh(state, ka, kb, A, B, threshold,
                                     rim_axes=has_cyl)
    return collide_compound_compound(state, ka, kb, A, B, threshold)


def live_classes(state, man):
    """Per manifold pair: (bucket class, -1 where no bucket runs it; swap;
    frozen: both sides asleep or static, points kept verbatim; stale: live
    pair beyond the breaking threshold, points dropped)."""
    ba = man.body_a.long()
    bb = man.body_b.long()
    cls, swap = classify(state.shape_type[ba], state.shape_type[bb])
    inactive = state.asleep | ((state.kind == KIND_STATIC) & state.valid)
    frozen = inactive[ba] & inactive[bb]
    _BT = CONTACT_BREAKING_THRESHOLD
    pre = (torch.all(state.aabb_min[ba] - _BT <= state.aabb_max[bb], -1)
           & torch.all(state.aabb_max[ba] + _BT >= state.aabb_min[bb], -1))
    cls = torch.where(man.valid & ~frozen & pre, cls, torch.full_like(cls, -1))
    return cls, swap, frozen, man.valid & ~frozen & ~pre


def bucket_points(bucket, state, man, s, swap, threshold: float,
                  has_cyl: bool, packed, dims, tri_cull: bool = False):
    """The fresh points of the manifold pairs ``s`` (int64) of one plain
    bucket, packed as ``update_contacts``' rows [len(s), 4, 14], computed
    in chunks of at most ``CHUNK`` support-SAT sub-pairs. ``swap`` is
    ``live_classes``' per manifold pair; ``packed, dims`` the state's
    ``pack_side_table``; ``tri_cull`` is ``Settings.mesh_triangle_cull``
    (the MESH bucket's triangle cull)."""
    ba = man.body_a.long()
    bb = man.body_b.long()
    parts = []
    step = max(1, CHUNK // sub_pairs(bucket, state))
    for c0 in range(0, s.shape[0], step):
        sc = s[c0:c0 + step]
        a = ba[sc]
        b = bb[sc]
        sw = swap[sc]
        ka = torch.where(sw, b, a)
        kb = torch.where(sw, a, b)
        A = side_from_packed(packed[ka], dims)
        B = side_from_packed(packed[kb], dims)
        res = _run_bucket(bucket, state, ka, kb, A, B, threshold, has_cyl,
                          tri_cull)
        if bucket not in (B_UNIFIED, B_BOXBOX):
            res_sw = res.swapped()
            w1 = sw[:, None]
            w2 = sw[:, None, None]
            pv = torch.where(w1, res_sw.point_valid, res.point_valid)
            pa = torch.where(w2, res_sw.pivot_a, res.pivot_a)
            pb = torch.where(w2, res_sw.pivot_b, res.pivot_b)
            nr = torch.where(w2, res_sw.normal, res.normal)
            at = torch.where(w1, res_sw.attachment, res.attachment)
        else:
            pv, pa, pb, nr, at = (res.point_valid, res.pivot_a,
                                  res.pivot_b, res.normal, res.attachment)
        parts.append(torch.cat([
            pa, pb, nr, at.to(pa.dtype)[..., None],
            res.distance[..., None], pv.to(pa.dtype)[..., None],
            res.friction_scale[..., None],
            res.restitution_scale[..., None]], dim=-1))
    return torch.cat(parts)


def update_contacts(state, man, threshold: float, types_present: frozenset,
                    bucket_cap: int | None = None, dt: float = 1.0 / 60.0,
                    tri_cull: bool = False):
    """Run the bucket kernels over the manifold pair list and merge fresh
    points into ``man``. Returns (table, dropped candidates as a host
    int). ``tri_cull``: ``Settings.mesh_triangle_cull``."""
    return update_contacts_sharded(state, man, threshold, types_present,
                                   bucket_cap, dt, tri_cull,
                                   Mesh((state.device,)))


def update_contacts_sharded(state, man, threshold: float,
                            types_present: frozenset, bucket_cap, dt: float,
                            tri_cull: bool, mesh: Mesh):
    """``update_contacts`` with the manifold slots split into the mesh's
    contiguous ranges: each shard classifies its slots, runs the buckets
    over its share of each bucket's selection (K4 on its device for the
    UNIFIED bucket) and merges its slots' points. The shards' selections, concatenated
    in shard order and cut at the bucket's capacity, are the selections
    over all slots, so the table (gathered on the home device) and the
    drop count are the same for any number of shards. Spans:
    ``narrowphase.classify``, ``narrowphase.<CLASS>`` for each bucket
    class (attr ``pairs``, also counted as ``bucket_pairs.<CLASS>``) and
    ``narrowphase.merge``."""
    _check_types(types_present)
    M = man.key.shape[0]
    cap = bucket_cap or M
    classes = _classes_present(types_present)
    with span("narrowphase.classify"):
        states = replicas(state, mesh)
        parts, sels = [], []
        for s, (m0, m1) in enumerate(ranges(M, mesh.size)):
            with mesh.scope(s):
                man_s = to_device(slice_table(man, m0, m1), mesh.devices[s])
                cls, swap, frozen, stale = live_classes(states[s], man_s)
                man_s = dataclasses.replace(
                    man_s, point_valid=man_s.point_valid & ~stale[:, None])
                parts.append((man_s, swap, frozen))
                sels.append({b: host("narrowphase.select",
                                     torch.nonzero(cls == b)).flatten()
                             for b in classes})
        # padded bucket rows produce nothing the JAX path keeps, so only
        # the live prefix of each selection is computed
        dropped = 0
        for bucket in classes:
            this_cap = _bucket_cap(bucket, cap, M)
            counts = [sel[bucket].shape[0] for sel in sels]
            dropped += max(sum(counts) - this_cap, 0)
            off = 0
            for sel, c in zip(sels, counts):
                sel[bucket] = sel[bucket][:max(0, min(c, this_cap - off))]
                off += c
    pts, tables = [], {}
    for s, (man_s, swap, frozen) in enumerate(parts):
        with mesh.scope(s):
            # the side tables are per body: one build per device
            dev = mesh.devices[s]
            if dev not in tables:
                tables[dev] = SideTables(states[s])
            pts.append(fresh_points(states[s], man_s, swap, sels[s],
                                    threshold, types_present, tri_cull,
                                    tables[dev]))
    with span("narrowphase.merge"):
        out = []
        for s, ((man_s, swap, frozen), new_pts) in enumerate(zip(parts,
                                                                 pts)):
            with mesh.scope(s):
                out.append(merge_fresh(states[s], man_s, new_pts, frozen,
                                       dt))
        return gather_tables(out, mesh.home), dropped


def slice_table(tab, m0: int, m1: int):
    """Slots ``m0:m1`` of a table whose every field is slot-major."""
    return dataclasses.replace(tab, **{
        f.name: getattr(tab, f.name)[m0:m1]
        for f in dataclasses.fields(tab)})


def gather_tables(parts, device):
    """Slot-major tables concatenated in order on ``device``."""
    return dataclasses.replace(parts[0], **{
        f.name: gather([getattr(p, f.name) for p in parts], device)
        for f in dataclasses.fields(parts[0])})


def _check_types(types_present):
    unsupported = set(types_present) - SUPPORTED_TYPES
    if unsupported:
        raise NotImplementedError(
            f"shape types {sorted(unsupported)} have no narrowphase bucket")


class SideTables:
    """A body state's side tables, each built at its first use and shared
    by the shards on one device: ``plain`` (``pack_side_table``'s, the
    plain buckets) and ``k4`` (``pack_side_table_t``'s)."""

    def __init__(self, state):
        self.state = state

    @functools.cached_property
    def plain(self):
        return pack_side_table(self.state)

    @functools.cached_property
    def k4(self):
        return pack_side_table_t(self.state)


def fresh_points(state, man, swap, sels: dict, threshold: float,
                 types_present: frozenset, tri_cull: bool, tables):
    """The fresh points of every bucket's live selection (``sels``: bucket
    -> int64 slots of ``man``), packed [M,4,14]: pivot_a 0:3 | pivot_b
    3:6 | normal 6:9 | attachment 9 | distance 10 | point_valid 11 |
    friction_scale 12 | restitution_scale 13; slots no bucket ran are 0.
    ``tables``: the state's ``SideTables``."""
    M = man.key.shape[0]
    dev = man.key.device
    ba = man.body_a.long()
    bb = man.body_b.long()
    # row M is the scratch row of dropped writes
    new_pts = torch.zeros((M + 1, 4, 14), dtype=state.dtype, device=dev)
    has_cyl = S.CYLINDER in types_present
    for bucket, s in sels.items():
        name = CLASS_NAMES[bucket]
        count("bucket_pairs." + name, s.shape[0])
        if not s.shape[0]:
            continue
        with span("narrowphase." + name, pairs=s.shape[0]):
            if bucket == B_UNIFIED and dev.type == "cuda":
                # K4 over the whole live prefix; the bucket needs no swap,
                # and its friction/restitution scales are ones
                # (narrowphase.py:266 in the JAX package)
                tbl_t, dims_t = tables.k4
                out = collide_support_unified(tbl_t, ba[s], bb[s], dims_t,
                                              threshold, rim_axes=has_cyl)
                new_pts[s] = torch.cat([
                    out[..., :12], torch.ones(out.shape[:2] + (2,),
                                              dtype=out.dtype,
                                              device=dev)], dim=-1)
                continue
            packed, dims = tables.plain
            new_pts[s] = bucket_points(bucket, state, man, s, swap,
                                       threshold, has_cyl, packed, dims,
                                       tri_cull)
    return new_pts[:M]
