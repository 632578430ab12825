"""Narrowphase: contact generation over the manifold pair list by bucket
class, then the merge into the persistent manifolds (counterpart of
``edyn_tpu/collision/narrowphase.py``; reference: narrowphase.cpp:21-109).

Buckets in this slice: UNIFIED (any convex pair, support-mapped SAT),
BOXBOX (box pair, face clipping) and PLANE (convex vs plane). The compound
and mesh buckets come with a later slice, and ``update_contacts`` refuses a
world whose shape types would need them.

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
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import CONTACT_BREAKING_THRESHOLD
from ..core.state import KIND_STATIC
from ..math import quat
from ..shapes.params import ShapeType
from .broadphase import compact
from .kernels import box_box
from .kernels.plane_unified import collide_convex_plane
from .kernels.support import pack_side_table, side_from_packed
from .kernels.support_sat import collide_support
from .kernels.unified_kernel import collide_support_unified, pack_side_table_t
from .manifold import merge_points

S = ShapeType
B_UNIFIED, B_BOXBOX, B_PLANE = 0, 1, 2
CONVEX_TYPES = (S.SPHERE, S.BOX, S.CAPSULE, S.CYLINDER, S.POLYHEDRON)
SUPPORTED_TYPES = frozenset(CONVEX_TYPES + (S.PLANE, S.NONE))
# pairs per call of a plain bucket: bounds the [K, axes, verts, 3]
# temporaries of the support-mapped SAT on the CPU
CHUNK = 32768


def _is_convex(t):
    out = torch.zeros_like(t, dtype=torch.bool)
    for c in CONVEX_TYPES:
        out |= t == c
    return out


def classify(ta, tb):
    """(bucket_class, swap); swap puts the convex body first for the plane
    bucket. Other combinations get class -1."""
    cls = torch.full(ta.shape, -1, dtype=torch.int32, device=ta.device)
    cls = torch.where(_is_convex(ta) & _is_convex(tb),
                      torch.full_like(cls, B_UNIFIED), cls)
    cls = torch.where((ta == S.BOX) & (tb == S.BOX),
                      torch.full_like(cls, B_BOXBOX), cls)
    plane_b = _is_convex(ta) & (tb == S.PLANE)
    plane_a = (ta == S.PLANE) & _is_convex(tb)
    cls = torch.where(plane_a | plane_b, torch.full_like(cls, B_PLANE), cls)
    return cls, plane_a


def _classes_present(types_present: frozenset):
    conv = [t for t in types_present if t in CONVEX_TYPES]
    out = []
    if conv:
        out.append(B_UNIFIED)
    if S.BOX in types_present:
        out.append(B_BOXBOX)
    if S.PLANE in types_present and conv:
        out.append(B_PLANE)
    return out


def _bucket_cap(bucket, cap, M):
    if bucket == B_UNIFIED:
        return min(2 * cap, M)
    return max(512, cap // 4)


def _run_bucket(bucket, A, B, threshold, has_cyl):
    if bucket == B_UNIFIED:
        return collide_support(A, B, threshold, rim_axes=has_cyl)
    if bucket == B_BOXBOX:
        return box_box.collide_box_box(A.pos, A.orn, A.params,
                                       B.pos, B.orn, B.params, threshold)
    return collide_convex_plane(A, B, threshold)


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


def update_contacts(state, man, threshold: float, types_present: frozenset,
                    bucket_cap: int | None = None, dt: float = 1.0 / 60.0):
    """Run the bucket kernels over the manifold pair list and merge fresh
    points into ``man``. Returns (table, dropped candidates as a host
    int)."""
    unsupported = set(types_present) - SUPPORTED_TYPES
    if unsupported:
        raise NotImplementedError(
            f"shape types {sorted(unsupported)} need narrowphase buckets "
            "that are not ported yet")
    M = man.key.shape[0]
    dev = man.key.device
    cap = bucket_cap or M
    ba = man.body_a.long()
    bb = man.body_b.long()
    cls, swap, frozen, stale = live_classes(state, man)
    man = dataclasses.replace(
        man, point_valid=man.point_valid & ~stale[:, None])

    # packed fresh points [M+1,4,14] (row M is the scratch row of dropped
    # writes): pivot_a 0:3 | pivot_b 3:6 | normal 6:9 | attachment 9 |
    # distance 10 | point_valid 11 | friction_scale 12 | restitution_scale 13
    new_pts = torch.zeros((M + 1, 4, 14), device=dev)
    dropped = 0
    packed, dims = pack_side_table(state)
    has_cyl = S.CYLINDER in types_present

    for bucket in _classes_present(types_present):
        sel, count = compact(cls == bucket, _bucket_cap(bucket, cap, M))
        this_cap = sel.shape[0]
        dropped += max(count - this_cap, 0)
        live = min(count, this_cap)
        if bucket == B_UNIFIED and dev.type == "cuda":
            # K4 over the whole live prefix; the bucket needs no swap, and
            # its friction/restitution scales are ones (narrowphase.py:266
            # in the JAX package)
            if live:
                s = sel[:live].long()
                table_t, dims_t = pack_side_table_t(state)
                out = collide_support_unified(table_t, ba[s], bb[s], dims_t,
                                              threshold, rim_axes=has_cyl)
                new_pts[s] = torch.cat([
                    out[..., :12], torch.ones(out.shape[:2] + (2,),
                                              device=dev)], dim=-1)
            continue
        # padded bucket rows produce nothing the JAX path keeps, so only the
        # live prefix is computed, in chunks
        for c0 in range(0, live, CHUNK):
            s = sel[c0:min(live, c0 + CHUNK)].long()
            a = ba[s]
            b = bb[s]
            sw = swap[s]
            ka = torch.where(sw, b, a)
            kb = torch.where(sw, a, b)
            A = side_from_packed(packed[ka], dims)
            B = side_from_packed(packed[kb], dims)
            res = _run_bucket(bucket, A, B, threshold, has_cyl)
            if bucket == B_PLANE:
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
            ones = torch.ones(pv.shape + (2,), device=dev)
            blk = torch.cat([
                pa, pb, nr, at.to(torch.float32)[..., None],
                res.distance[..., None], pv.to(torch.float32)[..., None],
                ones], dim=-1)
            new_pts[s] = blk
    new_pts = new_pts[:M]

    # rolling analogue of the reference's rolling_tag
    st = state.shape_type
    rolling = ((st == S.SPHERE) | (st == S.CAPSULE) | (st == S.CYLINDER)) \
        & state.is_dynamic
    org = state.origin_pos()
    new_attach = new_pts[..., 9].to(torch.int32)
    new_normal = new_pts[..., 6:9]
    orn_a = state.orn[ba][:, None, :]
    orn_b = state.orn[bb][:, None, :]
    local_n = torch.where(
        (new_attach == 1)[..., None], quat.rotate_inv(orn_a, new_normal),
        torch.where((new_attach == 2)[..., None],
                    quat.rotate_inv(orn_b, new_normal), new_normal))
    pose = (org[ba], orn_a[:, 0], state.angvel[ba], rolling[ba],
            org[bb], orn_b[:, 0], state.angvel[bb], rolling[bb])
    # device branch (narrowphase.py:397 in the JAX package): the merge width
    # ladder gives identical numbers in every tier, so the full width runs
    merged = merge_points(man, new_pts[..., 0:3], new_pts[..., 3:6], local_n,
                          new_attach, new_pts[..., 10], new_pts[..., 11] > 0.5,
                          pose=pose, dt=dt, scales=new_pts[..., 12:14])
    # frozen pairs keep their points verbatim
    fr = frozen & man.valid
    fields = ("point_valid", "pivot_a", "pivot_b", "local_normal",
              "normal_attachment", "distance", "lifetime", "normal_impulse",
              "friction_impulse", "spin_impulse", "roll_impulse",
              "friction_scale", "restitution_scale")

    def keep_frozen(f):
        old, new = getattr(man, f), getattr(merged, f)
        return torch.where(fr.reshape(fr.shape + (1,) * (old.dim() - 1)),
                           old, new)

    man = dataclasses.replace(merged, **{f: keep_frozen(f) for f in fields})
    return man, dropped
