"""Contact-manifold persistence and point merging (counterpart of
``edyn_tpu/collision/manifold.py``; reference:
src/edyn/util/collision_util.cpp:158-438).

``update_slots`` reconciles the slot-stable manifold table with this step's
sorted pair list; ``merge_points`` merges fresh narrowphase points into the
carried manifolds with the reference's retention semantics.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import (
    CONTACT_BREAKING_THRESHOLD, CONTACT_CACHING_THRESHOLD,
    CONTACT_MERGING_THRESHOLD,
)
from ..core.state import INVALID_KEY, ContactTable
from ..math import quat as _q
from ..math import vec
from ..utils.profile import host
from .broadphase import compact


def set_drop(x, idx, val):
    """``x.at[idx].set(val, mode="drop")``: indices >= len(x) are routed to
    one scratch row and sliced off."""
    M = x.shape[0]
    ext = torch.cat([x, x[:1]])
    ext[torch.clamp(idx.long(), max=M)] = val
    return ext[:M]


def update_slots(old: ContactTable, keys, body_a, body_b, pair_valid):
    """Returns ``(table, dropped_slots [M] bool, n_dropped int, same bool)``.
    Surviving pairs keep their slot, new pairs take freed slots (both in
    ascending order), vanished pairs are invalidated. ``same`` is True when
    the pair list equals last step's, and then the table is returned as it
    is."""
    M = old.key.shape[0]
    P = keys.shape[0]
    dev = keys.device
    body_a = body_a.to(torch.int32)
    body_b = body_b.to(torch.int32)

    same_t = torch.all(keys == old.sort_key[:P]) \
        & torch.all(pair_valid == old.sort_pvalid[:P])
    if P < M:
        same_t &= torch.all(old.sort_key[P:] == INVALID_KEY)
    # device branch (manifold.py:114 in the JAX package): host-synced here
    same = host("manifold.same", bool(same_t))
    if same:
        return old, torch.zeros((M,), dtype=torch.bool, device=dev), 0, True

    idx = torch.searchsorted(old.sort_key, keys, side="left")
    idxc = torch.clamp(idx, 0, M - 1)
    slot_m = old.sort_slot[idxc]
    found = (old.sort_key[idxc] == keys) & pair_valid & (slot_m < M)
    slot_mc = torch.where(found, slot_m, torch.zeros_like(slot_m)).long()
    matched = found & old.valid[slot_mc]
    slot_mc = torch.where(matched, slot_mc, torch.zeros_like(slot_mc))

    keep = torch.zeros((M,), dtype=torch.bool, device=dev)
    keep[slot_mc[matched]] = True
    host("manifold.keep", n=2)      # a mask index and the scalar's copy
    dropped_slots = old.valid & ~keep

    is_new = pair_valid & ~matched
    new_rank = torch.cumsum(is_new.to(torch.int32), 0) - 1
    free_slot, free_cnt = compact(~keep, M)
    slot_n = free_slot[torch.clamp(new_rank, 0, M - 1).long()]
    alloc = is_new & (new_rank < free_cnt) & (slot_n >= 0)
    n_dropped = host("manifold.dropped", int(is_new.sum())
                     - int(alloc.sum()), n=2)

    written = matched | alloc
    slot_new = torch.clamp(slot_n, 0, M - 1).long()
    slot_w = torch.where(matched, slot_mc,
                         torch.where(alloc, slot_new,
                                     torch.full_like(slot_mc, M)))
    slot_w = torch.where(written, slot_w, torch.full_like(slot_w, M))

    def padM(x, fill):
        if x.shape[0] == M:
            return x
        return torch.cat([x, torch.full((M - x.shape[0],), fill,
                                        dtype=x.dtype, device=dev)])

    tab = dataclasses.replace(
        old,
        key=set_drop(old.key, slot_w, keys),
        body_a=set_drop(old.body_a, slot_w, body_a),
        body_b=set_drop(old.body_b, slot_w, body_b),
        valid=set_drop(keep, slot_w, written),
        point_valid=old.point_valid & keep[:, None],
        sort_key=padM(keys, INVALID_KEY),
        sort_slot=padM(slot_w.to(torch.int32), M),
        sort_pvalid=padM(pair_valid, False),
    )
    return tab, dropped_slots, n_dropped, False


def _manifold_score(p0, p1, p2, p3):
    """Patch-area proxy of 4 points (reference: geom.cpp:847-855)."""
    c0 = vec.cross(p0 - p1, p0 - p2)
    c1 = vec.cross(p0 - p2, p0 - p3)
    c2 = vec.cross(p0 - p3, p0 - p1)
    c3 = vec.cross(p1 - p2, p2 - p3)
    return (vec.length_sqr(c0) + vec.length_sqr(c1)
            + vec.length_sqr(c2) + vec.length_sqr(c3))


def merge_points(man: ContactTable, new_pivot_a, new_pivot_b,
                 new_local_normal, new_attachment, new_distance,
                 new_point_valid, pose, dt: float, scales) -> ContactTable:
    """Merge fresh points into the carried manifolds (reference
    process_collision, collision_util.hpp:105-276, batched): nearest-match
    existing -> fresh within the caching threshold (rolling bodies also by
    back-rotated pivots); unmatched points kept until they break; leftover
    fresh points merge, append or replace by manifold area."""
    cache2 = CONTACT_CACHING_THRESHOLD * CONTACT_CACHING_THRESHOLD
    merge2 = CONTACT_MERGING_THRESHOLD * CONTACT_MERGING_THRESHOLD
    break_thr = CONTACT_BREAKING_THRESHOLD
    inf = float("inf")

    ov = man.point_valid                          # [M,O]
    nv = new_point_valid & man.valid[:, None]     # [M,N]
    M, O = ov.shape
    Nn = nv.shape[1]
    dev = ov.device
    ar_n = torch.arange(Nn, device=dev)
    ar_o = torch.arange(O, device=dev)

    da = torch.sum((man.pivot_a[:, :, None, :]
                    - new_pivot_a[:, None, :, :]) ** 2, -1)
    db = torch.sum((man.pivot_b[:, :, None, :]
                    - new_pivot_b[:, None, :, :]) ** 2, -1)
    d2 = torch.minimum(da, db)                    # [M,O,N]
    pairable = ov[:, :, None] & nv[:, None, :]
    infs = torch.full_like(d2, inf)
    d2_direct = torch.where(pairable & (d2 < cache2), d2, infs)

    pos_a, orn_a, angvel_a, rolling_a, pos_b, orn_b, angvel_b, rolling_b = pose
    d2_roll = infs
    for pos, orn, w, rolling, old_piv, new_piv in (
            (pos_a, orn_a, angvel_a, rolling_a, man.pivot_a, new_pivot_a),
            (pos_b, orn_b, angvel_b, rolling_b, man.pivot_b, new_pivot_b)):
        prev_orn = _q.integrate(orn, w, -dt)
        prev_w = pos[:, None, :] + _q.rotate(prev_orn[:, None, :], old_piv)
        new_w = pos[:, None, :] + _q.rotate(orn[:, None, :], new_piv)
        dr = torch.sum((prev_w[:, :, None, :] - new_w[:, None, :, :]) ** 2, -1)
        dr = torch.where(pairable & (dr < cache2) & rolling[:, None, None],
                         dr, infs)
        d2_roll = torch.minimum(d2_roll, dr)
    has_direct = torch.any(torch.isfinite(d2_direct), dim=-1, keepdim=True)
    d2_eff = torch.where(has_direct, d2_direct, d2_roll)

    nearest_d2, nearest_n = torch.min(d2_eff, dim=-1)             # [M,O]
    claims = torch.isfinite(nearest_d2)
    near_oh = nearest_n[:, :, None] == ar_n[None, None, :]

    match_mat = claims[:, :, None] & near_oh                      # [M,O,N]
    cost = torch.where(match_mat, d2_eff, infs)
    cost_min, winner_o = torch.min(cost, dim=1)                   # [M,N]
    won = torch.isfinite(cost_min)
    winner_at_nearest = torch.sum(
        torch.where(near_oh, winner_o[:, None, :],
                    torch.zeros_like(winner_o[:, None, :])), dim=-1)
    matched = claims & (winner_at_nearest == ar_o[None, :])

    f = lambda x: x.to(new_pivot_a.dtype)[..., None]
    new_geom = torch.cat([
        new_pivot_a, new_pivot_b, new_local_normal,
        f(new_attachment), f(new_distance), scales], dim=-1)     # [M,N,13]
    old_geom = torch.cat([
        man.pivot_a, man.pivot_b, man.local_normal,
        f(man.normal_attachment), f(man.distance),
        man.friction_scale[..., None],
        man.restitution_scale[..., None]], dim=-1)               # [M,O,13]
    adopted = torch.sum(torch.where(near_oh[..., None],
                                    new_geom[:, None, :, :],
                                    torch.zeros_like(new_geom[:, None])),
                        dim=2)
    geom = torch.where(matched[..., None], adopted, old_geom)

    # keep-or-break unmatched existing points
    piv_a = geom[..., 0:3]
    piv_b = geom[..., 3:6]
    ln = geom[..., 6:9]
    att = geom[..., 9].to(torch.int32)
    pA_w = pos_a[:, None, :] + _q.rotate(orn_a[:, None, :], piv_a)
    pB_w = pos_b[:, None, :] + _q.rotate(orn_b[:, None, :], piv_b)
    n_w = torch.where((att == 1)[..., None], _q.rotate(orn_a[:, None, :], ln),
                      torch.where((att == 2)[..., None],
                                  _q.rotate(orn_b[:, None, :], ln), ln))
    d = pA_w - pB_w
    nd = torch.sum(d * n_w, -1)
    tang2 = torch.sum((d - nd[..., None] * n_w) ** 2, -1)
    breaking = (nd > break_thr) | (tang2 > break_thr * break_thr)
    keep = ov & (matched | ~breaking)
    geom = geom.clone()
    geom[..., 10] = torch.where(matched, geom[..., 10], nd)

    lifetime = torch.where(keep, man.lifetime + 1,
                           torch.zeros_like(man.lifetime))
    imp = torch.cat([
        f(man.normal_impulse), man.friction_impulse,
        f(man.spin_impulse), man.roll_impulse], dim=-1)          # [M,O,6]
    imp = torch.where(keep[..., None], imp, torch.zeros_like(imp))
    valid = keep

    for j in range(Nn):
        want = nv[:, j] & ~won[:, j]
        pj_geom = new_geom[:, j]
        pj_a = pj_geom[:, 0:3]
        ds = torch.sum((geom[..., 0:3] - pj_a[:, None, :]) ** 2, -1)
        ds = torch.where(valid, ds, torch.full_like(ds, inf))
        ds_min, sim_slot = torch.min(ds, dim=-1)
        sim_ok = want & (ds_min < merge2)
        free_slot = torch.argmin(valid.to(torch.int32), dim=-1)
        has_free = ~torch.all(valid, dim=-1)
        app_ok = want & ~sim_ok & has_free
        pts = geom[..., 0:3]
        cur = _manifold_score(pts[:, 0], pts[:, 1], pts[:, 2], pts[:, 3])
        scores = torch.stack([
            _manifold_score(*[pj_a if k == r else pts[:, k] for k in range(O)])
            for r in range(O)], dim=-1)                          # [M,O]
        best_score, rep_slot = torch.max(scores, dim=-1)
        rep_ok = want & ~sim_ok & ~has_free & (best_score > cur)

        slot = torch.where(sim_ok, sim_slot,
                           torch.where(app_ok, free_slot, rep_slot))
        doit = sim_ok | app_ok | rep_ok
        onehot = doit[:, None] & (ar_o[None, :] == slot[:, None])
        geom = torch.where(onehot[..., None], pj_geom[:, None, :], geom)
        reset = onehot & ~sim_ok[:, None]
        imp = torch.where(reset[..., None], torch.zeros_like(imp), imp)
        lifetime = torch.where(reset, torch.zeros_like(lifetime), lifetime)
        valid = valid | onehot

    return dataclasses.replace(
        man,
        point_valid=valid & man.valid[:, None],
        pivot_a=geom[..., 0:3].contiguous(),
        pivot_b=geom[..., 3:6].contiguous(),
        local_normal=geom[..., 6:9].contiguous(),
        normal_attachment=geom[..., 9].to(torch.int32),
        distance=geom[..., 10].contiguous(),
        lifetime=lifetime,
        normal_impulse=imp[..., 0].contiguous(),
        friction_impulse=imp[..., 1:3].contiguous(),
        spin_impulse=imp[..., 3].contiguous(),
        roll_impulse=imp[..., 4:6].contiguous(),
        friction_scale=geom[..., 11].contiguous(),
        restitution_scale=geom[..., 12].contiguous(),
    )
