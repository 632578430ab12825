"""Broadphase: batched AABB overlap -> padded, sorted candidate pair list.

Counterpart of the dense path of ``edyn_tpu/collision/broadphase.py``
(reference: dynamic_tree broadphase, src/edyn/collision/broadphase.cpp).
Pairs are admitted by the carried admission boxes (``bp_aabb_*``); planes
("wide" bodies) are paired through a [N, wide_cap] block with the exact
AABB-vs-halfspace test. The pair list is the first ``max_pairs`` set bits of
the row-major [narrow columns | wide columns] mask, exactly as the JAX
extraction orders them, sorted by int64 key ``a * N + b``.

The sweep path (``find_pairs_sweep``) waits for a later slice: the dense
mask covers the main path's sizes.
"""
from __future__ import annotations

import torch

from ..core.state import INVALID_KEY, KIND_DYNAMIC
from ..math import quat
from ..shapes.params import ShapeType

PLANE_PAIR_MARGIN = 0.05
ROW_BLOCK = 2048  # mask rows built at a time (bounds the [B, N] temporaries)


def pack_keys(a, b, N: int, ok):
    """int64 pair key a*N+b where ok, else INVALID_KEY."""
    k = a.to(torch.int64) * N + b.to(torch.int64)
    return torch.where(ok, k, torch.full_like(k, INVALID_KEY))


def compact(flat_mask, size: int):
    """Indices of set bits, ascending, padded with -1 to ``size``; and the
    count of set bits (which may exceed ``size``)."""
    idx = torch.nonzero(flat_mask).flatten().to(torch.int32)
    count = idx.shape[0]
    out = torch.full((size,), -1, dtype=torch.int32, device=flat_mask.device)
    n = min(count, size)
    out[:n] = idx[:n]
    return out, count


def _pair_filters_elt(state, i, j):
    """should_collide_default minus exclusions, for broadcastable index
    tensors."""
    valid = state.valid & (state.shape_type != ShapeType.NONE)
    dyn = state.kind == KIND_DYNAMIC
    m = valid[i] & valid[j]
    m &= i != j
    m &= dyn[i] | dyn[j]
    m &= ((state.group[i] & state.mask[j]) != 0) \
        & ((state.group[j] & state.mask[i]) != 0)
    return m


def _overlap_boxes(state, i, j):
    amin, amax = state.bp_aabb_min, state.bp_aabb_max
    o = torch.all(amin[i] <= amax[j], dim=-1)
    o &= torch.all(amax[i] >= amin[j], dim=-1)
    return o


def _overlap_elt(state, i, j):
    """Box overlap, with the plane's slab test replaced by the exact
    AABB-vs-halfspace predicate on either side."""
    amin, amax = state.bp_aabb_min, state.bp_aabb_max
    o = _overlap_boxes(state, i, j)

    def plane_clip(o, p, other):
        is_p = state.shape_type[p] == ShapeType.PLANE
        prm = state.shape_params[p]
        n = quat.rotate(state.orn[p], prm[..., 0:3])
        opos = state.pos[p] - quat.rotate(state.orn[p], state.com[p])
        c = prm[..., 3] + torch.sum(n * opos, -1)
        lo = torch.sum(torch.minimum(amin[other] * n, amax[other] * n), -1)
        return o & (~is_p | (lo <= c + PLANE_PAIR_MARGIN))

    o = plane_clip(o, i, j)
    o = plane_clip(o, j, i)
    return o


def find_pairs(state, max_pairs: int, wide_cap: int = 64):
    """Returns (keys [max_pairs] int64 ascending, body_a, body_b, valid,
    dropped). ``dropped`` is a host int: set bits beyond ``max_pairs`` plus
    wide bodies beyond ``wide_cap``."""
    N = state.capacity
    dev = state.device
    idx = torch.arange(N, device=dev)
    validb = state.valid & (state.shape_type != ShapeType.NONE)
    wide = validb & (state.shape_type == ShapeType.PLANE)
    narrow = validb & ~wide

    wloc, wcnt = compact(wide, wide_cap)
    wj_ids = torch.where(wloc >= 0, wloc, torch.zeros_like(wloc)).long()
    wok = wloc >= 0

    rows, cols = [], []
    for r0 in range(0, N, ROW_BLOCK):
        ib = idx[r0:r0 + ROW_BLOCK]
        i2 = ib[:, None]
        m = _pair_filters_elt(state, i2, idx[None, :])
        m &= narrow[ib][:, None] & narrow[None, :]
        m &= i2 < idx[None, :]
        m &= _overlap_boxes(state, i2, idx[None, :])
        jw = wj_ids[None, :]
        mw = wok[None, :] & _pair_filters_elt(state, i2, jw)
        mw &= narrow[ib][:, None] | (wide[ib][:, None] & (i2 < jw))
        mw &= _overlap_elt(state, i2, jw)
        nz = torch.nonzero(torch.cat([m, mw], dim=1))
        rows.append(nz[:, 0] + r0)
        cols.append(nz[:, 1])
    rows = torch.cat(rows)
    cols = torch.cat(cols)
    total = rows.shape[0]
    rows = rows[:max_pairs]
    cols = cols[:max_pairs]
    j_col = torch.where(cols < N, cols,
                        wj_ids[torch.clamp(cols - N, 0, wide_cap - 1)])
    lo_ab = torch.minimum(rows, j_col)
    hi_ab = torch.maximum(rows, j_col)
    keys = torch.full((max_pairs,), INVALID_KEY, dtype=torch.int64,
                      device=dev)
    keys[:rows.shape[0]] = pack_keys(lo_ab, hi_ab, N,
                                     torch.ones_like(lo_ab, dtype=torch.bool))
    keys = torch.sort(keys, stable=True).values
    dropped = max(total - max_pairs, 0) + max(wcnt - wide_cap, 0)

    valid, body_a, body_b = decode_keys(keys, N)
    # exclusion lists, post-compaction
    ex_a = state.exclusions[body_a.long()]
    excluded = torch.any(ex_a == body_b[:, None], dim=-1)
    valid &= ~excluded
    return keys, body_a, body_b, valid, dropped


def decode_keys(keys, N: int):
    """(valid, body_a, body_b) of sorted int64 keys."""
    valid = keys != INVALID_KEY
    zero = torch.zeros_like(keys)
    body_a = torch.where(valid, keys // N, zero).to(torch.int32)
    body_b = torch.where(valid, keys % N, zero).to(torch.int32)
    return valid, body_a, body_b
