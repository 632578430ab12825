"""Broadphase: batched AABB overlap -> padded, sorted candidate pair list.

Counterpart of the dense path of ``edyn_tpu/collision/broadphase.py``
(reference: dynamic_tree broadphase, src/edyn/collision/broadphase.cpp).
Pairs are admitted by the carried admission boxes (``bp_aabb_*``); planes
("wide" bodies) are paired through a [N, wide_cap] block with the exact
AABB-vs-halfspace test. The pair list is the first ``max_pairs`` set bits of
the row-major [narrow columns | wide columns] mask, exactly as the JAX
extraction orders them, sorted by int64 key ``a * N + b``.

``find_pairs_sweep`` is the sort-and-sweep path of the same module: bodies
sorted by box minimum along the axis of largest centre variance, each
tested against the next ``window`` bodies of that order, wide bodies as
dense rows. Both paths AND an optional user filter
``should_collide_fn(state, i_idx, j_idx) -> bool tensor`` (broadcastable
index tensors; reference: settings.should_collide_func) into their masks.
"""
from __future__ import annotations

import torch

from ..core.state import INVALID_KEY, KIND_DYNAMIC
from ..math import quat
from ..parallel.collectives import Mesh, gather, ranges, replicas
from ..shapes.params import ShapeType
from ..utils.profile import host

PLANE_PAIR_MARGIN = 0.05
ROW_BLOCK = 2048  # mask rows built at a time (bounds the [B, N] temporaries)
# The JAX package's key bound (uint32 keys), kept so that the "auto" mode
# picks what the JAX package picks; the port's int64 keys have no such limit.
MAX_BODIES_FOR_KEYS = 65536
SWEEP_BLOCK = 1 << 22  # window entries built at a time by the sweep
DENSE_LIMIT = MAX_BODIES_FOR_KEYS


def pack_keys(a, b, N: int, ok):
    """int64 pair key a*N+b where ok, else INVALID_KEY."""
    k = a.to(torch.int64) * N + b.to(torch.int64)
    return torch.where(ok, k, torch.full_like(k, INVALID_KEY))


def compact(flat_mask, size: int):
    """Indices of set bits, ascending, padded with -1 to ``size``; and the
    count of set bits (which may exceed ``size``)."""
    idx = host("broadphase.compact",
               torch.nonzero(flat_mask)).flatten().to(torch.int32)
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


def _check_capacity(N: int):
    assert N <= MAX_BODIES_FOR_KEYS, \
        f"pair keys: capacity {N} > {MAX_BODIES_FOR_KEYS}"


def find_pairs(state, max_pairs: int, wide_cap: int = 64,
               should_collide_fn=None, mesh: Mesh | None = None):
    """Returns (keys [max_pairs] int64 ascending, body_a, body_b, valid,
    dropped). ``dropped`` is a host int: set bits beyond ``max_pairs`` plus
    wide bodies beyond ``wide_cap``. Over a ``mesh`` each shard builds the
    mask rows of its contiguous range of bodies on its device; their set
    bits, concatenated in shard order, are those of one shard over all
    rows."""
    N = state.capacity
    _check_capacity(N)
    dev = state.device
    mesh = mesh or Mesh((dev,))
    states = replicas(state, mesh)
    parts = []
    for s, (n0, n1) in enumerate(ranges(N, mesh.size)):
        with mesh.scope(s):
            parts.append(_mask_rows(states[s], n0, n1, wide_cap,
                                    should_collide_fn))
    rows = gather([p[0] for p in parts], dev)
    cols = gather([p[1] for p in parts], dev)
    wj_ids, wcnt = parts[0][2].to(dev), parts[0][3]
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
    valid, body_a, body_b = _decode_excluded(state, keys)
    return keys, body_a, body_b, valid, dropped


def _mask_rows(state, n0: int, n1: int, wide_cap: int, should_collide_fn):
    """The set bits of rows ``n0:n1`` of the [narrow | wide] pair mask, row
    major: (rows, cols, the wide bodies' ids, their count)."""
    N = state.capacity
    dev = state.device
    idx = torch.arange(N, device=dev)
    validb = state.valid & (state.shape_type != ShapeType.NONE)
    wide = validb & (state.shape_type == ShapeType.PLANE)
    narrow = validb & ~wide

    wloc, wcnt = compact(wide, wide_cap)
    wj_ids = torch.where(wloc >= 0, wloc, torch.zeros_like(wloc)).long()
    wok = wloc >= 0

    rows, cols = [idx[:0]], [idx[:0]]
    for r0 in range(n0, n1, ROW_BLOCK):
        ib = idx[r0:min(r0 + ROW_BLOCK, n1)]
        i2 = ib[:, None]
        m = _pair_filters_elt(state, i2, idx[None, :])
        m &= narrow[ib][:, None] & narrow[None, :]
        m &= i2 < idx[None, :]
        if should_collide_fn is not None:
            m &= should_collide_fn(state, i2, idx[None, :])
        m &= _overlap_boxes(state, i2, idx[None, :])
        jw = wj_ids[None, :]
        mw = wok[None, :] & _pair_filters_elt(state, i2, jw)
        mw &= narrow[ib][:, None] | (wide[ib][:, None] & (i2 < jw))
        if should_collide_fn is not None:
            mw &= should_collide_fn(state, i2, jw)
        mw &= _overlap_elt(state, i2, jw)
        nz = host("broadphase.dense_pairs",
                  torch.nonzero(torch.cat([m, mw], dim=1)))
        rows.append(nz[:, 0] + r0)
        cols.append(nz[:, 1])
    return torch.cat(rows), torch.cat(cols), wj_ids, wcnt


def _decode_excluded(state, keys):
    """``decode_keys`` with the exclusion lists applied post-compaction."""
    valid, body_a, body_b = decode_keys(keys, state.capacity)
    ex_a = state.exclusions[body_a.long()]
    excluded = torch.any(ex_a == body_b[:, None], dim=-1)
    return valid & ~excluded, body_a, body_b


def find_pairs_sweep(state, max_pairs: int, window: int = 128,
                     wide_cap: int = 64, should_collide_fn=None):
    """Sort-and-sweep broadphase (counterpart of the JAX package's
    ``find_pairs_sweep``). Bodies are sorted by admission-box minimum along
    the axis of largest centre variance (a stable sort, as ``jnp.argsort``
    is, so bodies with equal minima keep index order and fall into the
    same windows); each tests the next ``window`` bodies of that order.
    Wide bodies (planes always; others whose extent on the axis exceeds a
    quarter of the non-plane span) are up to ``wide_cap`` dense rows
    against every body, wide-wide pairs kept once by index order.

    Returns (keys sorted ascending, body_a, body_b, valid, dropped,
    alarms): ``dropped`` as ``find_pairs``; ``alarms`` (a host int) counts
    bodies whose axis overlap continues past the window, a conservative
    alarm that is not a definite drop."""
    N = state.capacity
    _check_capacity(N)
    dev = state.device
    W = min(window, max(N - 1, 1))
    amin, amax = state.bp_aabb_min, state.bp_aabb_max
    validb = state.valid & (state.shape_type != ShapeType.NONE)

    # axis: largest variance of the box centres of valid bodies (first
    # index among equal variances, as jnp.argmax)
    cen = 0.5 * (amin + amax)
    nv = max(host("sweep.valid_count", int(validb.sum())), 1)
    zero = torch.zeros_like(cen)
    mean = torch.sum(torch.where(validb[:, None], cen, zero), 0) / nv
    var = torch.sum(torch.where(validb[:, None], (cen - mean) ** 2, zero), 0)
    ax = host("sweep.axis", int(torch.argmax(var)))
    smin, smax = amin[:, ax], amax[:, ax]

    inf = torch.full_like(smin, float("inf"))
    is_plane = state.shape_type == ShapeType.PLANE
    span_b = validb & ~is_plane
    lo_w = torch.min(torch.where(span_b, smin, inf))
    hi_w = torch.max(torch.where(span_b, smax, -inf))
    span = torch.clamp(hi_w - lo_w, min=1e-6)
    wide = validb & (is_plane | ((smax - smin) > 0.25 * span))
    narrow = validb & ~wide

    skey = torch.where(narrow, smin, inf)
    order = torch.argsort(skey, stable=True)
    os_min = skey[order]
    os_max = torch.where(narrow[order], smax[order], -inf)

    # windowed scan in sweep order, in blocks of sorted positions; the
    # mask's row-major order is the JAX package's [N, W] order. Both
    # bodies of a set bit are narrow, and planes are always wide, so the
    # box test is the whole overlap test here.
    koff = torch.arange(1, W + 1, device=dev)
    rows, cols = [], []
    block = max(1, SWEEP_BLOCK // W)
    for r0 in range(0, N, block):
        pos = torch.arange(r0, min(N, r0 + block), device=dev)
        nbr = pos[:, None] + koff[None, :]
        nbr_c = torch.clamp(nbr, max=N - 1)
        i2 = order[pos][:, None]
        j2 = order[nbr_c]
        m = (nbr < N) & (os_min[nbr_c] <= os_max[pos][:, None])
        m &= _pair_filters_elt(state, i2, j2)
        m &= _overlap_boxes(state, i2, j2)
        if should_collide_fn is not None:
            m &= should_collide_fn(state, i2, j2)
        nz = host("sweep.pairs", torch.nonzero(m))
        rows.append(nz[:, 0] + r0)
        cols.append(nz[:, 1])
    rows = torch.cat(rows)
    cols = torch.cat(cols)

    # beyond-window alarm: the (W+1)-th body still overlaps on the axis
    pos = torch.arange(N, device=dev)
    beyond = torch.clamp(pos + W + 1, max=N - 1)
    alarms = host("sweep.alarms", int(
        ((os_min[beyond] <= os_max) & (pos + W + 1 < N)).sum()))

    # wide rows: dense against every body; wide-wide pairs by index order
    wloc, wcnt = compact(wide, wide_cap)
    wi = torch.where(wloc >= 0, wloc, torch.zeros_like(wloc)).long()
    iw = wi[:, None]
    jw = pos[None, :]
    mw = (wloc >= 0)[:, None] & _pair_filters_elt(state, iw, jw)
    mw &= _overlap_elt(state, iw, jw)
    mw &= ~wide[None, :] | (jw > iw)
    if should_collide_fn is not None:
        mw &= should_collide_fn(state, iw, jw)
    nzw = host("sweep.wide_pairs", torch.nonzero(mw))

    # the first max_pairs set bits of [narrow block | wide block]
    a_ = torch.cat([order[rows], wi[nzw[:, 0]]])
    b_ = torch.cat([order[rows + 1 + cols], nzw[:, 1]])
    total = a_.shape[0]
    a_, b_ = a_[:max_pairs], b_[:max_pairs]
    keys = torch.full((max_pairs,), INVALID_KEY, dtype=torch.int64,
                      device=dev)
    keys[:a_.shape[0]] = pack_keys(torch.minimum(a_, b_),
                                   torch.maximum(a_, b_), N,
                                   torch.ones_like(a_, dtype=torch.bool))
    keys = torch.sort(keys, stable=True).values
    dropped = max(total - max_pairs, 0) + max(wcnt - wide_cap, 0)
    valid, body_a, body_b = _decode_excluded(state, keys)
    return keys, body_a, body_b, valid, dropped, alarms


def decode_keys(keys, N: int):
    """(valid, body_a, body_b) of sorted int64 keys."""
    valid = keys != INVALID_KEY
    zero = torch.zeros_like(keys)
    body_a = torch.where(valid, keys // N, zero).to(torch.int32)
    body_b = torch.where(valid, keys % N, zero).to(torch.int32)
    return valid, body_a, body_b
