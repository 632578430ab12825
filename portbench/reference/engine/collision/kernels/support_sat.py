"""Generic support-mapped SAT for any convex pair: the UNIFIED bucket
(counterpart of ``edyn_tpu/collision/kernels/support_sat.py``; reference:
the collide_* matrix under src/edyn/collision/collide/).

1. Candidate axes: face normals of A and B, the center delta, the cylinder
   side normals, edge-direction crosses and cylinder rim axes.
2. Separation along n (B -> A): sep = -P_A(-n) - P_B(n).
3. Contact patch by support sampling along the normal tilted toward 4
   tangents; candidates outside either supporting feature's tangent slab are
   rejected (or clamped when both features are flat), then reduced to 4.

This is the port of the JAX package's jnp path, and it runs the UNIFIED
bucket on the CPU; on CUDA the bucket runs as K4
(``unified_kernel.collide_support_unified``, the counterpart of the Pallas
kernel ``collide_support_pallas``), see ``collision/narrowphase.py``.
"""
from __future__ import annotations

import torch

from ...math import vec
from .common import ATTACH_NONE, gather_points, make_result, reduce_to_4, take1
from .support import (Side, edge_dirs, face_axes, support_point,
                      support_projection, world_disc_axis, world_verts)

TILT = 0.02


def _up_like(x):
    up = torch.zeros_like(x)
    up[..., 1] = 1.0
    return up


def _masked_proj(S: Side, d):
    vw = world_verts(S)
    proj = torch.sum(vw * d[:, None, :], -1)
    return vw, torch.where(S.vert_mask, proj, torch.full_like(proj, -1e30))


def _closest_on_circle(c, w, r, x):
    u = x - c
    perp = u - torch.sum(u * w, -1, keepdim=True) * w
    t1, _ = vec.orthonormal_basis(w)
    return c + r[..., None] * vec.normalize_or(perp, t1)


def _closest_on_segment(q0, q1, x):
    d = q1 - q0
    dd = torch.sum(d * d, -1, keepdim=True)
    t = torch.clamp(torch.sum((x - q0) * d, -1, keepdim=True)
                    / torch.clamp(dd, min=1e-12), 0.0, 1.0)
    return q0 + t * d


def _top2_verts(S: Side, d):
    """The two highest-projection cloud verts along d."""
    vw, proj = _masked_proj(S, d)
    i0 = torch.argmax(proj, -1)
    ar = torch.arange(proj.shape[1], device=proj.device)[None, :]
    proj2 = torch.where(ar == i0[:, None], torch.full_like(proj, -1e30), proj)
    i1 = torch.argmax(proj2, -1)
    has2 = take1(proj2, i1) > -1e29
    q0 = take1(vw, i0)
    q1 = take1(vw, i1)
    return q0, torch.where(has2[:, None], q1, q0)


def _rim_axes(A: Side, B: Side, n_seed, iters: int = 8):
    """Cylinder rim candidate axes by alternating closest-point projection
    between the supporting rim circle and the other body's supporting
    feature (reference: closest_point_circle_line / circle_circle,
    geom.cpp:217-476). Returns (axes [K,2,3], mask [K,2])."""

    def one(C_, D_):
        wC = world_disc_axis(C_)
        vw, proj = _masked_proj(C_, -n_seed)
        cC = take1(vw, torch.argmax(proj, -1))
        rC = C_.disc_r
        d_is_disc = D_.disc_r > 1e-9
        wD = world_disc_axis(D_)
        vwd, projd = _masked_proj(D_, n_seed)
        cD = take1(vwd, torch.argmax(projd, -1))
        q0, q1 = _top2_verts(D_, n_seed)

        def closest_D(p):
            on_circ = _closest_on_circle(cD, wD, D_.disc_r, p)
            on_seg = _closest_on_segment(q0, q1, p)
            return torch.where(d_is_disc[:, None], on_circ, on_seg)

        p = _closest_on_circle(cC, wC, rC, cD)
        for _ in range(iters):
            q = closest_D(p)
            p = _closest_on_circle(cC, wC, rC, q)
        ax = p - q
        ok = (C_.disc_r > 1e-9) & (vec.length(ax) > 1e-7)
        return vec.normalize_or(ax, n_seed), ok

    ax_a, ok_a = one(A, B)
    ax_b, ok_b = one(B, A)
    return torch.stack([ax_a, ax_b], 1), torch.stack([ok_a, ok_b], 1)


def collide_support(A: Side, B: Side, threshold, axis_validity=None,
                    orient_ref=None, clamp_flat: bool = True,
                    rim_axes: bool = True):
    """The unified convex-convex contact generator.

    The mesh bucket's options: ``axis_validity(axes) -> mask`` restricts
    the admissible separating axes (Voronoi internal-edge rejection);
    ``orient_ref`` [K,3] replaces the centre delta that orients the axes
    (the one-sided surface normal, which never flips under penetration);
    ``clamp_flat=False`` rejects out-of-slab candidates instead of clamping
    them (a triangle's tangent slab is its bounding rectangle)."""
    K = A.pos.shape[0]
    dev = A.pos.device
    delta = orient_ref if orient_ref is not None else A.pos - B.pos

    fa, fam = face_axes(A, B.pos)
    fb, fbm = face_axes(B, A.pos)
    ea, eam = edge_dirs(A)
    eb, ebm = edge_dirs(B)
    cr = vec.cross(ea[:, :, None, :], eb[:, None, :, :]).reshape(K, -1, 3)
    crm = (eam[:, :, None] & ebm[:, None, :]).reshape(K, -1)
    crl = vec.length(cr)
    crm = crm & (crl > 1e-6)
    cr = cr / torch.clamp(crl, min=1e-12)[..., None]

    if rim_axes:
        seed = vec.normalize_or(delta, _up_like(delta))
        ra, ram = _rim_axes(A, B, seed)
    else:
        ra = torch.zeros((K, 0, 3), dtype=delta.dtype, device=dev)
        ram = torch.zeros((K, 0), dtype=torch.bool, device=dev)

    axes = torch.cat([fa, fb, cr, ra], dim=1)          # [K,X,3]
    amask = torch.cat([fam, fbm, crm, ram], dim=1)
    sign = torch.where(torch.sum(axes * delta[:, None, :], -1) >= 0,
                       1.0, -1.0).to(axes.dtype)
    axes = axes * sign[..., None]
    if axis_validity is not None:
        amask = amask & axis_validity(axes)

    pa_proj = -support_projection(A, -axes)
    pb_proj = support_projection(B, axes)
    sep = pa_proj - pb_proj
    sep = torch.where(amask, sep, torch.full_like(sep, -float("inf")))
    best = torch.argmax(sep, dim=-1)
    best_sep = take1(sep, best)
    n = take1(axes, best)
    plane_a = take1(pa_proj, best)
    plane_b = take1(pb_proj, best)

    def line_feature_dir(S_, d):
        vw, proj = _masked_proj(S_, d)
        maxp = torch.amax(proj, dim=-1, keepdim=True)
        feat = (proj >= maxp - 1e-3) & S_.vert_mask
        cnt = torch.sum(feat, -1)
        cen = torch.sum(torch.where(feat[..., None], vw,
                                    torch.zeros_like(vw)), 1) \
            / torch.clamp(cnt, min=1)[:, None]
        diffs = torch.where(feat[..., None], vw - cen[:, None, :],
                            torch.zeros_like(vw))
        d2 = torch.sum(diffs * diffs, -1)
        return take1(diffs, torch.argmax(d2, -1)), cnt == 2

    eA, lineA = line_feature_dir(A, -n)
    eB, lineB = line_feature_dir(B, n)
    e = torch.where(lineB[:, None], eB, eA)
    e_t = e - torch.sum(e * n, -1, keepdim=True) * n
    use_line = (lineA | lineB) & (vec.length(e_t) > 1e-6)
    t1d, t2d = vec.orthonormal_basis(n)
    t1 = torch.where(use_line[:, None], vec.normalize_or(e_t, t1d), t1d)
    t2 = torch.where(use_line[:, None], vec.cross(n, t1), t2d)
    tilts = torch.stack([torch.zeros_like(t1), t1, -t1, t2, -t2], dim=1)
    dirs_a = vec.normalize(-n[:, None, :] + TILT * tilts)
    dirs_b = vec.normalize(n[:, None, :] + TILT * tilts)

    pa_pts = support_point(A, dirs_a)              # [K,5,3]
    pb_pts = support_point(B, dirs_b)
    depth_a = torch.sum(pa_pts * n[:, None, :], -1) - plane_b[:, None]
    depth_b = plane_a[:, None] - torch.sum(pb_pts * n[:, None, :], -1)

    on_a = torch.cat([pa_pts, pb_pts + n[:, None, :] * depth_b[..., None]], 1)
    on_b = torch.cat([pa_pts - n[:, None, :] * depth_a[..., None], pb_pts], 1)
    depth = torch.cat([depth_a, depth_b], 1)
    valid = depth < threshold
    valid = valid & (best_sep < threshold)[:, None]

    tol = 5e-3
    FEAT_TOL = 1e-3

    def flat_feature(S_, d):
        _, proj = _masked_proj(S_, d)
        maxp = torch.amax(proj, dim=-1, keepdim=True)
        cnt = torch.sum(proj >= maxp - FEAT_TOL, dim=-1)
        cap_face = (S_.disc_r > 1e-9) & \
            (torch.abs(torch.sum(world_disc_axis(S_) * d, -1)) > 0.99)
        return (S_.radius < 1e-9) & ((cnt >= 2) | cap_face)

    def feature_slab(S_, d, t):
        vw, proj = _masked_proj(S_, d)
        maxp = torch.amax(proj, dim=-1, keepdim=True)
        feat = proj >= maxp - FEAT_TOL
        vt = torch.sum(vw * t[:, None, :], -1)
        base_lo = torch.amin(torch.where(feat, vt, torch.full_like(vt, 1e30)),
                             -1)
        base_hi = torch.amax(torch.where(feat, vt,
                                         torch.full_like(vt, -1e30)), -1)
        off = S_.radius * torch.sum(d * t, -1)
        w = world_disc_axis(S_)
        dw = torch.sum(d * w, -1)
        perp = d - dw[:, None] * w
        plen = vec.length(perp)
        cap = torch.abs(dw) > 0.99
        tw = t - torch.sum(t * w, -1, keepdim=True) * w
        disc_span = S_.disc_r * vec.length(tw)
        rim_off = S_.disc_r * torch.sum(perp * t, -1) \
            / torch.clamp(plen, min=1e-12)
        lo = base_lo + off + torch.where(cap, -disc_span, rim_off)
        hi = base_hi + off + torch.where(cap, disc_span, rim_off)
        return lo, hi

    if clamp_flat:
        both_flat = (flat_feature(A, -n) & flat_feature(B, n))[:, None]
    else:
        both_flat = torch.zeros((K, 1), dtype=torch.bool, device=dev)

    shift = torch.zeros_like(on_a)
    for t in (t1, t2):
        lo_a, hi_a = feature_slab(A, -n, t)
        lo_b, hi_b = feature_slab(B, n, t)
        lo = torch.maximum(lo_a, lo_b)[:, None]
        hi = torch.minimum(hi_a, hi_b)[:, None]
        hi = torch.maximum(hi, lo)
        proj = torch.sum(on_a * t[:, None, :], -1)
        inside = (proj >= lo - tol) & (proj <= hi + tol)
        valid = valid & (inside | both_flat)
        clipped = torch.minimum(torch.maximum(proj, lo), hi)
        shift = shift + torch.where(both_flat[..., None],
                                    (clipped - proj)[..., None]
                                    * t[:, None, :],
                                    torch.zeros_like(shift))
    on_a = on_a + shift
    on_b = on_b + shift
    shifted = torch.sum(shift * shift, -1) > 1e-12
    sel_depth = depth + torch.where(shifted, 1e-5, 0.0).to(depth.dtype)

    idx4, pv = reduce_to_4(on_a, sel_depth, valid)
    pa4 = gather_points(on_a, idx4)
    pb4 = gather_points(on_b, idx4)
    d4 = gather_points(depth, idx4)
    return make_result(A.pos, A.orn, B.pos, B.orn, pa4, pb4,
                       n[:, None, :], d4, pv,
                       torch.full((K, 4), ATTACH_NONE, dtype=torch.int32,
                                  device=dev), threshold)
