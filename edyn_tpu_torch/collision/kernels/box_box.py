"""Box-box SAT narrowphase, batched and branchless (counterpart of
``edyn_tpu/collision/kernels/box_box.py``; reference:
src/edyn/collision/collide/collide_box_box.cpp:16-265): 15 candidate axes,
the max-separation axis, then feature clipping over a fixed 24-candidate set
reduced to the best 4."""
from __future__ import annotations

import torch

from ...math import geom, quat, vec
from ...utils.profile import host
from .common import ATTACH_A, ATTACH_B, gather_points, make_result, \
    reduce_to_4, take1

EDGE_AXIS_BIAS = 1e-5


def _rows(x, k):
    """x [K,3,3] row k[K] -> [K,3]."""
    return take1(x, k)


def collide_box_box(pos_a, orn_a, params_a, pos_b, orn_b, params_b,
                    threshold):
    K = pos_a.shape[0]
    dev = pos_a.device
    ha = params_a[:, :3]
    hb = params_b[:, :3]
    axes_a = quat.to_matrix(orn_a).transpose(-1, -2)   # rows = world axes
    axes_b = quat.to_matrix(orn_b).transpose(-1, -2)
    t = pos_b - pos_a

    cross = vec.cross(axes_a[:, :, None, :], axes_b[:, None, :, :])
    cross = cross.reshape(K, 9, 3)
    cross_len = vec.length(cross)
    cross_ok = cross_len > 1e-6
    cross_n = cross / torch.clamp(cross_len, min=1e-12)[..., None]
    axes = torch.cat([axes_a, axes_b, cross_n], dim=1)  # [K,15,3]
    ok = torch.cat([torch.ones((K, 6), dtype=torch.bool, device=dev),
                    cross_ok], dim=1)

    tL = torch.einsum("kld,kd->kl", axes, t)
    projA = torch.einsum("kld,kid->kli", axes, axes_a)
    projB = torch.einsum("kld,kid->kli", axes, axes_b)
    extent = (torch.einsum("ki,kli->kl", ha, torch.abs(projA))
              + torch.einsum("ki,kli->kl", hb, torch.abs(projB)))
    sep = torch.abs(tL) - extent
    sep = torch.where(ok, sep, torch.full_like(sep, -float("inf")))
    sep = torch.cat([sep[:, :6], sep[:, 6:] - EDGE_AXIS_BIAS], dim=1)

    best = torch.argmax(sep, dim=-1)
    best_sep = take1(sep, best)
    L = take1(axes, best)
    tl_best = vec.dot(L, t)
    n = torch.where((tl_best > 0)[:, None], -L, L)

    is_face = best < 6
    ref_is_a = best < 3

    # =============== face case ===============
    k = torch.where(ref_is_a, best, best - 3) % 3
    ref_pos = torch.where(ref_is_a[:, None], pos_a, pos_b)
    inc_pos = torch.where(ref_is_a[:, None], pos_b, pos_a)
    ref_axes = torch.where(ref_is_a[:, None, None], axes_a, axes_b)
    inc_axes = torch.where(ref_is_a[:, None, None], axes_b, axes_a)
    ref_h = torch.where(ref_is_a[:, None], ha, hb)
    inc_h = torch.where(ref_is_a[:, None], hb, ha)
    n_out = torch.where(ref_is_a[:, None], -n, n)

    ku = (k + 1) % 3
    kv = (k + 2) % 3
    u = _rows(ref_axes, ku)
    v = _rows(ref_axes, kv)
    hk = take1(ref_h, k)
    hu = take1(ref_h, ku)
    hv = take1(ref_h, kv)
    face_center = ref_pos + n_out * hk[:, None]

    dots = torch.einsum("kid,kd->ki", inc_axes, n_out)
    j = torch.argmax(torch.abs(dots), dim=-1)
    sj = -torch.sign(take1(dots, j))
    sj = torch.where(sj == 0, torch.ones_like(sj), sj)
    inc_n = _rows(inc_axes, j) * sj[:, None]
    hj = take1(inc_h, j)
    ju = (j + 1) % 3
    jv = (j + 2) % 3
    iu = _rows(inc_axes, ju)
    iv = _rows(inc_axes, jv)
    hju = take1(inc_h, ju)
    hjv = take1(inc_h, jv)
    inc_center = inc_pos + inc_n * hj[:, None]
    corner_signs = host("box_box.corner_signs", torch.tensor(
        [[1, 1], [1, -1], [-1, -1], [-1, 1]], dtype=inc_pos.dtype,
        device=dev))
    inc_corners = (inc_center[:, None, :]
                   + iu[:, None, :] * (corner_signs[None, :, 0, None]
                                       * hju[:, None, None])
                   + iv[:, None, :] * (corner_signs[None, :, 1, None]
                                       * hjv[:, None, None]))

    rel = inc_corners - face_center[:, None, :]
    cx = torch.einsum("kcd,kd->kc", rel, u)
    cy = torch.einsum("kcd,kd->kc", rel, v)
    cz = torch.einsum("kcd,kd->kc", rel, n_out)

    tol = 1e-6
    a_valid = (torch.abs(cx) <= hu[:, None] + tol) \
        & (torch.abs(cy) <= hv[:, None] + tol)

    n_inc_ref = torch.stack([vec.dot(inc_n, u), vec.dot(inc_n, v),
                             vec.dot(inc_n, n_out)], -1)
    nz = torch.where(torch.abs(n_inc_ref[:, 2]) > 1e-6, n_inc_ref[:, 2],
                     torch.full_like(n_inc_ref[:, 2], 1e-6))
    gx = -n_inc_ref[:, 0] / nz
    gy = -n_inc_ref[:, 1] / nz

    rx = corner_signs[None, :, 0] * hu[:, None]
    ry = corner_signs[None, :, 1] * hv[:, None]
    ex = torch.roll(cx, -1, dims=1) - cx
    ey = torch.roll(cy, -1, dims=1) - cy
    px = rx[:, :, None] - cx[:, None, :]
    py = ry[:, :, None] - cy[:, None, :]
    crossz = ex[:, None, :] * py - ey[:, None, :] * px
    b_valid = torch.all(crossz >= -tol, dim=-1) \
        | torch.all(crossz <= tol, dim=-1)
    b_z = cz[:, 0:1] + gx[:, None] * (rx - cx[:, 0:1]) \
        + gy[:, None] * (ry - cy[:, 0:1])

    def side_hits(c0, e0, c1, e1, bound, other_bound):
        e0s = torch.where(torch.abs(e0) > 1e-9, e0, torch.full_like(e0, 1e-9))
        tt = torch.stack([(bound - c0) / e0s, (-bound - c0) / e0s], -1)
        bnd = bound.expand(c0.shape)
        xx = torch.stack([bnd, -bnd], -1)
        yy = c1[..., None] + tt * e1[..., None]
        valid = ((tt >= 0) & (tt <= 1)
                 & (torch.abs(yy) <= other_bound[:, None, None] + tol)
                 & (torch.abs(e0) > 1e-9)[..., None])
        return tt, xx, yy, valid

    t_u, x_u, y_u, val_u = side_hits(cx, ex, cy, ey, hu[:, None], hv)
    t_v, y_v, x_v, val_v = side_hits(cy, ey, cx, ex, hv[:, None], hu)
    c_x = torch.cat([x_u.reshape(K, 8), x_v.reshape(K, 8)], 1)
    c_y = torch.cat([y_u.reshape(K, 8), y_v.reshape(K, 8)], 1)
    t_all = torch.cat([t_u.reshape(K, 8), t_v.reshape(K, 8)], 1)
    edge_idx = torch.arange(4, device=dev).repeat_interleave(2)
    edge_idx = torch.cat([edge_idx, edge_idx])[None, :].expand(K, -1)
    z0 = torch.gather(cz, 1, edge_idx)
    z1 = torch.gather(torch.roll(cz, -1, dims=1), 1, edge_idx)
    c_z = z0 + t_all * (z1 - z0)
    c_valid = torch.cat([val_u.reshape(K, 8), val_v.reshape(K, 8)], 1)

    X = torch.cat([cx, rx, c_x], 1)                    # [K,24]
    Y = torch.cat([cy, ry, c_y], 1)
    Z = torch.cat([cz, b_z, c_z], 1)
    V = torch.cat([a_valid, b_valid, c_valid], 1)
    V = V & (Z < threshold)

    cand_world = (face_center[:, None, :] + u[:, None, :] * X[..., None]
                  + v[:, None, :] * Y[..., None]
                  + n_out[:, None, :] * Z[..., None])
    idx4, pv_face = reduce_to_4(cand_world, Z, V)
    p_inc = gather_points(cand_world, idx4)
    z4 = gather_points(Z, idx4)
    p_ref = p_inc - n_out[:, None, :] * z4[..., None]

    face_pa = torch.where(ref_is_a[:, None, None], p_ref, p_inc)
    face_pb = torch.where(ref_is_a[:, None, None], p_inc, p_ref)
    face_attach = torch.where(ref_is_a, torch.full_like(best, ATTACH_A),
                              torch.full_like(best, ATTACH_B))

    # =============== edge-edge case ===============
    ei = torch.clamp(torch.div(best - 6, 3, rounding_mode="floor"), 0, 2)
    ej = torch.clamp((best - 6) % 3, 0, 2)
    ai = _rows(axes_a, ei)
    bj = _rows(axes_b, ej)
    ar3 = torch.arange(3, device=dev)[None, :]
    sa = torch.sign(torch.einsum("kid,kd->ki", axes_a, -n))
    sa = torch.where(sa == 0, torch.ones_like(sa), sa)
    ca = pos_a + torch.einsum(
        "ki,kid->kd", torch.where(ar3 != ei[:, None], sa * ha,
                                  torch.zeros_like(ha)), axes_a)
    sb = torch.sign(torch.einsum("kid,kd->ki", axes_b, n))
    sb = torch.where(sb == 0, torch.ones_like(sb), sb)
    cb = pos_b + torch.einsum(
        "ki,kid->kd", torch.where(ar3 != ej[:, None], sb * hb,
                                  torch.zeros_like(hb)), axes_b)
    hai = take1(ha, ei)
    hbj = take1(hb, ej)
    _, _, pae, pbe, _ = geom.closest_point_segment_segment(
        ca - ai * hai[:, None], ca + ai * hai[:, None],
        cb - bj * hbj[:, None], cb + bj * hbj[:, None])
    edge_dist = vec.dot(pae - pbe, n)

    # =============== combine ===============
    is_face_ = is_face[:, None]
    z33 = torch.zeros((K, 3, 3), dtype=pae.dtype, device=dev)
    pa_w = torch.where(is_face_[..., None], face_pa,
                       torch.cat([pae[:, None], z33], 1))
    pb_w = torch.where(is_face_[..., None], face_pb,
                       torch.cat([pbe[:, None], z33], 1))
    dist = torch.where(is_face_, z4,
                       torch.cat([edge_dist[:, None],
                                  torch.zeros((K, 3), dtype=pae.dtype,
                                              device=dev)], 1))
    pv_edge = torch.zeros((K, 4), dtype=torch.bool, device=dev)
    pv_edge[:, 0] = edge_dist < threshold
    pv = torch.where(is_face_, pv_face, pv_edge)
    attach = torch.where(is_face_, face_attach[:, None],
                         torch.zeros((K, 4), dtype=best.dtype, device=dev))
    pv = pv & (best_sep < threshold)[:, None]
    return make_result(pos_a, orn_a, pos_b, orn_b, pa_w, pb_w,
                       n[:, None, :], dist, pv, attach, threshold)
