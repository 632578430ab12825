"""Unified convex-vs-plane contacts (counterpart of
``edyn_tpu/collision/kernels/plane_unified.py``): cloud vertices (+radius)
and, for cylinders, 4 cap-rim candidates per cap below the plane, reduced to
the best 4. Exact for spheres, boxes, capsules, polyhedra and cylinders."""
from __future__ import annotations

import torch

from ...math import quat, vec
from .common import ATTACH_B, gather_points, make_result, reduce_to_4
from .support import Side, world_disc_axis, world_verts


def collide_convex_plane(A: Side, B: Side, threshold):
    """A = convex body, B = plane body (params = object-space normal +
    constant)."""
    K = A.pos.shape[0]
    n = quat.rotate(B.orn, B.params[:, :3])
    c = B.params[:, 3] + vec.dot(n, B.pos)
    vw = world_verts(A)
    r = A.radius[:, None]
    surf = vw - n[:, None, :] * r[..., None]

    has_disc = A.disc_r > 1e-9
    w = world_disc_axis(A)
    perp = -n - torch.sum(-n * w, -1, keepdim=True) * w
    t1, _ = vec.orthonormal_basis(w)
    e1 = vec.normalize_or(perp, t1)
    e2 = vec.cross(w, e1)
    dr = A.disc_r[:, None, None]
    rim = torch.stack([
        vw + dr * e1[:, None, :],
        vw - dr * e1[:, None, :],
        vw + dr * e2[:, None, :],
        vw - dr * e2[:, None, :],
    ], dim=2).reshape(K, -1, 3)
    rim_valid = (A.vert_mask & has_disc[:, None])[:, :, None].expand(
        -1, -1, 4).reshape(K, -1)
    cand = torch.cat([surf, rim], dim=1)
    cand_valid = torch.cat([A.vert_mask & ~has_disc[:, None], rim_valid],
                           dim=1)

    dist = vec.dot(cand, n[:, None, :]) - c[:, None]
    cand_valid = cand_valid & (dist < threshold)
    idx, pv = reduce_to_4(cand, dist, cand_valid)
    pa_w = gather_points(cand, idx)
    d4 = gather_points(dist, idx)
    pb_w = pa_w - n[:, None, :] * d4[..., None]
    return make_result(A.pos, A.orn, B.pos, B.orn, pa_w, pb_w,
                       n[:, None, :], d4, pv,
                       torch.full(d4.shape, ATTACH_B, dtype=torch.int32,
                                  device=d4.device), threshold)
