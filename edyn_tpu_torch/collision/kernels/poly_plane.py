"""Polyhedron against plane (counterpart of
``edyn_tpu/collision/kernels/poly_plane.py``; reference:
src/edyn/collision/collide/collide_polyhedron_plane.cpp): the vertices
below the plane are candidates, reduced to the best 4. Plain PyTorch; no
bucket of the step reaches it."""
from __future__ import annotations

import torch

from ...math import quat, vec
from .common import ATTACH_B, gather_points, make_result, reduce_to_4
from .support import Side


def collide_polyhedron_plane(A: Side, B: Side, threshold):
    n = quat.rotate(B.orn, B.params[:, :3])
    c = B.params[:, 3] + vec.dot(n, B.pos)
    vw = quat.rotate(A.orn[:, None, :], A.verts) + A.pos[:, None, :]
    dist = vec.dot(vw, n[:, None, :]) - c[:, None]
    cand_valid = A.vert_mask & (dist < threshold)
    idx, pv = reduce_to_4(vw, dist, cand_valid)
    pa_w = gather_points(vw, idx)
    d4 = gather_points(dist, idx)
    pb_w = pa_w - n[:, None, :] * d4[..., None]
    return make_result(A.pos, A.orn, B.pos, B.orn, pa_w, pb_w,
                       n[:, None, :], d4, pv,
                       torch.full(d4.shape, ATTACH_B, dtype=torch.int32,
                                  device=d4.device), threshold)
