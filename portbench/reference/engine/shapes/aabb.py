"""Batched world-space AABBs over the unified convex table (counterpart of
``edyn_tpu/shapes/aabb.py``; reference: include/edyn/util/aabb_util.hpp).
Planes get a world-sized slab, meshes their baked object-space bounds
transformed."""
from __future__ import annotations

import torch

from ..math import quat
from .params import ShapeType

AABB_MARGIN = 0.01
PLANE_EXTENT = 1e6
BIG = 1e30


def compute_aabbs(shape_type, pos, orn, convex_table, shape_index=None,
                  mesh_table=None, margin=AABB_MARGIN):
    """Returns (aabb_min [N,3], aabb_max [N,3]); ``pos`` is the shape
    origin. The convex table may carry rows past the N bodies (compound
    children): the body rows are its first N."""
    st = shape_type[..., None]
    cx = convex_table
    N = pos.shape[0]
    vw = quat.rotate(orn[..., None, :], cx.verts[:N]) + pos[..., None, :]
    vmask = cx.vert_mask[:N][..., None]
    radius = cx.radius[:N]
    big = torch.full_like(vw, BIG)
    amin = torch.amin(torch.where(vmask, vw, big), dim=-2) - radius[..., None]
    amax = torch.amax(torch.where(vmask, vw, -big), dim=-2) + radius[..., None]
    # cylinder cap discs: a disc of radius disc_r with world axis w extends
    # disc_r*sqrt(1-w_k^2) along coordinate axis k
    disc_r = cx.disc_r[:N]
    w_ax = quat.rotate(orn, cx.disc_axis[:N])
    disc_ext = disc_r[..., None] * torch.sqrt(
        torch.clamp(1.0 - w_ax * w_ax, 0.0, 1.0))
    amin = amin - disc_ext
    amax = amax + disc_ext
    has_cloud = torch.any(cx.vert_mask[:N], dim=-1)[..., None]
    amin = torch.where(has_cloud, amin, pos)
    amax = torch.where(has_cloud, amax, pos)
    is_plane = st == ShapeType.PLANE
    amin = torch.where(is_plane, pos - PLANE_EXTENT, amin)
    amax = torch.where(is_plane, pos + PLANE_EXTENT, amax)
    if mesh_table is not None and mesh_table.aabb.shape[0] > 0:
        mi = torch.clamp(shape_index.long(), 0, mesh_table.aabb.shape[0] - 1)
        mb = mesh_table.aabb[mi]                            # [N,2,3]
        # corner c takes the high bound on axis k where bit k of c is set
        # (made on the device: no host copy in the step)
        bit = torch.arange(3, device=pos.device)
        high = ((torch.arange(8, device=pos.device)[:, None] >> bit)
                & 1).bool()                                 # [8,3]
        corners = torch.where(high, mb[:, None, 1, :],
                              mb[:, None, 0, :])            # [N,8,3]
        R = quat.to_matrix(orn)
        w = torch.einsum("...ij,...cj->...ci", R, corners) + pos[..., None, :]
        is_mesh = ((shape_type == ShapeType.MESH)
                   | (shape_type == ShapeType.PAGED_MESH))[..., None]
        amin = torch.where(is_mesh, torch.amin(w, dim=-2), amin)
        amax = torch.where(is_mesh, torch.amax(w, dim=-2), amax)
    return amin - margin, amax + margin
