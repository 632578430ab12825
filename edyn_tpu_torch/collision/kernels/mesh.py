"""Convex shape vs static triangle mesh: the MESH bucket (counterpart of
``edyn_tpu/collision/kernels/mesh.py``; reference: the *_mesh collide
kernels under src/edyn/collision/collide/, with Voronoi-region
internal-edge rejection).

Each (convex body, mesh) pair gathers its ``CAP`` candidate triangles from
the baked cell grid (``shapes/mesh.py``), every triangle becomes a
3-vertex cloud Side, and the support-mapped SAT (``support_sat``) runs over
the flattened [K*CAP] (body, triangle) pairs; the candidates fold back to
<= 4 points per pair. Plain PyTorch on every device: the JAX package
computes this bucket in XLA, with no Pallas kernel.

Internal-edge rejection happens before axis selection: a candidate axis is
admissible only inside the Voronoi wedge of the triangle feature it
selects (face: the triangle normal; edge: up to the adjacent face's
normal; vertex: the loosest of its edges), so SAT cannot pick a lone
triangle's axis across an interior edge of the surface.
"""
from __future__ import annotations

import torch

from ...math import quat, vec
from ...shapes.mesh import candidate_tris
from .common import ContactResult, gather_points, reduce_to_4
from .support import Side, side_map
from .support_sat import collide_support

VORONOI_TOL = 0.01
FACE_COS = 0.999


def _edge_dirs(tv):
    """[F,3,3] triangle verts -> [F,3,3] unit edge directions."""
    e = torch.stack([tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 1],
                     tv[:, 0] - tv[:, 2]], dim=1)
    return e / torch.clamp(torch.linalg.vector_norm(e, dim=-1, keepdim=True),
                           min=1e-12)


def collide_convex_mesh(A: Side, B: Side, threshold, mesh_table,
                        mesh_index, rim_axes: bool = True,
                        cull_box=None) -> ContactResult:
    """A = convex body, B = static mesh body (its mesh table row is
    ``mesh_index``). ``cull_box`` = (lo, hi) [K,3], the convex body's
    world AABB, keeps only the candidate triangles whose world AABB
    overlaps it inflated by ``threshold`` (``Settings.mesh_triangle_cull``;
    None runs every candidate, as the JAX package does)."""
    K = A.pos.shape[0]
    CAP = mesh_table.grid.shape[-1]
    dev = A.pos.device
    mi = torch.clamp(mesh_index.long(), 0,
                     max(mesh_table.tri_verts.shape[0] - 1, 0))

    # body centre in mesh object space -> candidate triangle ids
    c_local = quat.rotate_inv(B.orn, A.pos - B.pos)
    ids = candidate_tris(mesh_table, mi, c_local)          # [K,CAP]
    ids_c = torch.clamp(ids, min=0).long()
    mr = mi[:, None]
    ids_ok = (ids >= 0) & mesh_table.tri_mask[mr, ids_c]

    tv = mesh_table.tri_verts[mr, ids_c]                   # [K,CAP,3,3]
    tn = mesh_table.tri_normal[mr, ids_c]                  # [K,CAP,3]
    adj = mesh_table.adj_normal[mr, ids_c]                 # [K,CAP,3,3]
    tv_w = quat.rotate(B.orn[:, None, None, :], tv) + B.pos[:, None, None, :]
    if cull_box is not None:
        lo, hi = cull_box
        ids_ok = ids_ok & torch.all(
            (torch.amin(tv_w, dim=2) <= hi[:, None, :] + threshold)
            & (torch.amax(tv_w, dim=2) >= lo[:, None, :] - threshold),
            dim=-1)
    tn_w = quat.rotate(B.orn[:, None, :], tn)
    adj_w = quat.rotate(B.orn[:, None, None, :], adj)

    F = K * CAP
    tv_f = tv_w.reshape(F, 3, 3)
    tn_f = tn_w.reshape(F, 3)
    adj_f = adj_w.reshape(F, 3, 3)
    cent = tv_f.mean(dim=1)
    fz = lambda *s: torch.zeros(s, dtype=tv_f.dtype, device=dev)
    ident = fz(F, 4)
    ident[:, 3] = 1.0
    disc_axis = fz(F, 3)
    disc_axis[:, 2] = 1.0
    ones = lambda n: torch.ones((F, n), dtype=torch.bool, device=dev)
    tri_side = Side(
        pos=cent, orn=ident, params=fz(F, 4),
        verts=tv_f - cent[:, None, :], vert_mask=ones(3),
        radius=fz(F),
        face_normals=tn_f[:, None, :], face_mask=ones(1),
        edge_dirs=_edge_dirs(tv_f), edge_mask=ones(3),
        disc_r=fz(F), disc_axis=disc_axis)
    A_rep = side_map(lambda x: torch.repeat_interleave(x, CAP, dim=0), A)

    # admissible-axis filter: the Voronoi wedge of the triangle's support
    # feature
    cos_adj = vec.dot(adj_f, tn_f[:, None, :])             # [F,3] per edge
    vert_bound = torch.stack([
        torch.minimum(cos_adj[:, 0], cos_adj[:, 2]),       # v0: edges 01, 20
        torch.minimum(cos_adj[:, 0], cos_adj[:, 1]),       # v1: edges 01, 12
        torch.minimum(cos_adj[:, 1], cos_adj[:, 2]),       # v2: edges 12, 20
    ], -1)

    def axis_validity(axes):                               # [F,X,3]
        cosn = torch.sum(axes * tn_f[:, None, :], -1)
        proj = torch.sum(tv_f[:, None, :, :] * axes[:, :, None, :], -1)
        maxp = torch.amax(proj, dim=-1, keepdim=True)
        m = proj >= maxp - 1e-5                            # support verts
        count = torch.sum(m, dim=-1)
        e0 = m[..., 0] & m[..., 1]
        e1 = m[..., 1] & m[..., 2]
        edge_b = torch.where(e0, cos_adj[:, None, 0],
                             torch.where(e1, cos_adj[:, None, 1],
                                         cos_adj[:, None, 2]))
        vert_b = torch.where(m[..., 0], vert_bound[:, None, 0],
                             torch.where(m[..., 1], vert_bound[:, None, 1],
                                         vert_bound[:, None, 2]))
        bound = torch.where(count >= 3, torch.full_like(edge_b, FACE_COS),
                            torch.where(count == 2, edge_b, vert_b))
        ok = (cosn >= bound - VORONOI_TOL) | (cosn >= FACE_COS)
        return ok & (cosn > 0.0)

    res = collide_support(A_rep, tri_side, threshold,
                          axis_validity=axis_validity, orient_ref=tn_f,
                          clamp_flat=False, rim_axes=rim_axes)  # [F,4]
    pv = res.point_valid & ids_ok.reshape(F)[:, None]
    pv = pv & (vec.dot(res.normal, tn_f[:, None, :]) > 0.0)

    p_on_tri = cent[:, None, :] + res.pivot_b              # identity orn
    on_a_w = A_rep.pos[:, None, :] + quat.rotate(A_rep.orn[:, None, :],
                                                 res.pivot_a)

    # fold CAP triangles' candidates into <= 4 points per (body, mesh) pair
    C4 = CAP * 4
    idx4, pv4 = reduce_to_4(on_a_w.reshape(K, C4, 3),
                            res.distance.reshape(K, C4), pv.reshape(K, C4))
    take = lambda x: gather_points(x.reshape((K, C4) + x.shape[2:]), idx4)
    # the per-triangle material scale rides each point
    tri_fr = torch.repeat_interleave(mesh_table.tri_friction[mr, ids_c], 4,
                                     dim=1)
    tri_re = torch.repeat_interleave(mesh_table.tri_restitution[mr, ids_c],
                                     4, dim=1)
    return ContactResult(
        point_valid=pv4,
        pivot_a=take(res.pivot_a),
        pivot_b=quat.rotate_inv(B.orn[:, None, :],
                                take(p_on_tri) - B.pos[:, None, :]),
        normal=take(res.normal),
        distance=take(res.distance),
        attachment=torch.zeros((K, 4), dtype=torch.int32, device=dev),
        friction_scale=gather_points(tri_fr, idx4),
        restitution_scale=gather_points(tri_re, idx4))
