"""Compound-shape narrowphase: expand children, run the convex kernels,
fold (counterpart of ``edyn_tpu/collision/kernels/compound.py``;
reference: collide_compound_* under src/edyn/collision/collide/).

Each (compound, other) pair expands into (child, other) sub-pairs, as the
mesh bucket expands into triangles; the children are convex-table rows past
the N bodies (``CompoundTable.child_row``). The sub-results fold back to the
best <= 4 points per pair. Plain PyTorch on every device, as in the JAX
package (no Pallas kernel).
"""
from __future__ import annotations

import torch

from ...math import quat
from .common import ContactResult, gather_points, reduce_to_4
from .mesh import collide_convex_mesh
from .plane_unified import collide_convex_plane
from .support import Side, side_map
from .support_sat import collide_support


def _expand_children(state, body_idx):
    """Side over the flattened children of compound bodies [K] -> [K*CH]:
    the children's convex rows with composed world transforms. Returns
    (Side, child mask [K*CH], CH)."""
    ct = state.compound
    cx = state.convex
    ci = torch.clamp(state.shape_index[body_idx].long(), 0,
                     max(ct.child_row.shape[0] - 1, 0))
    rows = ct.child_row[ci]                    # [K,CH]
    mask = ct.child_mask[ci]
    K, CH = rows.shape
    pos_b = state.origin_pos()[body_idx]
    orn_b = state.orn[body_idx]
    pos_w = pos_b[:, None, :] + quat.rotate(orn_b[:, None, :],
                                            ct.child_pos[ci])
    orn_w = quat.mul(orn_b[:, None, :], ct.child_orn[ci])
    F = K * CH
    flat = lambda x: x.reshape((F,) + x.shape[2:])
    r = flat(torch.clamp(rows, min=0)).long()
    side = Side(
        pos=flat(pos_w), orn=flat(orn_w),
        params=torch.zeros((F, 4), dtype=pos_b.dtype, device=pos_b.device),
        verts=cx.verts[r], vert_mask=cx.vert_mask[r] & flat(mask)[:, None],
        radius=cx.radius[r],
        face_normals=cx.face_normals[r], face_mask=cx.face_mask[r],
        edge_dirs=cx.edge_dirs[r], edge_mask=cx.edge_mask[r],
        disc_r=cx.disc_r[r], disc_axis=cx.disc_axis[r])
    return side, flat(mask), CH


def _rep_side(S: Side, n: int) -> Side:
    return side_map(lambda x: torch.repeat_interleave(x, n, dim=0), S)


def _fold(res: ContactResult, sub_valid, K, SUB, A_body: Side, B_body: Side,
          sub_A: Side, sub_B: Side) -> ContactResult:
    """Fold [K*SUB] sub-results into [K] body-frame results."""
    pv = res.point_valid & sub_valid[:, None]
    on_a_w = sub_A.pos[:, None, :] + quat.rotate(sub_A.orn[:, None, :],
                                                 res.pivot_a)
    on_b_w = sub_B.pos[:, None, :] + quat.rotate(sub_B.orn[:, None, :],
                                                 res.pivot_b)
    C4 = SUB * 4
    idx4, pv4 = reduce_to_4(on_a_w.reshape(K, C4, 3),
                            res.distance.reshape(K, C4), pv.reshape(K, C4))
    take = lambda x: gather_points(x.reshape((K, C4) + x.shape[2:]), idx4)
    return ContactResult(
        point_valid=pv4,
        pivot_a=quat.rotate_inv(A_body.orn[:, None, :],
                                take(on_a_w) - A_body.pos[:, None, :]),
        pivot_b=quat.rotate_inv(B_body.orn[:, None, :],
                                take(on_b_w) - B_body.pos[:, None, :]),
        normal=take(res.normal),
        distance=take(res.distance),
        attachment=torch.zeros((K, 4), dtype=torch.int32,
                               device=pv4.device),
        friction_scale=take(res.friction_scale),
        restitution_scale=take(res.restitution_scale))


def collide_compound_convex(state, ka, kb, A: Side, B: Side, threshold):
    """A = compound body, B = convex body."""
    K = A.pos.shape[0]
    sub_A, mask, CH = _expand_children(state, ka)
    sub_B = _rep_side(B, CH)
    res = collide_support(sub_A, sub_B, threshold)
    return _fold(res, mask, K, CH, A, B, sub_A, sub_B)


def collide_compound_plane(state, ka, kb, A: Side, B: Side, threshold):
    """A = compound body, B = plane body."""
    K = A.pos.shape[0]
    sub_A, mask, CH = _expand_children(state, ka)
    sub_B = _rep_side(B, CH)
    res = collide_convex_plane(sub_A, sub_B, threshold)
    return _fold(res, mask, K, CH, A, B, sub_A, sub_B)


def collide_compound_mesh(state, ka, kb, A: Side, B: Side, threshold,
                          rim_axes: bool = False):
    """A = compound body, B = static mesh body (reference:
    collide_compound_mesh.cpp): each (child, mesh) sub-pair runs the
    convex-vs-mesh kernel, and the sub-results fold back."""
    K = A.pos.shape[0]
    sub_A, mask, CH = _expand_children(state, ka)
    sub_B = _rep_side(B, CH)
    mesh_idx = torch.repeat_interleave(state.shape_index[kb], CH, dim=0)
    res = collide_convex_mesh(sub_A, sub_B, threshold, state.mesh, mesh_idx,
                              rim_axes=rim_axes)
    return _fold(res, mask, K, CH, A, B, sub_A, sub_B)


def collide_compound_compound(state, ka, kb, A: Side, B: Side, threshold):
    """Both compound: [K*CHA] x [K*CHB] -> [K*CHA*CHB] child pairs."""
    K = A.pos.shape[0]
    sub_A, mask_a, CHA = _expand_children(state, ka)
    sub_B, mask_b, CHB = _expand_children(state, kb)
    repA = _rep_side(sub_A, CHB)
    mask_a_r = torch.repeat_interleave(mask_a, CHB, dim=0)
    # B's children tiled once per child of A: [K, CHA, CHB] flattened
    tile = lambda x: torch.repeat_interleave(
        x.reshape((K, CHB) + x.shape[1:]), CHA, dim=0).reshape(
            (K * CHA * CHB,) + x.shape[1:])
    tileB = side_map(tile, sub_B)
    res = collide_support(repA, tileB, threshold)
    return _fold(res, mask_a_r & tile(mask_b), K, CHA * CHB, A, B, repA,
                 tileB)
