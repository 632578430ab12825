"""Support functions over the unified convex representation (counterpart
of ``edyn_tpu/collision/kernels/support.py``): data-driven support points
and projections, no shape-type switching."""
from __future__ import annotations

import dataclasses

import torch

from ...math import quat, vec


@dataclasses.dataclass
class Side:
    """Gathered per-pair data for one body of each candidate pair; verts,
    face_normals and edge_dirs are in object space."""
    pos: torch.Tensor           # [K,3] shape origin
    orn: torch.Tensor           # [K,4]
    params: torch.Tensor        # [K,4] raw shape params
    verts: torch.Tensor         # [K,V,3]
    vert_mask: torch.Tensor     # [K,V]
    radius: torch.Tensor        # [K]
    face_normals: torch.Tensor  # [K,F,3]
    face_mask: torch.Tensor     # [K,F]
    edge_dirs: torch.Tensor     # [K,E,3]
    edge_mask: torch.Tensor     # [K,E]
    disc_r: torch.Tensor        # [K]
    disc_axis: torch.Tensor     # [K,3]


SIDE_FIELDS = tuple(f.name for f in dataclasses.fields(Side))


def pack_side_table(state):
    """[N, C] packed transform + convex columns of the N bodies (the body
    rows of the convex table, never its compound-child rows), so a bucket's
    Side costs one gather per pair side. Layout: pos 3 | orn 4 | params 4 |
    radius 1 | disc_r 1 | disc_axis 3 | verts V*3 | vert_mask V |
    face_normals F*3 | face_mask F | edge_dirs E*3 | edge_mask E."""
    cx = state.convex
    N = state.capacity
    V = cx.verts.shape[1]
    F = cx.face_normals.shape[1]
    E = cx.edge_dirs.shape[1]
    f = lambda x: x.to(state.dtype)
    return torch.cat([
        state.origin_pos(), state.orn, state.shape_params,
        f(cx.radius)[:N, None], f(cx.disc_r)[:N, None], f(cx.disc_axis)[:N],
        cx.verts[:N].reshape(N, V * 3), f(cx.vert_mask)[:N],
        cx.face_normals[:N].reshape(N, F * 3), f(cx.face_mask)[:N],
        cx.edge_dirs[:N].reshape(N, E * 3), f(cx.edge_mask)[:N],
    ], dim=1), (V, F, E)


def side_from_packed(g, dims) -> Side:
    """Unpack one gathered [K, C] block into a Side."""
    V, F, E = dims
    K = g.shape[0]
    o = [0]

    def cut(n):
        s = g[:, o[0]:o[0] + n]
        o[0] += n
        return s

    pos = cut(3)
    orn = cut(4)
    params = cut(4)
    radius = cut(1)[:, 0]
    disc_r = cut(1)[:, 0]
    disc_axis = cut(3)
    verts = cut(V * 3).reshape(K, V, 3)
    vmask = cut(V) > 0.5
    fn = cut(F * 3).reshape(K, F, 3)
    fmask = cut(F) > 0.5
    ed = cut(E * 3).reshape(K, E, 3)
    emask = cut(E) > 0.5
    return Side(pos=pos, orn=orn, params=params, verts=verts, vert_mask=vmask,
                radius=radius, face_normals=fn, face_mask=fmask,
                edge_dirs=ed, edge_mask=emask, disc_r=disc_r,
                disc_axis=disc_axis)


def world_verts(side: Side):
    """[K,V,3] rotated and translated point cloud."""
    return quat.rotate(side.orn[:, None, :], side.verts) + side.pos[:, None, :]


def world_disc_axis(side: Side):
    return quat.rotate(side.orn, side.disc_axis)


def _exp(x, extra):
    return x.reshape(x.shape[:1] + (1,) * extra + x.shape[1:])


def _disc_perp(side: Side, d, extra):
    w = _exp(world_disc_axis(side), extra)
    dw = torch.sum(d * w, -1, keepdim=True)
    perp = d - dw * w
    return perp, vec.length(perp)


def support_point(side: Side, d):
    """Exact support point along world unit dir d ([K,3] or [K,S,3])."""
    extra = d.dim() - 2
    vw_e = _exp(world_verts(side), extra)            # [K,(1,)*,V,3]
    proj = torch.sum(vw_e * d[..., None, :], -1)
    proj = torch.where(_exp(side.vert_mask, extra), proj,
                       torch.full_like(proj, -1e30))
    idx = torch.argmax(proj, dim=-1)
    vw_b = vw_e.expand(proj.shape + (3,))
    base = torch.gather(vw_b, -2, idx[..., None, None].expand(
        idx.shape + (1, 3)))[..., 0, :]
    pt = base + d * _exp(side.radius[:, None], extra)
    perp, plen = _disc_perp(side, d, extra)
    disc = _exp(side.disc_r[:, None], extra)
    return pt + disc * perp / torch.clamp(plen[..., None], min=1e-12)


def support_projection(side: Side, d):
    """max over the shape of dot(point, d); d [K,3] or [K,S,3]."""
    extra = d.dim() - 2
    vw = world_verts(side)
    proj = torch.sum(_exp(vw, extra) * d[..., None, :], -1)
    proj = torch.where(_exp(side.vert_mask, extra), proj,
                       torch.full_like(proj, -1e30))
    out = torch.amax(proj, dim=-1) + _exp(side.radius[:, None], extra)[..., 0]
    _, plen = _disc_perp(side, d, extra)
    return out + _exp(side.disc_r[:, None], extra)[..., 0] * plen


def face_axes(side: Side, other_center):
    """World face normals + the center-delta direction + the cylinder side
    normal facing the other body."""
    fw = quat.rotate(side.orn[:, None, :], side.face_normals)
    d = other_center - side.pos
    up = torch.zeros_like(side.pos)
    up[:, 1] = 1.0
    delta = vec.normalize_or(d, up)
    w = world_disc_axis(side)
    perp = d - torch.sum(d * w, -1, keepdim=True) * w
    plen = vec.length(perp)
    side_n = perp / torch.clamp(plen, min=1e-12)[..., None]
    side_ok = (side.disc_r > 1e-9) & (plen > 1e-9)
    axes = torch.cat([fw, delta[:, None, :], side_n[:, None, :]], dim=1)
    mask = torch.cat([side.face_mask,
                      torch.ones((side.pos.shape[0], 1), dtype=torch.bool,
                                 device=side.pos.device),
                      side_ok[:, None]], dim=1)
    return axes, mask


def edge_dirs(side: Side):
    return quat.rotate(side.orn[:, None, :], side.edge_dirs), side.edge_mask
