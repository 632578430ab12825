"""Narrowphase kernels for primitive shape pairs (counterpart of
``edyn_tpu/collision/kernels/primitives.py``; reference: the per-pair
collide() units src/edyn/collision/collide/collide_sphere_sphere.cpp,
collide_sphere_plane.cpp, collide_box_plane.cpp, collide_capsule_plane.cpp,
collide_cylinder_plane.cpp, collide_sphere_box.cpp,
collide_capsule_capsule.cpp, collide_capsule_sphere.cpp). Each runs on K
gathered pairs at once, in plain PyTorch: no bucket of the step reaches
them (the step's UNIFIED, BOXBOX and PLANE buckets cover these pairs);
they are library functions, as in the JAX package.

Convention: body A is the first (non-plane) shape; planes are always body
B. Normals point from B toward A. Every float follows ``pos_a``'s dtype.
"""
from __future__ import annotations

import torch

from ...math import geom, quat, vec
from .common import (
    ATTACH_B, ATTACH_NONE, axis_onehot, gather_points, make_result,
    reduce_to_4,
)


def _plane_world(pos_b, orn_b, params_b):
    """World-space unit normal and constant of a plane shape on body B."""
    n = quat.rotate(orn_b, params_b[:, :3])
    c = params_b[:, 3] + vec.dot(n, pos_b)
    return n, c


def _up(x):
    return torch.tensor([0.0, 1.0, 0.0], dtype=x.dtype, device=x.device)


def _int4(x, value):
    return torch.full(x.shape, value, dtype=torch.int32, device=x.device)


def _single_point(pos_a, orn_a, pos_b, orn_b, pa_w, pb_w, normal, dist,
                  valid, attachment, threshold):
    """A one-point-per-pair result in the 4-slot ContactResult."""
    K = pos_a.shape[0]

    def pad(x):
        return torch.cat([x[:, None], torch.zeros_like(x[:, None]).repeat(
            (1, 3) + (1,) * (x.dim() - 1))], 1)

    point_valid = torch.zeros((K, 4), dtype=torch.bool, device=pos_a.device)
    point_valid[:, 0] = valid
    d4 = torch.zeros((K, 4), dtype=pos_a.dtype, device=pos_a.device)
    d4[:, 0] = dist
    return make_result(pos_a, orn_a, pos_b, orn_b, pad(pa_w), pad(pb_w),
                       pad(normal), d4, point_valid, _int4(d4, attachment),
                       threshold)


def _cap_offsets(x):
    """[1, 2, 1] the +1 / -1 end factors of a capsule or cylinder axis."""
    return torch.tensor([1.0, -1.0], dtype=x.dtype,
                        device=x.device)[None, :, None]


# ---------------------------------------------------------------------------

def collide_sphere_sphere(pos_a, orn_a, params_a, pos_b, orn_b, params_b,
                          threshold):
    """reference: collide_sphere_sphere.cpp"""
    ra = params_a[:, 0]
    rb = params_b[:, 0]
    d = pos_a - pos_b
    dist_c = vec.length(d)
    n = vec.normalize_or(d, _up(d))
    dist = dist_c - ra - rb
    pa_w = pos_a - n * ra[:, None]
    pb_w = pos_b + n * rb[:, None]
    return _single_point(pos_a, orn_a, pos_b, orn_b, pa_w, pb_w, n, dist,
                         torch.ones_like(dist, dtype=torch.bool),
                         ATTACH_NONE, threshold)


def collide_sphere_plane(pos_a, orn_a, params_a, pos_b, orn_b, params_b,
                         threshold):
    """reference: collide_sphere_plane.cpp"""
    r = params_a[:, 0]
    n, c = _plane_world(pos_b, orn_b, params_b)
    center_d = vec.dot(n, pos_a) - c
    dist = center_d - r
    pa_w = pos_a - n * r[:, None]
    pb_w = pos_a - n * center_d[:, None]
    return _single_point(pos_a, orn_a, pos_b, orn_b, pa_w, pb_w, n, dist,
                         torch.ones_like(dist, dtype=torch.bool), ATTACH_B,
                         threshold)


def collide_box_plane(pos_a, orn_a, params_a, pos_b, orn_b, params_b,
                      threshold):
    """Box vertices below the plane (reference: collide_box_plane.cpp): all
    8 vertices tested and reduced to the best 4."""
    h = params_a[:, :3]
    n, c = _plane_world(pos_b, orn_b, params_b)
    signs = torch.tensor([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                          for sz in (-1, 1)], dtype=h.dtype, device=h.device)
    v_local = signs[None, :, :] * h[:, None, :]                 # [K,8,3]
    v_world = pos_a[:, None, :] + quat.rotate(orn_a[:, None, :], v_local)
    dist = vec.dot(v_world, n[:, None, :]) - c[:, None]         # [K,8]
    idx, pv = reduce_to_4(v_world, dist, dist < threshold)
    pa_w = gather_points(v_world, idx)
    d4 = gather_points(dist, idx)
    pb_w = pa_w - n[:, None, :] * d4[..., None]
    return make_result(pos_a, orn_a, pos_b, orn_b, pa_w, pb_w,
                       n[:, None, :], d4, pv, _int4(d4, ATTACH_B), threshold)


def collide_capsule_plane(pos_a, orn_a, params_a, pos_b, orn_b, params_b,
                          threshold):
    """reference: collide_capsule_plane.cpp"""
    r = params_a[:, 0]
    hl = params_a[:, 1]
    axis_w = quat.rotate(orn_a, axis_onehot(params_a[:, 2]))
    n, c = _plane_world(pos_b, orn_b, params_b)
    ends = pos_a[:, None, :] + axis_w[:, None, :] * (
        _cap_offsets(pos_a) * hl[:, None, None])               # [K,2,3]
    center_d = vec.dot(ends, n[:, None, :]) - c[:, None]
    dist = center_d - r[:, None]                               # [K,2]
    pa_w = ends - n[:, None, :] * r[:, None, None]
    pb_w = ends - n[:, None, :] * center_d[..., None]
    K = pos_a.shape[0]
    z = torch.zeros((K, 2, 3), dtype=pos_a.dtype, device=pos_a.device)
    pv = torch.zeros((K, 4), dtype=torch.bool, device=pos_a.device)
    pv[:, :2] = True
    d4 = torch.cat([dist, torch.zeros_like(dist)], 1)
    return make_result(pos_a, orn_a, pos_b, orn_b,
                       torch.cat([pa_w, z], 1), torch.cat([pb_w, z], 1),
                       n[:, None, :], d4, pv, _int4(d4, ATTACH_B), threshold)


def collide_cylinder_plane(pos_a, orn_a, params_a, pos_b, orn_b, params_b,
                           threshold):
    """Cylinder cap-rim sampling against a plane (reference:
    collide_cylinder_plane.cpp): each cap rim gives 4 samples (the deepest
    radial direction and its quarter turns), reduced to the best 4."""
    r = params_a[:, 0]
    hl = params_a[:, 1]
    axis_w = quat.rotate(orn_a, axis_onehot(params_a[:, 2]))
    n, c = _plane_world(pos_b, orn_b, params_b)
    t1, _ = vec.orthonormal_basis(axis_w)
    radial = -(n - axis_w * vec.dot(n, axis_w)[:, None])
    d0 = vec.normalize_or(radial, t1)
    d90 = vec.cross(axis_w, d0)
    caps = pos_a[:, None, :] + axis_w[:, None, :] * (
        _cap_offsets(pos_a) * hl[:, None, None])               # [K,2,3]
    dirs = torch.stack([d0, d90, -d0, -d90], dim=1)            # [K,4,3]
    pts = caps[:, :, None, :] + dirs[:, None, :, :] * r[:, None, None, None]
    pts = pts.reshape(pts.shape[0], 8, 3)
    dist = vec.dot(pts, n[:, None, :]) - c[:, None]
    idx, pv = reduce_to_4(pts, dist, dist < threshold)
    pa_w = gather_points(pts, idx)
    d4 = gather_points(dist, idx)
    pb_w = pa_w - n[:, None, :] * d4[..., None]
    return make_result(pos_a, orn_a, pos_b, orn_b, pa_w, pb_w,
                       n[:, None, :], d4, pv, _int4(d4, ATTACH_B), threshold)


def collide_sphere_box(pos_a, orn_a, params_a, pos_b, orn_b, params_b,
                       threshold):
    """Sphere A against box B through the closest point in box space
    (reference: collide_sphere_box.cpp); a centre inside the box takes the
    face of least penetration."""
    r = params_a[:, 0]
    h = params_b[:, :3]
    c_local = quat.rotate_inv(orn_b, pos_a - pos_b)
    clamped = torch.maximum(torch.minimum(c_local, h), -h)
    delta = c_local - clamped
    outside_d = vec.length(delta)
    inside = outside_d < 1e-9

    n_out = vec.normalize_or(delta, _up(delta))
    dist_out = outside_d - r

    pen = h - torch.abs(c_local)
    k = torch.argmin(pen, dim=-1)
    sign = torch.sign(torch.gather(c_local, 1, k[:, None])[:, 0])
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    n_in = axis_onehot(k.to(c_local.dtype)) * sign[:, None]
    dist_in = -(torch.gather(pen, 1, k[:, None])[:, 0] + r)
    ar = torch.arange(3, device=k.device)[None, :]
    closest_in = torch.where(ar == k[:, None], sign[:, None] * h, c_local)

    n_local = torch.where(inside[:, None], n_in, n_out)
    dist = torch.where(inside, dist_in, dist_out)
    closest = torch.where(inside[:, None], closest_in, clamped)

    n_world = quat.rotate(orn_b, n_local)
    pb_w = pos_b + quat.rotate(orn_b, closest)
    pa_w = pos_a - n_world * r[:, None]
    return _single_point(pos_a, orn_a, pos_b, orn_b, pa_w, pb_w, n_world,
                         dist, torch.ones_like(dist, dtype=torch.bool),
                         ATTACH_B, threshold)


def collide_sphere_capsule(pos_a, orn_a, params_a, pos_b, orn_b, params_b,
                           threshold):
    """reference: collide_capsule_sphere.cpp (the sphere is A here)."""
    ra = params_a[:, 0]
    rb = params_b[:, 0]
    hlb = params_b[:, 1]
    axis_b = quat.rotate(orn_b, axis_onehot(params_b[:, 2]))
    e0 = pos_b - axis_b * hlb[:, None]
    e1 = pos_b + axis_b * hlb[:, None]
    _, cb, _ = geom.closest_point_segment(e0, e1, pos_a)
    d = pos_a - cb
    n = vec.normalize_or(d, _up(d))
    dist = vec.length(d) - ra - rb
    pa_w = pos_a - n * ra[:, None]
    pb_w = cb + n * rb[:, None]
    return _single_point(pos_a, orn_a, pos_b, orn_b, pa_w, pb_w, n, dist,
                         torch.ones_like(dist, dtype=torch.bool),
                         ATTACH_NONE, threshold)


def collide_capsule_capsule(pos_a, orn_a, params_a, pos_b, orn_b, params_b,
                            threshold):
    """reference: collide_capsule_capsule.cpp: the closest-point contact,
    and for near-parallel capsules a second point at the other end of the
    projected overlap."""
    ra, hla = params_a[:, 0], params_a[:, 1]
    rb, hlb = params_b[:, 0], params_b[:, 1]
    ax_a = quat.rotate(orn_a, axis_onehot(params_a[:, 2]))
    ax_b = quat.rotate(orn_b, axis_onehot(params_b[:, 2]))
    a0 = pos_a - ax_a * hla[:, None]
    a1 = pos_a + ax_a * hla[:, None]
    b0 = pos_b - ax_b * hlb[:, None]
    b1 = pos_b + ax_b * hlb[:, None]
    _, _, ca, cb, _ = geom.closest_point_segment_segment(a0, a1, b0, b1)
    d = ca - cb
    n = vec.normalize_or(d, vec.normalize_or(vec.cross(ax_a, ax_b), _up(d)))
    dist = vec.length(d) - ra - rb

    # parallel second point: B's segment projected on A's axis, the overlap
    par = torch.abs(vec.dot(ax_a, ax_b)) > 0.999
    tb0 = vec.dot(b0 - pos_a, ax_a)
    tb1 = vec.dot(b1 - pos_a, ax_a)
    lo = torch.maximum(-hla, torch.minimum(tb0, tb1))
    hi = torch.minimum(hla, torch.maximum(tb0, tb1))
    pa_line0 = pos_a + ax_a * lo[:, None]
    pa_line1 = pos_a + ax_a * hi[:, None]
    # the overlap end farther from the closest point
    d_e0 = vec.length_sqr(pa_line0 - ca)
    d_e1 = vec.length_sqr(pa_line1 - ca)
    p2_axis = torch.where((d_e0 > d_e1)[:, None], pa_line0, pa_line1)
    valid2 = par & (hi > lo)

    pa1_w = ca - n * ra[:, None]
    pb1_w = cb + n * rb[:, None]
    pa2_w = p2_axis - n * ra[:, None]
    _, cb2, _ = geom.closest_point_segment(b0, b1, p2_axis)
    pb2_w = cb2 + n * rb[:, None]
    dist2 = vec.dot(p2_axis - cb2, n) - ra - rb

    K = pos_a.shape[0]
    z = torch.zeros((K, 2, 3), dtype=pos_a.dtype, device=pos_a.device)
    pa_w = torch.cat([pa1_w[:, None], pa2_w[:, None], z], 1)
    pb_w = torch.cat([pb1_w[:, None], pb2_w[:, None], z], 1)
    zk = torch.zeros_like(dist)
    dists = torch.stack([dist, dist2, zk, zk], 1)
    fk = torch.zeros_like(valid2)
    pv = torch.stack([torch.ones_like(valid2), valid2, fk, fk], 1)
    return make_result(pos_a, orn_a, pos_b, orn_b, pa_w, pb_w,
                       n[:, None, :], dists, pv, _int4(dists, ATTACH_NONE),
                       threshold)
