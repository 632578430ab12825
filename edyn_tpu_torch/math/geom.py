"""Geometric queries (reference: include/edyn/math/geom.hpp): the segment
closest points of the box-box kernel and the ray intersections of the
raycast (counterpart of ``edyn_tpu/math/geom.py``)."""
from __future__ import annotations

import torch

from . import vec

# the JAX module's own epsilon (``edyn_tpu/math/geom.py``), tighter than
# ``vec.EPS``
EPS = 1e-10


def closest_point_segment(a, b, p):
    """Closest point on segment [a,b] to point p. Returns (t, c,
    dist_sqr)."""
    ab = b - a
    t = vec.dot(p - a, ab) / torch.clamp(vec.length_sqr(ab), min=EPS)
    t = torch.clamp(t, 0.0, 1.0)
    c = a + ab * t[..., None]
    return t, c, vec.length_sqr(p - c)


def closest_point_segment_segment(p1, q1, p2, q2):
    """Closest points between segments [p1,q1] and [p2,q2] (branchless
    Ericson RTCD 5.1.9). Returns (s, t, c1, c2, dist_sqr)."""
    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    a = vec.length_sqr(d1)
    e = vec.length_sqr(d2)
    f = vec.dot(d2, r)
    c = vec.dot(d1, r)
    b = vec.dot(d1, d2)
    denom = a * e - b * b
    zero = torch.zeros_like(a)

    s = torch.where(denom > EPS,
                    torch.clamp((b * f - c * e) / torch.clamp(denom, min=EPS),
                                0.0, 1.0), zero)
    t = (b * s + f) / torch.clamp(e, min=EPS)
    t_cl = torch.clamp(t, 0.0, 1.0)
    s = torch.where(t != t_cl,
                    torch.clamp((t_cl * b - c) / torch.clamp(a, min=EPS),
                                0.0, 1.0), s)
    t = t_cl
    s = torch.where(e <= EPS, torch.clamp(-c / torch.clamp(a, min=EPS),
                                          0.0, 1.0), s)
    t = torch.where(e <= EPS, zero, t)
    t = torch.where(a <= EPS, torch.clamp(f / torch.clamp(e, min=EPS),
                                          0.0, 1.0), t)
    s = torch.where(a <= EPS, zero, s)
    t = torch.where((a <= EPS) & (e <= EPS), zero, t)
    c1 = p1 + d1 * s[..., None]
    c2 = p2 + d2 * t[..., None]
    return s, t, c1, c2, vec.length_sqr(c1 - c2)


# --- ray intersection primitives (raycast; reference:
# src/edyn/collision/raycast.cpp). ``RAY_EPS`` is the JAX module's own
# epsilon, tighter than ``vec.EPS``.
BIG = 1e30
RAY_EPS = 1e-10


def intersect_ray_plane(p0, d, n, c):
    """Ray p0 + t*d vs plane n.x = c: t, or BIG when parallel or behind."""
    denom = vec.dot(d, n)
    ok = torch.abs(denom) > RAY_EPS
    t = (c - vec.dot(p0, n)) / torch.where(ok, denom, torch.ones_like(denom))
    return torch.where(ok & (t >= 0.0), t, torch.full_like(t, BIG))


def intersect_ray_sphere(p0, d, center, radius):
    """The smallest t >= 0 of the ray's entry into the sphere, or BIG."""
    m = p0 - center
    a = vec.length_sqr(d)
    b = vec.dot(m, d)
    c = vec.length_sqr(m) - radius * radius
    disc = b * b - a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    a_safe = torch.clamp(a, min=RAY_EPS)
    t0 = (-b - sq) / a_safe
    t1 = (-b + sq) / a_safe
    t = torch.where(t0 >= 0.0, t0, t1)
    return torch.where((disc >= 0.0) & (t >= 0.0), t,
                       torch.full_like(t, BIG))


def intersect_ray_aabb(p0, d, amin, amax):
    """Slab test: (t_enter clamped at 0, t_exit); a miss has t_enter >
    t_exit."""
    tiny = torch.where(d >= 0, torch.full_like(d, RAY_EPS),
                       torch.full_like(d, -RAY_EPS))
    inv = 1.0 / torch.where(torch.abs(d) > RAY_EPS, d, tiny)
    t0 = (amin - p0) * inv
    t1 = (amax - p0) * inv
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    return torch.clamp(tmin, min=0.0), tmax


def intersect_segment_triangle(p0, d, a, b, c):
    """Moller-Trumbore: (t, hit) of the ray p0 + t*d against triangle abc,
    t = BIG on a miss (reference: geom.hpp:411
    intersect_segment_triangle)."""
    e1 = b - a
    e2 = c - a
    h = vec.cross(d, e2)
    det = vec.dot(e1, h)
    ok = torch.abs(det) > RAY_EPS
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    s = p0 - a
    u = vec.dot(s, h) * inv
    q = vec.cross(s, e1)
    v = vec.dot(d, q) * inv
    t = vec.dot(e2, q) * inv
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t >= 0)
    return torch.where(hit, t, torch.full_like(t, BIG)), hit
