"""Geometric queries (reference: include/edyn/math/geom.hpp): the segment
closest points of the box-box kernel and the ray intersections of the
raycast (counterpart of ``edyn_tpu/math/geom.py``)."""
from __future__ import annotations

import torch

from . import vec

# the JAX module's own epsilon (``edyn_tpu/math/geom.py``), tighter than
# ``vec.EPS``
EPS = 1e-10


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


