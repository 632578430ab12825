"""Quaternion math, batched, (x, y, z, w) storage order (reference:
include/edyn/math/quaternion.hpp). Counterpart of ``edyn_tpu/math/quat.py``.
"""
from __future__ import annotations

import torch

from . import vec


def mul(p, q):
    """Hamilton product p*q."""
    px, py, pz, pw = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    qx, qy, qz, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        pw * qx + px * qw + py * qz - pz * qy,
        pw * qy - px * qz + py * qw + pz * qx,
        pw * qz + px * qy - py * qx + pz * qw,
        pw * qw - px * qx - py * qy - pz * qz,
    ], dim=-1)


def conjugate(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def normalize(q):
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                           min=1e-12)


def rotate(q, v):
    """Rotate vector v by unit quaternion q."""
    u = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * vec.cross(u, v)
    return v + w * t + vec.cross(u, t)


def rotate_inv(q, v):
    return rotate(conjugate(q), v)


def integrate(q, w, dt):
    """Exponential-map orientation integration with the small-angle Taylor
    guard (reference: src/edyn/math/quaternion.cpp:1-46)."""
    theta_sq = vec.length_sqr(w) * dt * dt
    theta = torch.sqrt(torch.clamp(theta_sq, min=1e-30))
    half = theta * 0.5
    small = theta_sq < 1e-8
    s = torch.where(small, 0.5 * dt - theta_sq * dt / 48.0,
                    torch.sin(half) / torch.clamp(theta, min=1e-30) * dt)
    c = torch.where(small, 1.0 - theta_sq * 0.125, torch.cos(half))
    dq = torch.cat([w * s[..., None], c[..., None]], dim=-1)
    return normalize(mul(dq, q))


def to_matrix(q):
    """Rotation matrix of a unit quaternion."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
    ], dim=-2)


def shortest_arc(v0, v1):
    """Quaternion rotating unit vector v0 onto v1 (reference:
    include/edyn/math/quaternion.hpp shortest_arc). Batched [...,3]."""
    c = vec.cross(v0, v1)
    d = torch.sum(v0 * v1, dim=-1, keepdim=True)
    w = 1.0 + d
    # antiparallel fallback: rotate pi about any orthogonal axis
    t1, _ = vec.orthonormal_basis(v0)
    anti = w < 1e-6
    xyz = torch.where(anti, t1, c)
    q = torch.cat([xyz, torch.where(anti, torch.zeros_like(w), w)], dim=-1)
    return normalize(q)
