"""Vector math on batched tensors (reference: include/edyn/math/vector3.hpp).

Counterpart of ``edyn_tpu/math/vec.py``: every function broadcasts over
leading batch dimensions and works on trailing-dim-3 tensors.
"""
from __future__ import annotations

import torch

EPS = 1e-9


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by,
                        az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def length_sqr(v):
    return torch.sum(v * v, dim=-1)


def length(v):
    return torch.sqrt(length_sqr(v))


def normalize(v, eps: float = EPS):
    """Safe normalize: zeros for (near-)zero vectors."""
    l2 = length_sqr(v)
    inv = torch.where(l2 > eps, 1.0 / torch.sqrt(torch.clamp(l2, min=eps)),
                      torch.zeros_like(l2))
    return v * inv[..., None]


def normalize_or(v, fallback, eps: float = EPS):
    """Normalize, substituting ``fallback`` where ``v`` is near zero."""
    l2 = length_sqr(v)
    ok = l2 > eps
    inv = 1.0 / torch.sqrt(torch.clamp(l2, min=eps))
    return torch.where(ok[..., None], v * inv[..., None], fallback)


def orthonormal_basis(n):
    """Two unit tangents orthogonal to unit normal ``n`` (Duff et al.
    branchless construction, as in the JAX package)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, torch.ones_like(nz), -torch.ones_like(nz))
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t1 = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    t2 = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return t1, t2


def clamp_length(v, max_len):
    ln = length(v)
    scale = torch.where(ln > max_len, max_len / torch.clamp(ln, min=EPS),
                        torch.ones_like(ln))
    return v * scale[..., None]
