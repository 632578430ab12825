"""Shared narrowphase kernel infrastructure (counterpart of
``edyn_tpu/collision/kernels/common.py``).

Every kernel is vectorized over K gathered pairs and returns a
``ContactResult`` of up to 4 points per pair. Normals are world-space unit
vectors from B toward A; pivots are in each body's object space;
``distance`` is the signed separation (negative = penetrating).
"""
from __future__ import annotations

import dataclasses

import torch

from ...math import quat, vec

ATTACH_NONE, ATTACH_A, ATTACH_B = 0, 1, 2
BIG = 1e30


@dataclasses.dataclass
class ContactResult:
    """Batched collision_result (reference: collision_result.hpp:13-50)."""
    point_valid: torch.Tensor  # [K,4] bool
    pivot_a: torch.Tensor      # [K,4,3] object space of A
    pivot_b: torch.Tensor      # [K,4,3] object space of B
    normal: torch.Tensor       # [K,4,3] world, B -> A
    distance: torch.Tensor     # [K,4]
    attachment: torch.Tensor   # [K,4] int32
    friction_scale: torch.Tensor     # [K,4] per-point surface material scale
    restitution_scale: torch.Tensor  # [K,4]

    def swapped(self) -> "ContactResult":
        """Swap the roles of A and B."""
        at = self.attachment
        attach = torch.where(at == ATTACH_A, torch.full_like(at, ATTACH_B),
                             torch.where(at == ATTACH_B,
                                         torch.full_like(at, ATTACH_A),
                                         torch.full_like(at, ATTACH_NONE)))
        return ContactResult(point_valid=self.point_valid,
                             pivot_a=self.pivot_b, pivot_b=self.pivot_a,
                             normal=-self.normal, distance=self.distance,
                             attachment=attach,
                             friction_scale=self.friction_scale,
                             restitution_scale=self.restitution_scale)


def take1(x, i):
    """``take_along_axis(x, i[:, None], axis=1)[:, 0]`` for x [K,C] or
    [K,C,3] and i [K]."""
    if x.dim() == 2:
        return torch.gather(x, 1, i[:, None].long())[:, 0]
    return torch.gather(x, 1, i[:, None, None].long().expand(
        -1, 1, x.shape[-1]))[:, 0]


def gather_points(cand, idx):
    """cand [K,C,...], idx [K,4] -> [K,4,...]."""
    idx = idx.long()
    if cand.dim() == 2:
        return torch.gather(cand, 1, idx)
    return torch.gather(cand, 1, idx[..., None].expand(-1, -1,
                                                       cand.shape[-1]))


def make_result(pos_a, orn_a, pos_b, orn_b, p_world_a, p_world_b, normal,
                distance, point_valid, attachment, threshold):
    """Assemble a ContactResult from world-space contact data (object-space
    pivots, like the reference stores pivotA/pivotB)."""
    point_valid = point_valid & (distance < threshold)
    pivot_a = quat.rotate_inv(orn_a[:, None, :], p_world_a - pos_a[:, None, :])
    pivot_b = quat.rotate_inv(orn_b[:, None, :], p_world_b - pos_b[:, None, :])
    return ContactResult(
        point_valid=point_valid, pivot_a=pivot_a, pivot_b=pivot_b,
        normal=normal.expand(pivot_a.shape),
        distance=distance,
        attachment=attachment.expand(point_valid.shape).to(torch.int32),
        friction_scale=torch.ones_like(distance),
        restitution_scale=torch.ones_like(distance))


def reduce_to_4(cand_pos, cand_depth, cand_valid):
    """Select <= 4 of C candidate points maximizing coverage: the deepest,
    the farthest from it, the triangle-area maximizer, then the farthest
    from the triangle (reference: insertion_point_index, geom.hpp:264).
    Returns indices [K,4] int32 and validity [K,4]."""
    K, C = cand_depth.shape
    ar = torch.arange(C, device=cand_depth.device)[None, :]
    big = torch.full_like(cand_depth, BIG)
    depth = torch.where(cand_valid, cand_depth, big)
    i0 = torch.argmin(depth, dim=-1)
    v0 = take1(cand_valid, i0)
    p0 = take1(cand_pos, i0)

    d0 = torch.sum((cand_pos - p0[:, None, :]) ** 2, -1)
    d0 = torch.where(cand_valid, d0, -big)
    d0 = torch.where(ar == i0[:, None], -big, d0)
    i1 = torch.argmax(d0, dim=-1)
    v1 = v0 & (take1(d0, i1) > 0)
    p1 = take1(cand_pos, i1)

    e01 = p1 - p0
    area = vec.length_sqr(vec.cross(cand_pos - p0[:, None, :],
                                    e01[:, None, :]))
    taken = (ar == i0[:, None]) | (ar == i1[:, None])
    area = torch.where(cand_valid & ~taken, area, -big)
    i2 = torch.argmax(area, dim=-1)
    v2 = v1 & (take1(area, i2) > 1e-12)
    p2 = take1(cand_pos, i2)

    d_all = (torch.sum((cand_pos - p0[:, None, :]) ** 2, -1)
             + torch.sum((cand_pos - p1[:, None, :]) ** 2, -1)
             + torch.sum((cand_pos - p2[:, None, :]) ** 2, -1))
    taken = taken | (ar == i2[:, None])
    d_all = torch.where(cand_valid & ~taken, d_all, -big)
    i3 = torch.argmax(d_all, dim=-1)
    v3 = v2 & (take1(d_all, i3) > 0)

    idx = torch.stack([i0, i1, i2, i3], dim=-1).to(torch.int32)
    return idx, torch.stack([v0, v1, v2, v3], dim=-1)
