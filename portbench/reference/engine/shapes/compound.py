"""Compound shapes: rigid unions of convex children (counterpart of
``edyn_tpu/shapes/compound.py``; reference: include/edyn/shapes/
compound_shape.hpp).

Children live as extra rows of the unified convex table, past the N body
rows, so the compound narrowphase expands each (compound, other) pair into
(child, other) sub-pairs that run through the same convex kernels and fold
back to <= 4 points. Mass properties are composed host-side at build.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .inertia import moment_of_inertia, polyhedron_inertia
from .params import PolyhedronShape, ShapeType, _convex_hull


@dataclasses.dataclass
class CompoundTable:
    """Padded per-compound child lists. child_row indexes the convex table;
    child_type / child_params carry the raw shape descriptors."""
    child_row: torch.Tensor     # [NC, CH] int32 (-1 pad)
    child_pos: torch.Tensor     # [NC, CH, 3] local
    child_orn: torch.Tensor     # [NC, CH, 4] local (xyzw)
    child_mask: torch.Tensor    # [NC, CH] bool
    child_type: torch.Tensor    # [NC, CH] int32 ShapeType
    child_params: torch.Tensor  # [NC, CH, 4]

    @staticmethod
    def empty(device, dtype=None) -> "CompoundTable":
        from ..config import scalar_dtype
        dtype = dtype or scalar_dtype()
        orn = torch.zeros((0, 1, 4), dtype=dtype, device=device)
        orn[..., 3] = 1.0
        return CompoundTable(
            child_row=torch.full((0, 1), -1, dtype=torch.int32,
                                 device=device),
            child_pos=torch.zeros((0, 1, 3), dtype=dtype, device=device),
            child_orn=orn,
            child_mask=torch.zeros((0, 1), dtype=torch.bool, device=device),
            child_type=torch.zeros((0, 1), dtype=torch.int32, device=device),
            child_params=torch.zeros((0, 1, 4), dtype=dtype,
                                     device=device))


def _quat_to_matrix_f32(q):
    """The float32 rotation matrix of a quaternion, as the JAX package
    computes it (``math.quat.to_matrix`` on float32)."""
    from ..math import quat
    return quat.to_matrix(torch.as_tensor(q, dtype=torch.float32)).numpy()


def compound_mass_properties(comp, mass: float):
    """(inertia 3x3 about the compound's centre of mass, centre-of-mass
    offset). Children are weighted by volume fraction, each child's inertia
    rotated into the compound frame and shifted by the parallel-axis
    theorem."""
    vols = []
    for shape, lpos, lorn in comp.children:
        if isinstance(shape, PolyhedronShape):
            v = np.asarray(shape.vertices, np.float64)
            vol = abs(sum(np.linalg.det(np.stack([v[f[0]], v[f[1]], v[f[2]]],
                                                 axis=1)) / 6
                          for f in _convex_hull(v)))
        else:
            st, prm = shape.pack()
            p = np.asarray(prm)
            if st == ShapeType.SPHERE:
                vol = 4 / 3 * np.pi * p[0] ** 3
            elif st == ShapeType.BOX:
                vol = 8 * p[0] * p[1] * p[2]
            elif st == ShapeType.CAPSULE:
                vol = np.pi * p[0] ** 2 * (2 * p[1]) + 4 / 3 * np.pi * p[0] ** 3
            elif st == ShapeType.CYLINDER:
                vol = np.pi * p[0] ** 2 * 2 * p[1]
            else:
                vol = 1.0
        vols.append(max(vol, 1e-9))
    vols = np.asarray(vols)
    fracs = vols / vols.sum()

    com = np.zeros(3)
    for frac, (shape, lpos, lorn) in zip(fracs, comp.children):
        com += frac * np.asarray(lpos, np.float64)

    I_total = np.zeros((3, 3))
    for frac, (shape, lpos, lorn) in zip(fracs, comp.children):
        m_child = mass * frac
        if isinstance(shape, PolyhedronShape):
            I_local = polyhedron_inertia(shape.vertices, m_child)
        else:
            st, prm = shape.pack()
            I_local = np.diag(moment_of_inertia(int(st), prm, m_child))
        R = _quat_to_matrix_f32(np.asarray(lorn, np.float64))
        I_rot = R @ I_local @ R.T
        d = np.asarray(lpos, np.float64) - com
        I_total += I_rot + m_child * (np.dot(d, d) * np.eye(3)
                                      - np.outer(d, d))
    return I_total, com


def compound_aabb_extent(comp) -> float:
    """Conservative bounding radius of the compound about its origin."""
    r = 0.0
    for shape, lpos, lorn in comp.children:
        if isinstance(shape, PolyhedronShape):
            ext = float(np.abs(np.asarray(shape.vertices)).max())
        else:
            st, prm = shape.pack()
            p = np.asarray(prm)
            if st == ShapeType.SPHERE:
                ext = p[0]
            elif st == ShapeType.BOX:
                ext = float(np.linalg.norm(p[:3]))
            else:
                ext = float(p[0] + p[1])
        r = max(r, float(np.linalg.norm(lpos)) + ext)
    return r
