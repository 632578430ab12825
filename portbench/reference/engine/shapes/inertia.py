"""Moments of inertia per shape, host-side numpy (reference:
src/edyn/dynamics/moment_of_inertia.cpp). The port's own copy of
``edyn_tpu/shapes/inertia.py``."""
from __future__ import annotations

import numpy as np

from .params import ShapeType, _convex_hull


def moment_of_inertia(shape_type: int, params, mass: float) -> np.ndarray:
    """Diagonal local inertia tensor [3]."""
    p = np.asarray(params, np.float64)
    if shape_type == ShapeType.SPHERE:
        s = 2.0 / 5.0 * mass * p[0] ** 2
        return np.array([s, s, s])
    if shape_type == ShapeType.BOX:
        e = 2.0 * p[:3]
        return mass / 12.0 * np.array([
            e[1] ** 2 + e[2] ** 2,
            e[0] ** 2 + e[2] ** 2,
            e[0] ** 2 + e[1] ** 2,
        ])
    if shape_type == ShapeType.CYLINDER:
        r, hl, axis = p[0], p[1], int(p[2])
        L = 2 * hl
        out = np.full(3, mass / 12.0 * (3 * r * r + L * L))
        out[axis] = 0.5 * mass * r * r
        return out
    if shape_type == ShapeType.CAPSULE:
        r, hl, axis = p[0], p[1], int(p[2])
        L = 2 * hl
        m_cyl = mass * L / (L + 4.0 / 3.0 * r) if (L + 4.0 / 3.0 * r) > 0 \
            else 0.0
        m_hemi = (mass - m_cyl) / 2.0
        i_axis = 0.5 * m_cyl * r * r + 2 * m_hemi * (2.0 / 5.0 * r * r)
        i_perp = (m_cyl * (L * L / 12.0 + r * r / 4.0)
                  + 2 * m_hemi * (2.0 / 5.0 * r * r + hl * hl
                                  + 3.0 / 8.0 * r * L))
        out = np.array([i_perp, i_perp, i_perp])
        out[axis] = i_axis
        return out
    # plane / amorphous: point inertia
    return np.array([mass, mass, mass]) * 0.0 + mass * 1e-3


def polyhedron_inertia(vertices: np.ndarray, mass: float) -> np.ndarray:
    """Full 3x3 inertia about the centroid by tetrahedron decomposition."""
    verts = np.asarray(vertices, np.float64)
    faces = _convex_hull(verts)
    C_canon = np.array([[1 / 60, 1 / 120, 1 / 120],
                        [1 / 120, 1 / 60, 1 / 120],
                        [1 / 120, 1 / 120, 1 / 60]])
    C = np.zeros((3, 3))
    vol = 0.0
    centroid = np.zeros(3)
    for f in faces:
        a, b, c = verts[f[0]], verts[f[1]], verts[f[2]]
        A = np.stack([a, b, c], axis=1)
        detA = np.linalg.det(A)
        C += detA * A @ C_canon @ A.T
        vol += detA / 6.0
        centroid += detA / 24.0 * (a + b + c)
    if vol <= 0:
        return np.eye(3) * mass * 1e-3
    centroid /= vol
    C *= mass / vol
    C -= mass * np.outer(centroid, centroid)
    return np.eye(3) * np.trace(C) - C
