"""Shape volumes and mesh centroid, the port's own copy of
``edyn_tpu/shapes/volume.py`` (reference:
include/edyn/math/shape_volume.hpp:12-51, src/edyn/math/shape_volume.cpp;
util/shape_util.hpp:376-384 mesh_centroid). Host-side numpy utilities used
at authoring time (buoyancy, density-derived mass), same tier as
shapes/inertia.py."""
from __future__ import annotations

import math

import numpy as np

from .params import (
    BoxShape, CapsuleShape, CompoundShape, CylinderShape, PolyhedronShape,
    SphereShape, _convex_hull,
)


def sphere_volume(radius: float) -> float:
    return 4.0 / 3.0 * math.pi * radius ** 3


def box_volume(half_extents) -> float:
    h = np.asarray(half_extents, np.float64)
    return float(8.0 * h[0] * h[1] * h[2])


def cylinder_volume(radius: float, half_length: float) -> float:
    return math.pi * radius ** 2 * (2.0 * half_length)


def capsule_volume(radius: float, half_length: float) -> float:
    return cylinder_volume(radius, half_length) + sphere_volume(radius)


def mesh_volume(vertices: np.ndarray, indices: np.ndarray) -> float:
    """Signed volume of a closed triangle mesh with outward winding
    (divergence theorem: sum of origin-apex tetrahedra det/6 — translation
    invariant for a CLOSED surface)."""
    v = np.asarray(vertices, np.float64)
    f = np.asarray(indices, np.int64).reshape(-1, 3)
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    return float(np.einsum("ij,ij->i", a, np.cross(b, c)).sum() / 6.0)


def mesh_centroid(vertices: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Volume centroid of a closed triangle mesh with outward winding
    (reference: mesh_centroid, util/shape_util.hpp:376-384). Each face forms
    a tetrahedron with the origin: volume det/6, centroid (a+b+c+0)/4."""
    v = np.asarray(vertices, np.float64)
    f = np.asarray(indices, np.int64).reshape(-1, 3)
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    w = np.einsum("ij,ij->i", a, np.cross(b, c)) / 6.0
    total = w.sum()
    if abs(total) < 1e-12:
        return v.mean(axis=0)
    return np.asarray((w[:, None] * (a + b + c) / 4.0).sum(axis=0) / total)


def polyhedron_volume(vertices: np.ndarray) -> float:
    """Volume of a convex vertex cloud via its hull triangulation."""
    faces = _convex_hull(np.asarray(vertices, np.float64))
    return mesh_volume(vertices, faces)


def shape_volume(shape) -> float:
    """Volume of a shape instance (reference: the shape_volume overload set,
    math/shape_volume.hpp:46-51 — box, capsule, compound, cylinder,
    polyhedron, sphere). Planes and trimeshes have no volume."""
    if isinstance(shape, SphereShape):
        return sphere_volume(shape.radius)
    if isinstance(shape, BoxShape):
        return box_volume(shape.half_extents)
    if isinstance(shape, CylinderShape):
        return cylinder_volume(shape.radius, shape.half_length)
    if isinstance(shape, CapsuleShape):
        return capsule_volume(shape.radius, shape.half_length)
    if isinstance(shape, PolyhedronShape):
        return polyhedron_volume(shape.vertices)
    if isinstance(shape, CompoundShape):
        return sum(shape_volume(child) for child, _pos, _orn in shape.children)
    raise TypeError(f"shape has no volume: {type(shape).__name__}")
