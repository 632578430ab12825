"""Host-side shape descriptors and their packed representation (numpy).

The port's own copy of ``edyn_tpu/shapes/params.py`` (reference:
include/edyn/shapes/*.hpp). Each shape becomes a ``ShapeType`` value plus a
4-float parameter row; polyhedra, compounds and meshes index side tables.

Packed ``shape_params`` layout per type:
- SPHERE:     [radius, 0, 0, 0]
- BOX:        [hx, hy, hz, 0]            (half extents)
- CAPSULE:    [radius, half_length, axis(0/1/2), 0]
- CYLINDER:   [radius, half_length, axis(0/1/2), 0]
- PLANE:      [nx, ny, nz, constant]     (static only)
- COMPOUND:   [table_index, 0, 0, 0]
- MESH:       [mesh_index, 0, 0, 0]
- PAGED_MESH: [mesh_index, 1, 0, 0]      (flag marks paged)
- POLYHEDRON: [table_index, 0, 0, 0]
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

import numpy as np


class ShapeType(enum.IntEnum):
    NONE = 0
    SPHERE = 1
    BOX = 2
    CAPSULE = 3
    CYLINDER = 4
    PLANE = 5
    POLYHEDRON = 6
    COMPOUND = 7
    MESH = 8
    PAGED_MESH = 9


AXIS_X, AXIS_Y, AXIS_Z = 0, 1, 2


def shape_roll_direction(stype: int, sparams) -> np.ndarray:
    """Unit object-space rolling axis of cylinders and capsules, zero for
    everything else (reference: shapes.hpp:127-139)."""
    v = np.zeros(3, np.float32)
    if stype in (ShapeType.CYLINDER, ShapeType.CAPSULE):
        v[int(round(float(sparams[2])))] = 1.0
    return v


@dataclasses.dataclass
class SphereShape:
    radius: float

    def pack(self):
        return ShapeType.SPHERE, (self.radius, 0.0, 0.0, 0.0)


@dataclasses.dataclass
class BoxShape:
    half_extents: Sequence[float]

    def pack(self):
        h = tuple(float(x) for x in self.half_extents)
        return ShapeType.BOX, (h[0], h[1], h[2], 0.0)


@dataclasses.dataclass
class CapsuleShape:
    radius: float
    half_length: float
    axis: int = AXIS_X

    def pack(self):
        return ShapeType.CAPSULE, (self.radius, self.half_length,
                                   float(self.axis), 0.0)


@dataclasses.dataclass
class CylinderShape:
    radius: float
    half_length: float
    axis: int = AXIS_X

    def pack(self):
        return ShapeType.CYLINDER, (self.radius, self.half_length,
                                    float(self.axis), 0.0)


@dataclasses.dataclass
class PlaneShape:
    """Infinite plane n.x = c, static only."""
    normal: Sequence[float]
    constant: float = 0.0

    def pack(self):
        n = np.asarray(self.normal, np.float64)
        n = n / np.linalg.norm(n)
        return ShapeType.PLANE, (float(n[0]), float(n[1]), float(n[2]),
                                 float(self.constant))


@dataclasses.dataclass
class PolyhedronShape:
    """Convex polyhedron from a vertex cloud (reference: convex_mesh)."""
    vertices: np.ndarray  # [V,3]

    def pack(self):
        raise RuntimeError("PolyhedronShape is packed via the builder's "
                           "polyhedron table")


@dataclasses.dataclass
class CompoundShape:
    """Children = list of (shape, local_pos, local_orn_xyzw)."""
    children: list

    def pack(self):
        raise RuntimeError("CompoundShape is packed via the builder's "
                           "compound table")


@dataclasses.dataclass
class MeshShape:
    """Concave static triangle mesh (reference: triangle_mesh), with
    optional per-vertex material scales."""
    vertices: np.ndarray  # [V,3]
    indices: np.ndarray   # [T,3]
    vertex_friction: np.ndarray | None = None     # [V] multiplier
    vertex_restitution: np.ndarray | None = None  # [V] multiplier

    def pack(self):
        raise RuntimeError("MeshShape is packed via the builder's mesh table")


@dataclasses.dataclass
class PagedMeshShape(MeshShape):
    """Paged terrain mesh (reference: paged_triangle_mesh), stored like a
    MeshShape."""


@dataclasses.dataclass
class PolyhedronTable:
    """Padded vertex / unique face-normal / unique edge-direction arrays of
    every distinct polyhedron in a world (numpy)."""
    verts: np.ndarray         # [P, MAXV, 3] (padded with the first vertex)
    vert_mask: np.ndarray     # [P, MAXV]
    face_normals: np.ndarray  # [P, MAXF, 3]
    face_mask: np.ndarray     # [P, MAXF]
    edge_dirs: np.ndarray     # [P, MAXE, 3]
    edge_mask: np.ndarray     # [P, MAXE]


def _convex_hull(vertices: np.ndarray):
    """Convex hull faces with outward winding."""
    try:
        from scipy.spatial import ConvexHull
        faces = np.array(ConvexHull(vertices).simplices)
    except ImportError:
        faces = np.array(_incremental_hull(vertices))
    v = np.asarray(vertices, np.float64)
    centroid = v.mean(axis=0)
    for i, f in enumerate(faces):
        a, b, c = v[f[0]], v[f[1]], v[f[2]]
        if np.dot(np.cross(b - a, c - a), a - centroid) < 0:
            faces[i] = [f[0], f[2], f[1]]
    return faces


def _incremental_hull(pts: np.ndarray):
    """Minimal O(V^2) incremental hull (outward triangles)."""
    pts = np.asarray(pts, np.float64)
    n = len(pts)
    if n < 4:
        raise ValueError("polyhedron needs >= 4 vertices")
    i0 = 0
    i1 = max(range(n), key=lambda i: np.linalg.norm(pts[i] - pts[i0]))
    i2 = max(range(n), key=lambda i: np.linalg.norm(
        np.cross(pts[i1] - pts[i0], pts[i] - pts[i0])))
    nrm = np.cross(pts[i1] - pts[i0], pts[i2] - pts[i0])
    i3 = max(range(n), key=lambda i: abs(np.dot(nrm, pts[i] - pts[i0])))
    if np.dot(nrm, pts[i3] - pts[i0]) > 0:
        i1, i2 = i2, i1
    faces = [(i0, i1, i2), (i0, i2, i3), (i0, i3, i1), (i1, i3, i2)]

    def face_normal(f):
        a, b, c = pts[f[0]], pts[f[1]], pts[f[2]]
        return np.cross(b - a, c - a)

    centroid = pts[[i0, i1, i2, i3]].mean(axis=0)
    faces = [f if np.dot(face_normal(f), pts[f[0]] - centroid) > 0
             else (f[0], f[2], f[1]) for f in faces]
    for i in range(n):
        if i in (i0, i1, i2, i3):
            continue
        visible = [f for f in faces
                   if np.dot(face_normal(f), pts[i] - pts[f[0]]) > 1e-12]
        if not visible:
            continue
        edge_count = {}
        for f in visible:
            for e in ((f[0], f[1]), (f[1], f[2]), (f[2], f[0])):
                edge_count.setdefault((min(e), max(e)), []).append(e)
        faces = [f for f in faces if f not in visible]
        for es in edge_count.values():
            if len(es) == 1:
                a, b = es[0]
                faces.append((a, b, i))
    return np.array(faces, np.int64)


def preprocess_polyhedron(vertices: np.ndarray):
    """Unique face normals and edge directions of a convex vertex cloud
    (reference: convex_mesh::initialize relevant-direction dedup)."""
    vertices = np.asarray(vertices, np.float64)
    faces = _convex_hull(vertices)
    tol = 0.0006
    normals = []
    for f in faces:
        a, b, c = vertices[f[0]], vertices[f[1]], vertices[f[2]]
        nrm = np.cross(b - a, c - a)
        ln = np.linalg.norm(nrm)
        if ln < 1e-12:
            continue
        nrm = nrm / ln
        if not any(np.dot(nrm, m) > 1.0 - tol for m in normals):
            normals.append(nrm)
    edges = []
    for f in faces:
        for e in ((f[0], f[1]), (f[1], f[2]), (f[2], f[0])):
            d = vertices[e[1]] - vertices[e[0]]
            ln = np.linalg.norm(d)
            if ln < 1e-12:
                continue
            d = d / ln
            if not any(abs(np.dot(d, m)) > 1.0 - tol for m in edges):
                edges.append(d)
    return np.asarray(normals), np.asarray(edges)


def pack_polyhedra(shapes: list) -> PolyhedronTable:
    """The padded PolyhedronTable of a list of PolyhedronShape."""
    if not shapes:
        z3 = np.zeros((0, 1, 3), np.float32)
        z1 = np.zeros((0, 1), bool)
        return PolyhedronTable(z3, z1, z3, z1, z3, z1)
    pre = [(np.asarray(s.vertices, np.float64),)
           + preprocess_polyhedron(s.vertices) for s in shapes]
    mv = max(len(v) for v, _, _ in pre)
    mf = max(len(f) for _, f, _ in pre)
    me = max(len(e) for _, _, e in pre)
    P = len(pre)
    verts = np.zeros((P, mv, 3), np.float32)
    vmask = np.zeros((P, mv), bool)
    fnorm = np.zeros((P, mf, 3), np.float32)
    fmask = np.zeros((P, mf), bool)
    edirs = np.zeros((P, me, 3), np.float32)
    emask = np.zeros((P, me), bool)
    for i, (v, f, e) in enumerate(pre):
        verts[i, :len(v)] = v
        verts[i, len(v):] = v[0]
        vmask[i, :len(v)] = True
        fnorm[i, :len(f)] = f
        fmask[i, :len(f)] = True
        edirs[i, :len(e)] = e
        emask[i, :len(e)] = True
    return PolyhedronTable(verts, vmask, fnorm, fmask, edirs, emask)
