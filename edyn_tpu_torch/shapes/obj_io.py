"""OBJ loading, the port's own copy of ``edyn_tpu/shapes/obj_io.py``
(reference: util/shape_io.hpp:56-120 — load_tri_mesh_from_obj with
per-vertex materials from vertex colors, and
load_convex_polyhedrons_from_obj splitting objects into convex shapes),
over the port's ``native/loader.py`` and its Python fallback."""
from __future__ import annotations

import numpy as np

from ..native import loader
from .params import MeshShape, PolyhedronShape


def _parse_obj_python(path: str):
    verts, colors, faces = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
                colors.append([float(x) for x in parts[4:7]] if len(parts) >= 7
                              else [1.0, 1.0, 1.0])
            elif parts[0] == "f":
                idx = []
                for tok in parts[1:]:
                    v = int(tok.split("/")[0])
                    idx.append(v - 1 if v > 0 else len(verts) + v)
                for k in range(2, len(idx)):
                    faces.append([idx[0], idx[k - 1], idx[k]])
    return (np.asarray(verts, np.float64), np.asarray(colors, np.float64),
            np.asarray(faces, np.int64))


def parse_obj(path: str):
    """Returns (verts [V,3], colors [V,3], faces [F,3])."""
    out = loader.parse_obj(path) if loader.lib() is not None else None
    if out is None:
        out = _parse_obj_python(path)
    return out


def load_tri_mesh_from_obj(path: str, friction_from_red: bool = False,
                           restitution_from_green: bool = False) -> MeshShape:
    """Concave trimesh from OBJ; optionally map vertex colors to per-vertex
    material scales (reference: per-vertex materials from vertex colors,
    util/shape_io.cpp)."""
    verts, colors, faces = parse_obj(path)
    return MeshShape(
        vertices=verts.astype(np.float32),
        indices=faces,
        vertex_friction=colors[:, 0] if friction_from_red else None,
        vertex_restitution=colors[:, 1] if restitution_from_green else None,
    )


def load_convex_polyhedrons_from_obj(path: str) -> list[PolyhedronShape]:
    """Each connected face group becomes one convex polyhedron (the reference
    splits by OBJ object; we split by connectivity which matches typical
    convex-decomposition exports)."""
    verts, _, faces = parse_obj(path)
    # union-find over shared vertices
    parent = list(range(len(verts)))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for f in faces:
        a = find(int(f[0]))
        for v in f[1:]:
            b = find(int(v))
            parent[b] = a
    groups: dict[int, set] = {}
    for f in faces:
        groups.setdefault(find(int(f[0])), set()).update(int(v) for v in f)
    return [PolyhedronShape(verts[sorted(g)].astype(np.float32))
            for g in groups.values() if len(g) >= 4]
