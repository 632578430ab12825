"""Static triangle meshes (concave terrain): the baked mesh table and its
candidate grid (counterpart of ``edyn_tpu/shapes/mesh.py``; reference:
include/edyn/shapes/triangle_mesh.hpp).

The reference's BVH becomes a dense 2D cell grid over the mesh's dominant
plane, baked host-side in numpy: every triangle is registered (with margin)
in every cell it overlaps, so a body's narrowphase candidates are one
gather ``grid[cell] -> [CAP]`` triangle ids. Triangle geometry is stored
pre-gathered per triangle (vertices, normal, edge-adjacent normals for the
Voronoi-region internal-edge rejection, per-triangle material scales).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import scalar_dtype

CAP = 64  # candidate triangles per grid cell


@dataclasses.dataclass
class MeshTable:
    """Padded SoA over all mesh shapes in a world."""
    tri_verts: torch.Tensor    # [NM, MAXT, 3, 3]
    tri_normal: torch.Tensor   # [NM, MAXT, 3]
    adj_normal: torch.Tensor   # [NM, MAXT, 3, 3] neighbour normal per edge
    tri_mask: torch.Tensor     # [NM, MAXT] bool
    tri_friction: torch.Tensor     # [NM, MAXT] per-triangle material scale
    tri_restitution: torch.Tensor  # [NM, MAXT]
    aabb: torch.Tensor         # [NM, 2, 3] object-space bounds
    grid: torch.Tensor         # [NM, GX, GY, CAP] int32 tri ids (-1 pad)
    grid_origin: torch.Tensor  # [NM, 2]
    grid_cell: torch.Tensor    # [NM] cell size
    grid_axes: torch.Tensor    # [NM, 2] int32 coordinate axes of the grid

    @staticmethod
    def empty(device, dtype=None) -> "MeshTable":
        dtype = dtype or scalar_dtype()
        f = lambda *s: torch.zeros(s, dtype=dtype, device=device)
        i = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
        return MeshTable(
            tri_verts=f(0, 1, 3, 3), tri_normal=f(0, 1, 3),
            adj_normal=f(0, 1, 3, 3),
            tri_mask=torch.zeros((0, 1), dtype=torch.bool, device=device),
            tri_friction=f(0, 1), tri_restitution=f(0, 1), aabb=f(0, 2, 3),
            grid=i(0, 1, 1, 1), grid_origin=f(0, 2), grid_cell=f(0),
            grid_axes=i(0, 2))


def preprocess_trimesh(vertices, indices, vertex_friction=None,
                       vertex_restitution=None):
    """Per-triangle vertices and unit normals, the neighbour's normal across
    each edge (own normal on a boundary; reference: triangle_mesh::
    calculate_adjacent_normals) and per-triangle material scales, the mean
    of the per-vertex ones."""
    vertices = np.asarray(vertices, np.float64)
    indices = np.asarray(indices, np.int64)
    T = len(indices)
    tv = vertices[indices]                       # [T,3,3]
    n = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
    n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    edge_map: dict[tuple, list] = {}
    for t, tri in enumerate(indices):
        for e in range(3):
            a, b = int(tri[e]), int(tri[(e + 1) % 3])
            edge_map.setdefault((min(a, b), max(a, b)), []).append((t, e))
    adj = np.repeat(n[:, None, :], 3, axis=1)
    for users in edge_map.values():
        if len(users) == 2:
            (t0, e0), (t1, e1) = users
            adj[t0, e0] = n[t1]
            adj[t1, e1] = n[t0]
    fr = (np.asarray(vertex_friction)[indices].mean(axis=1)
          if vertex_friction is not None else np.ones(T))
    re = (np.asarray(vertex_restitution)[indices].mean(axis=1)
          if vertex_restitution is not None else np.ones(T))
    return tv, n, adj, fr, re


def build_grid(tv, cell_size: float | None = None, cap: int = CAP,
               margin: float = 0.5):
    """Bake the 2D candidate grid over the mesh's two widest axes: each
    triangle, inflated by ``margin``, is registered in every cell it
    overlaps (the first ``cap`` of a cell are kept). Returns (grid
    [GX,GY,cap], origin [2], cell size, axes [2], (lo, hi), the most
    triangles one cell dropped)."""
    lo = tv.reshape(-1, 3).min(axis=0)
    hi = tv.reshape(-1, 3).max(axis=0)
    extent = hi - lo
    up = int(np.argmin(extent))          # thinnest axis = height axis
    axes = [a for a in range(3) if a != up]
    if cell_size is None:
        area = max(extent[axes[0]] * extent[axes[1]], 1e-6)
        cell_size = max(np.sqrt(area / max(len(tv), 1)) * 2.0, 1e-3)
    gx = max(1, int(np.ceil(extent[axes[0]] / cell_size)) + 1)
    gy = max(1, int(np.ceil(extent[axes[1]] / cell_size)) + 1)
    origin = np.array([lo[axes[0]], lo[axes[1]]])
    cells: dict[tuple, list] = {}
    for t, tri in enumerate(tv):
        tlo = tri.min(axis=0) - margin
        thi = tri.max(axis=0) + margin
        x0 = int((tlo[axes[0]] - lo[axes[0]]) // cell_size)
        x1 = int((thi[axes[0]] - lo[axes[0]]) // cell_size)
        y0 = int((tlo[axes[1]] - lo[axes[1]]) // cell_size)
        y1 = int((thi[axes[1]] - lo[axes[1]]) // cell_size)
        for cx in range(max(0, x0), min(gx - 1, x1) + 1):
            for cy in range(max(0, y0), min(gy - 1, y1) + 1):
                cells.setdefault((cx, cy), []).append(t)
    overflow = max((max(len(v) - cap, 0) for v in cells.values()), default=0)
    grid = np.full((gx, gy, cap), -1, np.int32)
    for (cx, cy), tris in cells.items():
        grid[cx, cy, :min(len(tris), cap)] = tris[:cap]
    return grid, origin, float(cell_size), np.array(axes, np.int32), \
        (lo, hi), overflow


def pack_meshes(mesh_shapes: list, device, dtype=None,
                cap: int = CAP) -> MeshTable:
    """The padded MeshTable of MeshShape descriptors, on ``device``: staged
    in float32 as the JAX package stages it, placed at ``dtype`` (default
    the scalar dtype)."""
    dtype = dtype or scalar_dtype()
    if not mesh_shapes:
        return MeshTable.empty(device, dtype)
    pre = []
    for m in mesh_shapes:
        tv, n, adj, fr, re = preprocess_trimesh(
            m.vertices, m.indices, m.vertex_friction, m.vertex_restitution)
        grid, origin, cell, axes, bounds, _ = build_grid(tv, cap=cap)
        pre.append((tv, n, adj, fr, re, grid, origin, cell, axes, bounds))
    NM = len(pre)
    MAXT = max(len(p[0]) for p in pre)
    GX = max(p[5].shape[0] for p in pre)
    GY = max(p[5].shape[1] for p in pre)
    f32 = np.float32
    tri_verts = np.zeros((NM, MAXT, 3, 3), f32)
    tri_normal = np.zeros((NM, MAXT, 3), f32)
    adj_normal = np.zeros((NM, MAXT, 3, 3), f32)
    tri_mask = np.zeros((NM, MAXT), bool)
    tri_fr = np.ones((NM, MAXT), f32)
    tri_re = np.ones((NM, MAXT), f32)
    aabb = np.zeros((NM, 2, 3), f32)
    grid = np.full((NM, GX, GY, cap), -1, np.int32)
    gorigin = np.zeros((NM, 2), f32)
    gcell = np.ones((NM,), f32)
    gaxes = np.zeros((NM, 2), np.int32)
    for i, (tv, n, adj, fr, re, g, origin, cell, axes, bounds) in \
            enumerate(pre):
        T = len(tv)
        tri_verts[i, :T] = tv
        tri_normal[i, :T] = n
        adj_normal[i, :T] = adj
        tri_mask[i, :T] = True
        tri_fr[i, :T] = fr
        tri_re[i, :T] = re
        aabb[i, 0], aabb[i, 1] = bounds
        grid[i, :g.shape[0], :g.shape[1]] = g
        gorigin[i] = origin
        gcell[i] = cell
        gaxes[i] = axes
    def t(x):
        x = torch.as_tensor(x, device=device)
        return x.to(dtype) if x.is_floating_point() else x

    return MeshTable(
        tri_verts=t(tri_verts), tri_normal=t(tri_normal),
        adj_normal=t(adj_normal), tri_mask=t(tri_mask),
        tri_friction=t(tri_fr), tri_restitution=t(tri_re), aabb=t(aabb),
        grid=t(grid), grid_origin=t(gorigin), grid_cell=t(gcell),
        grid_axes=t(gaxes))


