"""Unified convex representation: every convex shape as a padded point cloud
with a radius, its SAT face-normal and edge-direction sets, and a cylinder
cap-disc term (support(d) = max over verts + radius * d + disc_r *
|d_perp|). Counterpart of ``edyn_tpu/shapes/convex.py``; exact for spheres,
capsules, boxes, polyhedra and cylinders.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import scalar_dtype
from ..core.device import resolve_device
from .params import ShapeType


@dataclasses.dataclass
class ConvexTable:
    """Per-body unified convex data (object space)."""
    verts: torch.Tensor         # [N,V,3]
    vert_mask: torch.Tensor     # [N,V] bool
    radius: torch.Tensor        # [N]
    face_normals: torch.Tensor  # [N,F,3]
    face_mask: torch.Tensor     # [N,F] bool
    edge_dirs: torch.Tensor     # [N,E,3]
    edge_mask: torch.Tensor     # [N,E] bool
    disc_r: torch.Tensor        # [N] cylinder cap-disc radius (0 otherwise)
    disc_axis: torch.Tensor     # [N,3] cylinder axis (object space, unit)


def _axis_vec(axis: int):
    v = np.zeros(3)
    v[axis] = 1.0
    return v


_NO_DISC = (0.0, np.array([0.0, 0.0, 1.0]))


def shape_convex_data(stype: int, params, poly_np=None, poly_index: int = 0):
    """(verts [v,3], radius, face_normals [f,3], edge_dirs [e,3], disc_r,
    disc_axis [3]) in object space for one shape."""
    p = np.asarray(params, np.float64)
    if stype == ShapeType.SPHERE:
        return (np.zeros((1, 3)), float(p[0]), np.zeros((0, 3)),
                np.zeros((0, 3))) + _NO_DISC
    if stype == ShapeType.BOX:
        h = p[:3]
        verts = np.array([[sx * h[0], sy * h[1], sz * h[2]]
                          for sx in (-1, 1) for sy in (-1, 1)
                          for sz in (-1, 1)])
        eye = np.eye(3)
        return (verts, 0.0, eye, eye) + _NO_DISC
    if stype == ShapeType.CAPSULE:
        r, hl, axis = float(p[0]), float(p[1]), int(p[2])
        a = _axis_vec(axis)
        return (np.stack([a * hl, -a * hl]), r, a[None, :],
                a[None, :]) + _NO_DISC
    if stype == ShapeType.CYLINDER:
        r, hl, axis = float(p[0]), float(p[1]), int(p[2])
        a = _axis_vec(axis)
        return np.stack([a * hl, -a * hl]), 0.0, a[None, :], a[None, :], r, a
    if stype == ShapeType.POLYHEDRON and poly_np is not None:
        vm = poly_np.vert_mask[poly_index]
        fm = poly_np.face_mask[poly_index]
        em = poly_np.edge_mask[poly_index]
        return (poly_np.verts[poly_index][vm], 0.0,
                poly_np.face_normals[poly_index][fm],
                poly_np.edge_dirs[poly_index][em]) + _NO_DISC
    # NONE / PLANE / MESH / COMPOUND: point placeholder (never a convex side
    # of a pair; a compound's children have rows of their own)
    return (np.zeros((1, 3)), 0.0, np.zeros((0, 3)),
            np.zeros((0, 3))) + _NO_DISC


def build_convex_table(shape_types, shape_params, shape_index, poly_np=None,
                       extra_data=None, device=None,
                       dtype=None) -> ConvexTable:
    """Bake the per-body table host-side and place it on ``device``
    (default ``cuda``; raises without a GPU, see ``resolve_device``).
    ``extra_data`` appends rows (compound children, each a
    ``shape_convex_data`` tuple) past the N body rows. Staged in float32,
    as the JAX package stages it (its x64 mode keeps this table at
    float32); placed at ``dtype`` (default the scalar dtype), so a float64
    world holds the same values at float64 and one dtype runs the step."""
    device = resolve_device(device)
    dtype = dtype or scalar_dtype()
    data = [shape_convex_data(int(shape_types[i]), shape_params[i], poly_np,
                              int(shape_index[i]))
            for i in range(len(shape_types))] + list(extra_data or ())
    N = len(data)
    V = max(max((len(d[0]) for d in data), default=1), 1)
    F = max(max((len(d[2]) for d in data), default=1), 1)
    E = max(max((len(d[3]) for d in data), default=1), 1)
    f32 = np.float32
    verts = np.zeros((N, V, 3), f32)
    vmask = np.zeros((N, V), bool)
    radius = np.zeros((N,), f32)
    fnorm = np.zeros((N, F, 3), f32)
    fmask = np.zeros((N, F), bool)
    edirs = np.zeros((N, E, 3), f32)
    emask = np.zeros((N, E), bool)
    disc_r = np.zeros((N,), f32)
    disc_ax = np.zeros((N, 3), f32)
    disc_ax[:, 2] = 1.0
    for i, (v, r, f, e, dr, da) in enumerate(data):
        verts[i, :len(v)] = v
        verts[i, len(v):] = v[0] if len(v) else 0.0
        vmask[i, :len(v)] = True
        radius[i] = r
        fnorm[i, :len(f)] = f
        fmask[i, :len(f)] = True
        edirs[i, :len(e)] = e
        emask[i, :len(e)] = True
        disc_r[i] = dr
        disc_ax[i] = da

    def t(x):
        x = torch.as_tensor(x, device=device)
        return x.to(dtype) if x.is_floating_point() else x

    return ConvexTable(
        verts=t(verts), vert_mask=t(vmask), radius=t(radius),
        face_normals=t(fnorm), face_mask=t(fmask),
        edge_dirs=t(edirs), edge_mask=t(emask),
        disc_r=t(disc_r), disc_axis=t(disc_ax))

