"""Runtime body creation and destruction in pre-allocated slots
(counterpart of ``edyn_tpu/core/spawn.py``; reference: make_rigidbody and
clear_rigidbody, src/edyn/util/rigidbody.cpp).

A world has a fixed capacity: a new body claims the first free slot and
its def's columns are written into that row. Polyhedron, compound and mesh
shapes must be ones the world's side tables already hold. Every write goes
to a copy of the column it changes, so an earlier ``WorldState`` keeps its
own values.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import numpy_dtype
from ..shapes.inertia import moment_of_inertia, polyhedron_inertia
from ..shapes.params import PolyhedronShape, ShapeType, shape_roll_direction
from .builder import RigidBodyDef
from .state import KIND_DYNAMIC, WorldState


def find_free_slot(state: WorldState) -> int:
    # host read: the slot is a Python int
    free = torch.nonzero(~state.valid).flatten()
    if free.numel() == 0:
        raise RuntimeError("world at capacity: rebuild with a larger "
                           "capacity")
    return int(free[0])


def set_rows(table, i, **values):
    """A copy of ``table`` (a dataclass of tensors) whose columns named in
    ``values`` are new tensors with row ``i`` (an index or an index
    tensor) set; the other columns are shared."""
    out = {}
    for name, v in values.items():
        col = getattr(table, name).clone()
        col[i] = (torch.as_tensor(v, dtype=col.dtype, device=col.device)
                  if isinstance(v, np.ndarray) else v)
        out[name] = col
    return dataclasses.replace(table, **out)


def spawn_rigidbody(state: WorldState, d: RigidBodyDef,
                    slot: int | None = None,
                    default_gravity=(0.0, -9.8, 0.0),
                    poly_index: int | None = None):
    """Returns (state, slot): ``d`` written into a free slot (or ``slot``)
    as make_rigidbody writes it."""
    i = find_free_slot(state) if slot is None else slot

    if d.shape is None:
        stype, sparams = ShapeType.NONE, (0.0, 0.0, 0.0, 0.0)
        sindex = 0
    elif isinstance(d.shape, PolyhedronShape):
        if poly_index is None:
            raise ValueError("a runtime polyhedron needs poly_index into "
                             "the world's polyhedron table")
        stype = ShapeType.POLYHEDRON
        sparams = (float(poly_index), 0.0, 0.0, 0.0)
        sindex = poly_index
    else:
        stype, sparams = d.shape.pack()
        sindex = 0

    if d.kind == KIND_DYNAMIC:
        if not (d.mass > 0 and np.isfinite(d.mass)):
            raise ValueError("dynamic body needs finite positive mass")
        mass_inv = 1.0 / d.mass
        if d.inertia is not None:
            I = np.asarray(d.inertia, np.float64)
            I = np.diag(I) if I.ndim == 1 else I
        elif isinstance(d.shape, PolyhedronShape):
            I = polyhedron_inertia(d.shape.vertices, d.mass)
        elif d.shape is not None:
            I = np.diag(moment_of_inertia(int(stype), sparams, d.mass))
        else:
            raise ValueError("dynamic amorphous body requires explicit "
                             "inertia")
        inertia_inv = np.linalg.inv(I)
        grav = d.gravity if d.gravity is not None else default_gravity
    else:
        mass_inv = 0.0
        inertia_inv = np.zeros((3, 3))
        grav = (0.0, 0.0, 0.0)

    m = d.material
    orn = np.asarray(d.orientation, np.float64)
    orn = orn / np.linalg.norm(orn)

    # def.position is the shape origin; the stored position is the world
    # COM (reference: apply_center_of_mass, rigidbody.cpp:517-543)
    com = np.zeros(3)
    pos_w = np.asarray(d.position, np.float64)
    linvel = np.asarray(d.linvel, np.float64)
    if d.center_of_mass is not None:
        com = np.asarray(d.center_of_mass, np.float64)
        qv, qw = orn[:3], orn[3]
        t = 2.0 * np.cross(qv, com)
        com_w = com + qw * t + np.cross(qv, t)
        pos_w = pos_w + com_w
        linvel = linvel + np.cross(np.asarray(d.angvel, np.float64), com_w)
        if d.kind == KIND_DYNAMIC and d.inertia is None:
            sk = np.array([[0, -com[2], com[1]],
                           [com[2], 0, -com[0]],
                           [-com[1], com[0], 0]])
            inertia_inv = np.linalg.inv(np.linalg.inv(inertia_inv)
                                        + d.mass * (sk.T @ sk))

    f = numpy_dtype(state.dtype)  # staged at the world's scalar dtype
    host = lambda x: np.asarray(x, np.float64).astype(f)
    st = set_rows(
        state, i,
        valid=True, kind=int(d.kind),
        # unseat the carried broadphase box of a recycled slot so the next
        # step seats it at the new body's AABB
        bp_aabb_min=1e30, bp_aabb_max=-1e30,
        pos=host(pos_w), com=host(com), orn=host(orn), linvel=host(linvel),
        angvel=host(d.angvel), mass_inv=float(mass_inv),
        inertia_inv=host(inertia_inv), gravity=host(grav),
        restitution=m.restitution if m else 0.0,
        friction=m.friction if m else 0.5,
        spin_friction=m.spin_friction if m else 0.0,
        roll_friction=m.roll_friction if m else 0.0,
        stiffness=m.stiffness if m else 1e10,
        damping=m.damping if m else 1e10,
        has_material=m is not None, material_id=m.id if m else -1,
        group=int(d.collision_group), mask=int(d.collision_mask),
        shape_type=int(stype), shape_params=host(sparams),
        shape_index=int(sindex),
        roll_axis=host(shape_roll_direction(int(stype), sparams)),
        sleeping_disabled=bool(d.sleeping_disabled),
        networked=bool(d.networked), asleep=False, sleep_timer=0.0)
    data = None
    if stype == ShapeType.POLYHEDRON:
        # host read: the polyhedron's rows of the world's table
        p = state.poly
        pi = int(sindex)
        h = lambda x: x[pi].cpu().numpy()
        data = (h(p.verts)[h(p.vert_mask)], 0.0,
                h(p.face_normals)[h(p.face_mask)],
                h(p.edge_dirs)[h(p.edge_mask)], 0.0,
                np.array([0.0, 0.0, 1.0]))
    st = dataclasses.replace(st, convex=update_convex_row(
        st.convex, i, int(stype), sparams, data))
    return st, i


def update_convex_row(cx, i: int, stype: int, sparams, data=None):
    """One body's unified convex data written into the (fixed-width)
    table. The shape must fit the world's padded vertex, face and edge
    widths."""
    from ..shapes.convex import shape_convex_data
    return update_convex_rows(cx, [i], [data if data is not None
                                        else shape_convex_data(stype,
                                                               sparams)])


def update_convex_rows(cx, rows, datas):
    """Bodies' unified convex data (``shape_convex_data`` tuples, one per
    row) written into copies of the table's columns, one write a column."""
    V = cx.verts.shape[1]
    F = cx.face_normals.shape[1]
    E = cx.edge_dirs.shape[1]
    K = len(rows)
    pad_v = np.zeros((K, V, 3), np.float32)
    vm = np.zeros((K, V), bool)
    rad = np.zeros((K,), np.float32)
    pad_f = np.zeros((K, F, 3), np.float32)
    fm = np.zeros((K, F), bool)
    pad_e = np.zeros((K, E, 3), np.float32)
    em = np.zeros((K, E), bool)
    dr_ = np.zeros((K,), np.float32)
    da_ = np.zeros((K, 3), np.float32)
    for k, (v, r, f, e, dr, da) in enumerate(datas):
        if len(v) > V or len(f) > F or len(e) > E:
            raise ValueError("the shape exceeds the world's convex table "
                             "widths: build the world with at least one "
                             "shape of this complexity")
        pad_v[k, :len(v)] = v
        if len(v):
            pad_v[k, len(v):] = v[0]
        vm[k, :len(v)] = True
        rad[k] = r
        pad_f[k, :len(f)] = f
        fm[k, :len(f)] = True
        pad_e[k, :len(e)] = e
        em[k, :len(e)] = True
        dr_[k] = dr
        da_[k] = np.asarray(da, np.float64)
    idx = torch.as_tensor(np.asarray(rows, np.int64), device=cx.verts.device)
    return set_rows(
        cx, idx, verts=pad_v, vert_mask=vm, radius=rad, face_normals=pad_f,
        face_mask=fm, edge_dirs=pad_e, edge_mask=em, disc_r=dr_,
        disc_axis=da_)


def destroy_rigidbody(state: WorldState, i) -> WorldState:
    """reference: clear_rigidbody (src/edyn/util/rigidbody.cpp); ``i`` is
    a slot or an index tensor of slots."""
    return set_rows(
        state, i, valid=False, bp_aabb_min=1e30, bp_aabb_max=-1e30,
        com=0.0, shape_type=int(ShapeType.NONE), roll_axis=0.0,
        linvel=0.0, angvel=0.0, mass_inv=0.0, asleep=False)
