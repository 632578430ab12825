"""Scene building: rigidbody_def -> tensor world state.

Counterpart of ``edyn_tpu/core/builder.py`` (reference:
include/edyn/util/rigidbody.hpp rigidbody_def, make_rigidbody): bodies are
staged host-side in numpy at the scalar dtype (``config.scalar_dtype``), as
the JAX builder stages them, and ``finalize`` builds the tensors on the
target device, every float at the scalar dtype. Supports every
shape type (static triangle meshes only, as in the JAX package) and every
joint type (``constraints.api``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import numpy_dtype, scalar_dtype
from ..shapes.params import (
    CompoundShape, MeshShape, PagedMeshShape, PolyhedronShape, ShapeType,
    pack_polyhedra, preprocess_polyhedron, shape_roll_direction,
)
from ..shapes.compound import (
    CompoundTable, compound_aabb_extent, compound_mass_properties,
)
from ..shapes.convex import shape_convex_data
from ..shapes.inertia import moment_of_inertia, polyhedron_inertia
from .device import resolve_device
from .state import (
    KIND_DYNAMIC, KIND_STATIC, MAX_EXCLUSIONS, ContactTable,
    MixTable, PolyTable, WorldState,
)

ALL_GROUPS = 0xFFFFFFFF


@dataclasses.dataclass
class Material:
    """Reference: include/edyn/comp/material.hpp:15-31."""
    restitution: float = 0.0
    friction: float = 0.5
    spin_friction: float = 0.0
    roll_friction: float = 0.0
    stiffness: float = 1e10
    damping: float = 1e10
    id: int = -1


@dataclasses.dataclass
class RigidBodyDef:
    """Reference: rigidbody_def (include/edyn/util/rigidbody.hpp:29-75)."""
    kind: int = KIND_DYNAMIC
    position: Sequence[float] = (0.0, 0.0, 0.0)
    orientation: Sequence[float] = (0.0, 0.0, 0.0, 1.0)  # xyzw
    mass: float = 1.0
    inertia: Optional[np.ndarray] = None
    linvel: Sequence[float] = (0.0, 0.0, 0.0)
    angvel: Sequence[float] = (0.0, 0.0, 0.0)
    center_of_mass: Optional[Sequence[float]] = None
    gravity: Optional[Sequence[float]] = None
    shape: object = None
    material: Optional[Material] = dataclasses.field(default_factory=Material)
    collision_group: int = ALL_GROUPS
    collision_mask: int = ALL_GROUPS
    presentation: bool = True
    sleeping_disabled: bool = False
    networked: bool = False


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch or numpy dtype (None: the scalar
    dtype)."""
    if dtype is None:
        return scalar_dtype()
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def _qrot(q, v):
    qv = q[:3]
    t = 2.0 * np.cross(qv, v)
    return v + q[3] * t + np.cross(qv, t)


class WorldBuilder:
    """Accumulates bodies and joints host-side; ``finalize()`` builds the
    WorldState."""

    def __init__(self, gravity=None):
        self.default_gravity = (None if gravity is None
                                else np.asarray(gravity, np.float64))
        self.defs: list[RigidBodyDef] = []
        self._polyhedra: list[PolyhedronShape] = []
        self._poly_index: dict[int, int] = {}
        self._meshes: list[MeshShape] = []
        self._mesh_index: dict[int, int] = {}
        self._compounds: list[CompoundShape] = []
        self._compound_index: dict[int, int] = {}
        self.exclusions: list[tuple[int, int]] = []
        self.joints: list[dict] = []
        self.material_mixes: list[tuple[int, int, Material]] = []
        # user components: name -> (shape, torch dtype, default)
        self.user_components: dict[str, tuple] = {}
        self.user_component_policies: dict[str, str] = {}

    def make_rigidbody(self, def_: RigidBodyDef) -> int:
        """Returns the body's slot index."""
        idx = len(self.defs)
        self.defs.append(def_)
        sh = def_.shape
        if isinstance(sh, PolyhedronShape):
            if id(sh) not in self._poly_index:
                self._poly_index[id(sh)] = len(self._polyhedra)
                self._polyhedra.append(sh)
        elif isinstance(sh, MeshShape):
            if def_.kind != KIND_STATIC:
                raise ValueError("trimesh bodies are static-only "
                                 "(reference: mesh_shape)")
            if id(sh) not in self._mesh_index:
                self._mesh_index[id(sh)] = len(self._meshes)
                self._meshes.append(sh)
        elif isinstance(sh, CompoundShape):
            if id(sh) not in self._compound_index:
                self._compound_index[id(sh)] = len(self._compounds)
                self._compounds.append(sh)
        return idx

    def exclude_collision(self, a: int, b: int):
        self.exclusions.append((a, b))

    def _add_joint(self, **kw) -> int:
        """Stage one joint (called by the ``constraints.api`` factories)."""
        self.joints.append(kw)
        return len(self.joints) - 1

    def finalize(self, capacity: Optional[int] = None,
                 max_manifolds: Optional[int] = None,
                 max_joints: Optional[int] = None,
                 device=None) -> WorldState:
        """The WorldState of the bodies and joints added so far, on
        ``device`` (default ``cuda``; raises without a GPU, see
        ``resolve_device``). The joint table holds ``max_joints`` slots
        (default: the joints added, at least 1)."""
        from ..constraints.joints import pack_joints
        from ..shapes.aabb import compute_aabbs
        from ..shapes.convex import build_convex_table
        from ..shapes.mesh import pack_meshes

        device = resolve_device(device)
        n = len(self.defs)
        N = capacity or max(n, 1)
        if N < n:
            raise ValueError(f"capacity {N} < {n} bodies")
        M = max_manifolds if max_manifolds is not None else max(64, 8 * N)
        J = max_joints if max_joints is not None else max(len(self.joints), 1)
        if J < len(self.joints):
            raise ValueError(f"max_joints {J} < {len(self.joints)} joints")

        poly_np = pack_polyhedra(self._polyhedra)
        sdt = scalar_dtype()
        f = numpy_dtype(sdt)  # staged as the JAX builder stages
        pos = np.zeros((N, 3), f)
        orn = np.zeros((N, 4), f)
        orn[:, 3] = 1
        linvel = np.zeros((N, 3), f)
        angvel = np.zeros((N, 3), f)
        mass_inv = np.zeros((N,), f)
        inertia_inv = np.zeros((N, 3, 3), f)
        restitution = np.zeros((N,), f)
        friction = np.full((N,), 0.5, f)
        spin_fr = np.zeros((N,), f)
        roll_fr = np.zeros((N,), f)
        stiffness = np.full((N,), 1e10, f)
        damping = np.full((N,), 1e10, f)
        has_mat = np.zeros((N,), bool)
        mat_id = np.full((N,), -1, np.int32)
        gravity = np.zeros((N, 3), f)
        kind = np.full((N,), KIND_STATIC, np.int32)
        valid = np.zeros((N,), bool)
        sleeping_dis = np.zeros((N,), bool)
        networked = np.zeros((N,), bool)
        group = np.full((N,), ALL_GROUPS, np.int64)
        mask = np.full((N,), ALL_GROUPS, np.int64)
        excl = np.full((N, MAX_EXCLUSIONS), -1, np.int32)
        stype = np.zeros((N,), np.int32)
        sparams = np.zeros((N, 4), f)
        sindex = np.zeros((N,), np.int32)
        com = np.zeros((N, 3), f)
        roll_axis = np.zeros((N, 3), f)

        for i, d in enumerate(self.defs):
            valid[i] = True
            kind[i] = d.kind
            pos[i] = d.position
            orn[i] = d.orientation
            orn[i] /= np.linalg.norm(orn[i])
            linvel[i] = d.linvel
            angvel[i] = d.angvel
            if d.center_of_mass is not None:
                com[i] = d.center_of_mass
                com_w = _qrot(np.asarray(orn[i], np.float64), com[i])
                pos[i] = np.asarray(d.position) + com_w
                linvel[i] = np.asarray(d.linvel) + np.cross(angvel[i], com_w)
            default_g = (self.default_gravity if self.default_gravity
                         is not None else np.asarray((0.0, -9.8, 0.0)))
            gravity[i] = d.gravity if d.gravity is not None else (
                default_g if d.kind == KIND_DYNAMIC else 0.0)
            sleeping_dis[i] = d.sleeping_disabled
            networked[i] = d.networked
            group[i] = d.collision_group
            mask[i] = d.collision_mask

            sh = d.shape
            if sh is None:
                stype[i] = ShapeType.NONE
            elif isinstance(sh, PolyhedronShape):
                stype[i] = ShapeType.POLYHEDRON
                sindex[i] = self._poly_index[id(sh)]
                sparams[i, 0] = sindex[i]
            elif isinstance(sh, MeshShape):
                stype[i] = (ShapeType.PAGED_MESH
                            if isinstance(sh, PagedMeshShape)
                            else ShapeType.MESH)
                sindex[i] = self._mesh_index[id(sh)]
                sparams[i, 0] = sindex[i]
            elif isinstance(sh, CompoundShape):
                stype[i] = ShapeType.COMPOUND
                sindex[i] = self._compound_index[id(sh)]
                sparams[i, 0] = sindex[i]
            else:
                st, prm = sh.pack()
                stype[i] = st
                sparams[i] = prm
            roll_axis[i] = shape_roll_direction(int(stype[i]), sparams[i])

            if d.kind == KIND_DYNAMIC:
                if not (d.mass > 0 and np.isfinite(d.mass)):
                    raise ValueError("dynamic body needs finite positive mass")
                mass_inv[i] = 1.0 / d.mass
                if d.inertia is not None:
                    I = np.asarray(d.inertia, np.float64)
                    I = np.diag(I) if I.ndim == 1 else I
                elif isinstance(sh, PolyhedronShape):
                    I = polyhedron_inertia(sh.vertices, d.mass)
                elif isinstance(sh, CompoundShape):
                    I, _ = compound_mass_properties(sh, d.mass)
                elif sh is not None:
                    I = np.diag(moment_of_inertia(int(stype[i]), sparams[i],
                                                  d.mass))
                else:
                    raise ValueError("dynamic amorphous body requires "
                                     "explicit inertia")
                if d.center_of_mass is not None and d.inertia is None:
                    dvec = np.asarray(d.center_of_mass, np.float64)
                    sk = np.array([[0, -dvec[2], dvec[1]],
                                   [dvec[2], 0, -dvec[0]],
                                   [-dvec[1], dvec[0], 0]])
                    I = I + d.mass * (sk.T @ sk)
                inertia_inv[i] = np.linalg.inv(I)

            if d.material is not None:
                has_mat[i] = True
                m = d.material
                restitution[i] = m.restitution
                friction[i] = m.friction
                spin_fr[i] = m.spin_friction
                roll_fr[i] = m.roll_friction
                stiffness[i] = m.stiffness
                damping[i] = m.damping
                mat_id[i] = m.id

        for a, b in self.exclusions:
            for (x, y) in ((a, b), (b, a)):
                excl[x, np.argmax(excl[x] == -1)] = y

        def t(x):
            x = np.asarray(x)
            if x.dtype.kind == "f":
                x = x.astype(f)
            return torch.as_tensor(x, device=device)

        poly = PolyTable(t(poly_np.verts), t(poly_np.vert_mask),
                         t(poly_np.face_normals), t(poly_np.face_mask),
                         t(poly_np.edge_dirs), t(poly_np.edge_mask))
        # compound children become extra convex-table rows past the N
        # bodies; a compound body's own row is its bounding sphere (AABB)
        child_data, comp_rows = [], []
        for comp in self._compounds:
            rows = []
            for shape, _, _ in comp.children:
                if isinstance(shape, PolyhedronShape):
                    pi = self._poly_index.get(id(shape))
                    if pi is None:
                        v = np.asarray(shape.vertices, np.float64)
                        fn, ed = preprocess_polyhedron(v)
                        data = (v, 0.0, fn, ed, 0.0,
                                np.array([0.0, 0.0, 1.0]))
                    else:
                        data = shape_convex_data(int(ShapeType.POLYHEDRON),
                                                 (pi, 0, 0, 0), poly_np, pi)
                else:
                    st_c, prm_c = shape.pack()
                    data = shape_convex_data(int(st_c), prm_c)
                rows.append(N + len(child_data))
                child_data.append(data)
            comp_rows.append(rows)
        convex = build_convex_table(stype, sparams, sindex, poly_np,
                                    extra_data=child_data, device=device,
                                    dtype=sdt)
        for i, d in enumerate(self.defs):
            if isinstance(d.shape, CompoundShape):
                convex.radius[i] = compound_aabb_extent(d.shape)
        compound = self._compound_table(comp_rows, device, f)
        if self.material_mixes:
            ids = np.array([[ia, ib] for ia, ib, _ in self.material_mixes],
                           np.int32)
            vals = np.array([[m.restitution, m.friction, m.spin_friction,
                              m.roll_friction, m.stiffness, m.damping]
                             for _, _, m in self.material_mixes], f)
            mix = MixTable(ids=t(ids), vals=t(vals))
        else:
            mix = MixTable.empty(device, sdt)

        def zf(*s):
            return torch.zeros(s, dtype=sdt, device=device)

        scalar = lambda v, dt: torch.tensor(v, dtype=dt, device=device)
        ws = WorldState(
            pos=t(pos), orn=t(orn), linvel=t(linvel), angvel=t(angvel),
            mass_inv=t(mass_inv), inertia_inv=t(inertia_inv), com=t(com),
            restitution=t(restitution), friction=t(friction),
            spin_friction=t(spin_fr), roll_friction=t(roll_fr),
            stiffness=t(stiffness), damping=t(damping),
            has_material=t(has_mat), material_id=t(mat_id),
            gravity=t(gravity), kind=t(kind), valid=t(valid),
            sleeping_disabled=t(sleeping_dis), networked=t(networked),
            group=t(group), mask=t(mask), exclusions=t(excl),
            shape_type=t(stype), shape_params=t(sparams),
            shape_index=t(sindex),
            aabb_min=zf(N, 3), aabb_max=zf(N, 3),
            bp_aabb_min=torch.full((N, 3), 1e30, dtype=sdt, device=device),
            bp_aabb_max=torch.full((N, 3), -1e30, dtype=sdt, device=device),
            roll_axis=t(roll_axis),
            island_id=torch.full((N,), -1, dtype=torch.int32, device=device),
            sleep_timer=zf(N),
            asleep=torch.zeros((N,), dtype=torch.bool, device=device),
            edge_pointed=torch.zeros((M,), dtype=torch.bool, device=device),
            labels_stable=scalar(False, torch.bool),
            island_stable_steps=scalar(0, torch.int32),
            bp_carry_ok=scalar(False, torch.bool),
            contacts=ContactTable.zeros(M, device, sdt),
            joints=pack_joints(self.joints, J, device, sdt),
            poly=poly, mesh=pack_meshes(self._meshes, device, sdt),
            convex=convex,
            compound=compound, mix_table=mix,
            step_count=scalar(0, torch.int32),
            sim_time=scalar(0.0, sdt),
            overflow=torch.zeros((5,), dtype=torch.int32, device=device),
            user={name: torch.full((N,) + shape, default, dtype=dt,
                                   device=device)
                  for name, (shape, dt, default)
                  in self.user_components.items()})
        amin, amax = compute_aabbs(ws.shape_type, ws.origin_pos(), ws.orn,
                                   ws.convex, ws.shape_index, ws.mesh)
        return dataclasses.replace(ws, aabb_min=amin, aabb_max=amax)

    def _compound_table(self, comp_rows, device, f) -> CompoundTable:
        """The padded child lists of the compounds, staged at numpy dtype
        ``f``; ``comp_rows`` are their children's convex-table rows."""
        if not self._compounds:
            return CompoundTable.empty(device, torch_dtype(f))
        CH = max(len(r) for r in comp_rows)
        NC = len(self._compounds)
        c_row = np.full((NC, CH), -1, np.int32)
        c_pos = np.zeros((NC, CH, 3), f)
        c_orn = np.zeros((NC, CH, 4), f)
        c_orn[..., 3] = 1
        c_mask = np.zeros((NC, CH), bool)
        c_type = np.zeros((NC, CH), np.int32)
        c_prm = np.zeros((NC, CH, 4), f)
        for ci, (comp, rows) in enumerate(zip(self._compounds, comp_rows)):
            for k, ((shape, lpos, lorn), row) in enumerate(
                    zip(comp.children, rows)):
                c_row[ci, k] = row
                c_pos[ci, k] = lpos
                q = np.asarray(lorn, np.float64)
                c_orn[ci, k] = q / np.linalg.norm(q)
                c_mask[ci, k] = True
                if isinstance(shape, PolyhedronShape):
                    c_type[ci, k] = int(ShapeType.POLYHEDRON)
                else:
                    st_c, prm_c = shape.pack()
                    c_type[ci, k] = int(st_c)
                    c_prm[ci, k] = prm_c
        t = lambda x: torch.as_tensor(x, device=device)
        return CompoundTable(
            child_row=t(c_row), child_pos=t(c_pos), child_orn=t(c_orn),
            child_mask=t(c_mask), child_type=t(c_type),
            child_params=t(c_prm))
