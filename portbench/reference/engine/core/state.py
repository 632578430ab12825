"""The world state: a fixed-capacity structure of tensors.

Counterpart of ``edyn_tpu/core/state.py`` with the same field names, so a
JAX state flattened to numpy maps onto it field by field
(``core/convert.py``). Differences of representation:
- pair keys are int64 ``a * N + b`` with ``INVALID_KEY`` = int64 max (the
  JAX package uses uint32 with uint32 max; the order is the same);
- collision group/mask are int64 holding the uint32 bit patterns.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import MAX_CONTACTS, scalar_dtype

KIND_DYNAMIC = 0
KIND_KINEMATIC = 1
KIND_STATIC = 2

MAX_EXCLUSIONS = 16
MAX_JOINT_ROWS = 24
INVALID_KEY = torch.iinfo(torch.int64).max


@dataclasses.dataclass
class ContactTable:
    """Persistent 4-point contact manifolds, one slot per body pair, slot
    stable for the manifold's life (reference: contact_manifold +
    contact_point)."""
    key: torch.Tensor            # [M] int64, INVALID_KEY when free
    body_a: torch.Tensor         # [M] int32
    body_b: torch.Tensor         # [M] int32
    valid: torch.Tensor          # [M] bool
    sort_key: torch.Tensor       # [M] int64 ascending admitted keys
    sort_slot: torch.Tensor      # [M] int32, == M when the key has no slot
    sort_pvalid: torch.Tensor    # [M] bool
    point_valid: torch.Tensor    # [M,4] bool
    pivot_a: torch.Tensor        # [M,4,3]
    pivot_b: torch.Tensor        # [M,4,3]
    local_normal: torch.Tensor   # [M,4,3]
    normal_attachment: torch.Tensor  # [M,4] int32: 0 none, 1 A, 2 B
    distance: torch.Tensor       # [M,4]
    lifetime: torch.Tensor       # [M,4] int32
    normal_impulse: torch.Tensor     # [M,4]
    friction_impulse: torch.Tensor   # [M,4,2]
    spin_impulse: torch.Tensor       # [M,4]
    roll_impulse: torch.Tensor       # [M,4,2]
    friction_scale: torch.Tensor     # [M,4]
    restitution_scale: torch.Tensor  # [M,4]

    @staticmethod
    def zeros(M: int, device, dtype=None) -> "ContactTable":
        P = MAX_CONTACTS
        dtype = dtype or scalar_dtype()
        f = lambda *s: torch.zeros(s, dtype=dtype, device=device)
        i = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
        b = lambda *s: torch.zeros(s, dtype=torch.bool, device=device)
        inv = lambda: torch.full((M,), INVALID_KEY, dtype=torch.int64,
                                 device=device)
        return ContactTable(
            key=inv(), body_a=i(M), body_b=i(M), valid=b(M),
            sort_key=inv(),
            sort_slot=torch.full((M,), M, dtype=torch.int32, device=device),
            sort_pvalid=b(M), point_valid=b(M, P),
            pivot_a=f(M, P, 3), pivot_b=f(M, P, 3), local_normal=f(M, P, 3),
            normal_attachment=i(M, P), distance=f(M, P), lifetime=i(M, P),
            normal_impulse=f(M, P), friction_impulse=f(M, P, 2),
            spin_impulse=f(M, P), roll_impulse=f(M, P, 2),
            friction_scale=torch.ones((M, P), dtype=dtype, device=device),
            restitution_scale=torch.ones((M, P), dtype=dtype, device=device))


def grow_contact_table(tab: ContactTable, newM: int) -> ContactTable:
    """Pad the manifold table to ``newM`` slots keeping every live manifold
    in place (grow-on-overflow)."""
    M = tab.key.shape[0]
    if newM <= M:
        return tab
    pad = newM - M

    def ext(x, fill):
        return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill,
                                        dtype=x.dtype, device=x.device)])

    return dataclasses.replace(
        tab,
        key=ext(tab.key, INVALID_KEY),
        body_a=ext(tab.body_a, 0), body_b=ext(tab.body_b, 0),
        valid=ext(tab.valid, False),
        sort_key=ext(tab.sort_key, INVALID_KEY),
        sort_slot=ext(torch.where(tab.sort_slot >= M,
                                  torch.full_like(tab.sort_slot, newM),
                                  tab.sort_slot), newM),
        sort_pvalid=ext(tab.sort_pvalid, False),
        point_valid=ext(tab.point_valid, False),
        pivot_a=ext(tab.pivot_a, 0.0), pivot_b=ext(tab.pivot_b, 0.0),
        local_normal=ext(tab.local_normal, 0.0),
        normal_attachment=ext(tab.normal_attachment, 0),
        distance=ext(tab.distance, 0.0), lifetime=ext(tab.lifetime, 0),
        normal_impulse=ext(tab.normal_impulse, 0.0),
        friction_impulse=ext(tab.friction_impulse, 0.0),
        spin_impulse=ext(tab.spin_impulse, 0.0),
        roll_impulse=ext(tab.roll_impulse, 0.0),
        friction_scale=ext(tab.friction_scale, 1.0),
        restitution_scale=ext(tab.restitution_scale, 1.0))


@dataclasses.dataclass
class JointTable:
    """Non-contact constraints (joints), one slot per joint; the rows are
    built from it each step (``constraints.joints``). Free slots are
    invalid and take runtime joints (``World._add_joint``)."""
    jtype: torch.Tensor     # [J] int32
    body_a: torch.Tensor    # [J] int32
    body_b: torch.Tensor    # [J] int32
    valid: torch.Tensor     # [J] bool
    pivot_a: torch.Tensor   # [J,3]
    pivot_b: torch.Tensor   # [J,3]
    frame_a: torch.Tensor   # [J,4]
    frame_b: torch.Tensor   # [J,4]
    params: torch.Tensor    # [J,60]
    impulses: torch.Tensor  # [J,MAX_JOINT_ROWS]
    angle: torch.Tensor     # [J]

    @staticmethod
    def zeros(J: int, device, dtype=None) -> "JointTable":
        dtype = dtype or scalar_dtype()
        f = lambda *s: torch.zeros(s, dtype=dtype, device=device)
        i = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
        ident = f(J, 4)
        ident[:, 3] = 1.0
        return JointTable(
            jtype=i(J), body_a=i(J), body_b=i(J),
            valid=torch.zeros((J,), dtype=torch.bool, device=device),
            pivot_a=f(J, 3), pivot_b=f(J, 3), frame_a=ident,
            frame_b=ident.clone(), params=f(J, 60),
            impulses=f(J, MAX_JOINT_ROWS), angle=f(J))


@dataclasses.dataclass
class MixTable:
    """Material-mixing pair override table (reference: material_mix_table)."""
    ids: torch.Tensor   # [P,2] int32 material id pairs (unordered)
    vals: torch.Tensor  # [P,6] restitution, friction, spin, roll, stiff, damp

    @staticmethod
    def empty(device, dtype=None) -> "MixTable":
        return MixTable(
            ids=torch.full((0, 2), -1, dtype=torch.int32, device=device),
            vals=torch.zeros((0, 6), dtype=dtype or scalar_dtype(),
                             device=device))


@dataclasses.dataclass
class PolyTable:
    """Device-side polyhedron side table (see
    shapes.params.PolyhedronTable)."""
    verts: torch.Tensor
    vert_mask: torch.Tensor
    face_normals: torch.Tensor
    face_mask: torch.Tensor
    edge_dirs: torch.Tensor
    edge_mask: torch.Tensor


@dataclasses.dataclass
class WorldState:
    """Everything about the simulated world (field meanings as in
    ``edyn_tpu.core.state.WorldState``)."""
    pos: torch.Tensor          # [N,3] world COM
    orn: torch.Tensor          # [N,4] xyzw
    linvel: torch.Tensor       # [N,3]
    angvel: torch.Tensor       # [N,3]
    mass_inv: torch.Tensor     # [N]
    inertia_inv: torch.Tensor  # [N,3,3] local-space inverse inertia
    com: torch.Tensor          # [N,3] COM offset in the shape frame
    restitution: torch.Tensor
    friction: torch.Tensor
    spin_friction: torch.Tensor
    roll_friction: torch.Tensor
    stiffness: torch.Tensor
    damping: torch.Tensor
    has_material: torch.Tensor  # [N] bool
    material_id: torch.Tensor   # [N] int32
    gravity: torch.Tensor       # [N,3]
    kind: torch.Tensor          # [N] int32
    valid: torch.Tensor         # [N] bool
    sleeping_disabled: torch.Tensor
    networked: torch.Tensor
    group: torch.Tensor         # [N] int64 (uint32 bit pattern)
    mask: torch.Tensor          # [N] int64 (uint32 bit pattern)
    exclusions: torch.Tensor    # [N,MAX_EXCLUSIONS] int32, -1 empty
    shape_type: torch.Tensor    # [N] int32
    shape_params: torch.Tensor  # [N,4]
    shape_index: torch.Tensor   # [N] int32
    aabb_min: torch.Tensor      # [N,3]
    aabb_max: torch.Tensor
    bp_aabb_min: torch.Tensor   # [N,3] carried pair-admission boxes
    bp_aabb_max: torch.Tensor
    roll_axis: torch.Tensor     # [N,3]
    island_id: torch.Tensor     # [N] int32
    sleep_timer: torch.Tensor   # [N]
    asleep: torch.Tensor        # [N] bool
    edge_pointed: torch.Tensor  # [M] bool
    labels_stable: torch.Tensor  # [] bool
    island_stable_steps: torch.Tensor  # [] int32
    bp_carry_ok: torch.Tensor   # [] bool
    contacts: ContactTable
    joints: JointTable
    poly: PolyTable
    mesh: object                # shapes.mesh.MeshTable (static trimeshes)
    convex: object              # shapes.convex.ConvexTable (N body rows,
                                # then the compound children's rows)
    compound: object            # shapes.compound.CompoundTable
    mix_table: MixTable
    step_count: torch.Tensor    # [] int32
    sim_time: torch.Tensor      # [] scalar dtype
    overflow: torch.Tensor      # [5] int32: broadphase pairs, narrowphase
                                # candidates, contact rows, sweep alarms,
                                # manifold slots
    # user components (``WorldBuilder.register_component``): name -> [N,...]
    # columns that ride the step untouched, replicate over the wire and
    # take input-history writes
    user: dict = dataclasses.field(default_factory=dict)

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    @property
    def device(self):
        return self.pos.device

    @property
    def dtype(self):
        """The scalar dtype of the world's floats."""
        return self.pos.dtype

    @property
    def is_dynamic(self):
        return (self.kind == KIND_DYNAMIC) & self.valid

    @property
    def is_static(self):
        return (self.kind == KIND_STATIC) & self.valid

    @property
    def is_kinematic(self):
        return (self.kind == KIND_KINEMATIC) & self.valid

    @property
    def awake_dynamic(self):
        return self.is_dynamic & ~self.asleep

    def origin_pos(self):
        """Shape-origin world positions: pos - R*com."""
        from ..math import quat
        return self.pos - quat.rotate(self.orn, self.com)

    def inertia_world_inv(self):
        """World-space inverse inertia R I_l^-1 R^T per body."""
        from ..math import quat
        R = quat.to_matrix(self.orn)
        return R @ self.inertia_inv @ R.transpose(-1, -2)
