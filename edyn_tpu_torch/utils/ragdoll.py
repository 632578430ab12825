"""Ragdoll factory: a humanoid rig of bodies + cone/hinge joints
(counterpart of ``edyn_tpu/utils/ragdoll.py``, the same bodies and joints).

Reference: util/ragdoll.hpp:10-40 + src/edyn/util/ragdoll.cpp (935 LoC):
``make_ragdoll(registry, rag_def)`` builds head/neck/torso (3 segments)/hips/
legs/arms with cone constraints at ball-ish joints and hinges at knees/elbows,
sized from an overall height/weight.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..constraints import api as _api
from ..core.builder import Material, RigidBodyDef
from ..shapes.params import BoxShape, CapsuleShape, SphereShape


@dataclasses.dataclass
class RagdollDef:
    """reference: ragdoll_def (util/ragdoll.hpp:10-40)."""
    position: tuple = (0.0, 0.0, 0.0)
    orientation: tuple = (0.0, 0.0, 0.0, 1.0)
    height: float = 1.7
    weight: float = 72.0
    friction: float = 0.8
    restitution: float = 0.0
    collision_group: int = 0xFFFFFFFF
    collision_mask: int = 0xFFFFFFFF


@dataclasses.dataclass
class Ragdoll:
    """Entity handles (reference: ragdoll_simple_entities/ragdoll_entities)."""
    head: int
    torso_upper: int
    torso_middle: int
    torso_lower: int
    hips: int
    upper_arm_left: int
    lower_arm_left: int
    upper_arm_right: int
    lower_arm_right: int
    upper_leg_left: int
    lower_leg_left: int
    upper_leg_right: int
    lower_leg_right: int
    joints: list = dataclasses.field(default_factory=list)

    def bodies(self):
        return [self.head, self.torso_upper, self.torso_middle,
                self.torso_lower, self.hips,
                self.upper_arm_left, self.lower_arm_left,
                self.upper_arm_right, self.lower_arm_right,
                self.upper_leg_left, self.lower_leg_left,
                self.upper_leg_right, self.lower_leg_right]


def make_ragdoll(builder, rd: RagdollDef) -> Ragdoll:
    """Adds the rig's 13 bodies, 20 joints and 12 collision exclusions to
    ``builder`` at ``rd.position``."""
    h = rd.height
    m = rd.weight
    mat = Material(friction=rd.friction, restitution=rd.restitution,
                      roll_friction=0.005)
    base = np.asarray(rd.position, np.float64)

    def body(offset_y, shape, mass_frac, half_off=(0.0, 0.0, 0.0)):
        pos = base + np.array([half_off[0], offset_y, half_off[2]])
        return builder.make_rigidbody(RigidBodyDef(
            mass=m * mass_frac, shape=shape, position=tuple(pos),
            material=mat, collision_group=rd.collision_group,
            collision_mask=rd.collision_mask))

    # proportions (fractions of height, ~anatomical averages as in the
    # reference's size table)
    leg_u = 0.14 * h
    leg_l = 0.14 * h
    torso_seg = 0.10 * h
    arm_u = 0.11 * h
    arm_l = 0.11 * h
    hip_y = 0.50 * h
    shoulder_w = 0.12 * h
    hip_w = 0.07 * h

    hips = body(hip_y, BoxShape((0.10 * h, 0.045 * h, 0.06 * h)), 0.13)
    t_low = body(hip_y + torso_seg, BoxShape((0.095 * h, 0.05 * h, 0.055 * h)), 0.12)
    t_mid = body(hip_y + 2 * torso_seg, BoxShape((0.09 * h, 0.05 * h, 0.055 * h)), 0.12)
    t_up = body(hip_y + 3 * torso_seg, BoxShape((0.10 * h, 0.05 * h, 0.055 * h)), 0.13)
    head = body(hip_y + 3 * torso_seg + 0.11 * h, SphereShape(0.065 * h), 0.07)

    joints = []

    def cone_joint(a, b, piv_a, piv_b, axis, span):
        j1 = _api.make_point_constraint(builder, a, b, piv_a, piv_b)
        j2 = _api.make_cone_constraint(builder, a, b, piv_a, piv_b,
                                     axis_a=axis, axis_b=axis,
                                     span_y=span, span_z=span)
        joints.extend([j1, j2])

    def hinge_joint(a, b, piv_a, piv_b, axis, lo, hi):
        joints.append(_api.make_hinge_constraint(
            builder, a, b, piv_a, piv_b, axis, axis,
            has_limit=True, limit_min=lo, limit_max=hi))

    # spine: cone joints between segments (tight spans)
    cone_joint(hips, t_low, (0, 0.05 * h, 0), (0, -0.05 * h, 0), (0, 1, 0), 0.25)
    cone_joint(t_low, t_mid, (0, 0.05 * h, 0), (0, -0.05 * h, 0), (0, 1, 0), 0.25)
    cone_joint(t_mid, t_up, (0, 0.05 * h, 0), (0, -0.05 * h, 0), (0, 1, 0), 0.25)
    # neck
    cone_joint(t_up, head, (0, 0.06 * h, 0), (0, -0.07 * h, 0), (0, 1, 0), 0.4)

    limbs = {}
    for side, sx in (("left", -1.0), ("right", 1.0)):
        # legs
        u_leg = body(hip_y - leg_u, CapsuleShape(0.035 * h, leg_u / 2, axis=1),
                     0.10, half_off=(sx * hip_w, 0, 0))
        l_leg = body(hip_y - leg_u - leg_l,
                     CapsuleShape(0.03 * h, leg_l / 2, axis=1),
                     0.06, half_off=(sx * hip_w, 0, 0))
        cone_joint(hips, u_leg, (sx * hip_w, -0.04 * h, 0), (0, leg_u / 2, 0),
                   (0, -1, 0), 0.6)
        hinge_joint(u_leg, l_leg, (0, -leg_u / 2, 0), (0, leg_l / 2, 0),
                    (1, 0, 0), 0.0, 2.3)  # knee bends one way
        # arms
        u_arm = body(hip_y + 3 * torso_seg, CapsuleShape(0.03 * h, arm_u / 2, axis=1),
                     0.035, half_off=(sx * (shoulder_w + arm_u * 0.0), 0, 0))
        l_arm = body(hip_y + 3 * torso_seg - arm_u - arm_l * 0.5,
                     CapsuleShape(0.025 * h, arm_l / 2, axis=1),
                     0.025, half_off=(sx * (shoulder_w), 0, 0))
        cone_joint(t_up, u_arm, (sx * shoulder_w, 0.04 * h, 0), (0, arm_u / 2, 0),
                   (sx, 0, 0), 0.9)
        hinge_joint(u_arm, l_arm, (0, -arm_u / 2, 0), (0, arm_l / 2, 0),
                    (1, 0, 0), -2.3, 0.0)  # elbow
        limbs[side] = (u_arm, l_arm, u_leg, l_leg)

    # limbs of the same body shouldn't collide with the torso chain
    chain = [hips, t_low, t_mid, t_up, head]
    for i, x in enumerate(chain[:-1]):
        builder.exclude_collision(x, chain[i + 1])
    for side in ("left", "right"):
        u_arm, l_arm, u_leg, l_leg = limbs[side]
        builder.exclude_collision(u_arm, l_arm)
        builder.exclude_collision(u_leg, l_leg)
        builder.exclude_collision(t_up, u_arm)
        builder.exclude_collision(hips, u_leg)

    return Ragdoll(
        head=head, torso_upper=t_up, torso_middle=t_mid, torso_lower=t_low,
        hips=hips,
        upper_arm_left=limbs["left"][0], lower_arm_left=limbs["left"][1],
        upper_arm_right=limbs["right"][0], lower_arm_right=limbs["right"][1],
        upper_leg_left=limbs["left"][2], lower_leg_left=limbs["left"][3],
        upper_leg_right=limbs["right"][2], lower_leg_right=limbs["right"][3],
        joints=joints)
