"""Joint factory helpers (counterpart of ``edyn_tpu/constraints/api.py``;
reference: util/constraint_util.hpp make_constraint plus the per-type
constraint structs). Host math in float64 numpy. Each factory calls
``target._add_joint``, which a ``WorldBuilder`` and a live ``World`` both
provide, and returns the joint's index."""
from __future__ import annotations

import numpy as np

from .joints import JointType


def _frame_from_axis(axis):
    """Build a quaternion frame whose X axis is ``axis`` (joints use X as the
    primary axis, mirroring the reference's hinge/cone frames)."""
    axis = np.asarray(axis, np.float64)
    x = axis / np.linalg.norm(axis)
    up = np.array([0.0, 1.0, 0.0]) if abs(x[1]) < 0.9 else np.array([1.0, 0.0, 0.0])
    z = np.cross(x, up)
    z /= np.linalg.norm(z)
    y = np.cross(z, x)
    m = np.stack([x, y, z], axis=1)  # columns
    # matrix -> quaternion (xyzw)
    w = np.sqrt(max(0.0, 1.0 + m[0, 0] + m[1, 1] + m[2, 2])) / 2.0
    if w > 1e-6:
        qx = (m[2, 1] - m[1, 2]) / (4 * w)
        qy = (m[0, 2] - m[2, 0]) / (4 * w)
        qz = (m[1, 0] - m[0, 1]) / (4 * w)
    else:
        qx, qy, qz, w = 0.0, 0.0, 0.0, 1.0
    q = np.array([qx, qy, qz, w])
    return q / np.linalg.norm(q)


def _maybe_exclude(builder, a, b, disable_collision):
    """reference: make_constraint's disable_collision flag
    (include/edyn/util/constraint_util.hpp) — jointed bodies usually must
    not also collide with each other."""
    if disable_collision:
        builder.exclude_collision(a, b)


def make_distance_constraint(builder, a, b, pivot_a, pivot_b, distance,
                             disable_collision=False):
    _maybe_exclude(builder, a, b, disable_collision)
    return builder._add_joint(jtype=JointType.DISTANCE, body_a=a, body_b=b,
                              pivot_a=pivot_a, pivot_b=pivot_b,
                              params=(distance,))


def make_soft_distance_constraint(builder, a, b, pivot_a, pivot_b, distance,
                                  stiffness, damping,
                                  disable_collision=False):
    _maybe_exclude(builder, a, b, disable_collision)
    return builder._add_joint(jtype=JointType.SOFT_DISTANCE, body_a=a, body_b=b,
                              pivot_a=pivot_a, pivot_b=pivot_b,
                              params=(distance, stiffness, damping))


def make_point_constraint(builder, a, b, pivot_a, pivot_b,
                          disable_collision=False):
    _maybe_exclude(builder, a, b, disable_collision)
    return builder._add_joint(jtype=JointType.POINT, body_a=a, body_b=b,
                              pivot_a=pivot_a, pivot_b=pivot_b)


def make_hinge_constraint(builder, a, b, pivot_a, pivot_b, axis_a, axis_b,
                          limit_min=0.0, limit_max=0.0, has_limit=False,
                          friction_torque=0.0, damping=0.0,
                          spring_stiffness=0.0, rest_angle=0.0,
                          limit_restitution=0.0,
                          bump_stop_stiffness=0.0, bump_stop_angle=0.0,
                          disable_collision=False):
    """reference: hinge_constraint.hpp:22-115 (incl. bump stop + limit
    restitution)."""
    _maybe_exclude(builder, a, b, disable_collision)
    return builder._add_joint(
        jtype=JointType.HINGE, body_a=a, body_b=b,
        pivot_a=pivot_a, pivot_b=pivot_b,
        frame_a=_frame_from_axis(axis_a), frame_b=_frame_from_axis(axis_b),
        params=(limit_min, limit_max, limit_restitution, bump_stop_stiffness,
                bump_stop_angle, friction_torque, damping,
                spring_stiffness, rest_angle, 1.0 if has_limit else 0.0))


def make_cone_constraint(builder, a, b, pivot_a, pivot_b, axis_a, axis_b,
                         span_y, span_z, disable_collision=False):
    """span_y/span_z: half-angle tangents of the elliptic cone."""
    _maybe_exclude(builder, a, b, disable_collision)
    return builder._add_joint(
        jtype=JointType.CONE, body_a=a, body_b=b,
        pivot_a=pivot_a, pivot_b=pivot_b,
        frame_a=_frame_from_axis(axis_a), frame_b=_frame_from_axis(axis_b),
        params=(span_y, span_z))


def dof(limit_enabled=True, offset_min=0.0, offset_max=0.0,
        limit_restitution=0.0, bump_stop_size=0.0, bump_stop_stiffness=0.0,
        friction=0.0, rest=0.0, spring_stiffness=0.0, damping=0.0):
    """One generic-constraint degree of freedom (reference:
    generic_constraint::linear_dof / angular_dof,
    include/edyn/constraints/generic_constraint.hpp:18-57). The default
    (limit enabled, min == max == 0) is a locked DOF; pass
    ``limit_enabled=False`` for a free DOF."""
    return (1.0 if limit_enabled else 0.0, offset_min, offset_max,
            limit_restitution, bump_stop_size, bump_stop_stiffness,
            friction, rest, spring_stiffness, damping)


def make_generic_constraint(builder, a, b, pivot_a, pivot_b,
                            frame_a=(0.0, 0.0, 0.0, 1.0),
                            frame_b=(0.0, 0.0, 0.0, 1.0),
                            linear_dofs=None, angular_dofs=None,
                            lock_angular=None, disable_collision=False):
    """Full 6-DOF constraint: 3 linear DOFs along frame-A's axes + 3 angular,
    each with limits / bump stops / springs / friction+damping (reference:
    generic_constraint.cpp:1-330). ``linear_dofs``/``angular_dofs`` are
    3-sequences built with :func:`dof`; None means all locked.
    ``lock_angular`` is the legacy (bool, bool, bool) shorthand: True =
    locked angular axis, False = free."""
    if linear_dofs is None:
        linear_dofs = (dof(), dof(), dof())
    if angular_dofs is None:
        if lock_angular is not None:
            angular_dofs = tuple(
                dof() if l else dof(limit_enabled=False)
                for l in lock_angular)
        else:
            angular_dofs = (dof(), dof(), dof())
    params = []
    for d in tuple(linear_dofs) + tuple(angular_dofs):
        params.extend(d)
    _maybe_exclude(builder, a, b, disable_collision)
    return builder._add_joint(
        jtype=JointType.GENERIC, body_a=a, body_b=b,
        pivot_a=pivot_a, pivot_b=pivot_b,
        frame_a=frame_a, frame_b=frame_b,
        params=tuple(params))


def make_cvjoint_constraint(builder, a, b, pivot_a, pivot_b, axis_a, axis_b,
                            twist_min=0.0, twist_max=0.0,
                            twist_restitution=0.0,
                            twist_bump_stop_angle=0.0,
                            twist_bump_stop_stiffness=0.0,
                            twist_friction_torque=0.0, twist_rest_angle=0.0,
                            twist_stiffness=0.0, twist_damping=0.0,
                            rest_direction=(0.0, 0.0, 0.0),
                            bend_stiffness=0.0, bend_friction_torque=0.0,
                            bend_damping=0.0, disable_collision=False):
    """Constant-velocity joint (reference: cvjoint_constraint.hpp:21-135):
    twist_min == twist_max locks relative twist velocity; a real range gives
    twist limits with restitution/bump stop; bend spring pulls B's twist axis
    toward ``rest_direction`` (A's object space)."""
    rd = tuple(rest_direction)
    _maybe_exclude(builder, a, b, disable_collision)
    return builder._add_joint(
        jtype=JointType.CVJOINT, body_a=a, body_b=b,
        pivot_a=pivot_a, pivot_b=pivot_b,
        frame_a=_frame_from_axis(axis_a), frame_b=_frame_from_axis(axis_b),
        params=(twist_min, twist_max, twist_restitution,
                twist_bump_stop_angle, twist_bump_stop_stiffness,
                twist_friction_torque, twist_rest_angle, twist_stiffness,
                twist_damping, rd[0], rd[1], rd[2],
                bend_stiffness, bend_friction_torque, bend_damping))


def make_gravity_constraint(builder, a, b):
    return builder._add_joint(jtype=JointType.GRAVITY, body_a=a, body_b=b)


def make_null_constraint(builder, a, b):
    """Graph-edge-only tie (reference: null_constraint.hpp:14) — keeps two
    bodies in the same island without generating rows."""
    return builder._add_joint(jtype=JointType.NULL, body_a=a, body_b=b)
