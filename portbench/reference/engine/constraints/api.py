"""Joint factories for the point, cone and hinge joints (counterpart of
``edyn_tpu/constraints/api.py``; reference: util/constraint_util.hpp
make_constraint plus the per-type constraint structs). Host math in
float64 numpy. Each factory calls ``builder._add_joint`` and returns the
joint's index."""
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
