"""Object<->world space transforms (reference:
include/edyn/math/transform.hpp)."""
from __future__ import annotations

from . import quat


def to_world_space(p_local, pos, orn):
    return pos + quat.rotate(orn, p_local)


def to_object_space(p_world, pos, orn):
    return quat.rotate_inv(orn, p_world - pos)


def to_world_dir(d_local, orn):
    return quat.rotate(orn, d_local)


def to_object_dir(d_world, orn):
    return quat.rotate_inv(orn, d_world)
