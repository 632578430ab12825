"""The joint table of a world (counterpart of
``edyn_tpu/constraints/joints.py``): its types and its packing. The
benchmark's scenes hold no joint, so the reference keeps the empty table a
world carries and none of the joint solve (``physics_step`` refuses a
world with joints).
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from ..core.state import JointTable


class JointType(enum.IntEnum):
    NONE = 0
    DISTANCE = 1       # reference: constraints/distance_constraint.hpp
    SOFT_DISTANCE = 2  # reference: constraints/soft_distance_constraint.hpp
    POINT = 3          # reference: constraints/point_constraint.hpp
    HINGE = 4          # reference: constraints/hinge_constraint.hpp:22-115
    CONE = 5           # reference: constraints/cone_constraint.hpp
    GENERIC = 6        # reference: constraints/generic_constraint.hpp
    CVJOINT = 7        # reference: constraints/cvjoint_constraint.hpp
    GRAVITY = 8        # reference: constraints/gravity_constraint.hpp
    NULL = 9           # reference: constraints/null_constraint.hpp:14


def types_present(jt) -> frozenset:
    """The joint types of the table's valid joints (one host read)."""
    return frozenset(JointType(t)
                     for t in torch.unique(jt.jtype[jt.valid]).tolist())


# ---------------------------------------------------------------------------
# host-side packing
# ---------------------------------------------------------------------------

def pack_joints(joint_dicts: list, J: int, device,
                dtype=None) -> JointTable:
    """The JointTable of the builder's joint dicts, staged in float32 numpy as the JAX package stages
    it, then moved to ``device`` at ``dtype`` (default the scalar
    dtype)."""
    jtype = np.zeros((J,), np.int32)
    body_a = np.zeros((J,), np.int32)
    body_b = np.zeros((J,), np.int32)
    valid = np.zeros((J,), bool)
    pivot_a = np.zeros((J, 3), np.float32)
    pivot_b = np.zeros((J, 3), np.float32)
    frame_a = np.zeros((J, 4), np.float32)
    frame_a[:, 3] = 1
    frame_b = np.zeros((J, 4), np.float32)
    frame_b[:, 3] = 1
    params = np.zeros((J, 60), np.float32)
    for i, jd in enumerate(joint_dicts):
        jtype[i] = jd["jtype"]
        body_a[i] = jd["body_a"]
        body_b[i] = jd["body_b"]
        valid[i] = True
        pivot_a[i] = jd.get("pivot_a", (0, 0, 0))
        pivot_b[i] = jd.get("pivot_b", (0, 0, 0))
        frame_a[i] = jd.get("frame_a", (0, 0, 0, 1))
        frame_b[i] = jd.get("frame_b", (0, 0, 0, 1))
        p = jd.get("params", ())
        params[i, :len(p)] = p
    t = JointTable.zeros(J, device, dtype)
    ft = t.params.dtype

    def d(x):
        x = torch.as_tensor(x, device=device)
        return x.to(ft) if x.is_floating_point() else x

    return dataclasses.replace(
        t, jtype=d(jtype), body_a=d(body_a), body_b=d(body_b),
        valid=d(valid), pivot_a=d(pivot_a), pivot_b=d(pivot_b),
        frame_a=d(frame_a), frame_b=d(frame_b), params=d(params))
