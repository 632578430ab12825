"""The narrowphase's manifold merge as one CUDA kernel, and its plain
PyTorch version.

``merge_fresh`` merges ``narrowphase.fresh_points``' output [M,4,14]
(pivot_a 0:3 | pivot_b 3:6 | normal 6:9 | attachment 9 | distance 10 |
point_valid 11 | friction_scale 12 | restitution_scale 13) into the carried
manifolds; frozen pairs keep their points verbatim. The plain version
(``merge_fresh_plain``) puts each fresh normal into the frame it is
attached to, gathers both bodies' poses per pair and runs
``manifold.merge_points`` over every slot: ~1,850 PyTorch kernels a call
whatever M is. The JAX package keeps the merge in XLA, so the kernel
replaces no TPU kernel.

The kernel (``edyn_tpu_torch/csrc/merge_kernel.cu``, built with nvcc for
sm_90a at first use and loaded with ctypes by ``utils/cuda_lib``) does
the same in one launch, four lanes a slot, and reads the bodies' poses by
index. It is one source templated on the scalar type with a float and a
double entry point (``edyn_merge``, ``edyn_merge_f64``). The wrapper takes
the plain version for tensors on the CPU; for CUDA tensors it launches the
entry of the state's dtype (float32 or float64), or raises. It never falls
back and never casts. ``LAUNCHES["merge"]`` counts the float entry's
launches, ``LAUNCHES_F64`` the double entry's. It writes a new table: a
kept ``WorldState`` stays a snapshot.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ...config import (
    CONTACT_BREAKING_THRESHOLD, CONTACT_CACHING_THRESHOLD,
    CONTACT_MERGING_THRESHOLD,
)
from ...core.state import KIND_DYNAMIC
from ...math import quat
from ...shapes.params import ShapeType as S
from ...utils import cuda_lib
from ..manifold import merge_points

LAUNCHES = {"merge": 0}
LAUNCHES_F64 = dict.fromkeys(LAUNCHES, 0)

# the shape types that roll (the rolling analogue of the reference's
# rolling_tag), if the body is dynamic
ROLLING_TYPES = (S.SPHERE, S.CAPSULE, S.CYLINDER)
# the fields the merge writes, in the kernel's order (csrc Args' outputs)
FIELDS = ("point_valid", "pivot_a", "pivot_b", "local_normal",
          "normal_attachment", "distance", "lifetime", "normal_impulse",
          "friction_impulse", "spin_impulse", "roll_impulse",
          "friction_scale", "restitution_scale")
FRESH = 14


def reset_launch_counts():
    for counts in (LAUNCHES, LAUNCHES_F64):
        for k in counts:
            counts[k] = 0


def merge_fresh_plain(state, man, new_pts, frozen, dt: float):
    """The merge in plain PyTorch (see the module docstring)."""
    ba = man.body_a.long()
    bb = man.body_b.long()

    st = state.shape_type
    rolling = functools.reduce(
        torch.logical_or, [st == t for t in ROLLING_TYPES]) & state.is_dynamic
    org = state.origin_pos()
    new_attach = new_pts[..., 9].to(torch.int32)
    new_normal = new_pts[..., 6:9]
    orn_a = state.orn[ba][:, None, :]
    orn_b = state.orn[bb][:, None, :]
    local_n = torch.where(
        (new_attach == 1)[..., None], quat.rotate_inv(orn_a, new_normal),
        torch.where((new_attach == 2)[..., None],
                    quat.rotate_inv(orn_b, new_normal), new_normal))
    pose = (org[ba], orn_a[:, 0], state.angvel[ba], rolling[ba],
            org[bb], orn_b[:, 0], state.angvel[bb], rolling[bb])
    # device branch (narrowphase.py:397 in the JAX package): the merge width
    # ladder gives identical numbers in every tier, so the full width runs
    merged = merge_points(man, new_pts[..., 0:3], new_pts[..., 3:6], local_n,
                          new_attach, new_pts[..., 10], new_pts[..., 11] > 0.5,
                          pose=pose, dt=dt, scales=new_pts[..., 12:14])
    # frozen pairs keep their points verbatim
    fr = frozen & man.valid

    def keep_frozen(f):
        old, new = getattr(man, f), getattr(merged, f)
        return torch.where(fr.reshape(fr.shape + (1,) * (old.dim() - 1)),
                           old, new)

    return dataclasses.replace(merged, **{f: keep_frozen(f) for f in FIELDS})


_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
SIGNATURES = {name: [_P, _P, _I, _D, _D, _D, _D, _I, _I, _P]
              for name in ("edyn_merge", "edyn_merge_f64")}


def _entry(dtype):
    """(the entry point for ``dtype``, its launch counts)."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"merge: float32 or float64 tensors expected, got "
                        f"{dtype}")
    lib = cuda_lib.load("merge_kernel", SIGNATURES)
    if dtype == torch.float32:
        return lib.edyn_merge, LAUNCHES
    return lib.edyn_merge_f64, LAUNCHES_F64


def merge_fresh(state, man, new_pts, frozen, dt: float):
    """Merge ``fresh_points``' output ``new_pts`` [M,4,14] into ``man``
    (frozen [M] bool: pairs whose points stay verbatim). Returns a new
    table; the CPU's tensors take ``merge_fresh_plain``, CUDA's one launch
    of the merge kernel."""
    if cuda_lib.on_cpu(new_pts, frozen, man.pivot_a, state.pos):
        return merge_fresh_plain(state, man, new_pts, frozen, dt)
    dt_ = state.pos.dtype
    fn, counts = _entry(dt_)
    M = man.key.shape[0]
    N = state.pos.shape[0]
    dev = new_pts.device
    b, i, f = torch.bool, torch.int32, dt_
    ins = [
        (state.pos, "pos", (N, 3), f), (state.orn, "orn", (N, 4), f),
        (state.angvel, "angvel", (N, 3), f), (state.com, "com", (N, 3), f),
        (state.shape_type, "shape_type", (N,), i),
        (state.kind, "kind", (N,), i), (state.valid, "state.valid", (N,), b),
        (man.body_a, "body_a", (M,), i), (man.body_b, "body_b", (M,), i),
        (man.valid, "valid", (M,), b), (frozen, "frozen", (M,), b),
        (man.point_valid, "point_valid", (M, 4), b),
        (man.pivot_a, "pivot_a", (M, 4, 3), f),
        (man.pivot_b, "pivot_b", (M, 4, 3), f),
        (man.local_normal, "local_normal", (M, 4, 3), f),
        (man.normal_attachment, "normal_attachment", (M, 4), i),
        (man.distance, "distance", (M, 4), f),
        (man.lifetime, "lifetime", (M, 4), i),
        (man.normal_impulse, "normal_impulse", (M, 4), f),
        (man.friction_impulse, "friction_impulse", (M, 4, 2), f),
        (man.spin_impulse, "spin_impulse", (M, 4), f),
        (man.roll_impulse, "roll_impulse", (M, 4, 2), f),
        (man.friction_scale, "friction_scale", (M, 4), f),
        (man.restitution_scale, "restitution_scale", (M, 4), f),
        (new_pts, "new_pts", (M, 4, FRESH), f)]
    ptrs = []
    for t, name, shape, dtype in ins:
        t = t.contiguous()
        cuda_lib.check(t, name, shape, dtype)
        ptrs.append(t)
    out = {name: torch.empty(tuple(getattr(man, name).shape),
                             dtype=getattr(man, name).dtype, device=dev)
           for name in FIELDS}
    if M:
        in_arr = (ctypes.c_void_p * len(ptrs))(*[t.data_ptr() for t in ptrs])
        out_arr = (ctypes.c_void_p * len(FIELDS))(
            *[out[n].data_ptr() for n in FIELDS])
        roll = sum(1 << int(t) for t in ROLLING_TYPES)
        rc = fn(in_arr, out_arr, M, float(dt),
                CONTACT_CACHING_THRESHOLD * CONTACT_CACHING_THRESHOLD,
                CONTACT_MERGING_THRESHOLD * CONTACT_MERGING_THRESHOLD,
                CONTACT_BREAKING_THRESHOLD, roll, KIND_DYNAMIC,
                cuda_lib.stream(new_pts))
        cuda_lib.launched(counts, "merge", rc, dev)
    return dataclasses.replace(man, **out)
