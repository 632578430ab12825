"""The comparison that decides a run's ``correct``.

The reference is ``reference.engine``, a frozen plain-PyTorch copy of the
step (see its docstring); it imports nothing of the program. A physics
trajectory cannot be followed from the start over hundreds of frames by
two implementations that round differently (one ulp at a contact feature
flips which features touch, and a pile amplifies it), so the reference
follows the program frame by frame from the program's own state:

1. The start. The reference builds its own world from the same scene
   description and configuration, and every tensor of the program's built
   state must equal the reference's (``start_leaves_differ``, limit 0);
   its scene facts and capacities (``SceneMeta``) must equal the
   program's at every checked frame (``meta_fields_differ``, limit 0).
2. Each checked frame. The reference's input is the program's state
   before the frame's step, with every static table (shapes, masses,
   inertia, materials, convex and polyhedron tables, joints' definitions)
   taken from the reference's own build instead; it steps that once, and
   the program's frame is compared with it: positions and orientations as
   the frame's read-back delivered them to the host, velocities as the
   program's state holds them after the step. Over the valid dynamic
   bodies, the largest gap (a fault in a few bodies) and the median gap (a
   loss of precision in all of them), each the largest over the checked
   frames.

The control puts the reference, computed in bfloat16 (every float of its
input and its arithmetic), in the program's place, against the float32
reference. The witness does the same in float64: how far rounding alone
moves a frame, which the limits are placed well above.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import engine as ref
from .engine.core import state as ref_state

# WorldState fields a step changes: taken from the program's state before
# the checked step. Every other field is a static table of the scene and
# comes from the reference's own build.
DYNAMIC = ("pos", "orn", "linvel", "angvel", "aabb_min", "aabb_max",
           "bp_aabb_min", "bp_aabb_max", "island_id", "sleep_timer",
           "asleep", "edge_pointed", "labels_stable", "island_stable_steps",
           "bp_carry_ok", "contacts", "step_count", "sim_time", "overflow",
           "user")
DYNAMIC_JOINT = ("impulses", "angle")
META_FIELDS = ("types_present", "max_pairs", "bucket_cap", "island_iters",
               "broadphase_mode", "sweep_window", "wide_cap", "max_rows",
               "has_spin_roll", "has_joints", "joint_types", "sleep_gating")
GAPS = tuple(f"{q}_gap{s}{u}" for q, u in (
    ("pos", "_m"), ("orn", ""), ("linvel", "_mps"), ("angvel", "_radps"))
    for s in ("", "_median"))


def flatten(x, path: str = "") -> dict:
    """{dotted path: tensor} of a state's tensors."""
    if isinstance(x, torch.Tensor):
        return {path: x}
    out = {}
    if dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            out.update(flatten(getattr(x, f.name), f"{path}.{f.name}"))
    elif isinstance(x, dict):
        for k, v in x.items():
            out.update(flatten(v, f"{path}.{k}"))
    return out


def leaves_differ(a, b) -> int:
    """Tensors of two states that are not equal (shape, dtype and every
    element), counting a path present in one only."""
    fa, fb = flatten(a), flatten(b)
    n = len(set(fa) ^ set(fb))
    for k in set(fa) & set(fb):
        x, y = fa[k], fb[k]
        if (x.shape != y.shape or x.dtype != y.dtype
                or not torch.equal(x.cpu(), y.cpu())):
            n += 1
    return n


def meta_dict(meta) -> dict:
    return {f: getattr(meta, f) for f in META_FIELDS}


def meta_differ(a, b) -> int:
    da, db = meta_dict(a), meta_dict(b)
    return sum(str(da[f]) != str(db[f]) for f in META_FIELDS)


def reference_world(pkg_config: dict, desc: dict, device, bench_dir=None):
    """The reference's own world of ``desc`` (its scene's builder, found
    under ``bench_dir``, ``make_world`` and the configuration's
    capacities, as the program's is made)."""
    from harness import spec, traffic
    world, _ = traffic.make_world(ref, pkg_config, desc, device, None,
                                  bench_dir=bench_dir or spec.BENCH_DIR)
    return world


def _as_ref(x, cls):
    """A program dataclass as the reference's class of the same fields."""
    return cls(**{f.name: getattr(x, f.name) for f in dataclasses.fields(x)})


def reference_input(ref_built, pre):
    """The reference's state before a checked step: the program's dynamic
    fields, the reference's own static tables."""
    dyn = {f: getattr(pre, f) for f in DYNAMIC}
    dyn["contacts"] = _as_ref(pre.contacts, ref_state.ContactTable)
    dyn["user"] = dict(pre.user)
    joints = dataclasses.replace(
        ref_built.joints,
        **{f: getattr(pre.joints, f) for f in DYNAMIC_JOINT})
    return dataclasses.replace(ref_built, joints=joints, **dyn)


def cast(x, dtype):
    """Every float tensor of a state in ``dtype``."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype) if x.is_floating_point() else x
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: cast(getattr(x, f.name),
                                                      dtype)
                                         for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: cast(v, dtype) for k, v in x.items()}
    return x


def gaps(dynamic: np.ndarray, host: np.ndarray, vel: tuple, out) -> dict:
    """Between a frame (its read-back ``host`` [N,7], its velocities
    ``vel``) and the reference's step ``out``, over the valid dynamic
    bodies: each body's gap (its largest component's), the largest of
    them (``*_gap``: a fault in a few bodies) and their median
    (``*_gap_median``: a loss of precision in every body)."""
    def body_gaps(a, b):
        d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
        d = np.nan_to_num(d[dynamic], nan=np.inf).max(axis=1, initial=0.0)
        return d if d.size else np.zeros(1)

    def host_of(t):
        return t.double().cpu().numpy()

    out_g = {}
    for name, unit, a, b in (
            ("pos", "_m", host[:, :3], host_of(out.pos)),
            ("orn", "", host[:, 3:7], host_of(out.orn)),
            ("linvel", "_mps", host_of(vel[0]), host_of(out.linvel)),
            ("angvel", "_radps", host_of(vel[1]), host_of(out.angvel))):
        d = body_gaps(a, b)
        out_g[f"{name}_gap{unit}"] = float(d.max())
        out_g[f"{name}_gap_median{unit}"] = float(np.median(d))
    return out_g


def check_frames(samples, ref_world, control: bool = False,
                 witness: bool = False) -> dict:
    """The numbers of every checked frame, the largest of each: the
    program against the reference; with ``control`` the bfloat16
    reference against the float32 one; with ``witness`` the float64
    reference against the float32 one (what rounding alone moves, for
    placing the limits)."""
    worst = dict.fromkeys(GAPS, 0.0)
    worst["meta_fields_differ"] = 0
    settings, meta = ref_world.settings, ref_world.meta
    dynamic = ref_world.state.is_dynamic.cpu().numpy()
    for s in samples:
        worst["meta_fields_differ"] = max(worst["meta_fields_differ"],
                                          meta_differ(s.meta, meta))
        inp = reference_input(ref_world.state, s.pre)
        with torch.no_grad():
            out = ref.physics_step(inp, settings, meta)
            if control or witness:
                other = ref.physics_step(
                    cast(inp, torch.bfloat16 if control else torch.float64),
                    settings, meta)
                host = torch.cat([other.pos, other.orn], 1).double()
                g = gaps(dynamic, host.cpu().numpy(),
                         (other.linvel, other.angvel), out)
            else:
                g = gaps(dynamic, s.host, s.post_vel, out)
        for k, v in g.items():
            worst[k] = max(worst[k], v)
        del inp, out
    return worst


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers that
    ``limits`` (a cell's ``limits/<cell>.json``) names, and only those: a
    number without a limit is not judged and not listed; a limit whose
    number is missing, or not at most the limit, fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        out[name] = {"value": value, "limit": limit}
        if value is None or not value <= limit:
            ok = False
    return ok, out
