"""Joints as batched solver rows (counterpart of
``edyn_tpu/constraints/joints.py``; reference: the constraint family of
include/edyn/constraints/constraint.hpp:23-34): the joint table's types
and packing, and the step's joint phases for the point, cone and hinge
joints, which the reference steps (``physics_step`` refuses a world with
any other type).

Every joint type writes its rows into one padded table
``[J, MAX_JOINT_ROWS]`` and all types are evaluated masked: a later write
to the same slot overwrites the earlier one, in the JAX package's order. A
type that no valid joint has is skipped (``SceneMeta.joint_types``, or
``types_present`` of the table when a caller gives none): its masked
writes and corrections would change nothing.
Rows follow SURVEY A.1: rhs = -(error * erp + relvel), impulses accumulated
and clamped to [lower, upper], applied to the body deltas. Plain PyTorch on
every device; its sums keep ``index_sum``'s order.
"""
from __future__ import annotations

import dataclasses
import enum
import math

import numpy as np
import torch

from ..core.state import MAX_JOINT_ROWS, JointTable
from ..dynamics.solver import (BIG, degree_counts, gather_ab, index_sum,
                                scatter_add_ab)
from ..math import quat, vec

# Default positional-error reduction (reference:
# constraint_row_options.hpp:15). Limit rows carry their own restitution:
# rhs = -(error*erp + relvel*(1+restitution)) (constraint_row.cpp:21).
ERP = 0.2

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


# Sequential solve groups by row slot: {0,1,2} linear lock rows, {3,4}
# transverse angular rows, {5+} axial rows (limits, friction, bump stops,
# springs). The groups solve one after another in each velocity iteration,
# the rows of one group in parallel with per-joint degree splitting (see
# the JAX package for why).
N_GROUPS = 3


# the types the reference steps
STEPPED = frozenset((JointType.POINT, JointType.CONE, JointType.HINGE))
POINT_LIKE = frozenset((JointType.POINT, JointType.HINGE))


def types_present(jt) -> frozenset:
    """The joint types of the table's valid joints (one host read)."""
    return frozenset(JointType(t)
                     for t in torch.unique(jt.jtype[jt.valid]).tolist())


def _slot_group(slot: int) -> int:
    return 0 if slot < 3 else (1 if slot < 5 else 2)


@dataclasses.dataclass
class JointRows:
    """Flattened [J*MAX_JOINT_ROWS] generic rows."""
    valid: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    ab: torch.Tensor    # [2R] concat(a, b): one gather/scatter index
    JlA: torch.Tensor   # [R,3]
    JaA: torch.Tensor
    JlB: torch.Tensor
    JaB: torch.Tensor
    inv_mA: torch.Tensor
    inv_mB: torch.Tensor
    tA: torch.Tensor    # [R,3] inv_IA @ JaA
    tB: torch.Tensor    # [R,3] inv_IB @ JaB
    eff_mass: torch.Tensor
    rhs: torch.Tensor
    lower: torch.Tensor
    upper: torch.Tensor
    group: torch.Tensor  # [R] int32 sequential solve group


# ---------------------------------------------------------------------------
# host-side packing
# ---------------------------------------------------------------------------

def pack_joints(joint_dicts: list, J: int, device,
                dtype=None) -> JointTable:
    """The JointTable of the builder's joint dicts (see
    ``constraints.api``), staged in float32 numpy as the JAX package stages
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


# ---------------------------------------------------------------------------
# row building
# ---------------------------------------------------------------------------

def _where(c, x, y, dtype=None):
    """torch.where with either branch a Python number (both: a tensor of
    ``dtype``, the state's)."""
    if not isinstance(x, torch.Tensor):
        x = torch.full_like(y, x) if isinstance(y, torch.Tensor) else \
            torch.full(c.shape, x, dtype=dtype, device=c.device)
    if not isinstance(y, torch.Tensor):
        y = torch.full_like(x, y)
    return torch.where(c, x, y)


def _axis(v, Jn, device, dtype):
    """A constant axis for every joint, in the state's dtype (the program
    makes it float32, which is exact and promotes to a float64 state
    alike, but would lift a bfloat16 control to float32)."""
    return torch.tensor(v, dtype=dtype, device=device).expand(Jn, 3)


def build_joint_rows(state, dt: float, mass_splitting: bool = True, *,
                     types=None, cone_cap=None):
    """Returns (JointRows, new_angle): the joints' rows at the current poses
    and velocities, and the tracked twist angle after this step's unwrap.

    ``types``: a superset of the valid joints' types (default: read from
    the table). ``cone_cap``: ``Settings.cone_max_violation``; None keeps
    the JAX package's unbounded cone row (ROADMAP R8)."""
    jt = state.joints
    dev = jt.jtype.device
    Jn = jt.jtype.shape[0]
    R = Jn * MAX_JOINT_ROWS

    a = jt.body_a.long()
    b = jt.body_b.long()
    jvalid = jt.valid & ~(state.asleep[a] & state.asleep[b])
    pos_a, orn_a = state.pos[a], state.orn[a]
    pos_b, orn_b = state.pos[b], state.orn[b]
    # pivots are authored in the origin frame; pos is the COM, so the moment
    # arm is R*(pivot - com)
    rA = quat.rotate(orn_a, jt.pivot_a - state.com[a])
    rB = quat.rotate(orn_b, jt.pivot_b - state.com[b])
    pa_w = pos_a + rA
    pb_w = pos_b + rB
    va, wa = state.linvel[a], state.angvel[a]
    vb, wb = state.linvel[b], state.angvel[b]

    # joint frames in world space; frame X is the primary joint axis
    Ma = quat.to_matrix(quat.mul(orn_a, jt.frame_a))
    Mb = quat.to_matrix(quat.mul(orn_b, jt.frame_b))
    ax_a, ay_a, az_a = Ma[..., :, 0], Ma[..., :, 1], Ma[..., :, 2]
    ax_b = Mb[..., :, 0]

    fdt = state.dtype
    z = lambda *s: torch.zeros(s, dtype=fdt, device=dev)
    JlA, JaA = z(Jn, MAX_JOINT_ROWS, 3), z(Jn, MAX_JOINT_ROWS, 3)
    JlB, JaB = z(Jn, MAX_JOINT_ROWS, 3), z(Jn, MAX_JOINT_ROWS, 3)
    rhs = z(Jn, MAX_JOINT_ROWS)
    lower = torch.full((Jn, MAX_JOINT_ROWS), -BIG, dtype=fdt, device=dev)
    upper = torch.full((Jn, MAX_JOINT_ROWS), BIG, dtype=fdt, device=dev)
    rvalid = torch.zeros((Jn, MAX_JOINT_ROWS), dtype=torch.bool, device=dev)

    is_ = lambda t: jt.jtype == int(t)
    # a section whose type no valid joint has writes nothing: skip it
    present = types_present(jt) if types is None else types

    def set_row(slot, cond, jla, jaa, jlb, jab, r, lo=None, hi=None):
        cond = cond & jvalid
        c3 = cond[:, None]
        JlA[:, slot] = torch.where(c3, jla, JlA[:, slot])
        JaA[:, slot] = torch.where(c3, jaa, JaA[:, slot])
        JlB[:, slot] = torch.where(c3, jlb, JlB[:, slot])
        JaB[:, slot] = torch.where(c3, jab, JaB[:, slot])
        rhs[:, slot] = _where(cond, r, rhs[:, slot])
        if lo is not None:
            lower[:, slot] = _where(cond, lo, lower[:, slot])
        if hi is not None:
            upper[:, slot] = _where(cond, hi, upper[:, slot])
        rvalid[:, slot] = rvalid[:, slot] | cond

    zero3 = z(Jn, 3)
    zero = z(Jn)
    err = pa_w - pb_w

    def relvel_at(d):
        return (vec.dot(d, va) + vec.dot(vec.cross(rA, d), wa)
                - vec.dot(d, vb) - vec.dot(vec.cross(rB, d), wb))

    # --- point / hinge: 3 positional lock rows ---
    if present & POINT_LIKE:
        point_like = is_(JointType.POINT) | is_(JointType.HINGE)
        eye = torch.eye(3, dtype=fdt, device=dev)
        for k in range(3):
            d = eye[k].expand(Jn, 3)
            r = -(vec.dot(err, d) / dt * ERP + relvel_at(d))
            set_row(k, point_like, d, vec.cross(rA, d), -d,
                    -vec.cross(rB, d), r)

    # --- tracked continuous twist angle: wraps accumulate so limits beyond
    # +-pi work; twist measured after removing bend via shortest_arc ---
    arc = quat.shortest_arc(ax_b, ax_a)
    y_ax = _axis((0.0, 1.0, 0.0), Jn, dev, fdt)
    yb_in_a = quat.rotate(quat.mul(quat.conjugate(orn_a),
                                   quat.mul(arc, orn_b)),
                          quat.rotate(jt.frame_b, y_ax))
    fy_a = quat.rotate(jt.frame_a, y_ax)
    fz_a = quat.rotate(jt.frame_a, _axis((0.0, 0.0, 1.0), Jn, dev, fdt))
    inst_angle = torch.atan2(vec.dot(yb_in_a, fz_a), vec.dot(yb_in_a, fy_a))
    # floored modulo (jnp.mod), not the truncated torch.fmod
    two_pi = 2.0 * math.pi
    delta = inst_angle - torch.remainder(jt.angle + math.pi, two_pi) \
        + math.pi
    delta = torch.remainder(delta + math.pi, two_pi) - math.pi
    angle = jt.angle + delta
    new_angle = torch.where(jvalid, angle, jt.angle)

    # --- hinge: 2 angular alignment rows + limits + friction/damping/spring
    # + bump stop (reference: hinge_constraint.cpp). params:
    # [limit_min, limit_max, limit_restitution, bump_stop_stiffness,
    #  bump_stop_angle, friction_torque, damping, spring_stiffness,
    #  spring_rest_angle, has_limit]
    if JointType.HINGE in present:
        hinge = is_(JointType.HINGE)
        err_axis = vec.cross(ax_b, ax_a)
        for k, u in enumerate((ay_a, az_a)):
            relw_u = vec.dot(u, wa) - vec.dot(u, wb)
            r = -(vec.dot(u, err_axis) / dt * ERP + relw_u)
            set_row(3 + k, hinge, zero3, u, zero3, -u, r)
        relw = vec.dot(ax_a, wa) - vec.dot(ax_a, wb)  # = -d(angle)/dt
        has_limit = jt.params[:, 9] > 0.5
        lim_min = jt.params[:, 0]
        lim_max = jt.params[:, 1]
        lim_rest = jt.params[:, 2]
        # always-on speculative limit row toward the nearest bound
        # (hinge_constraint.cpp:91-113)
        mid_h = 0.5 * (lim_min + lim_max)
        near_min_h = angle < mid_h
        lim_err = torch.where(near_min_h, lim_min - angle, lim_max - angle)
        r_lim = -(lim_err / dt * ERP + relw * (1.0 + lim_rest))
        lo_lim = _where(near_min_h, -BIG, 0.0, fdt)
        hi_lim = _where(near_min_h, 0.0, BIG, fdt)
        set_row(5, hinge & has_limit, zero3, ax_a, zero3, -ax_a,
                r_lim, lo=lo_lim, hi=hi_lim)
        # friction + damping torque about the axis
        fr_t = jt.params[:, 5]
        dampg = jt.params[:, 6]
        max_fr = fr_t * dt + torch.abs(relw) * dampg * dt
        set_row(6, hinge & (max_fr > 0), zero3, ax_a, zero3, -ax_a, -relw,
                lo=-max_fr, hi=max_fr)
        # torsional spring toward the rest angle: exact spring impulse
        spring_k = jt.params[:, 7]
        rest_ang = jt.params[:, 8]
        spr_imp = spring_k * (angle - rest_ang) * dt
        set_row(7, hinge & (spring_k > 0), zero3, ax_a, zero3, -ax_a,
                zero, lo=spr_imp, hi=spr_imp)
        # bump stop: one-sided spring near each limit
        bump_k = jt.params[:, 3]
        bump_ang = jt.params[:, 4]
        bmin = lim_min + bump_ang
        bmax = lim_max - bump_ang
        bump_defl = torch.where(angle < bmin, angle - bmin,
                                _where(angle > bmax, angle - bmax, 0.0))
        bump_imp = bump_k * bump_defl * dt
        set_row(8, hinge & has_limit & (bump_k > 0) & (bump_ang > 0),
                zero3, ax_a, zero3, -ax_a, bump_defl / dt * ERP - relw,
                lo=torch.clamp(bump_imp, max=0.0),
                hi=torch.clamp(bump_imp, min=0.0))

    # --- cone: keep B's x-axis inside an elliptic cone around A's x-axis.
    # params: [span_y_tan, span_z_tan]
    if JointType.CONE in present:
        cone = is_(JointType.CONE)
        bx = torch.stack([vec.dot(ax_b, ax_a), vec.dot(ax_b, ay_a),
                          vec.dot(ax_b, az_a)], -1)
        ty = jt.params[:, 0]
        tz = jt.params[:, 1]
        xpos = torch.clamp(bx[:, 0], min=1e-3)
        ey = bx[:, 1] / (xpos * torch.clamp(ty, min=1e-6))
        ez = bx[:, 2] / (xpos * torch.clamp(tz, min=1e-6))
        viol = ey * ey + ez * ez - 1.0
        violated = cone & (viol > 0)
        # u oriented so that a positive impulse rotates ax_b toward ax_a
        u_corr = vec.normalize_or(vec.cross(ax_a, ax_b), y_ax)
        relw_c = vec.dot(u_corr, wa) - vec.dot(u_corr, wb)
        if cone_cap is not None:
            viol = torch.clamp(viol, max=cone_cap)
        r_cone = viol * 0.5 / dt * ERP - relw_c
        set_row(8, violated, zero3, u_corr, zero3, -u_corr, r_cone, lo=0.0,
                hi=BIG)

    # --- flatten ---
    flat = lambda x: x.reshape((R,) + tuple(x.shape[2:]))
    a_r = torch.repeat_interleave(a, MAX_JOINT_ROWS)
    b_r = torch.repeat_interleave(b, MAX_JOINT_ROWS)
    valid_r = flat(rvalid)
    inv_mA = torch.where(valid_r, state.mass_inv[a_r], 0.0)
    inv_mB = torch.where(valid_r, state.mass_inv[b_r], 0.0)
    Iw = state.inertia_world_inv()
    inv_IA = Iw[a_r] * valid_r[:, None, None]
    inv_IB = Iw[b_r] * valid_r[:, None, None]
    slot_groups = torch.tensor(
        [_slot_group(s) for s in range(MAX_JOINT_ROWS)], dtype=torch.int32,
        device=dev)
    group_r = slot_groups.repeat(Jn)
    if mass_splitting:
        # degree = incident JOINTS per body per solve group: within a group
        # one joint's rows are orthogonal (or impulse-bounded), so only
        # same-group rows of different joints split the mass
        degA = torch.ones((R,), dtype=fdt, device=dev)
        degB = torch.ones((R,), dtype=fdt, device=dev)
        for g in range(N_GROUPS):
            in_g = slot_groups == g
            jhas = torch.any(rvalid & in_g[None, :], dim=1) & jvalid
            deg_g = degree_counts(state.capacity, [a, b], [jhas, jhas],
                                  fdt)
            sel = in_g.repeat(Jn)
            degA = torch.where(sel, deg_g[a_r], degA)
            degB = torch.where(sel, deg_g[b_r], degB)
    else:
        degA = degB = 1.0
    fJlA, fJaA, fJlB, fJaB = flat(JlA), flat(JaA), flat(JlB), flat(JaB)
    tA = torch.einsum("rij,rj->ri", inv_IA, fJaA)
    tB = torch.einsum("rij,rj->ri", inv_IB, fJaB)
    term = (vec.dot(fJlA, fJlA) * inv_mA * degA + vec.dot(tA, fJaA) * degA
            + vec.dot(fJlB, fJlB) * inv_mB * degB + vec.dot(tB, fJaB) * degB)
    em = torch.where(term > 1e-12, 1.0 / torch.clamp(term, min=1e-12), 0.0)
    return JointRows(
        valid=valid_r, a=a_r, b=b_r, ab=torch.cat([a_r, b_r]),
        JlA=fJlA, JaA=fJaA, JlB=fJlB, JaB=fJaB,
        inv_mA=inv_mA, inv_mB=inv_mB, tA=tA, tB=tB,
        eff_mass=em, rhs=flat(rhs), lower=flat(lower),
        upper=flat(upper), group=group_r), new_angle


def _apply(rows: JointRows, dlam, dvw):
    dlam = torch.where(rows.valid, dlam, 0.0)[:, None]
    return scatter_add_ab(dvw, rows.ab,
                          rows.inv_mA[:, None] * rows.JlA * dlam,
                          rows.tA * dlam,
                          rows.inv_mB[:, None] * rows.JlB * dlam,
                          rows.tB * dlam)


def warm_start_joints(rows: JointRows, impulses, dvw):
    """Apply the stored joint impulses [J, MAX_JOINT_ROWS] to the packed
    [N,6] deltas."""
    return _apply(rows, impulses.reshape(-1), dvw)


def solve_joints_once(rows: JointRows, impulses, dvw):
    """One velocity iteration over the joint rows on [N,6] deltas: the
    N_GROUPS solve groups run one after another (each sees the previous
    group's deltas), the rows of a group in parallel. Returns (impulses,
    dvw)."""
    imp = impulses.reshape(-1)
    for g in range(N_GROUPS):
        in_g = rows.group == g
        dva, dwa, dvb, dwb = gather_ab(dvw, rows.ab)
        drel = (vec.dot(rows.JlA, dva) + vec.dot(rows.JaA, dwa)
                + vec.dot(rows.JlB, dvb) + vec.dot(rows.JaB, dwb))
        dlam = (rows.rhs - drel) * rows.eff_mass
        new = torch.minimum(torch.maximum(imp + dlam, rows.lower), rows.upper)
        dlam = torch.where(in_g, new - imp, 0.0)
        imp = torch.where(in_g, new, imp)
        dvw = _apply(rows, dlam, dvw)
    return imp.reshape(impulses.shape), dvw


def _world_inv_inertia(orn_ab, inertia_inv_ab):
    R = quat.to_matrix(orn_ab)
    return R @ inertia_inv_ab @ R.transpose(-1, -2)


def solve_joint_positions(state, num_iterations: int = 3,
                          correction_rate: float = 0.8, *, types=None):
    """NGS position correction for joints (reference: the per-constraint
    solve_position methods, src/edyn/dynamics/island_solver.cpp:250-353;
    hinge_constraint.cpp:180-215). Geometry is re-derived from the current
    poses each iteration; then the hinge axis alignment, its angular limit
    clamp and the pivot join are applied as direct positional/angular
    corrections, and the program's three generic-limit rows, which no
    stepped type has, renormalize as the program's do. ``types`` as in
    ``build_joint_rows``."""
    jt = state.joints
    Jn = jt.jtype.shape[0]
    N = state.capacity
    if Jn == 0 or num_iterations <= 0:
        return state
    dev = jt.jtype.device

    is_ = lambda t: jt.jtype == int(t)
    point_like = is_(JointType.POINT) | is_(JointType.HINGE)
    axis_align = is_(JointType.HINGE)
    a, b = jt.body_a.long(), jt.body_b.long()
    ab = torch.cat([a, b])
    jvalid = jt.valid & ~(state.asleep[a] & state.asleep[b])
    inertia_ab = state.inertia_inv[ab]

    pos = state.pos
    orn = state.orn
    inv_m = state.mass_inv

    def solve_row(pos, orn, Iw, d_a, ang_a, d_b, ang_b, error, active):
        """One position row J = {d_a, ang_a, d_b, ang_b} pushing error to 0
        (position_solver.hpp:13-52)."""
        ima = torch.where(active, inv_m[a], 0.0)
        imb = torch.where(active, inv_m[b], 0.0)
        tA = torch.einsum("jik,jk->ji", Iw[:Jn], ang_a)
        tB = torch.einsum("jik,jk->ji", Iw[Jn:], ang_b)
        term = (vec.dot(d_a, d_a) * ima + vec.dot(tA, ang_a)
                + vec.dot(d_b, d_b) * imb + vec.dot(tB, ang_b))
        em = torch.where(term > 1e-12, 1.0 / torch.clamp(term, min=1e-12),
                         0.0)
        lam = (error * correction_rate * em)[:, None]
        lam = torch.where(active[:, None], lam, 0.0)
        zn3 = torch.zeros((N, 3), dtype=pos.dtype, device=dev)
        dpos = index_sum(zn3, ab,
                         torch.cat([ima[:, None] * d_a * lam,
                                    imb[:, None] * d_b * lam]))
        dang = index_sum(zn3.clone(), ab,
                         torch.cat([tA * lam, tB * lam]))
        return pos + dpos, quat.integrate(orn, dang, 1.0)

    # A section whose joint types no valid joint has moves no body: its
    # rows' dpos and dang are +0, so each row adds 0 to pos and integrates
    # the identity rotation. ``unmoved`` does exactly that without the row.
    present = types_present(jt) if types is None else types
    align = JointType.HINGE in present
    pivots = bool(present & POINT_LIKE)
    ident = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=state.dtype,
                         device=dev).expand(N, 4)

    def unmoved(pos, orn, rows: int):
        for _ in range(rows):
            pos, orn = pos + 0.0, quat.normalize(quat.mul(ident, orn))
        return pos, orn

    z3 = torch.zeros((Jn, 3), dtype=state.dtype, device=dev)
    for _ in range(num_iterations):
        if align:
            orn_ab = orn[ab]
            Ma = quat.to_matrix(quat.mul(orn_ab[:Jn], jt.frame_a))
            Mb = quat.to_matrix(quat.mul(orn_ab[Jn:], jt.frame_b))
            Iw = _world_inv_inertia(orn_ab, inertia_ab)

            # --- angular: align the primary axes (hinge/cvjoint) ---
            ax_a = Ma[..., :, 0]
            ax_b = Mb[..., :, 0]
            u = vec.cross(ax_a, ax_b)
            p, q = vec.orthonormal_basis(ax_a)
            for tdir in (p, q):
                err = vec.dot(u, tdir)
                active = jvalid & axis_align & (torch.abs(err) > 1e-9)
                pos, orn = solve_row(pos, orn, Iw, z3, tdir, z3, -tdir, err,
                                     active)
                orn_ab = orn[ab]
                Iw = _world_inv_inertia(orn_ab, inertia_ab)

            # --- hinge/cvjoint angular limit clamp at the position level ---
            Ma2 = quat.to_matrix(quat.mul(orn_ab[:Jn], jt.frame_a))
            Mb2 = quat.to_matrix(quat.mul(orn_ab[Jn:], jt.frame_b))
            axh = Ma2[..., :, 0]
            cur = torch.atan2(vec.dot(Mb2[..., :, 1], Ma2[..., :, 2]),
                              vec.dot(Mb2[..., :, 1], Ma2[..., :, 1]))
            lim_mn = jt.params[:, 0]
            lim_mx = jt.params[:, 1]
            has_lim = is_(JointType.HINGE) & (jt.params[:, 9] > 0.5)
            viol = torch.where(cur < lim_mn, cur - lim_mn,
                               _where(cur > lim_mx, cur - lim_mx, 0.0))
            active = jvalid & has_lim & (torch.abs(viol) > 1e-9)
            pos, orn = solve_row(pos, orn, Iw, z3, axh, z3, -axh, viol,
                                 active)
        else:
            pos, orn = unmoved(pos, orn, 3)

        # --- linear: join the pivot points (arms about the COM) ---
        if pivots:
            orn_ab = orn[ab]
            Iw = _world_inv_inertia(orn_ab, inertia_ab)
            pos_ab = pos[ab]
            rA = quat.rotate(orn_ab[:Jn], jt.pivot_a - state.com[a])
            rB = quat.rotate(orn_ab[Jn:], jt.pivot_b - state.com[b])
            d = (pos_ab[:Jn] + rA) - (pos_ab[Jn:] + rB)
            err = vec.length(d)
            dirn = vec.normalize_or(d, _axis((0.0, 1.0, 0.0), Jn, dev,
                                                  state.dtype))
            active = jvalid & point_like & (err > 1e-9)
            pos, orn = solve_row(pos, orn, Iw, dirn, vec.cross(rA, dirn),
                                 -dirn, -vec.cross(rB, dirn), -err, active)
        else:
            pos, orn = unmoved(pos, orn, 1)

        # the generic section's three rows (no generic joint here)
        pos, orn = unmoved(pos, orn, 3)

    # immovable bodies never moved (inv_m = 0, inertia_inv = 0)
    return dataclasses.replace(state, pos=pos, orn=orn)
