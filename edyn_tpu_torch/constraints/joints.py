"""Non-contact constraints (joints) as batched solver rows (counterpart of
``edyn_tpu/constraints/joints.py``; reference: the constraint family of
include/edyn/constraints/constraint.hpp:23-34).

Distance, soft distance, point, hinge, cone, generic (6-DOF), cvjoint,
gravity and null. Every joint type writes its rows into one padded table
``[J, MAX_JOINT_ROWS]`` and all types are evaluated masked: a later write
to the same slot overwrites the earlier one, in the JAX package's order. A
type that no valid joint has is skipped (``SceneMeta.joint_types``, or
``types_present`` of the table when a caller gives none): its masked
writes and corrections would change nothing.
Rows follow SURVEY A.1: rhs = -(error * erp + relvel), impulses accumulated
and clamped to [lower, upper], applied to the body deltas. The joint code
is plain PyTorch on every device, as the JAX package keeps it in XLA.
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
from ..utils.profile import host

# Default positional-error reduction (reference:
# constraint_row_options.hpp:15).
# The generic constraint's enabled linear-limit rows use erp 0.9
# (generic_constraint.cpp:60), and limit rows carry their own restitution:
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


POINT_LIKE = frozenset((JointType.POINT, JointType.HINGE, JointType.CVJOINT))


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


def _axis(v, Jn, device):
    return host("joints.axis", torch.tensor(
        v, dtype=torch.float32, device=device)).expand(Jn, 3)


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

    # --- point / hinge / cvjoint: 3 positional lock rows ---
    if present & POINT_LIKE:
        point_like = is_(JointType.POINT) | is_(JointType.HINGE) \
            | is_(JointType.CVJOINT)
        eye = torch.eye(3, dtype=fdt, device=dev)
        for k in range(3):
            d = eye[k].expand(Jn, 3)
            r = -(vec.dot(err, d) / dt * ERP + relvel_at(d))
            set_row(k, point_like, d, vec.cross(rA, d), -d,
                    -vec.cross(rB, d), r)

    # --- distance: one row along the pivot separation ---
    if present & {JointType.DISTANCE, JointType.SOFT_DISTANCE}:
        dist_len = vec.length(err)
        d_dir = vec.normalize_or(err, _axis((0.0, 1.0, 0.0), Jn, dev))
        rest_len = jt.params[:, 0]
    if JointType.DISTANCE in present:
        r_dist = -((dist_len - rest_len) / dt * ERP + relvel_at(d_dir))
        set_row(0, is_(JointType.DISTANCE), d_dir, vec.cross(rA, d_dir),
                -d_dir, -vec.cross(rB, d_dir), r_dist)

    # --- soft distance: spring row (exact impulse) + damper row ---
    # params: [rest_len, stiffness, damping]
    if JointType.SOFT_DISTANCE in present:
        stiff = jt.params[:, 1]
        damp = jt.params[:, 2]
        spring_imp = -stiff * (dist_len - rest_len) * dt
        set_row(0, is_(JointType.SOFT_DISTANCE), d_dir, vec.cross(rA, d_dir),
                -d_dir, -vec.cross(rB, d_dir), zero, lo=spring_imp,
                hi=spring_imp)
        damp_imp = damp * dt
        set_row(1, is_(JointType.SOFT_DISTANCE), d_dir, vec.cross(rA, d_dir),
                -d_dir, -vec.cross(rB, d_dir), -relvel_at(d_dir),
                lo=-damp_imp, hi=damp_imp)

    # --- tracked continuous twist angle: wraps accumulate so limits beyond
    # +-pi work; twist measured after removing bend via shortest_arc ---
    arc = quat.shortest_arc(ax_b, ax_a)
    y_ax = _axis((0.0, 1.0, 0.0), Jn, dev)
    yb_in_a = quat.rotate(quat.mul(quat.conjugate(orn_a),
                                   quat.mul(arc, orn_b)),
                          quat.rotate(jt.frame_b, y_ax))
    fy_a = quat.rotate(jt.frame_a, y_ax)
    fz_a = quat.rotate(jt.frame_a, _axis((0.0, 0.0, 1.0), Jn, dev))
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

    # --- generic 6-DOF (generic_constraint.cpp:1-330): 3 linear DOFs along
    # frame-A axes, then 3 angular, 10 params each at d*10: [limit_enabled,
    # min, max, limit_restitution, bump_stop_size, bump_stop_stiffness,
    # friction, rest, spring_stiffness, damping]. Row slots d*4 + (0 limit
    # | 1 bump | 2 spring | 3 friction/damping).
    if JointType.GENERIC in present:
        gen = is_(JointType.GENERIC)
        axes_a = (ax_a, ay_a, az_a)
        pivot_off = pb_w - pa_w
        # angular DOF angles: dof 0 the tracked twist; dof 1 asin(bx . az_a);
        # dof 2 asin(bx . ay_a)
        ang1 = torch.arcsin(torch.clamp(vec.dot(ax_b, az_a), -1.0, 1.0))
        ang2 = torch.arcsin(torch.clamp(vec.dot(ax_b, ay_a), -1.0, 1.0))
        ax1 = vec.normalize_or(vec.cross(az_a, ax_b),
                               _axis((0.0, 0.0, 1.0), Jn, dev))
        ax2 = vec.normalize_or(vec.cross(ay_a, ax_b), y_ax)

        for d in range(6):
            p = jt.params[:, d * 10:d * 10 + 10]
            p_en = p[:, 0] > 0.5
            p_min, p_max, p_rst = p[:, 1], p[:, 2], p[:, 3]
            p_bsz, p_bk, p_fr = p[:, 4], p[:, 5], p[:, 6]
            p_rest, p_k, p_dmp = p[:, 7], p[:, 8], p[:, 9]
            nz_lim = p_min < p_max

            if d < 3:  # linear along frame-A axis d
                u = axes_a[d]
                jla, jaa, jlb, jab = u, vec.cross(rA, u), -u, -vec.cross(rB, u)
                coord = vec.dot(pivot_off, u)
                relv = relvel_at(u)
            else:      # angular about a frame axis
                k = d - 3
                u = (ax_a, -ax1, -ax2)[k]
                jla = jlb = zero3
                jaa, jab = u, -u
                coord = (angle, ang1, ang2)[k]
                relv = vec.dot(u, wa) - vec.dot(u, wb)

            # J.v = -d(coord)/dt, so a positive impulse reduces coord
            mid = 0.5 * (p_min + p_max)
            near_min = coord < mid
            lim_err = torch.where(near_min, p_min - coord, p_max - coord)
            inside = (coord > p_min) & (coord < p_max)
            # one-sided limit with a real range, a full lock otherwise
            lo_l = torch.where(nz_lim, _where(near_min, -BIG, 0.0, fdt),
                               torch.full_like(coord, -BIG))
            hi_l = torch.where(nz_lim, _where(near_min, 0.0, BIG, fdt),
                               torch.full_like(coord, BIG))
            # speculative stop inside the range (erp 0.9 for linear
            # limits), nothing when a linear limit is violated (the position
            # solver fixes it), -coord/dt for a locked angular DOF
            error_v = torch.where(
                nz_lim, _where(inside, lim_err / dt, 0.0),
                -coord / dt if d >= 3 else torch.zeros_like(coord))
            erp = (_where(nz_lim, 0.9, ERP, fdt) if d < 3
                   else torch.full_like(coord, ERP))
            r_l = -(error_v * erp
                    + relv * (1.0 + _where(nz_lim, p_rst, 0.0)))
            set_row(d * 4 + 0, gen & p_en, jla, jaa, jlb, jab, r_l,
                    lo=lo_l, hi=hi_l)

            # bump stop: one-sided spring near each end of the range
            bmin_ = p_min + p_bsz
            bmax_ = p_max - p_bsz
            defl = torch.where(coord < bmin_, coord - bmin_,
                               _where(coord > bmax_, coord - bmax_, 0.0))
            b_imp = p_bk * defl * dt
            set_row(d * 4 + 1, gen & p_en & nz_lim & (p_bk > 0) & (p_bsz > 0),
                    jla, jaa, jlb, jab, defl / dt * ERP - relv,
                    lo=torch.clamp(b_imp, max=0.0),
                    hi=torch.clamp(b_imp, min=0.0))

            # spring toward the rest coordinate: exact impulse
            # k*(coord-rest)*dt
            s_defl = coord - p_rest
            s_imp = p_k * s_defl * dt
            set_row(d * 4 + 2, gen & (p_k > 0), jla, jaa, jlb, jab,
                    s_defl / dt * ERP - relv,
                    lo=torch.clamp(s_imp, max=0.0),
                    hi=torch.clamp(s_imp, min=0.0))

            # friction + damping
            f_imp = p_fr * dt + torch.abs(relv) * p_dmp * dt
            set_row(d * 4 + 3, gen & ((p_fr > 0) | (p_dmp > 0)), jla, jaa,
                    jlb, jab, -relv, lo=-f_imp, hi=f_imp)

    # --- cvjoint (cvjoint_constraint.cpp:1-302): twist limit/lock + bump
    # stop + spring + friction/damping about the per-body twist axes, bend
    # friction/damping and a bend spring toward rest_direction. params:
    # [twist_min, twist_max, twist_restitution, bump_stop_angle,
    # bump_stop_stiffness, friction_torque, rest_angle, stiffness, damping,
    # rest_direction xyz (9:12), bend_stiffness 12, bend_friction 13,
    # bend_damping 14]
    if JointType.CVJOINT in present:
        cv = is_(JointType.CVJOINT)
        relw_cv = vec.dot(ax_a, wa) - vec.dot(ax_b, wb)
        tw_min = jt.params[:, 0]
        tw_max = jt.params[:, 1]
        tw_rst = jt.params[:, 2]
        tw_nz = tw_min < tw_max
        tw_below = angle < 0.5 * (tw_min + tw_max)
        tw_err = torch.where(tw_below, tw_min - angle, tw_max - angle)
        tw_inside = (angle > tw_min) & (angle < tw_max)
        r_tw = torch.where(
            tw_nz,
            -(_where(tw_inside, tw_err / dt, 0.0) * ERP
              + relw_cv * (1.0 + tw_rst)),
            -relw_cv)
        lo_tw = torch.where(tw_nz, _where(tw_below, -BIG, 0.0, fdt),
                            torch.full_like(angle, -BIG))
        hi_tw = torch.where(tw_nz, _where(tw_below, 0.0, BIG, fdt),
                            torch.full_like(angle, BIG))
        set_row(3, cv, zero3, ax_a, zero3, -ax_b, r_tw, lo=lo_tw, hi=hi_tw)

        # twist bump stop
        cb_ang = jt.params[:, 3]
        cb_k = jt.params[:, 4]
        cb_min = tw_min + cb_ang
        cb_max = tw_max - cb_ang
        cb_defl = torch.where(angle < cb_min, angle - cb_min,
                              _where(angle > cb_max, angle - cb_max, 0.0))
        cb_imp = cb_k * cb_defl * dt
        set_row(4, cv & tw_nz & (cb_k > 0) & (cb_ang > 0), zero3, ax_a,
                zero3, -ax_b, cb_defl / dt * ERP - relw_cv,
                lo=torch.clamp(cb_imp, max=0.0),
                hi=torch.clamp(cb_imp, min=0.0))

        # twist spring toward the rest angle
        cs_k = jt.params[:, 7]
        cs_defl = angle - jt.params[:, 6]
        cs_imp = cs_k * cs_defl * dt
        set_row(5, cv & (cs_k > 0), zero3, ax_a, zero3, -ax_b,
                cs_defl / dt * ERP - relw_cv,
                lo=torch.clamp(cs_imp, max=0.0),
                hi=torch.clamp(cs_imp, min=0.0))

        # twist friction + damping
        cf_imp = jt.params[:, 5] * dt \
            + torch.abs(relw_cv) * jt.params[:, 8] * dt
        set_row(6, cv & (cf_imp > 0), zero3, ax_a, zero3, -ax_b, -relw_cv,
                lo=-cf_imp, hi=cf_imp)

        # bend friction + damping: resists the non-twist relative angular
        # velocity
        wrel_bend = (wa - vec.dot(wa, ax_a)[:, None] * ax_a) \
            - (wb - vec.dot(wb, ax_b)[:, None] * ax_b)
        bend_spd = vec.length(wrel_bend)
        bend_axis = vec.normalize_or(wrel_bend, ay_a)
        bf_imp = jt.params[:, 13] * dt + bend_spd * jt.params[:, 14] * dt
        set_row(7, cv & (bf_imp > 0), zero3, bend_axis, zero3, -bend_axis,
                -(vec.dot(bend_axis, wa) - vec.dot(bend_axis, wb)),
                lo=-bf_imp, hi=bf_imp)

        # bend spring: torque B's twist axis toward rest_direction (in A's
        # object space)
        rest_dir_w = quat.rotate(orn_a, jt.params[:, 9:12])
        bspr_axis_raw = vec.cross(rest_dir_w, ax_b)
        sin_bend = torch.clamp(vec.length(bspr_axis_raw), -1.0, 1.0)
        bend_angle = torch.arcsin(sin_bend)
        bspr_axis = vec.normalize_or(bspr_axis_raw, ay_a)
        bs_k = jt.params[:, 12]
        bs_imp = bs_k * bend_angle * dt
        set_row(8, cv & (bs_k > 0), zero3, bspr_axis, zero3, -bspr_axis,
                bend_angle / dt * ERP
                - (vec.dot(bspr_axis, wa) - vec.dot(bspr_axis, wb)),
                lo=torch.clamp(bs_imp, max=0.0),
                hi=torch.clamp(bs_imp, min=0.0))

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
    slot_groups = host("joints.slot_groups", torch.tensor(
        [_slot_group(s) for s in range(MAX_JOINT_ROWS)], dtype=torch.int32,
        device=dev))
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
    poses each iteration; then the hinge/cvjoint axis alignment, their
    angular limit clamp, the pivot join and the generic linear limits are
    applied as direct positional/angular corrections. ``types`` as in
    ``build_joint_rows``."""
    jt = state.joints
    Jn = jt.jtype.shape[0]
    N = state.capacity
    if Jn == 0 or num_iterations <= 0:
        return state
    dev = jt.jtype.device

    is_ = lambda t: jt.jtype == int(t)
    point_like = (is_(JointType.POINT) | is_(JointType.HINGE)
                  | is_(JointType.CVJOINT))
    axis_align = is_(JointType.HINGE) | is_(JointType.CVJOINT)
    gen = is_(JointType.GENERIC)
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
    align = bool(present & {JointType.HINGE, JointType.CVJOINT})
    pivots = bool(present & POINT_LIKE)
    generic = JointType.GENERIC in present
    ident = host("joints.ident", torch.tensor(
        [0.0, 0.0, 0.0, 1.0], dtype=state.dtype, device=dev)).expand(N, 4)

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
            has_lim = (is_(JointType.HINGE) & (jt.params[:, 9] > 0.5)) \
                | (is_(JointType.CVJOINT) & (lim_mn < lim_mx))
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
            dirn = vec.normalize_or(d, _axis((0.0, 1.0, 0.0), Jn, dev))
            active = jvalid & point_like & (err > 1e-9)
            pos, orn = solve_row(pos, orn, Iw, dirn, vec.cross(rA, dirn),
                                 -dirn, -vec.cross(rB, dirn), -err, active)
        else:
            pos, orn = unmoved(pos, orn, 1)

        # --- generic: per-axis linear limit violation correction ---
        if not generic:
            pos, orn = unmoved(pos, orn, 3)
            continue
        orn_ab = orn[ab]
        Iw = _world_inv_inertia(orn_ab, inertia_ab)
        Ma = quat.to_matrix(quat.mul(orn_ab[:Jn], jt.frame_a))
        pos_ab = pos[ab]
        rA = quat.rotate(orn_ab[:Jn], jt.pivot_a - state.com[a])
        rB = quat.rotate(orn_ab[Jn:], jt.pivot_b - state.com[b])
        off = (pos_ab[Jn:] + rB) - (pos_ab[:Jn] + rA)
        for d_ in range(3):
            base = d_ * 10
            p_en = jt.params[:, base] > 0.5
            p_min = jt.params[:, base + 1]
            p_max = jt.params[:, base + 2]
            u = Ma[..., :, d_]
            proj = vec.dot(off, u)
            errg = torch.where(proj < p_min, proj - p_min,
                               _where(proj > p_max, proj - p_max, 0.0))
            active = jvalid & gen & p_en & (torch.abs(errg) > 1e-9)
            pos, orn = solve_row(pos, orn, Iw, u, vec.cross(rA, u),
                                 -u, -vec.cross(rB, u), errg, active)

    # immovable bodies never moved (inv_m = 0, inertia_inv = 0)
    return dataclasses.replace(state, pos=pos, orn=orn)


def apply_gravity_joints(state, dt: float):
    """Pairwise gravitational attraction applied directly to velocities
    (reference: src/edyn/constraints/gravity_constraint.cpp). Like the JAX
    package's, the step does not call it (ROADMAP R7)."""
    jt = state.joints
    G = 6.674e-11
    mask = jt.valid & (jt.jtype == int(JointType.GRAVITY))
    a, b = jt.body_a.long(), jt.body_b.long()
    d = state.pos[b] - state.pos[a]
    r2 = torch.clamp(vec.length_sqr(d), min=1e-12)
    dir_ = d / torch.sqrt(r2)[:, None]
    ma_inv, mb_inv = state.mass_inv[a], state.mass_inv[b]
    mA = torch.where(ma_inv > 0, 1.0 / torch.clamp(ma_inv, min=1e-12), 0.0)
    mB = torch.where(mb_inv > 0, 1.0 / torch.clamp(mb_inv, min=1e-12), 0.0)
    F = torch.where(mask, G * mA * mB / r2, 0.0)
    dva = dir_ * (F * ma_inv * dt)[:, None]
    dvb = -dir_ * (F * mb_inv * dt)[:, None]
    linvel = index_sum(index_sum(state.linvel, a, dva), b, dvb)
    return dataclasses.replace(state, linvel=linvel)
