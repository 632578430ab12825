"""Batched impulse solver, the contact part (counterpart of
``edyn_tpu/dynamics/solver.py``; reference: src/edyn/dynamics/solver.cpp,
constraint_row.cpp, constraint_row_friction.cpp).

Row semantics are those of the JAX package: every contact point is one row
block (normal + 2 coupled friction directions, plus spin and rolling rows);
each iteration solves all rows against the iteration-start deltas and
scatter-adds the results (block Jacobi with mass splitting).

The JAX package has two variants of the iteration and restitution loops
(jnp and Pallas, chosen by ``SceneMeta.pallas_solver``). The port has one:
the loops run over the packed row table (``solver_kernels.pack_rows_t``)
and call the ``solver_kernels`` wrappers, which take the CUDA kernel on the
card and the plain version on the CPU. On the card the velocity
iterations and the restitution passes, outer (K3b) and inner, run fused
over the step's scatter plan (``scatter.ScatterPlan``: the kernel gathers
its endpoints itself and ``segment_sum`` adds the terms); on the CPU they
gather, run the plain version and ``index_add``, as the JAX package's XLA
path does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config import LARGE_SCALAR
from ..core.state import KIND_STATIC
from ..math import quat, vec
from ..parallel.collectives import Mesh
from . import solver_kernels as sk

BIG = 1e18


@dataclasses.dataclass
class RowDir:
    """One constraint direction: angular jacobians Ja = r x d and the
    inertia-applied responses t = I^-1 Ja, eff. mass and rhs."""
    JaA: torch.Tensor
    JaB: torch.Tensor
    tA: torch.Tensor
    tB: torch.Tensor
    eff_mass: torch.Tensor
    rhs: torch.Tensor


@dataclasses.dataclass
class ContactRows:
    """One row block per live contact point, compacted into a prefix."""
    valid: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    ab: torch.Tensor
    inv_mA: torch.Tensor
    inv_mB: torch.Tensor
    n: torch.Tensor
    t1: torch.Tensor
    t2: torch.Tensor
    rn: RowDir
    r1: RowDir
    r2: RowDir
    friction: torch.Tensor
    restitution: torch.Tensor
    upper_n: torch.Tensor
    soft: torch.Tensor
    spin_friction: Optional[torch.Tensor]
    roll_friction: Optional[torch.Tensor]
    sA_n: Optional[torch.Tensor]
    sB_n: Optional[torch.Tensor]
    sA_t1: Optional[torch.Tensor]
    sB_t1: Optional[torch.Tensor]
    sA_t2: Optional[torch.Tensor]
    sB_t2: Optional[torch.Tensor]
    em_spin: Optional[torch.Tensor]
    em_roll1: Optional[torch.Tensor]
    em_roll2: Optional[torch.Tensor]
    rhs_spin: Optional[torch.Tensor]
    rhs_roll1: Optional[torch.Tensor]
    rhs_roll2: Optional[torch.Tensor]
    roll_t1: Optional[torch.Tensor]
    roll_t2: Optional[torch.Tensor]
    rA: torch.Tensor
    rB: torch.Tensor
    row_slot: torch.Tensor   # [R] int: flattened manifold point slot
    base_dist: torch.Tensor  # [R] step-start separation
    dropped: int             # live contacts beyond max_rows (host int)
    count: int               # live rows (a prefix of this length)


def pack_solver_view(state):
    """[N,35] per-body inputs for row building: orn 0:4 | linvel 4:7 |
    angvel 7:10 | inv_m 10 | inv_I world 11:20 | friction 20 |
    restitution 21 | spin_f 22 | roll_f 23 | stiffness 24 | damping 25 |
    material_id 26 | has_material 27 | asleep 28 | com 29:32 |
    roll_axis 32:35."""
    N = state.capacity
    Iw = state.inertia_world_inv().reshape(N, 9)
    f = lambda x: x.to(state.dtype)[:, None]
    return torch.cat([
        state.orn, state.linvel, state.angvel, f(state.mass_inv), Iw,
        f(state.friction), f(state.restitution), f(state.spin_friction),
        f(state.roll_friction), f(state.stiffness), f(state.damping),
        f(state.material_id), f(state.has_material), f(state.asleep),
        state.com, state.roll_axis,
    ], dim=1)


def pack_manifold_points(man):
    """[M,4,14]: pivot_a 0:3 | pivot_b 3:6 | local_normal 6:9 |
    attachment 9 | distance 10 | point_valid 11 | friction_scale 12 |
    restitution_scale 13."""
    f = lambda x: x.to(man.pivot_a.dtype)[..., None]
    return torch.cat([
        man.pivot_a, man.pivot_b, man.local_normal,
        f(man.normal_attachment), f(man.distance), f(man.point_valid),
        f(man.friction_scale), f(man.restitution_scale),
    ], dim=-1)


def _mv(M, v):
    return torch.einsum("...ij,...j->...i", M, v)


def _em(term):
    return torch.where(term > 1e-12, 1.0 / torch.clamp(term, min=1e-12),
                       torch.zeros_like(term))


def _make_dir(d, rA, rB, inv_mA, inv_IA, inv_mB, inv_IB, degA, degB):
    JaA = vec.cross(rA, d)
    JaB = -vec.cross(rB, d)
    tA = _mv(inv_IA, JaA)
    tB = _mv(inv_IB, JaB)
    term = (vec.dot(d, d) * inv_mA * degA + vec.dot(tA, JaA) * degA
            + vec.dot(d, d) * inv_mB * degB + vec.dot(tB, JaB) * degB)
    return JaA, JaB, tA, tB, _em(term)


def build_contact_rows(state, man, dt: float, use_restitution_solver: bool,
                       mass_splitting: bool = True,
                       with_spin_roll: bool = True,
                       max_rows: int | None = None) -> ContactRows:
    """Rows compacted to the live contact points (at most ``max_rows``);
    ``row_slot`` maps each row back to its manifold point."""
    M, P = man.point_valid.shape
    Rfull = M * P
    dev = man.point_valid.device

    inactive = state.asleep | ((state.kind == KIND_STATIC) & state.valid)
    code = state.has_material.to(torch.int32) + inactive.to(torch.int32) * 2
    ca = code[man.body_a.long()]
    cb = code[man.body_b.long()]
    elig = man.valid & ((ca & 1) > 0) & ((cb & 1) > 0) \
        & ~(((ca & 2) > 0) & ((cb & 2) > 0))
    valid0 = (man.point_valid & elig[:, None]).reshape(Rfull)

    R = max_rows or Rfull
    if R < Rfull:
        src = torch.nonzero(valid0).flatten()
        cnt = src.shape[0]
        row_slot = torch.full((R,), Rfull - 1, dtype=torch.int64, device=dev)
        live = min(cnt, R)
        row_slot[:live] = src[:live]
        valid = torch.zeros((R,), dtype=torch.bool, device=dev)
        valid[:live] = True
        rows_dropped = max(cnt - R, 0)
        live_count = live
    else:
        row_slot = torch.arange(Rfull, device=dev)
        valid = valid0
        rows_dropped = 0
        live_count = Rfull

    pair_idx = torch.div(row_slot, P, rounding_mode="floor")
    a = man.body_a[pair_idx].long()
    b = man.body_b[pair_idx].long()
    ab = torch.cat([a, b])

    pt = pack_manifold_points(man).reshape(Rfull, 14)[row_slot]
    pa_l = pt[:, 0:3]
    pb_l = pt[:, 3:6]
    ln = pt[:, 6:9]
    attach = pt[:, 9].to(torch.int32)
    dist = pt[:, 10]
    fr_scale = pt[:, 12]
    re_scale = pt[:, 13]

    g = pack_solver_view(state)[ab]
    ga, gb = g[:R], g[R:]
    orn_a, orn_b = ga[:, 0:4], gb[:, 0:4]
    va, wa = ga[:, 4:7], ga[:, 7:10]
    vb, wb = gb[:, 4:7], gb[:, 7:10]
    zero = torch.zeros_like(ga[:, 10])
    inv_mA = torch.where(valid, ga[:, 10], zero)
    inv_mB = torch.where(valid, gb[:, 10], zero)
    inv_IA = ga[:, 11:20].reshape(R, 3, 3) * valid[:, None, None]
    inv_IB = gb[:, 11:20].reshape(R, 3, 3) * valid[:, None, None]

    n = torch.where((attach == 1)[:, None], quat.rotate(orn_a, ln),
                    torch.where((attach == 2)[:, None],
                                quat.rotate(orn_b, ln), ln))
    rA = quat.rotate(orn_a, pa_l - ga[:, 29:32])
    rB = quat.rotate(orn_b, pb_l - gb[:, 29:32])

    if mass_splitting:
        v2 = valid.to(state.dtype)
        # counts of 0 and 1 are exact in any order of summation
        deg = torch.ones((state.capacity,), dtype=state.dtype,
                         device=dev).index_add(
            0, ab, torch.cat([v2, v2]))
        dg = torch.clamp(deg[ab] - 1.0, min=1.0)
        degA, degB = dg[:R], dg[R:]
    else:
        degA = degB = torch.ones_like(inv_mA)

    t1, t2 = vec.orthonormal_basis(n)

    def dir_rows(d, rhs_fn):
        JaA, JaB, tA, tB, em = _make_dir(d, rA, rB, inv_mA, inv_IA, inv_mB,
                                         inv_IB, degA, degB)
        relvel = (vec.dot(d, va) + vec.dot(JaA, wa)
                  - vec.dot(d, vb) + vec.dot(JaB, wb))
        return RowDir(JaA=JaA, JaB=JaB, tA=tA, tB=tB, eff_mass=em,
                      rhs=rhs_fn(relvel))

    restit_mix = torch.minimum(ga[:, 21], gb[:, 21])
    friction = torch.sqrt(torch.clamp(ga[:, 20] * gb[:, 20], min=0.0))
    spin_fr = torch.maximum(ga[:, 22], gb[:, 22])
    roll_fr = torch.maximum(ga[:, 23], gb[:, 23])
    stiff = 1.0 / (1.0 / torch.clamp(ga[:, 24], min=1.0)
                   + 1.0 / torch.clamp(gb[:, 24], min=1.0))
    dampc = 1.0 / (1.0 / torch.clamp(ga[:, 25], min=1.0)
                   + 1.0 / torch.clamp(gb[:, 25], min=1.0))

    mix = state.mix_table
    if mix.ids.shape[0] > 0:
        ida = ga[:, 26].to(torch.int32)
        idb = gb[:, 26].to(torch.int32)
        lo = torch.minimum(ida, idb)[:, None]
        hi = torch.maximum(ida, idb)[:, None]
        tlo = torch.minimum(mix.ids[:, 0], mix.ids[:, 1])[None, :]
        thi = torch.maximum(mix.ids[:, 0], mix.ids[:, 1])[None, :]
        match = (lo == tlo) & (hi == thi) & (lo >= 0)
        has = torch.any(match, dim=1)
        v = mix.vals[torch.argmax(match.to(torch.int32), dim=1)]
        restit_mix = torch.where(has, v[:, 0], restit_mix)
        friction = torch.where(has, v[:, 1], friction)
        spin_fr = torch.where(has, v[:, 2], spin_fr)
        roll_fr = torch.where(has, v[:, 3], roll_fr)
        stiff = torch.where(has & (v[:, 4] > 0), v[:, 4], stiff)
        dampc = torch.where(has & (v[:, 5] > 0), v[:, 5], dampc)

    friction = friction * fr_scale
    restit_mix = torch.clamp(restit_mix * re_scale, 0.0, 1.0)
    restitution = (torch.zeros_like(restit_mix) if use_restitution_solver
                   else restit_mix)
    error = torch.where(dist > 0, dist / dt, torch.zeros_like(dist))

    rn = dir_rows(n, lambda rv: -(error * 0.2 + rv * (1.0 + restitution)))
    r1 = dir_rows(t1, lambda rv: -rv)
    r2 = dir_rows(t2, lambda rv: -rv)

    sr = dict.fromkeys(("sA_n", "sB_n", "sA_t1", "sB_t1", "sA_t2", "sB_t2",
                        "em_spin", "em_roll1", "em_roll2", "rhs_spin",
                        "rhs_roll1", "rhs_roll2", "roll_t1", "roll_t2"))
    if with_spin_roll:
        def ang_row(d):
            sA = _mv(inv_IA, d)
            sB = _mv(inv_IB, -d)
            term = vec.dot(sA, d) * degA + vec.dot(sB, -d) * degB
            return sA, sB, _em(term)

        rdA = ga[:, 32:35]
        rdB = gb[:, 32:35]
        wrA = quat.rotate(orn_a, rdA)
        wrB = quat.rotate(orn_b, rdB)
        hasA = vec.length_sqr(rdA) > 1e-12
        hasB = vec.length_sqr(rdB) > 1e-12
        one = torch.ones_like(inv_mA)

        def roll_aligned(t):
            sc = torch.where(hasA, vec.dot(wrA, t), one) \
                * torch.where(hasB, vec.dot(wrB, t), one)
            return t * sc[..., None]

        roll_t1 = roll_aligned(t1)
        roll_t2 = roll_aligned(t2)
        sA_n, sB_n, em_spin = ang_row(n)
        sA_t1, sB_t1, em_roll1 = ang_row(roll_t1)
        sA_t2, sB_t2, em_roll2 = ang_row(roll_t2)
        rel_w = wa - wb
        sr = dict(sA_n=sA_n, sB_n=sB_n, sA_t1=sA_t1, sB_t1=sB_t1,
                  sA_t2=sA_t2, sB_t2=sB_t2, em_spin=em_spin,
                  em_roll1=em_roll1, em_roll2=em_roll2,
                  rhs_spin=-vec.dot(n, rel_w),
                  rhs_roll1=-vec.dot(roll_t1, rel_w),
                  rhs_roll2=-vec.dot(roll_t2, rel_w),
                  roll_t1=roll_t1, roll_t2=roll_t2)
    else:
        spin_fr = roll_fr = None

    soft = stiff < LARGE_SCALAR
    pen = torch.clamp(-dist, min=0.0)
    relvel_n = (vec.dot(n, va) + vec.dot(rn.JaA, wa)
                - vec.dot(n, vb) + vec.dot(rn.JaB, wb))
    spring_cap = torch.clamp((stiff * pen + dampc
                              * torch.clamp(-relvel_n, min=0.0)) * dt,
                             min=0.0)
    upper_n = torch.where(soft, spring_cap, torch.full_like(spring_cap, BIG))

    return ContactRows(valid=valid, a=a, b=b, ab=ab,
                       inv_mA=inv_mA, inv_mB=inv_mB,
                       n=n, t1=t1, t2=t2, rn=rn, r1=r1, r2=r2,
                       friction=friction, restitution=restit_mix,
                       upper_n=upper_n, soft=soft,
                       spin_friction=spin_fr, roll_friction=roll_fr,
                       rA=rA, rB=rB, row_slot=row_slot, base_dist=dist,
                       dropped=rows_dropped, count=live_count, **sr)


def rows_range(rows: ContactRows, r0: int, r1: int,
               device=None) -> ContactRows:
    """Rows r0:r1 of a row table, on ``device`` (default: theirs)."""
    device = device or rows.valid.device

    def cut(x):
        if isinstance(x, RowDir):
            return RowDir(*(getattr(x, f.name)[r0:r1].to(device)
                            for f in dataclasses.fields(RowDir)))
        if isinstance(x, torch.Tensor):
            return x[r0:r1].to(device)
        return x

    kw = {f.name: cut(getattr(rows, f.name))
          for f in dataclasses.fields(ContactRows)}
    kw["ab"] = torch.cat([kw["a"], kw["b"]])
    return ContactRows(**kw)


def refresh_contact_rhs(rows: ContactRows, state, dt: float,
                        use_restitution_solver: bool) -> ContactRows:
    """Recompute rhs terms against the current velocities (after the
    restitution pre-pass and gravity; reference solver.cpp:387-405)."""
    velp = torch.cat([state.linvel, state.angvel], dim=1)
    R = rows.valid.shape[0]
    g = velp[rows.ab]
    va, wa, vb, wb = g[:R, 0:3], g[:R, 3:6], g[R:, 0:3], g[R:, 3:6]
    dist = rows.base_dist
    error = torch.where(dist > 0, dist / dt, torch.zeros_like(dist))
    restitution = 0.0 if use_restitution_solver else rows.restitution

    def rv(d, rd):
        return (vec.dot(d, va) + vec.dot(rd.JaA, wa)
                - vec.dot(d, vb) + vec.dot(rd.JaB, wb))

    rn = dataclasses.replace(rows.rn, rhs=-(error * 0.2 + rv(rows.n, rows.rn)
                                            * (1.0 + restitution)))
    r1 = dataclasses.replace(rows.r1, rhs=-rv(rows.t1, rows.r1))
    r2 = dataclasses.replace(rows.r2, rhs=-rv(rows.t2, rows.r2))
    if rows.sA_n is None:
        return dataclasses.replace(rows, rn=rn, r1=r1, r2=r2)
    rel_w = wa - wb
    return dataclasses.replace(rows, rn=rn, r1=r1, r2=r2,
                               rhs_spin=-vec.dot(rows.n, rel_w),
                               rhs_roll1=-vec.dot(rows.roll_t1, rel_w),
                               rhs_roll2=-vec.dot(rows.roll_t2, rel_w))


def warm_start_terms(rows: ContactRows, imp6):
    """The stored impulses [R,6] (normal 0 | friction 1:3 | spin 3 |
    roll 4:6) as packed [lin, ang] deltas of the rows' bodies: (ua, ub),
    each [R,6]."""
    m = lambda x: torch.where(rows.valid, x, torch.zeros_like(x))[:, None]
    dn_ = m(imp6[:, 0])
    df1_ = m(imp6[:, 1])
    df2_ = m(imp6[:, 2])
    lin = rows.n * dn_ + rows.t1 * df1_ + rows.t2 * df2_
    lin_a = rows.inv_mA[:, None] * lin
    lin_b = rows.inv_mB[:, None] * -lin
    ang_a = rows.rn.tA * dn_ + rows.r1.tA * df1_ + rows.r2.tA * df2_
    ang_b = rows.rn.tB * dn_ + rows.r1.tB * df1_ + rows.r2.tB * df2_
    if rows.sA_n is not None:
        ds_ = m(imp6[:, 3])
        dr1_ = m(imp6[:, 4])
        dr2_ = m(imp6[:, 5])
        ang_a = ang_a + rows.sA_n * ds_ + rows.sA_t1 * dr1_ \
            + rows.sA_t2 * dr2_
        ang_b = ang_b + rows.sB_n * ds_ + rows.sB_t1 * dr1_ \
            + rows.sB_t2 * dr2_
    return torch.cat([lin_a, ang_a], 1), torch.cat([lin_b, ang_b], 1)


def warm_start_sharded(parts, imp6s, dvw, mesh: Mesh):
    """``warm_start_contacts`` over the shards' rows (``parts``, with their
    stored impulses ``imp6s``, each on its shard's device), the terms met
    in one ordered chain. Returns the deltas on the last shard's device."""
    terms = []
    for s, (rows, imp6) in enumerate(zip(parts, imp6s)):
        with mesh.scope(s):
            terms.append(warm_start_terms(rows, imp6))
    return chain_index_sum(
        dvw, [(rows.a, t[0]) for rows, t in zip(parts, terms)]
        + [(rows.b, t[1]) for rows, t in zip(parts, terms)],
        merge=not mesh.hop_each_shard)


def index_sum(x, index, src):
    """``x.index_add(0, index, src)``, each target's terms added in row
    order on every device. CUDA's ``index_add`` adds with atomics, in
    whatever order the threads arrive, so the same scene stepped one way in
    one run and another way in the next. ``index_put`` with ``accumulate``
    sorts the targets stably and adds each target's terms one after the
    other, in row order (the CPU's order). Its kernel walks a target's
    terms in one thread, so the rows of zeros (invalid rows, and rows into
    static bodies, whose inverse mass is 0: most of a table) each go to a
    scratch row of their own; adding zero changes no sum."""
    if not x.is_cuda:
        return x.index_add(0, index, src)
    N, E = x.shape[0], index.shape[0]
    live = (src != 0).reshape(E, -1).any(1)
    target = torch.where(live, index.long(),
                         torch.arange(N, N + E, device=x.device))
    out = torch.cat([x, x.new_zeros((E,) + tuple(x.shape[1:]))])
    return out.index_put_((target,), src, accumulate=True)[:N]


def gather_ab(dvw, ab):
    """One gather of both endpoints' packed [lin, ang] deltas for every row
    of an [N,6] table. Returns (lin_a, ang_a, lin_b, ang_b), each [R,3]."""
    g = dvw[ab]
    R = ab.shape[0] // 2
    return g[:R, 0:3], g[:R, 3:6], g[R:, 0:3], g[R:, 3:6]


def scatter_add_ab(dvw, ab, lin_a, ang_a, lin_b, ang_b):
    """One scatter-add applying every row's packed impulse to both bodies
    of an [N,6] table."""
    ua = torch.cat([lin_a, ang_a], dim=1)
    ub = torch.cat([lin_b, ang_b], dim=1)
    return index_sum(dvw, ab, torch.cat([ua, ub]))


def degree_counts(N: int, idx_list, valid_list, dtype=torch.float32):
    """Constraint degree per body (for mass splitting), >= 1 (counts of 0
    and 1, exact in any order of summation)."""
    deg = torch.zeros((N,), dtype=dtype, device=idx_list[0].device)
    for idx, valid in zip(idx_list, valid_list):
        deg = deg.index_add(0, idx.long(), valid.to(dtype))
    return torch.clamp(deg, min=1.0)


def scatter_upd_t(x_t, ab_p, upd):
    """Scatter-add a kernel's [12,Rp] endpoint update into transposed
    [6,N] body deltas (a-half to rows a, b-half to rows b)."""
    src = torch.cat([upd[:6], upd[6:]], dim=1)
    if x_t.is_cuda:
        return index_sum(x_t.t().contiguous(), ab_p, src.t()).t().contiguous()
    return x_t.index_add(1, ab_p, src)


def chain_index_sum(x, parts, dim: int = 0, merge: bool = True):
    """``x`` plus every part's terms, ``parts`` = [(index, src), ...] in
    order, scattered along ``dim`` of x ([N,6], or [6,N] with ``dim=1``);
    equal, bit for bit, to one ``index_sum`` (or ``scatter_upd_t``) over
    the concatenated parts. The sum hops from device to device in part
    order; with ``merge``, consecutive parts on one device are added in one
    call (shards sharing a card), else each part is a hop. Returns the sum
    on the last part's device.

    The two devices add in different orders, and the chain follows each.
    The CPU's ``index_add`` adds a target's terms to x one after the other,
    so x itself travels. The card's ``index_sum`` (``index_put`` with
    ``accumulate``) adds a target's terms one after the other from zero and
    then adds that sum to x; so the running sum travels, each hop adding
    it first, then its own terms, and x is added at the end."""
    hops = []
    for index, src in parts:
        if merge and hops and hops[-1][0] == src.device:
            hops[-1][1].append(index)
            hops[-1][2].append(src)
        else:
            hops.append((src.device, [index], [src]))
    hops = [(dev, torch.cat(i), torch.cat(s, dim)) for dev, i, s in hops]
    if not x.is_cuda:
        for dev, index, src in hops:
            x = x.to(dev).index_add(dim, index, src)
        return x
    if len(hops) == 1:
        _, index, src = hops[0]
        if dim == 0:
            return index_sum(x.to(src.device), index, src)
        return index_sum(x.to(src.device).t().contiguous(), index,
                         src.t()).t().contiguous()
    acc = None
    for dev, index, src in hops:
        src = src.t() if dim == 1 else src
        if acc is not None:
            acc = acc.to(dev)
            index = torch.cat([torch.arange(acc.shape[0], device=dev),
                               index])
            src = torch.cat([acc, src])
        acc = index_sum(src.new_zeros((x.shape[dim],)
                                      + tuple(src.shape[1:])),
                        index, src)
    return x.to(acc.device) + (acc.t() if dim == 1 else acc)


def chain_upd_t(x_t, packs, upds, mesh: Mesh):
    """``scatter_upd_t`` over the shards' row tables: the a-halves of every
    shard in shard order, then the b-halves, so each body takes its terms
    in the order of one scatter over the concatenated rows. ``packs`` are
    the shards' ``ShardPack``s, ``upds`` their [12,Rp] updates. Returns
    the sum on the home device."""
    if len(packs) == 1 and not mesh.hop_each_shard:
        return scatter_upd_t(x_t, packs[0].ab_p, upds[0])
    parts = ([(p.a_p, u[:6]) for p, u in zip(packs, upds)]
             + [(p.b_p, u[6:]) for p, u in zip(packs, upds)])
    return chain_index_sum(x_t, parts, dim=1,
                           merge=not mesh.hop_each_shard).to(mesh.home)


@dataclasses.dataclass
class ShardPack:
    """One shard's packed row table (``pack_rows_t``) on its device."""
    tbl: torch.Tensor
    a_p: torch.Tensor
    b_p: torch.Tensor
    ab_p: torch.Tensor
    Rp: int

    @classmethod
    def of_rows(cls, rows):
        tbl, a_p, b_p, Rp = sk.pack_rows_t(rows)
        return cls(tbl, a_p, b_p, torch.cat([a_p, b_p]), Rp)

    @property
    def device(self):
        return self.tbl.device


def solve_contacts_sharded(packs, imp_ts, dvw_t, with_sr: bool, mesh: Mesh):
    """``solve_contacts_once`` over the shards' row tables: K1 per shard
    on its device, the updates met in ``chain_upd_t``. Returns (the
    shards' impulses, the deltas on the home device)."""
    upds, out = [], []
    for s, p in enumerate(packs):
        with mesh.scope(s):
            imp_t, upd = sk.solve_iteration(
                p.tbl, imp_ts[s], dvw_t.to(p.device)[:, p.ab_p], with_sr)
            out.append(imp_t)
            upds.append(upd)
    return out, chain_upd_t(dvw_t, packs, upds, mesh)


def solve_velocities(packs, imp_ts, dvw, with_sr: bool, mesh: Mesh,
                     iterations: int, after=None):
    """The velocity iterations from the [N,6] deltas ``dvw``
    (``solve_contacts_sharded`` over transposed [6,N] deltas). ``after``
    (the joint solve) maps the [N,6] deltas after each iteration. Returns
    (the shards' impulses, the [N,6] deltas)."""
    dvw_t = dvw.T.contiguous()
    for _ in range(iterations):
        imp_ts, dvw_t = solve_contacts_sharded(packs, imp_ts, dvw_t,
                                               with_sr, mesh)
        if after is not None:
            dvw_t = after(dvw_t.T).T.contiguous()
    return imp_ts, dvw_t.T


def solve_restitution_sharded(state, packs, mesh: Mesh, num_iterations: int,
                              num_individual_iterations: int):
    """The restitution shock-propagation pre-pass (reference:
    restitution_solver.cpp:86-408) over the shards' row tables: K3b and
    K3a run per shard on its device, the early exit takes every shard's
    rows, and each inner iteration's updates meet in ``chain_upd_t``.
    Outer passes play the role of BFS levels and stop early once no row
    approaches faster than the threshold. Returns (linvel, angvel)."""
    N = state.capacity
    home = mesh.home
    velp_t = torch.cat([state.linvel, state.angvel], dim=1).T.contiguous()
    for it in range(num_iterations):
        dyns, any_active = [], None
        for s, p in enumerate(packs):
            with mesh.scope(s):
                valid_p = p.tbl[55:56, :] > 0.5
                restit_p = p.tbl[56:57, :]
                relvel = sk.relvel(p.tbl, velp_t.to(p.device)[:, p.ab_p])
                active = valid_p & (relvel < sk.RELVEL_THRESHOLD) \
                    & (restit_p > 0)
                rhs = -relvel * (1.0 + restit_p)
                dyns.append(torch.cat([rhs, active.to(p.tbl.dtype)], dim=0))
                a = torch.any(active).to(home)
                any_active = a if any_active is None else any_active | a
        # device branches (solver.py:643 and :730 in the JAX package):
        # host-synced, once for all shards. The JAX loop exits one pass
        # later, after a pass that adds a zero update; stopping here gives
        # the same velocities.
        if not bool(any_active):
            break
        imp3 = [torch.zeros((3, p.Rp), dtype=p.tbl.dtype, device=p.device)
                for p in packs]
        dvw_t = torch.zeros((6, N), dtype=velp_t.dtype, device=home)
        for _ in range(num_individual_iterations):
            upds = []
            for s, p in enumerate(packs):
                with mesh.scope(s):
                    g = dvw_t.to(p.device)[:, p.ab_p]
                    imp3[s], upd = sk.restitution_iteration(p.tbl, dyns[s],
                                                            imp3[s], g)
                    upds.append(upd)
            dvw_t = chain_upd_t(dvw_t, packs, upds, mesh)
        velp_t = velp_t + dvw_t
    velp = velp_t.T
    return velp[:, 0:3], velp[:, 3:6]


