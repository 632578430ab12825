"""The solver's per-row kernels as plain PyTorch, and the packed row table
they read.

Counterpart of ``edyn_tpu/dynamics/pallas_solver.py``. The contact-row
constants are packed once per solve phase into ONE component-major
``[C, Rp]`` table at the rows' scalar dtype (``pack_rows_t``, the same
layout as the JAX package's). Every iteration runs as

    gather (index_select) -> kernel -> scatter-add (index_add_)

with the plain versions of K1 (``solve_iteration``), K3a
(``restitution_iteration``), K3b (``relvel``) and K2 (``ngs_iteration``)
as the kernels, on every device.
"""
from __future__ import annotations

import torch

BLK = 128
BIG = 1e18

# Row layout of the packed table (component-major, [C, Rp]).
# Base block:
#   n 0:3 | t1 3:6 | t2 6:9
#   rn.JaA 9:12 | rn.JaB 12:15 | rn.tA 15:18 | rn.tB 18:21
#   r1.JaA 21:24 | r1.JaB 24:27 | r1.tA 27:30 | r1.tB 30:33
#   r2.JaA 33:36 | r2.JaB 36:39 | r2.tA 39:42 | r2.tB 42:45
#   em_n 45 | em_1 46 | em_2 47 | rhs_n 48 | rhs_1 49 | rhs_2 50
#   inv_mA 51 | inv_mB 52 | friction 53 | upper_n 54 | valid 55
#   restitution 56 | rA 57:60 | rB 60:63 | base_dist 63 | ngs_valid 64
C_BASE = 65
# Spin/roll block (appended when the scene has spin/roll materials):
#   sA_n +0:3 | sB_n +3:6 | sA_t1 +6:9 | sB_t1 +9:12 | sA_t2 +12:15
#   sB_t2 +15:18 | roll_t1 +18:21 | roll_t2 +21:24
#   em_spin +24 | em_roll1 +25 | em_roll2 +26
#   rhs_spin +27 | rhs_roll1 +28 | rhs_roll2 +29 | spin_f +30 | roll_f +31
C_SR = 32

_B = dict(n=0, t1=3, t2=6, JaA_n=9, JaB_n=12, tA_n=15, tB_n=18,
          JaA_1=21, JaB_1=24, tA_1=27, tB_1=30,
          JaA_2=33, JaB_2=36, tA_2=39, tB_2=42,
          em_n=45, em_1=46, em_2=47, rhs_n=48, rhs_1=49, rhs_2=50,
          inv_mA=51, inv_mB=52, friction=53, upper_n=54, valid=55,
          restitution=56, rA=57, rB=60, base_dist=63, ngs_valid=64)
_S = dict(sA_n=0, sB_n=3, sA_t1=6, sB_t1=9, sA_t2=12, sB_t2=15,
          roll_t1=18, roll_t2=21, em_spin=24, em_roll1=25, em_roll2=26,
          rhs_spin=27, rhs_roll1=28, rhs_roll2=29, spin_f=30, roll_f=31)
_VEC3 = {"n", "t1", "t2", "rA", "rB"} | {
    f"{p}_{d}" for p in ("JaA", "JaB", "tA", "tB") for d in "n12"} | {
    "sA_n", "sB_n", "sA_t1", "sB_t1", "sA_t2", "sB_t2", "roll_t1", "roll_t2"}

# ---------------------------------------------------------------------------
# table packing
# ---------------------------------------------------------------------------

def pack_rows_t(rows):
    """Pack the per-row solve constants into ONE [C, Rp] table at the rows'
    scalar dtype (Rp padded to a BLK multiple) and the padded endpoint
    indices. Returns (tbl, a_p, b_p, Rp)."""
    R = rows.valid.shape[0]
    Rp = -(-R // BLK) * BLK
    pad = Rp - R
    dt = rows.n.dtype

    def p1(x):
        x = x.to(dt)
        return torch.nn.functional.pad(x, (0, pad))[None, :]

    def p3(x):
        x = x.to(dt)
        return torch.nn.functional.pad(x, (0, 0, 0, pad)).T

    parts = [
        p3(rows.n), p3(rows.t1), p3(rows.t2),
        p3(rows.rn.JaA), p3(rows.rn.JaB), p3(rows.rn.tA), p3(rows.rn.tB),
        p3(rows.r1.JaA), p3(rows.r1.JaB), p3(rows.r1.tA), p3(rows.r1.tB),
        p3(rows.r2.JaA), p3(rows.r2.JaB), p3(rows.r2.tA), p3(rows.r2.tB),
        p1(rows.rn.eff_mass), p1(rows.r1.eff_mass), p1(rows.r2.eff_mass),
        p1(rows.rn.rhs), p1(rows.r1.rhs), p1(rows.r2.rhs),
        p1(rows.inv_mA), p1(rows.inv_mB), p1(rows.friction),
        p1(torch.clamp(rows.upper_n, max=BIG)), p1(rows.valid),
        p1(rows.restitution), p3(rows.rA), p3(rows.rB), p1(rows.base_dist),
        p1(rows.valid & ~rows.soft),
    ]
    if rows.sA_n is not None:
        parts += [
            p3(rows.sA_n), p3(rows.sB_n), p3(rows.sA_t1), p3(rows.sB_t1),
            p3(rows.sA_t2), p3(rows.sB_t2), p3(rows.roll_t1),
            p3(rows.roll_t2),
            p1(rows.em_spin), p1(rows.em_roll1), p1(rows.em_roll2),
            p1(rows.rhs_spin), p1(rows.rhs_roll1), p1(rows.rhs_roll2),
            p1(rows.spin_friction), p1(rows.roll_friction),
        ]
    tbl = torch.cat(parts, dim=0).contiguous()
    a_p = torch.nn.functional.pad(rows.a, (0, pad))
    b_p = torch.nn.functional.pad(rows.b, (0, pad))
    return tbl, a_p, b_p, Rp


def _unpack(tbl, with_sr: bool):
    """Named row views of the table: [Rp] tensors, 3-tuples for vectors."""
    d = {}
    for name, r in _B.items():
        d[name] = (tuple(tbl[r + c] for c in range(3)) if name in _VEC3
                   else tbl[r])
    if with_sr:
        for name, r in _S.items():
            r += C_BASE
            d[name] = (tuple(tbl[r + c] for c in range(3)) if name in _VEC3
                       else tbl[r])
    return d


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _drel(d, JaA, JaB, va, wa, vb, wb):
    return _dot3(d, va) + _dot3(JaA, wa) - _dot3(d, vb) + _dot3(JaB, wb)


def _split_g(g):
    Rp = g.shape[1] // 2
    return (tuple(g[c, :Rp] for c in range(3)),
            tuple(g[c + 3, :Rp] for c in range(3)),
            tuple(g[c, Rp:] for c in range(3)),
            tuple(g[c + 3, Rp:] for c in range(3)))


def _where(c, x):
    return torch.where(c, x, torch.zeros_like(x))


def _circle(i1, i2, max_len):
    ln = torch.sqrt(i1 * i1 + i2 * i2)
    sc = torch.where(ln > torch.clamp(max_len, min=1e-12),
                     max_len / torch.clamp(ln, min=1e-12),
                     torch.ones_like(ln))
    return i1 * sc, i2 * sc


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def solve_iteration_plain(tbl, imp_t, g, with_sr: bool):
    """K1's plain version. tbl [C,Rp]; imp_t [6,Rp]; g [6,2Rp] gathered
    endpoint deltas (a-half, then b-half). Returns (imp_t' [6,Rp],
    upd [12,Rp]: ua lin 0:3 | ua ang 3:6 | ub lin 6:9 | ub ang 9:12)."""
    C = _unpack(tbl, with_sr)
    dva, dwa, dvb, dwb = _split_g(g)
    n_imp, f1, f2, s_imp, ri1, ri2 = (imp_t[i] for i in range(6))

    dlam = (C["rhs_n"] - _drel(C["n"], C["JaA_n"], C["JaB_n"],
                               dva, dwa, dvb, dwb)) * C["em_n"]
    new_n = torch.minimum(torch.clamp(n_imp + dlam, min=0.0), C["upper_n"])
    dn = new_n - n_imp
    d1 = (C["rhs_1"] - _drel(C["t1"], C["JaA_1"], C["JaB_1"],
                             dva, dwa, dvb, dwb)) * C["em_1"]
    d2 = (C["rhs_2"] - _drel(C["t2"], C["JaA_2"], C["JaB_2"],
                             dva, dwa, dvb, dwb)) * C["em_2"]
    imp1, imp2 = _circle(f1 + d1, f2 + d2, C["friction"] * new_n)
    ok = C["valid"] > 0.5
    dn_ = _where(ok, dn)
    df1_ = _where(ok, imp1 - f1)
    df2_ = _where(ok, imp2 - f2)
    lin = [C["n"][c] * dn_ + C["t1"][c] * df1_ + C["t2"][c] * df2_
           for c in range(3)]
    ua_l = [C["inv_mA"] * lin[c] for c in range(3)]
    ub_l = [-C["inv_mB"] * lin[c] for c in range(3)]
    ua_a = [C["tA_n"][c] * dn_ + C["tA_1"][c] * df1_ + C["tA_2"][c] * df2_
            for c in range(3)]
    ub_a = [C["tB_n"][c] * dn_ + C["tB_1"][c] * df1_ + C["tB_2"][c] * df2_
            for c in range(3)]
    if with_sr:
        rel_s = _dot3(C["n"], dwa) - _dot3(C["n"], dwb)
        max_s = C["spin_f"] * new_n
        new_s = torch.minimum(torch.maximum(
            s_imp + (C["rhs_spin"] - rel_s) * C["em_spin"], -max_s), max_s)
        ds = new_s - s_imp
        dr1 = (C["rhs_roll1"] - (_dot3(C["roll_t1"], dwa)
                                 - _dot3(C["roll_t1"], dwb))) * C["em_roll1"]
        dr2 = (C["rhs_roll2"] - (_dot3(C["roll_t2"], dwa)
                                 - _dot3(C["roll_t2"], dwb))) * C["em_roll2"]
        r1n, r2n = _circle(ri1 + dr1, ri2 + dr2, C["roll_f"] * new_n)
        ds_ = _where(ok, ds)
        dr1_ = _where(ok, r1n - ri1)
        dr2_ = _where(ok, r2n - ri2)
        for c in range(3):
            ua_a[c] = ua_a[c] + C["sA_n"][c] * ds_ \
                + C["sA_t1"][c] * dr1_ + C["sA_t2"][c] * dr2_
            ub_a[c] = ub_a[c] + C["sB_n"][c] * ds_ \
                + C["sB_t1"][c] * dr1_ + C["sB_t2"][c] * dr2_
        s_out, r1_out, r2_out = new_s, r1n, r2n
    else:
        s_out, r1_out, r2_out = s_imp, ri1, ri2
    oimp = torch.stack([new_n, imp1, imp2, s_out, r1_out, r2_out])
    oupd = torch.stack(ua_l + ua_a + ub_l + ub_a)
    return oimp, oupd


def restitution_iteration_plain(tbl, dyn, imp3_t, g):
    """K3a's plain version. dyn [2,Rp]: rhs_n | active; imp3_t [3,Rp].
    Returns (imp3_t' [3,Rp], upd [12,Rp])."""
    C = _unpack(tbl, False)
    dva, dwa, dvb, dwb = _split_g(g)
    rhs_n = dyn[0]
    active = dyn[1] > 0.5
    n_i, f1, f2 = imp3_t[0], imp3_t[1], imp3_t[2]
    dlam = (rhs_n - _drel(C["n"], C["JaA_n"], C["JaB_n"],
                          dva, dwa, dvb, dwb)) * C["em_n"]
    new_n = torch.clamp(n_i + dlam, min=0.0)
    dn = new_n - n_i
    d1 = -_drel(C["t1"], C["JaA_1"], C["JaB_1"], dva, dwa, dvb, dwb) \
        * C["em_1"]
    d2 = -_drel(C["t2"], C["JaA_2"], C["JaB_2"], dva, dwa, dvb, dwb) \
        * C["em_2"]
    imp1, imp2 = _circle(f1 + d1, f2 + d2, C["friction"] * new_n)
    dn_ = _where(active, dn)
    df1_ = _where(active, imp1 - f1)
    df2_ = _where(active, imp2 - f2)
    lin = [C["n"][c] * dn_ + C["t1"][c] * df1_ + C["t2"][c] * df2_
           for c in range(3)]
    ua_l = [C["inv_mA"] * lin[c] for c in range(3)]
    ub_l = [-C["inv_mB"] * lin[c] for c in range(3)]
    ua_a = [C["tA_n"][c] * dn_ + C["tA_1"][c] * df1_ + C["tA_2"][c] * df2_
            for c in range(3)]
    ub_a = [C["tB_n"][c] * dn_ + C["tB_1"][c] * df1_ + C["tB_2"][c] * df2_
            for c in range(3)]
    return (torch.stack([new_n, imp1, imp2]),
            torch.stack(ua_l + ua_a + ub_l + ub_a))


def relvel_plain(tbl, g):
    """K3b's plain version: normal relative velocity per row, [1,Rp]."""
    C = _unpack(tbl, False)
    va, wa, vb, wb = _split_g(g)
    return _drel(C["n"], C["JaA_n"], C["JaB_n"], va, wa, vb, wb)[None, :]


# a row approaching faster than this (m/s) is active in the restitution
# pre-pass (edyn_tpu/dynamics/solver.py:609)
RELVEL_THRESHOLD = -0.005


def ngs_iteration_plain(tbl, g, rate: float, max_corr: float):
    """K2's plain version. g [6,2Rp] gathered position/rotation deltas.
    Returns (upd [12,Rp], err [1,Rp])."""
    C = _unpack(tbl, False)
    dpa, daa, dpb, dab = _split_g(g)

    def cross(a, b):
        return (a[1] * b[2] - a[2] * b[1],
                a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0])

    ca = cross(daa, C["rA"])
    cb = cross(dab, C["rB"])
    corr_rel = tuple(dpa[c] + ca[c] - dpb[c] - cb[c] for c in range(3))
    dist = C["base_dist"] + _dot3(corr_rel, C["n"])
    error = torch.clamp(torch.clamp(-dist, min=0.0), max=max_corr)
    error = _where(C["ngs_valid"] > 0.5, error)
    lam = error * rate * C["em_n"]
    ua_l = [C["inv_mA"] * C["n"][c] * lam for c in range(3)]
    ua_a = [C["tA_n"][c] * lam for c in range(3)]
    ub_l = [-C["inv_mB"] * C["n"][c] * lam for c in range(3)]
    ub_a = [C["tB_n"][c] * lam for c in range(3)]
    return torch.stack(ua_l + ua_a + ub_l + ub_a), error[None, :]


# the step's names for the kernels: their plain versions, on every device
solve_iteration = solve_iteration_plain
restitution_iteration = restitution_iteration_plain
relvel = relvel_plain
ngs_iteration = ngs_iteration_plain
