"""The solver's per-row kernels, their plain PyTorch versions, and the
packed row table they read.

Counterpart of ``edyn_tpu/dynamics/pallas_solver.py``. The contact-row
constants are packed once per solve phase into ONE component-major
``[C, Rp]`` table at the rows' scalar dtype (``pack_rows_t``, the same
layout as the JAX package's). On the TPU every iteration runs as

    gather (index_select) -> kernel -> scatter-add (index_add_)

with the gather and the scatter-add in XLA around the Pallas kernel. The
port's CPU path keeps that shape (the plain versions, ``index_add``). On
the card the velocity, restitution and position iterations run fused: the
kernel reads its rows' endpoint deltas by index and writes its update
terms where the step's scatter plan puts them (``dynamics/scatter.py``),
and ``segment_sum`` adds each body's terms in the order of
``solver.index_sum``.

Kernels (CUDA C++ in ``edyn_tpu_torch/csrc/solver_kernels.cu``, built with
nvcc for sm_90a at first use and loaded with ctypes by ``utils/cuda_lib``):
- ``solve_iteration_fused``: one velocity iteration with its gather and
  its half of the scatter (K1, replaces
  ``pallas_solver.solve_iteration_pallas``);
- ``restitution_iteration_fused``: one restitution inner iteration, the
  same way (K3a, replaces ``restitution_iteration_pallas``);
- ``segment_sum``: the per-body sums of those terms (replaces no TPU
  kernel: it is the scatter-add XLA did);
- ``ngs_iteration_fused``: one NGS position iteration, the same way (K2,
  replaces ``ngs_iteration_pallas``);
- ``relvel_fused``: one restitution outer pass's rows: the normal
  relative velocity from the [N,8] velocity table read by index, the rhs
  and activity the inner iterations take, and the pass's early-exit flag
  (K3b, replaces ``relvel_pallas``, with the gather and the glue around
  it);
- ``solve_iteration``, ``restitution_iteration``, ``ngs_iteration``,
  ``relvel``: K1, K3a, K2 and K3b unfused, against gathered deltas or
  velocities (the CPU's path, and on the card the reference the fused
  kernels are held to).

Each kernel is one CUDA source templated on the scalar type, with a float
and a double entry point (``edyn_*`` and ``edyn_*_f64``). Each wrapper takes
the plain version for tensors on the CPU; for CUDA tensors it launches the
entry of the tensors' dtype (float32 or float64), or raises. It never
falls back and never casts. ``LAUNCHES`` counts the float entries'
launches per wrapper, ``LAUNCHES_F64`` the double entries'.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import cuda_lib

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

# Table rows each kernel reads: the table bytes its memory bound counts.
ROWS_READ = {
    "solve_iteration": C_BASE - 9,  # rows 0..55, and the C_SR block with sr
    "ngs_iteration": 20,  # n, tA_n, tB_n, em_n, inv_m x2, rA, rB, dist, ngs
    "restitution_iteration": 51,  # n,t1,t2, 3 dirs x4, 3 em, inv_m x2, fr
    "relvel": 9,                  # n, JaA_n, JaB_n
    "relvel_fused": 11,           # n, JaA_n, JaB_n, valid, restitution
}


def rows_read(name: str, with_sr: bool = False) -> int:
    """Table rows kernel ``name`` reads per contact row."""
    sr = C_SR if with_sr and name == "solve_iteration" else 0
    return ROWS_READ[name] + sr


LAUNCHES = {"solve_iteration": 0, "ngs_iteration": 0,
            "restitution_iteration": 0, "relvel": 0,
            "solve_iteration_fused": 0, "restitution_iteration_fused": 0,
            "ngs_iteration_fused": 0, "segment_sum": 0, "relvel_fused": 0}
LAUNCHES_F64 = dict.fromkeys(LAUNCHES, 0)


def reset_launch_counts():
    for counts in (LAUNCHES, LAUNCHES_F64):
        for k in counts:
            counts[k] = 0


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


def relvel_fused_plain(tbl, vel, ab, flag, gen: int, out=None):
    """The fused K3b's plain version: ``relvel_plain`` on the endpoint
    velocities gathered from the [N,8] table ``vel`` by ``ab`` [2Rp], then
    the restitution pass's glue: ``out`` [2,Rp] (new when None) gets rhs_n
    = -r * (1 + restitution) and active = valid & (r < -0.005) &
    (restitution > 0) as 0/1; ``flag`` [1] int32 is set to ``gen`` where a
    row is active. Returns the [2,Rp] rows."""
    relv = relvel_plain(tbl, vel[ab.long(), :6].T)
    restit = tbl[56:57]
    active = (tbl[55:56] > 0.5) & (relv < RELVEL_THRESHOLD) & (restit > 0)
    dyn = torch.cat([-relv * (1.0 + restit), active.to(tbl.dtype)], dim=0)
    if bool(active.any()):
        flag.fill_(gen)
    return dyn if out is None else out.copy_(dyn)


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


def _place(terms, pos, upd):
    """Write the [6,Rp] update terms ``upd`` to the rows ``pos`` of an
    [E,8] terms buffer (columns 0:6), none where the position is -1."""
    keep = pos >= 0
    terms[pos[keep].long(), :6] = upd.T[keep]


def solve_iteration_fused_plain(tbl, imp_t, d, ab, pos, terms_a, terms_b,
                                with_sr: bool):
    """The fused K1's plain version: ``solve_iteration_plain`` on the
    endpoint deltas gathered from the body table ``d`` [N,8] (lin 0:3 | ang
    3:6 | two zero columns) by ``ab`` [2Rp] (a-half, then b-half), the
    a-terms placed in ``terms_a`` at ``pos[:Rp]``, the b-terms in
    ``terms_b`` at ``pos[Rp:]``. Returns the impulses [6,Rp]."""
    Rp = tbl.shape[1]
    oimp, upd = solve_iteration_plain(tbl, imp_t, d[ab.long(), :6].T,
                                      with_sr)
    _place(terms_a, pos[:Rp], upd[:6])
    _place(terms_b, pos[Rp:], upd[6:])
    return oimp


def restitution_iteration_fused_plain(tbl, dyn, imp3_t, d, ab, pos, terms_a,
                                      terms_b):
    """The fused K3a's plain version (see ``solve_iteration_fused_plain``).
    Returns the impulses [3,Rp]."""
    Rp = tbl.shape[1]
    oimp, upd = restitution_iteration_plain(tbl, dyn, imp3_t,
                                            d[ab.long(), :6].T)
    _place(terms_a, pos[:Rp], upd[:6])
    _place(terms_b, pos[Rp:], upd[6:])
    return oimp


def ngs_iteration_fused_plain(tbl, d, ab, pos, terms_a, terms_b,
                              rate: float, max_corr: float):
    """The fused K2's plain version (see ``solve_iteration_fused_plain``):
    ``ngs_iteration_plain`` on the position and rotation deltas gathered
    from ``d`` [N,8]. Returns the errors [1,Rp]."""
    Rp = tbl.shape[1]
    upd, err = ngs_iteration_plain(tbl, d[ab.long(), :6].T, rate, max_corr)
    _place(terms_a, pos[:Rp], upd[:6])
    _place(terms_b, pos[Rp:], upd[6:])
    return err


def segment_sum_plain(terms, offsets, x=None, start=None):
    """``segment_sum``'s plain version: a loop over the largest number of
    terms a body has, vectorised over the bodies, each step adding one
    term per body where it is live (a component not zero), in the kernel's
    order."""
    off = offsets.long()
    lo, deg = off[:-1], off[1:] - off[:-1]
    n = lo.shape[0]
    g = terms.new_zeros((n, 8))
    seen = torch.zeros((n,), dtype=torch.bool, device=terms.device)

    def add(g, seen, v, live):
        return torch.where(live[:, None], g + v, g), seen | live

    if start is not None:
        g, seen = add(g, seen, start, (start[:, :6] != 0).any(1))
    for k in range(int(deg.max()) if n else 0):
        has = deg > k
        v = terms[torch.where(has, lo + k, 0)]
        g, seen = add(g, seen, v, has & (v[:, :6] != 0).any(1))
    if x is None:
        return torch.where(seen[:, None], 0.0 + g, torch.zeros_like(g))
    return x.copy_(torch.where(seen[:, None], x + g, x))


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_F, _D = ctypes.c_float, ctypes.c_double
SIGNATURES = {
    "edyn_solve_iteration": [_P, _P, _P, _P, _P, _I, _I, _P],
    "edyn_restitution_iteration": [_P, _P, _P, _P, _P, _P, _I, _P],
    "edyn_relvel": [_P, _P, _P, _I, _P],
    "edyn_relvel_fused": [_P] * 5 + [_I, _I, _P],
    "edyn_ngs_iteration": [_P, _P, _P, _P, _I, _F, _F, _P],
    "edyn_solve_iteration_f64": [_P, _P, _P, _P, _P, _I, _I, _P],
    "edyn_restitution_iteration_f64": [_P, _P, _P, _P, _P, _P, _I, _P],
    "edyn_relvel_f64": [_P, _P, _P, _I, _P],
    "edyn_relvel_fused_f64": [_P] * 5 + [_I, _I, _P],
    "edyn_ngs_iteration_f64": [_P, _P, _P, _P, _I, _D, _D, _P],
}
for _sfx in ("", "_f64"):
    SIGNATURES.update({
        f"edyn_solve_iteration_fused{_sfx}": [_P] * 8 + [_I, _I, _P],
        f"edyn_restitution_iteration_fused{_sfx}": [_P] * 9 + [_I, _P],
        f"edyn_ngs_iteration_fused{_sfx}": [_P] * 7 + [
            _I, _D if _sfx else _F, _D if _sfx else _F, _P],
        f"edyn_segment_sum{_sfx}": [_P] * 5 + [_I, _P],
    })


def _entry(name: str, dtype):
    """(the entry point of kernel ``name`` for ``dtype``, its launch
    counts)."""
    lib = cuda_lib.load("solver_kernels", SIGNATURES)
    if dtype == torch.float32:
        return getattr(lib, f"edyn_{name}"), LAUNCHES
    if dtype == torch.float64:
        return getattr(lib, f"edyn_{name}_f64"), LAUNCHES_F64
    raise TypeError(f"{name}: float32 or float64 tensors expected, got "
                    f"{dtype}")


def _table_dims(tbl, with_sr):
    C, Rp = tbl.shape
    want = C_BASE + (C_SR if with_sr else 0)
    if C < want:
        raise ValueError(f"table has {C} rows, {want} needed")
    return C, Rp


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def solve_iteration(tbl, imp_t, g, with_sr: bool):
    """K1: one velocity iteration (see ``solve_iteration_plain``)."""
    if cuda_lib.on_cpu(tbl, imp_t, g):
        return solve_iteration_plain(tbl, imp_t, g, with_sr)
    C, Rp = _table_dims(tbl, with_sr)
    fn, counts = _entry("solve_iteration", tbl.dtype)
    dt = tbl.dtype
    cuda_lib.check(tbl, "tbl", (C, Rp), dt)
    cuda_lib.check(imp_t, "imp_t", (6, Rp), dt)
    cuda_lib.check(g, "g", (6, 2 * Rp), dt)
    oimp = torch.empty((6, Rp), dtype=dt, device=tbl.device)
    oupd = torch.empty((12, Rp), dtype=dt, device=tbl.device)
    rc = fn(tbl.data_ptr(), imp_t.data_ptr(), g.data_ptr(), oimp.data_ptr(),
            oupd.data_ptr(), Rp, int(bool(with_sr)), cuda_lib.stream(tbl))
    cuda_lib.launched(counts, "solve_iteration", rc, tbl.device)
    return oimp, oupd


def restitution_iteration(tbl, dyn, imp3_t, g):
    """K3a: one restitution inner iteration."""
    if cuda_lib.on_cpu(tbl, dyn, imp3_t, g):
        return restitution_iteration_plain(tbl, dyn, imp3_t, g)
    C, Rp = _table_dims(tbl, False)
    fn, counts = _entry("restitution_iteration", tbl.dtype)
    dt = tbl.dtype
    cuda_lib.check(tbl, "tbl", (C, Rp), dt)
    cuda_lib.check(dyn, "dyn", (2, Rp), dt)
    cuda_lib.check(imp3_t, "imp3_t", (3, Rp), dt)
    cuda_lib.check(g, "g", (6, 2 * Rp), dt)
    oimp = torch.empty((3, Rp), dtype=dt, device=tbl.device)
    oupd = torch.empty((12, Rp), dtype=dt, device=tbl.device)
    rc = fn(tbl.data_ptr(), dyn.data_ptr(), imp3_t.data_ptr(), g.data_ptr(),
            oimp.data_ptr(), oupd.data_ptr(), Rp, cuda_lib.stream(tbl))
    cuda_lib.launched(counts, "restitution_iteration", rc, tbl.device)
    return oimp, oupd


def relvel(tbl, g):
    """K3b: normal relative velocity per row, [1,Rp]."""
    if cuda_lib.on_cpu(tbl, g):
        return relvel_plain(tbl, g)
    C, Rp = _table_dims(tbl, False)
    fn, counts = _entry("relvel", tbl.dtype)
    cuda_lib.check(tbl, "tbl", (C, Rp), tbl.dtype)
    cuda_lib.check(g, "g", (6, 2 * Rp), tbl.dtype)
    out = torch.empty((1, Rp), dtype=tbl.dtype, device=tbl.device)
    rc = fn(tbl.data_ptr(), g.data_ptr(), out.data_ptr(), Rp,
            cuda_lib.stream(tbl))
    cuda_lib.launched(counts, "relvel", rc, tbl.device)
    return out


def relvel_fused(tbl, vel, ab, flag, gen: int, out=None):
    """The fused K3b: one restitution outer pass over the rows against the
    body velocities ``vel`` [N,8], read by the rows' endpoints ``ab`` [2Rp]
    int32 inside the kernel. Writes rhs_n | active into ``out`` [2,Rp]
    (new when None) and returns it; sets ``flag`` [1] int32 to ``gen``
    (an int32 above 0, new for each pass) where a row is active, else
    leaves it as it was (see ``relvel_fused_plain``)."""
    ts = [t for t in (tbl, vel, ab, flag, out) if t is not None]
    if cuda_lib.on_cpu(*ts):
        return relvel_fused_plain(tbl, vel, ab, flag, gen, out)
    C, Rp = _table_dims(tbl, False)
    dt = tbl.dtype
    fn, counts = _entry("relvel_fused", dt)
    cuda_lib.check(tbl, "tbl", (C, Rp), dt)
    cuda_lib.check(vel, "vel", (vel.shape[0], 8), dt)
    cuda_lib.check(ab, "ab", (2 * Rp,), torch.int32)
    cuda_lib.check(flag, "flag", (1,), torch.int32)
    if out is None:
        out = torch.empty((2, Rp), dtype=dt, device=tbl.device)
    cuda_lib.check(out, "out", (2, Rp), dt)
    rc = fn(tbl.data_ptr(), vel.data_ptr(), ab.data_ptr(), out.data_ptr(),
            flag.data_ptr(), int(gen), Rp, cuda_lib.stream(tbl))
    cuda_lib.launched(counts, "relvel_fused", rc, tbl.device)
    return out


def ngs_iteration(tbl, g, rate: float, max_corr: float):
    """K2: one NGS position iteration; returns (upd [12,Rp], err [1,Rp])."""
    if cuda_lib.on_cpu(tbl, g):
        return ngs_iteration_plain(tbl, g, rate, max_corr)
    C, Rp = _table_dims(tbl, False)
    fn, counts = _entry("ngs_iteration", tbl.dtype)
    cuda_lib.check(tbl, "tbl", (C, Rp), tbl.dtype)
    cuda_lib.check(g, "g", (6, 2 * Rp), tbl.dtype)
    upd = torch.empty((12, Rp), dtype=tbl.dtype, device=tbl.device)
    err = torch.empty((1, Rp), dtype=tbl.dtype, device=tbl.device)
    rc = fn(tbl.data_ptr(), g.data_ptr(), upd.data_ptr(), err.data_ptr(), Rp,
            float(rate), float(max_corr), cuda_lib.stream(tbl))
    cuda_lib.launched(counts, "ngs_iteration", rc, tbl.device)
    return upd, err


def _check_plan_args(tbl, d, ab, pos, terms_a, terms_b):
    """Check a fused kernel's body table, endpoints, positions and terms
    buffers against the table's dtype and width."""
    Rp, dt = tbl.shape[1], tbl.dtype
    cuda_lib.check(d, "d", (d.shape[0], 8), dt)
    cuda_lib.check(ab, "ab", (2 * Rp,), torch.int32)
    cuda_lib.check(pos, "pos", (2 * Rp,), torch.int32)
    for name, t in (("terms_a", terms_a), ("terms_b", terms_b)):
        cuda_lib.check(t, name, (t.shape[0], 8), dt)


def solve_iteration_fused(tbl, imp_t, d, ab, pos, terms_a, terms_b,
                          with_sr: bool):
    """The fused K1: one velocity iteration of the rows against the body
    deltas ``d`` [N,8], read by the rows' endpoints ``ab`` [2Rp] int32
    inside the kernel; row j's a-term goes to row ``pos[j]`` of
    ``terms_a`` [E,8], its b-term to row ``pos[Rp + j]`` of ``terms_b``
    (int32 positions, -1: not written). Returns the impulses [6,Rp]; the
    terms buffers are written in place."""
    if cuda_lib.on_cpu(tbl, imp_t, d, ab, pos, terms_a, terms_b):
        return solve_iteration_fused_plain(tbl, imp_t, d, ab, pos, terms_a,
                                           terms_b, with_sr)
    C, Rp = _table_dims(tbl, with_sr)
    fn, counts = _entry("solve_iteration_fused", tbl.dtype)
    cuda_lib.check(tbl, "tbl", (C, Rp), tbl.dtype)
    cuda_lib.check(imp_t, "imp_t", (6, Rp), tbl.dtype)
    _check_plan_args(tbl, d, ab, pos, terms_a, terms_b)
    oimp = torch.empty((6, Rp), dtype=tbl.dtype, device=tbl.device)
    rc = fn(tbl.data_ptr(), imp_t.data_ptr(), d.data_ptr(), ab.data_ptr(),
            pos.data_ptr(), terms_a.data_ptr(), terms_b.data_ptr(),
            oimp.data_ptr(), Rp, int(bool(with_sr)), cuda_lib.stream(tbl))
    cuda_lib.launched(counts, "solve_iteration_fused", rc, tbl.device)
    return oimp


def restitution_iteration_fused(tbl, dyn, imp3_t, d, ab, pos, terms_a,
                                terms_b):
    """The fused K3a: one restitution inner iteration, as
    ``solve_iteration_fused``. Returns the impulses [3,Rp]."""
    if cuda_lib.on_cpu(tbl, dyn, imp3_t, d, ab, pos, terms_a, terms_b):
        return restitution_iteration_fused_plain(tbl, dyn, imp3_t, d, ab,
                                                 pos, terms_a, terms_b)
    C, Rp = _table_dims(tbl, False)
    fn, counts = _entry("restitution_iteration_fused", tbl.dtype)
    cuda_lib.check(tbl, "tbl", (C, Rp), tbl.dtype)
    cuda_lib.check(dyn, "dyn", (2, Rp), tbl.dtype)
    cuda_lib.check(imp3_t, "imp3_t", (3, Rp), tbl.dtype)
    _check_plan_args(tbl, d, ab, pos, terms_a, terms_b)
    oimp = torch.empty((3, Rp), dtype=tbl.dtype, device=tbl.device)
    rc = fn(tbl.data_ptr(), dyn.data_ptr(), imp3_t.data_ptr(), d.data_ptr(),
            ab.data_ptr(), pos.data_ptr(), terms_a.data_ptr(),
            terms_b.data_ptr(), oimp.data_ptr(), Rp, cuda_lib.stream(tbl))
    cuda_lib.launched(counts, "restitution_iteration_fused", rc, tbl.device)
    return oimp


def ngs_iteration_fused(tbl, d, ab, pos, terms_a, terms_b, rate: float,
                        max_corr: float):
    """The fused K2: one NGS position iteration of the rows against the
    body position and rotation deltas ``d`` [N,8], as
    ``solve_iteration_fused``. Returns the errors [1,Rp]; the terms
    buffers are written in place."""
    if cuda_lib.on_cpu(tbl, d, ab, pos, terms_a, terms_b):
        return ngs_iteration_fused_plain(tbl, d, ab, pos, terms_a, terms_b,
                                         rate, max_corr)
    C, Rp = _table_dims(tbl, False)
    fn, counts = _entry("ngs_iteration_fused", tbl.dtype)
    cuda_lib.check(tbl, "tbl", (C, Rp), tbl.dtype)
    _check_plan_args(tbl, d, ab, pos, terms_a, terms_b)
    err = torch.empty((1, Rp), dtype=tbl.dtype, device=tbl.device)
    rc = fn(tbl.data_ptr(), d.data_ptr(), ab.data_ptr(), pos.data_ptr(),
            terms_a.data_ptr(), terms_b.data_ptr(), err.data_ptr(), Rp,
            float(rate), float(max_corr), cuda_lib.stream(tbl))
    cuda_lib.launched(counts, "ngs_iteration_fused", rc, tbl.device)
    return err


def segment_sum(terms, offsets, x=None, start=None):
    """Per body b, the terms ``terms[offsets[b]:offsets[b+1]]`` ([E,8]
    rows, int32 offsets [N+1]) summed from zero in order, each term only
    where live (a component of 0:6 not zero), as ``solver.index_sum`` adds.
    With ``x`` [N,8]: x plus each body's sum where a term was live, written
    into x in place; returns x. Without: one hop of
    ``solver.chain_index_sum``, the running sum ``start`` [N,8] (optional)
    counted as each body's first term, then 0 + the sum (0 where nothing
    was live); returns a new [N,8] tensor."""
    ts = [t for t in (terms, offsets, x, start) if t is not None]
    if cuda_lib.on_cpu(*ts):
        return segment_sum_plain(terms, offsets, x, start)
    n, dt = offsets.shape[0] - 1, terms.dtype
    fn, counts = _entry("segment_sum", dt)
    cuda_lib.check(terms, "terms", (terms.shape[0], 8), dt)
    cuda_lib.check(offsets, "offsets", (n + 1,), torch.int32)
    for name, t in (("x", x), ("start", start)):
        if t is not None:
            cuda_lib.check(t, name, (n, 8), dt)
    if terms.data_ptr() % 16:  # the kernel copies 16 bytes at a time
        raise ValueError("terms: 16-byte aligned data expected")
    out = x if x is not None else torch.empty((n, 8), dtype=dt,
                                              device=terms.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = fn(terms.data_ptr(), offsets.data_ptr(), ptr(start), ptr(x),
            out.data_ptr(), n, cuda_lib.stream(terms))
    cuda_lib.launched(counts, "segment_sum", rc, terms.device)
    return out
