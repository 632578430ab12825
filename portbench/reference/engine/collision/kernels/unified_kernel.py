"""The UNIFIED convex-convex narrowphase bucket as one CUDA kernel (K4),
its plain PyTorch version, and the transposed side table it reads.

Counterpart of ``edyn_tpu/collision/kernels/pallas_unified.py``
(``collide_support_pallas``, kernel ``_make_kernel``). Per pair, in order:
SAT over the face, centre-delta and cylinder-side axes of both sides, the
E x E edge crosses and the 2 rim axes; disc-swept support; a tangent basis
aligned to line features; 5 tilted support samples per side; the
feature-slab reject/clamp; the reduction to <= 4 points.

``collide_support_plain`` ports ``_make_kernel`` step by step on ``[G, K]``
tensors (one column per pair) and follows the TPU kernel's own formulation
where it differs from ``support_sat.collide_support``: masked values are
-1e30, the disc term is ``sqrt(max(d.d - (d.w)^2, 0))``, every selection
takes the first index among equal maxima, three-component sums run as
``a0*b0 + a1*b1 + a2*b2`` (never ``torch.sum``, which rounds otherwise on the
card), sums over vertices run in vertex order, and reduce-to-4 is the
kernel's inline version. It runs as ``world_side`` on each side (the
world rotations), then ``collide_sides_plain``, which also takes two
sides of different widths, as the CUDA kernel runs them. The CUDA kernel
(``edyn_tpu_torch/csrc/unified_kernel.cu``) evaluates the same operations in
the same order per pair, built without FMA contraction.

``collide_support_unified`` is the step's entry: the plain version, on
every device (the program runs the CUDA kernel there instead).
"""
from __future__ import annotations

import torch

TILT = 0.02
EPS = 1e-12
BIG = 1e30
# Cap of the CUDA kernel's per-side vertex registers. Every convex shape of
# the JAX package's scenes and tests fits (box V 8); faces and edges are
# streamed from the feature rows and have no cap.
VMAX = 8
OUT_ROWS = 48  # 4 points x (pivot_a 3 | pivot_b 3 | normal 3 | attachment |
#                           distance | point_valid)

# ---------------------------------------------------------------------------
# packing: component-major transposed side table
# ---------------------------------------------------------------------------

def table_rows(dims) -> int:
    """Rows C of the side table for convex widths (V, F, E)."""
    V, F, E = dims
    return 12 + 4 * V + 4 * F + 4 * E


def pack_side_table_t(state):
    """[C, N] transposed, component-major packed side table (at the
    state's scalar dtype) and its widths
    (V, F, E). Layout rows: pos 0:3 | orn 3:7 | radius 7 | disc_r 8 |
    disc_axis 9:12 | verts x V | y V | z V | vert_mask V | face x F | y F |
    z F | face_mask F | edge x E | y E | z E | edge_mask E."""
    cx = state.convex
    N = state.capacity
    Ncx = cx.verts.shape[0]
    V = cx.verts.shape[1]
    F = cx.face_normals.shape[1]
    E = cx.edge_dirs.shape[1]

    def pad(x):
        x = x.to(state.dtype)
        if Ncx < N:
            return torch.nn.functional.pad(
                x, (0, 0) * (x.dim() - 1) + (0, N - Ncx))
        return x[:N]

    def cm(x):  # [N, G, 3] -> [3G, N] component-major
        return x.permute(2, 1, 0).reshape(3 * x.shape[1], x.shape[0])

    rows = [state.origin_pos().T, state.orn.T,
            pad(cx.radius)[None, :], pad(cx.disc_r)[None, :],
            pad(cx.disc_axis).T,
            cm(pad(cx.verts)), pad(cx.vert_mask).T,
            cm(pad(cx.face_normals)), pad(cx.face_mask).T,
            cm(pad(cx.edge_dirs)), pad(cx.edge_mask).T]
    return torch.cat(rows, dim=0).contiguous(), (V, F, E)


# ---------------------------------------------------------------------------
# component-wise helpers on tuples of [G, K] tensors
# ---------------------------------------------------------------------------

def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def _add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _neg(a):
    return (-a[0], -a[1], -a[2])


def _where3(c, a, b):
    return tuple(torch.where(c, a[i], b[i]) for i in range(3))


def _length(a):
    return torch.sqrt(torch.clamp(_dot(a, a), min=0.0))


def _normalize_or(a, fallback, eps=1e-9):
    l2 = _dot(a, a)
    ok = l2 > eps
    inv = 1.0 / torch.sqrt(torch.clamp(l2, min=eps))
    return _where3(ok, _scale(a, inv), fallback)


def _normalize(a, eps=1e-9):
    l2 = _dot(a, a)
    inv = torch.where(l2 > eps, 1.0 / torch.sqrt(torch.clamp(l2, min=eps)),
                      torch.zeros_like(l2))
    return _scale(a, inv)


def _qrotate(q, v):
    qv = (q[0], q[1], q[2])
    t = _scale(_cross(qv, v), 2.0)
    return _add(_add(v, _scale(t, q[3])), _cross(qv, t))


def _qrotate_inv(q, v):
    return _qrotate((-q[0], -q[1], -q[2], q[3]), v)


def _ortho_basis(n):
    nx, ny, nz = n
    sign = torch.where(nz >= 0.0, 1.0, -1.0).to(nz.dtype)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t1 = (1.0 + sign * nx * nx * a, sign * b, -sign * nx)
    t2 = (b, sign + ny * ny * a, -ny)
    return t1, t2


def _masked(mask, x, fill):
    return torch.where(mask, x, torch.full_like(x, fill))


def _argmax_sel(vals, *gather):
    """Row of each [G, K] array in ``gather`` at the first maximum of vals
    along dim 0 (the one-hot selection of the TPU kernel). Returns the max
    [1, K] first, then the selected rows."""
    idx = torch.argmax(vals, dim=0, keepdim=True)
    return [torch.gather(vals, 0, idx)] + [torch.gather(g, 0, idx)
                                            for g in gather]


def _argmin_sel(vals, *gather):
    idx = torch.argmin(vals, dim=0, keepdim=True)
    return [torch.gather(vals, 0, idx)] + [torch.gather(g, 0, idx)
                                            for g in gather]


def _first_hit(idx, G):
    """[G, K] bool one-hot of row ``idx`` [1, K]."""
    return torch.arange(G, device=idx.device)[:, None] == idx


def _vsum(x):
    """Sum over dim 0 in row order, one add at a time (the kernel's
    order)."""
    acc = x[0:1]
    for i in range(1, x.shape[0]):
        acc = acc + x[i:i + 1]
    return acc


def _bc(x, like):
    return x.expand_as(like)


# ---------------------------------------------------------------------------
# the kernel's building blocks
# ---------------------------------------------------------------------------

def _unpack(t, dims):
    V, F, E = dims
    o = [0]

    def cut(n):
        s = t[o[0]:o[0] + n]
        o[0] += n
        return s

    pos = tuple(cut(1) for _ in range(3))
    orn = tuple(cut(1) for _ in range(4))
    radius = cut(1)
    disc_r = cut(1)
    disc_axis = tuple(cut(1) for _ in range(3))
    verts = (cut(V), cut(V), cut(V))
    vmask = cut(V) > 0.5
    faces = (cut(F), cut(F), cut(F))
    fmask = cut(F) > 0.5
    edges = (cut(E), cut(E), cut(E))
    emask = cut(E) > 0.5
    return dict(pos=pos, orn=orn, radius=radius, disc_r=disc_r,
                disc_axis=disc_axis, verts=verts, vert_mask=vmask,
                faces=faces, face_mask=fmask, edges=edges, edge_mask=emask)


def _world(S):
    vw = _add(_qrotate(S["orn"], S["verts"]),
              tuple(_bc(c, S["verts"][0]) for c in S["pos"]))
    w = _qrotate(S["orn"], S["disc_axis"])
    fw = _qrotate(S["orn"], S["faces"])
    ew = _qrotate(S["orn"], S["edges"])
    return vw, w, fw, ew


def _proj_xv(S, vw, d):
    """Masked projections [X, V, K] of the verts on axes d [X, K]."""
    proj = (d[0][:, None, :] * vw[0][None, :, :]
            + d[1][:, None, :] * vw[1][None, :, :]
            + d[2][:, None, :] * vw[2][None, :, :])
    return _masked(S["vert_mask"][None, :, :], proj, -BIG)


def _support_projection(S, vw, w, d):
    base = torch.amax(_proj_xv(S, vw, d), dim=1)
    dw = _dot(d, w)
    perp2 = torch.clamp(_dot(d, d) - dw * dw, min=0.0)
    return base + S["radius"] + S["disc_r"] * torch.sqrt(perp2)


def _support_point(S, vw, w, d):
    proj = _proj_xv(S, vw, d)
    idx = torch.argmax(proj, dim=1, keepdim=True)        # [X, 1, K]
    base = tuple(torch.gather(_bc(vw[c][None], proj), 1, idx)[:, 0]
                 for c in range(3))
    dw = _dot(d, w)
    perp = _sub(d, _scale(tuple(_bc(c, d[0]) for c in w), dw))
    plen = _length(perp)
    disc = _scale(perp, S["disc_r"] / torch.clamp(plen, min=EPS))
    return tuple(base[c] + d[c] * S["radius"] + disc[c] for c in range(3))


def _closest_on_circle(c, w, r, x):
    u = _sub(x, c)
    perp = _sub(u, _scale(w, _dot(u, w)))
    t1, _ = _ortho_basis(w)
    dirn = _normalize_or(perp, t1)
    return _add(c, _scale(dirn, r))


def _closest_on_segment(q0, q1, x):
    d = _sub(q1, q0)
    dd = _dot(d, d)
    t = torch.clamp(_dot(_sub(x, q0), d) / torch.clamp(dd, min=EPS),
                    0.0, 1.0)
    return _add(q0, _scale(d, t))


def _vproj(S, vw, d):
    """Masked projections [V, K] of the verts on one axis d [1, K]."""
    return _masked(S["vert_mask"], _dot(d, vw), -BIG)


def _deepest_vert(S, vw, d):
    _, x, y, z = _argmax_sel(_vproj(S, vw, d), vw[0], vw[1], vw[2])
    return (x, y, z)


def _top2_verts(S, vw, d):
    proj = _vproj(S, vw, d)
    _, x0, y0, z0 = _argmax_sel(proj, vw[0], vw[1], vw[2])
    i0 = torch.argmax(proj, dim=0, keepdim=True)
    proj2 = _masked(~_first_hit(i0, proj.shape[0]), proj, -BIG)
    m2, x, y, z = _argmax_sel(proj2, vw[0], vw[1], vw[2])
    has2 = m2 > -1e29
    return (x0, y0, z0), _where3(has2, (x, y, z), (x0, y0, z0))


def rim_axis(C_, D_, seed, iters=8):
    """The rim candidate axis of side C against side D (sides from
    ``world_side``) and its mask, which is False unless C has a disc."""
    vwC, wC, vwD, wD = C_["vw"], C_["w"], D_["vw"], D_["w"]
    cC = _deepest_vert(C_, vwC, _neg(seed))
    rC = C_["disc_r"]
    d_is_disc = D_["disc_r"] > 1e-9
    cD = _deepest_vert(D_, vwD, seed)
    q0, q1 = _top2_verts(D_, vwD, seed)

    def closest_D(p):
        oc = _closest_on_circle(cD, wD, D_["disc_r"], p)
        os_ = _closest_on_segment(q0, q1, p)
        return _where3(d_is_disc, oc, os_)

    p = _closest_on_circle(cC, wC, rC, cD)
    q = p
    for _ in range(iters):
        q = closest_D(p)
        p = _closest_on_circle(cC, wC, rC, q)
    ax = _sub(p, q)
    ok = (C_["disc_r"] > 1e-9) & (_length(ax) > 1e-7)
    return _normalize_or(ax, seed), ok


def _rim_axes(A, B, seed):
    ax_a, ok_a = rim_axis(A, B, seed)
    ax_b, ok_b = rim_axis(B, A, seed)
    return (tuple(torch.cat([ax_a[c], ax_b[c]], 0) for c in range(3)),
            torch.cat([ok_a, ok_b], 0))


def _line_feature_dir(S, vw, d):
    proj = _vproj(S, vw, d)
    maxp = torch.amax(proj, dim=0, keepdim=True)
    feat = (proj >= maxp - 1e-3) & S["vert_mask"]
    featf = feat.to(proj.dtype)
    cnt = _vsum(featf)
    cen = tuple(_vsum(vw[c] * featf) / torch.clamp(cnt, min=1.0)
                for c in range(3))
    zero = torch.zeros_like(proj)
    diffs = tuple(torch.where(feat, vw[c] - cen[c], zero) for c in range(3))
    d2 = _dot(diffs, diffs)
    _, ex, ey, ez = _argmax_sel(d2, diffs[0], diffs[1], diffs[2])
    return (ex, ey, ez), cnt == 2.0


def _flat_feature(S, vw, w, d):
    proj = _vproj(S, vw, d)
    maxp = torch.amax(proj, dim=0, keepdim=True)
    cnt = _vsum((proj >= maxp - 1e-3).to(proj.dtype))
    cap = (S["disc_r"] > 1e-9) & (torch.abs(_dot(d, w)) > 0.99)
    return (S["radius"] < 1e-9) & ((cnt >= 2.0) | cap)


def _feature_slab(S, vw, w, d, t):
    proj = _vproj(S, vw, d)
    maxp = torch.amax(proj, dim=0, keepdim=True)
    feat = proj >= maxp - 1e-3
    vt = _dot(t, vw)
    lo = torch.amin(_masked(feat, vt, BIG), dim=0, keepdim=True)
    hi = torch.amax(_masked(feat, vt, -BIG), dim=0, keepdim=True)
    off = S["radius"] * _dot(d, t)
    dw = _dot(d, w)
    perp = _sub(d, _scale(w, dw))
    plen = _length(perp)
    cap = torch.abs(dw) > 0.99
    tw = _sub(t, _scale(w, _dot(t, w)))
    disc_span = S["disc_r"] * _length(tw)
    rim_off = S["disc_r"] * _dot(perp, t) / torch.clamp(plen, min=EPS)
    lo = lo + off + torch.where(cap, -disc_span, rim_off)
    hi = hi + off + torch.where(cap, disc_span, rim_off)
    return lo, hi


def world_side(cols, dims):
    """One side of each pair from its side-table columns [C, K] of widths
    ``dims``: the unpacked fields and their world features (``_world``:
    vertices ``vw``, disc axis ``w``, faces ``fw``, edges ``ew``)."""
    S = _unpack(cols, dims)
    S["vw"], S["w"], S["fw"], S["ew"] = _world(S)
    return S


def collide_support_plain(a_t, b_t, dims, threshold: float,
                          rim_axes: bool = True):
    """K4's plain version on gathered columns: a_t, b_t [C, K] side-table
    columns of each pair's sides. Returns [K, 4, 12] points (pivot_a 0:3 |
    pivot_b 3:6 | normal 6:9 | attachment 9 | distance 10 |
    point_valid 11)."""
    return collide_sides_plain(world_side(a_t, dims), world_side(b_t, dims),
                               threshold, rim_axes)


def collide_sides_plain(A, B, threshold: float, rim_axes: bool = True):
    """``collide_support_plain`` after the world rotations: on two sides
    from ``world_side``, each at its own widths (V, F, E)."""
    K = A["radius"].shape[1]
    vwA, wA, fwA, ewA = A["vw"], A["w"], A["fw"], A["ew"]
    vwB, wB, fwB, ewB = B["vw"], B["w"], B["fw"], B["ew"]
    one = torch.ones_like(A["radius"])
    zero = torch.zeros_like(one)
    true = one > 0.5

    delta = _sub(A["pos"], B["pos"])
    ydef = (zero, one, zero)
    seed = _normalize_or(delta, ydef)

    ax_list = [[], [], []]
    m_list = []

    def add_axes(v3, mask):
        for c in range(3):
            ax_list[c].append(v3[c])
        m_list.append(mask)

    def side_axes(S, fw, w, other_pos):
        add_axes(fw, S["face_mask"])
        d = _sub(other_pos, S["pos"])
        add_axes(_normalize_or(d, ydef), true)
        perp = _sub(d, _scale(w, _dot(d, w)))
        plen = _length(perp)
        side_n = _scale(perp, 1.0 / torch.clamp(plen, min=EPS))
        add_axes(side_n, (S["disc_r"] > 1e-9) & (plen > 1e-9))

    side_axes(A, fwA, wA, B["pos"])
    side_axes(B, fwB, wB, A["pos"])

    # edge crosses, A edge major: row i * EB + j is (A edge i) x (B edge j)
    EA, EB = ewA[0].shape[0], ewB[0].shape[0]
    eax = tuple(ewA[c][:, None, :].expand(EA, EB, K).reshape(EA * EB, K)
                for c in range(3))
    ebx = tuple(ewB[c][None, :, :].expand(EA, EB, K).reshape(EA * EB, K)
                for c in range(3))
    crm = (A["edge_mask"][:, None, :] & B["edge_mask"][None, :, :]) \
        .reshape(EA * EB, K)
    cr = _cross(eax, ebx)
    crl = _length(cr)
    cr = _scale(cr, 1.0 / torch.clamp(crl, min=EPS))
    add_axes(cr, crm & (crl > 1e-6))

    if rim_axes:
        ra, ram = _rim_axes(A, B, seed)
        add_axes(ra, ram)

    axes = tuple(torch.cat(ax_list[c], 0) for c in range(3))
    amask = torch.cat(m_list, 0)

    sgn = torch.where(_dot(axes, delta) >= 0, 1.0, -1.0).to(delta[0].dtype)
    axes = _scale(axes, sgn)

    pa_proj = -_support_projection(A, vwA, wA, _neg(axes))
    pb_proj = _support_projection(B, vwB, wB, axes)
    sep = _masked(amask, pa_proj - pb_proj, -BIG)
    best_sep, nx, ny, nz, plane_a, plane_b = _argmax_sel(
        sep, axes[0], axes[1], axes[2], pa_proj, pb_proj)
    n = (nx, ny, nz)

    # tangent basis aligned to line features
    nn = _neg(n)
    eA, lineA = _line_feature_dir(A, vwA, nn)
    eB, lineB = _line_feature_dir(B, vwB, n)
    e = _where3(lineB, eB, eA)
    e_t = _sub(e, _scale(n, _dot(e, n)))
    use_line = (lineA | lineB) & (_length(e_t) > 1e-6)
    t1d, t2d = _ortho_basis(n)
    e_tn = _normalize_or(e_t, t1d)
    t1 = _where3(use_line, e_tn, t1d)
    t2 = _where3(use_line, _cross(n, t1), t2d)

    # patch sampling: 5 tilted directions per side
    def tilt_dirs(base):
        return _normalize(tuple(torch.cat([
            base[c], base[c] + TILT * t1[c], base[c] - TILT * t1[c],
            base[c] + TILT * t2[c], base[c] - TILT * t2[c]], 0)
            for c in range(3)))

    pa_pts = _support_point(A, vwA, wA, tilt_dirs(nn))     # [5, K]
    pb_pts = _support_point(B, vwB, wB, tilt_dirs(n))

    depth_a = _dot(pa_pts, n) - plane_b
    depth_b = plane_a - _dot(pb_pts, n)
    on_a = tuple(torch.cat([pa_pts[c], pb_pts[c] + n[c] * depth_b], 0)
                 for c in range(3))
    on_b = tuple(torch.cat([pa_pts[c] - n[c] * depth_a, pb_pts[c]], 0)
                 for c in range(3))
    depth = torch.cat([depth_a, depth_b], 0)              # [10, K]
    valid = (depth < threshold) & (best_sep < threshold)

    # feature-slab containment / clamp
    both_flat = _flat_feature(A, vwA, wA, nn) & _flat_feature(B, vwB, wB, n)
    shift = [torch.zeros_like(on_a[0]) for _ in range(3)]
    for t in (t1, t2):
        lo_a, hi_a = _feature_slab(A, vwA, wA, nn, t)
        lo_b, hi_b = _feature_slab(B, vwB, wB, n, t)
        lo = torch.maximum(lo_a, lo_b)
        hi = torch.maximum(torch.minimum(hi_a, hi_b), lo)
        proj = _dot(on_a, t)
        inside = (proj >= lo - 5e-3) & (proj <= hi + 5e-3)
        valid = valid & (inside | both_flat)
        clipped = torch.minimum(torch.maximum(proj, lo), hi)
        dmove = torch.where(both_flat, clipped - proj,
                            torch.zeros_like(proj))
        for c in range(3):
            shift[c] = shift[c] + dmove * t[c]
    on_a = _add(on_a, shift)
    on_b = _add(on_b, shift)
    shifted = (shift[0] * shift[0] + shift[1] * shift[1]
               + shift[2] * shift[2]) > EPS
    sel_depth = depth + torch.where(shifted, 1e-5, 0.0).to(depth.dtype)

    # reduce to <= 4 (insertion heuristic)
    G = depth.shape[0]
    d0 = _masked(valid, sel_depth, BIG)
    i0 = torch.argmin(d0, dim=0, keepdim=True)
    m0, p0x, p0y, p0z, dd0, bx0, by0, bz0 = _argmin_sel(
        d0, on_a[0], on_a[1], on_a[2], depth, on_b[0], on_b[1], on_b[2])
    v0 = m0 < BIG * 0.5
    p0 = (p0x, p0y, p0z)
    taken = _first_hit(i0, G)

    def sq(x):
        return x * x

    dist0 = (sq(on_a[0] - p0[0]) + sq(on_a[1] - p0[1])
             + sq(on_a[2] - p0[2]))
    c1 = _masked(valid & ~taken, dist0, -BIG)
    i1 = torch.argmax(c1, dim=0, keepdim=True)
    m1, p1x, p1y, p1z, dd1, bx1, by1, bz1 = _argmax_sel(
        c1, on_a[0], on_a[1], on_a[2], depth, on_b[0], on_b[1], on_b[2])
    v1 = v0 & (m1 > 0)
    p1 = (p1x, p1y, p1z)
    taken = taken | _first_hit(i1, G)

    e01 = _sub(p1, p0)
    rel = _sub(on_a, p0)
    crs = _cross(rel, tuple(_bc(c, rel[0]) for c in e01))
    area = _dot(crs, crs)
    c2 = _masked(valid & ~taken, area, -BIG)
    i2 = torch.argmax(c2, dim=0, keepdim=True)
    m2, p2x, p2y, p2z, dd2, bx2, by2, bz2 = _argmax_sel(
        c2, on_a[0], on_a[1], on_a[2], depth, on_b[0], on_b[1], on_b[2])
    v2 = v1 & (m2 > EPS)
    p2 = (p2x, p2y, p2z)
    taken = taken | _first_hit(i2, G)

    d_all = dist0 \
        + sq(on_a[0] - p1[0]) + sq(on_a[1] - p1[1]) + sq(on_a[2] - p1[2]) \
        + sq(on_a[0] - p2[0]) + sq(on_a[1] - p2[1]) + sq(on_a[2] - p2[2])
    c3 = _masked(valid & ~taken, d_all, -BIG)
    m3, p3x, p3y, p3z, dd3, bx3, by3, bz3 = _argmax_sel(
        c3, on_a[0], on_a[1], on_a[2], depth, on_b[0], on_b[1], on_b[2])
    v3 = v2 & (m3 > 0)

    picks = [((p0x, p0y, p0z), (bx0, by0, bz0), dd0, v0),
             ((p1x, p1y, p1z), (bx1, by1, bz1), dd1, v1),
             ((p2x, p2y, p2z), (bx2, by2, bz2), dd2, v2),
             ((p3x, p3y, p3z), (bx3, by3, bz3), dd3, v3)]

    orow = []
    for pa_w, pb_w, dd, vv in picks:
        vv = vv & (dd < threshold)
        piv_a = _qrotate_inv(A["orn"], _sub(pa_w, A["pos"]))
        piv_b = _qrotate_inv(B["orn"], _sub(pb_w, B["pos"]))
        orow += [piv_a[0], piv_a[1], piv_a[2], piv_b[0], piv_b[1], piv_b[2],
                 n[0], n[1], n[2], zero, dd, vv.to(dd.dtype)]
    return torch.cat(orow, 0).T.reshape(K, 4, 12)


def collide_support_unified(table_t, ka, kb, dims, threshold: float,
                            rim_axes: bool = True):
    """K4: the UNIFIED bucket's contacts for pairs (ka[k], kb[k]) of the
    side table ``table_t`` [C, N] (``pack_side_table_t``). Returns
    [K, 4, 12] (see ``collide_support_plain``), by the plain version on
    every device."""
    return collide_support_plain(table_t[:, ka], table_t[:, kb], dims,
                                 threshold, rim_axes)
