"""Batched raycasting (counterpart of ``edyn_tpu/collision/raycast.py``;
reference: include/edyn/collision/raycast.hpp and the per-shape functions
of src/edyn/collision/raycast.cpp:58-403).

The reference walks the broadphase tree for each ray and dispatches on the
shape. Here Q rays test every body's AABB at once, keep up to H candidates
each (nearest entry first, a stable sort), and evaluate every shape's
formula masked by type; a mesh candidate walks its candidate grid along
the ray, a compound candidate tests each child. Plain PyTorch on every
device: the JAX package computes this in XLA, with no Pallas kernel.

Per ray: fraction t in [0, 1], hit entity (-1 on a miss), world normal,
and the feature detail below.
"""
from __future__ import annotations

import torch

from ..math import geom, quat, vec
from ..shapes.mesh import candidate_tris
from ..shapes.params import ShapeType
from .kernels.common import axis_onehot

BIG = geom.BIG

# feature kinds of a hit (the reference's per-shape raycast info variants,
# include/edyn/collision/raycast.hpp:33-120):
# FACE       sub_index = face id (box: axis * 2 + (negative side); cylinder:
#            cap disc 0 (+axis) or 1; polyhedron: face table row)
# SIDE       curved side of a cylinder or capsule (no sub index)
# HEMISPHERE capsule cap, sub_index 0 (+axis) or 1 (-axis)
# TRIANGLE   mesh hit, sub_index = triangle id in the body's mesh row
FEAT_NONE, FEAT_FACE, FEAT_SIDE, FEAT_HEMISPHERE, FEAT_TRIANGLE = 0, 1, 2, 3, 4
RAY_CELLS = 32  # grid cells sampled along a ray through a mesh


def _ray_shape_local(stype, params, verts, vert_mask, face_normals,
                     face_mask, p0, d):
    """Ray against shape in the shape's object space, masked over shape
    types. Inputs batched [C, ...]. Returns (t, normal_local, feature,
    sub_index)."""
    C = p0.shape[0]
    dev = p0.device
    t_out = torch.full((C,), BIG, dtype=p0.dtype, device=dev)
    n_out = torch.zeros((C, 3), dtype=p0.dtype, device=dev)
    f_out = torch.zeros((C,), dtype=torch.int32, device=dev)
    s_out = torch.zeros((C,), dtype=torch.int32, device=dev)
    zi = torch.zeros((C,), dtype=torch.int32, device=dev)
    full_i = lambda v: torch.full((C,), v, dtype=torch.int32, device=dev)
    big = torch.full((C,), BIG, dtype=p0.dtype, device=dev)

    def merge(mask, t, n, feat=None, sub=None):
        nonlocal t_out, n_out, f_out, s_out
        better = mask & (t < t_out)
        t_out = torch.where(better, t, t_out)
        n_out = torch.where(better[:, None], n, n_out)
        f_out = torch.where(better, full_i(FEAT_NONE) if feat is None
                            else feat, f_out)
        s_out = torch.where(better, zi if sub is None else sub, s_out)

    st = stype

    # SPHERE
    t_s = geom.intersect_ray_sphere(p0, d, torch.zeros_like(p0),
                                    params[:, 0])
    n_s = vec.normalize(p0 + d * t_s[:, None])
    merge(st == ShapeType.SPHERE, t_s, n_s)

    # PLANE (object-space normal and constant in the params)
    pn = params[:, :3]
    t_p = geom.intersect_ray_plane(p0, d, pn, params[:, 3])
    merge(st == ShapeType.PLANE, t_p, pn)

    # BOX: slab test; the face is the axis of the largest |p| / h
    h = params[:, :3]
    t_enter, t_exit = geom.intersect_ray_aabb(p0, d, -h, h)
    hit_b = t_enter <= t_exit
    p_hit = p0 + d * t_enter[:, None]
    ratio = torch.abs(p_hit) / torch.clamp(h, min=1e-9)
    ax = torch.argmax(ratio, dim=-1)
    sign_ax = torch.sign(torch.gather(p_hit, 1, ax[:, None]))
    n_b = axis_onehot(ax.to(p0.dtype)) * sign_ax
    face_b = (ax.to(torch.int32) * 2 + (sign_ax[:, 0] < 0).to(torch.int32))
    merge((st == ShapeType.BOX) & hit_b, torch.where(hit_b, t_enter, big),
          n_b, full_i(FEAT_FACE), face_b)

    # CAPSULE: the cylinder side and two sphere caps
    rc = params[:, 0]
    hl = params[:, 1]
    axis = axis_onehot(params[:, 2])
    p0p = p0 - axis * vec.dot(p0, axis)[:, None]
    dp = d - axis * vec.dot(d, axis)[:, None]
    a_q = vec.length_sqr(dp)
    b_q = vec.dot(p0p, dp)
    c_q = vec.length_sqr(p0p) - rc * rc
    disc = b_q * b_q - a_q * c_q
    ok = (disc >= 0) & (a_q > 1e-12)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_side = (-b_q - sq) / torch.clamp(a_q, min=1e-12)
    z = vec.dot(p0 + d * t_side[:, None], axis)
    ok_side = ok & (t_side >= 0) & (torch.abs(z) <= hl)
    n_side = vec.normalize((p0 + d * t_side[:, None]) - axis * z[:, None])
    t_cap = torch.where(ok_side, t_side, big)
    n_cap = torch.where(ok_side[:, None], n_side, torch.zeros_like(n_side))
    f_cap = full_i(FEAT_SIDE)
    s_cap = zi
    for ci, sgn in enumerate((1.0, -1.0)):
        cc = axis * hl[:, None] * sgn
        t_c = geom.intersect_ray_sphere(p0, d, cc, rc)
        better = t_c < t_cap
        n_c = vec.normalize(p0 + d * t_c[:, None] - cc)
        t_cap = torch.where(better, t_c, t_cap)
        n_cap = torch.where(better[:, None], n_c, n_cap)
        f_cap = torch.where(better, full_i(FEAT_HEMISPHERE), f_cap)
        s_cap = torch.where(better, full_i(ci), s_cap)
    merge(st == ShapeType.CAPSULE, t_cap, n_cap, f_cap, s_cap)

    # CYLINDER: the side within |z| <= hl and the cap discs
    t_cyl = torch.where(ok & (t_side >= 0) & (torch.abs(z) <= hl), t_side,
                        big)
    n_cyl = n_side
    f_cyl = full_i(FEAT_SIDE)
    s_cyl = zi
    for ci, sgn in enumerate((1.0, -1.0)):
        denom = vec.dot(d, axis) * sgn
        par = torch.abs(denom) > 1e-9
        t_d = (hl - vec.dot(p0, axis) * sgn) / torch.where(
            par, denom, torch.full_like(denom, 1e-9))
        p_d = p0 + d * t_d[:, None]
        radial = p_d - axis * vec.dot(p_d, axis)[:, None]
        ok_d = par & (t_d >= 0) & (vec.length_sqr(radial) <= rc * rc)
        better = ok_d & (t_d < t_cyl)
        t_cyl = torch.where(better, t_d, t_cyl)
        n_cyl = torch.where(better[:, None], axis * sgn, n_cyl)
        f_cyl = torch.where(better, full_i(FEAT_FACE), f_cyl)
        s_cyl = torch.where(better, full_i(ci), s_cyl)
    merge(st == ShapeType.CYLINDER, t_cyl, n_cyl, f_cyl, s_cyl)

    # POLYHEDRON: convex half-space clipping over the face planes
    if face_normals.shape[1] > 0:
        # face plane offset = max over the vertices of dot(v, n_f)
        proj = torch.einsum("cvd,cfd->cvf", verts, face_normals)
        proj = torch.where(vert_mask[:, :, None], proj,
                           torch.full_like(proj, -BIG))
        off = torch.amax(proj, dim=1)                       # [C,F]
        dn = torch.einsum("cd,cfd->cf", d, face_normals)
        pn_ = torch.einsum("cd,cfd->cf", p0, face_normals)
        nz = torch.abs(dn) > 1e-9
        t_f = (off - pn_) / torch.where(nz, dn, torch.full_like(dn, 1e-9))
        entering = dn < 0
        fm = face_mask & nz
        near_t = torch.where(fm & entering, t_f, torch.full_like(t_f, -BIG))
        t_near = torch.amax(near_t, dim=1)
        t_far = torch.amin(torch.where(fm & ~entering, t_f,
                                       torch.full_like(t_f, BIG)), dim=1)
        # parallel to a face and outside it: a miss
        outside_par = torch.any(face_mask & ~nz & (pn_ > off), dim=1)
        hit_ph = (t_near <= t_far) & (t_far >= 0) & ~outside_par
        t_ph = torch.clamp(t_near, min=0.0)
        near_idx = torch.argmax(near_t, dim=1)
        n_ph = torch.gather(face_normals, 1,
                            near_idx[:, None, None].expand(-1, 1, 3))[:, 0]
        merge((st == ShapeType.POLYHEDRON) & hit_ph,
              torch.where(hit_ph, t_ph, big), n_ph, full_i(FEAT_FACE),
              near_idx.to(torch.int32))

    return t_out, n_out, f_out, s_out


def _mesh_hits(state, flat, p0_l, d_l):
    """A mesh candidate's nearest triangle hit, walking the candidate grid
    along the ray: the ray is sampled at cell spacing (short rays hit every
    cell; the samples are clamped to the segment's end) and each sample's
    cell triangles are tested (reference: the static BVH walk,
    raycast.cpp:380). Returns (t, normal, triangle id)."""
    mesh = state.mesh
    C = flat.shape[0]
    msi = torch.clamp(state.shape_index[flat].long(), 0,
                      mesh.tri_verts.shape[0] - 1)
    cell = mesh.grid_cell[msi]                                  # [C]
    dlen = torch.clamp(vec.length(d_l), min=1e-9)
    step_t = torch.clamp(cell / dlen, max=1.0 / RAY_CELLS)
    ar = torch.arange(RAY_CELLS + 1, device=flat.device,
                      dtype=d_l.dtype)
    ts = torch.clamp(step_t[:, None] * ar[None, :], max=1.0)    # [C,S+1]
    pts = p0_l[:, None, :] + d_l[:, None, :] * ts[..., None]    # [C,S+1,3]
    S1 = RAY_CELLS + 1
    ids = candidate_tris(mesh, torch.repeat_interleave(msi, S1),
                         pts.reshape(-1, 3)).reshape(C, -1)     # [C,S1*CAP]
    ok_id = ids >= 0
    idc = torch.clamp(ids, min=0).long()
    tv = mesh.tri_verts[msi[:, None], idc]                      # [C,K,3,3]
    t_tri, hit_tri = geom.intersect_segment_triangle(
        p0_l[:, None, :], d_l[:, None, :], tv[:, :, 0], tv[:, :, 1],
        tv[:, :, 2])
    tmask = mesh.tri_mask[msi[:, None], idc] & ok_id
    t_tri = torch.where(tmask & hit_tri, t_tri, torch.full_like(t_tri, BIG))
    best_tri = torch.argmin(t_tri, dim=1)
    t_m = torch.gather(t_tri, 1, best_tri[:, None])[:, 0]
    best_id = torch.gather(idc, 1, best_tri[:, None])[:, 0]
    n_m = mesh.tri_normal[msi, best_id]
    # the surface normal faces the ray
    n_m = torch.where(vec.dot(n_m, d_l)[:, None] > 0, -n_m, n_m)
    return t_m, n_m, best_id.to(torch.int32)


def _compound_hits(state, flat, p0_l, d_l):
    """A compound candidate's nearest child hit (reference: raycast.cpp:323
    compound dispatch into the child shapes). Returns (t, normal in the
    compound's frame, feature, sub index, child index)."""
    ct = state.compound
    cx = state.convex
    C = flat.shape[0]
    ci = torch.clamp(state.shape_index[flat].long(), 0,
                     ct.child_row.shape[0] - 1)
    CH = ct.child_row.shape[1]
    rows = torch.clamp(ct.child_row[ci], min=0).long()          # [C,CH]
    corn = ct.child_orn[ci]
    ctype = ct.child_type[ci].reshape(-1)
    p0_c = quat.rotate_inv(corn, p0_l[:, None, :] - ct.child_pos[ci])
    d_c = quat.rotate_inv(corn, d_l[:, None, :].expand(-1, CH, -1))
    CC = C * CH
    rflat = rows.reshape(-1)
    fm_c = cx.face_mask[rflat] & (ctype == ShapeType.POLYHEDRON)[:, None]
    t_c, n_c, f_c, s_c = _ray_shape_local(
        ctype, ct.child_params[ci].reshape(-1, 4), cx.verts[rflat],
        cx.vert_mask[rflat], cx.face_normals[rflat], fm_c,
        p0_c.reshape(CC, 3), d_c.reshape(CC, 3))
    t_c = torch.where(ct.child_mask[ci].reshape(-1), t_c,
                      torch.full_like(t_c, BIG)).reshape(C, CH)
    n_b = quat.rotate(corn.reshape(CC, 4), n_c).reshape(C, CH, 3)
    bi = torch.argmin(t_c, dim=1)
    g = lambda x: torch.gather(x, 1, bi[:, None])[:, 0]
    n_comp = torch.gather(n_b, 1, bi[:, None, None].expand(-1, 1, 3))[:, 0]
    return (g(t_c), n_comp, g(f_c.reshape(C, CH)), g(s_c.reshape(C, CH)),
            bi.to(torch.int32))


def _raycast_block(state, p0, p1, H):
    Q = p0.shape[0]
    dev = p0.device
    d = p1 - p0

    # broadphase: the segment against every body's AABB [Q, N]
    t_en, t_ex = geom.intersect_ray_aabb(
        p0[:, None, :], d[:, None, :], state.aabb_min[None],
        state.aabb_max[None])
    hit_aabb = ((t_en <= t_ex) & (t_en <= 1.0) & state.valid[None, :]
                & (state.shape_type[None, :] != ShapeType.NONE))

    # candidates: nearest entries first, ties in body order (stable, as
    # jnp.argsort is)
    order = torch.argsort(torch.where(hit_aabb, t_en,
                                      torch.full_like(t_en, BIG)),
                          dim=1, stable=True)
    cand = order[:, :H]                                         # [Q,H]
    cand_ok = torch.gather(hit_aabb, 1, cand)
    flat = cand.reshape(-1)
    C = flat.shape[0]

    # the ray in each candidate's object space
    pos_c = state.origin_pos()[flat]
    orn_c = state.orn[flat]
    p0_l = quat.rotate_inv(orn_c, torch.repeat_interleave(p0, H, 0) - pos_c)
    d_l = quat.rotate_inv(orn_c, torch.repeat_interleave(d, H, 0))

    stype = state.shape_type[flat]
    poly = state.poly
    if poly.verts.shape[0] > 0:
        si = torch.clamp(state.shape_index[flat].long(), 0,
                         poly.verts.shape[0] - 1)
        verts, vmask = poly.verts[si], poly.vert_mask[si]
        fnorm = poly.face_normals[si]
        fmask = poly.face_mask[si] & (stype == ShapeType.POLYHEDRON)[:, None]
    else:
        verts = torch.zeros((C, 0, 3), dtype=p0_l.dtype, device=dev)
        vmask = torch.zeros((C, 0), dtype=torch.bool, device=dev)
        fnorm = torch.zeros((C, 0, 3), dtype=p0_l.dtype, device=dev)
        fmask = torch.zeros((C, 0), dtype=torch.bool, device=dev)
    t_l, n_l, f_l, s_l = _ray_shape_local(
        stype, state.shape_params[flat], verts, vmask, fnorm, fmask, p0_l,
        d_l)
    child_l = torch.full((C,), -1, dtype=torch.int32, device=dev)

    if state.mesh.tri_verts.shape[0] > 0:
        t_m, n_m, id_m = _mesh_hits(state, flat, p0_l, d_l)
        better = ((stype == ShapeType.MESH) | (stype == ShapeType.PAGED_MESH)
                  ) & (t_m < t_l)
        t_l = torch.where(better, t_m, t_l)
        n_l = torch.where(better[:, None], n_m, n_l)
        f_l = torch.where(better, torch.full_like(f_l, FEAT_TRIANGLE), f_l)
        s_l = torch.where(better, id_m, s_l)

    if state.compound.child_row.shape[0] > 0:
        t_c, n_c, f_c, s_c, b_c = _compound_hits(state, flat, p0_l, d_l)
        better = (stype == ShapeType.COMPOUND) & (t_c < t_l)
        t_l = torch.where(better, t_c, t_l)
        n_l = torch.where(better[:, None], n_c, n_l)
        f_l = torch.where(better, f_c, f_l)
        s_l = torch.where(better, s_c, s_l)
        child_l = torch.where(better, b_c, child_l)

    t = torch.where(cand_ok.reshape(-1), t_l,
                    torch.full_like(t_l, BIG)).reshape(Q, H)
    n_w = quat.rotate(orn_c, n_l).reshape(Q, H, 3)
    best = torch.argmin(t, dim=1)
    take = lambda x: torch.gather(x.reshape(Q, H), 1, best[:, None])[:, 0]
    t_best = take(t)
    hit = t_best <= 1.0
    entity = torch.where(hit, take(cand), torch.full_like(best, -1))
    normal = torch.gather(n_w, 1, best[:, None, None].expand(-1, 1, 3))[:, 0]
    return {
        "fraction": torch.where(hit, t_best, torch.ones_like(t_best)),
        "entity": entity.to(torch.int32),
        "normal": torch.where(hit[:, None], normal,
                              torch.zeros_like(normal)),
        "feature": torch.where(hit, take(f_l), torch.zeros_like(best).to(
            torch.int32)),
        "sub_index": torch.where(hit, take(s_l), torch.zeros_like(
            best).to(torch.int32)),
        "child_index": torch.where(hit, take(child_l), torch.full_like(
            best, -1).to(torch.int32)),
    }


def raycast(state, p0, p1, max_candidates: int = 16, block: int = 1024):
    """Batched raycast of the segments p0 -> p1 ([Q, 3] world space, on the
    state's device). Returns a dict of ``fraction`` [Q], ``entity`` [Q]
    (-1 on a miss), ``normal`` [Q, 3] world, ``feature``, ``sub_index``
    and ``child_index`` [Q] (reference: edyn::raycast,
    src/edyn/collision/raycast.cpp:20-57). Rays are independent: they run
    in blocks of ``block`` to bound the [Q, N] broadphase temporaries."""
    H = min(max_candidates, state.capacity)
    parts = [_raycast_block(state, p0[q:q + block], p1[q:q + block], H)
             for q in range(0, p0.shape[0], block)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
