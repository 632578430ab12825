#!/usr/bin/env python3
"""K4 and K5 against their first CUDA versions, or the segment sum, K2 and
K3b against an earlier ``solver_kernels.cu``, in one process on one card,
timed in turns (old, new, new, old).

    python3 scripts/torch_kernel_ab.py --old <dir>
    python3 scripts/torch_kernel_ab.py --solver --old <dir> [--old <dir>]

With ``--solver``, each ``<dir>`` holds an earlier ``solver_kernels.cu``
whose ``edyn_segment_sum``, ``edyn_ngs_iteration`` and ``edyn_relvel``
have today's C interfaces (e.g. the parent commit's, ``git archive <commit>
edyn_tpu_torch/csrc``, or a copy of this checkout's with the segment
sum's ``SEG_BODIES`` edited); see ``solver_ab``. Without it:

``<dir>`` holds the first versions' ``unified_kernel.cu`` and
``overlap_count.cu``, e.g. unpacked from the commit that added them with
``git archive <commit> edyn_tpu_torch/csrc``. The script binds their C
interfaces as they were then (``old_k4``, ``old_k5`` below): K4 one
launch, one thread per pair, reading the [C, N] side table itself and
writing [48, K]; K5 ``edyn_count_overlaps`` as now. It serves that one
comparison: sources with another C interface need those bindings
rewritten; the new side is always the current version. Both versions
are built with the same flags (``utils/cuda_lib.py``). Inputs: the live UNIFIED
pairs of ``mixed_pile(10_000)`` landed for 120 steps, 190,000 random pairs
of its side table with and without rim axes, and 65,573 random AABBs. Each
time is a CUDA-graph replay over rotating input copies that move at least
three times the L2 (as ``chip_smoke.py`` times the kernels); the old and
new outputs must be equal. Prints one JSON object as its last line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", action="append", default=[],
                    help="directory with the earlier unified_kernel.cu and "
                         "overlap_count.cu (with --solver: solver_kernels.cu;"
                         " repeat it to compare several)")
    ap.add_argument("--n-bodies", type=int, default=10_000)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--solver", action="store_true",
                    help="the segment sum, K2 and K3b against --old's "
                         "solver_kernels.cu")
    args = ap.parse_args()
    if not args.solver and len(args.old) != 1:
        ap.error("one --old directory expected")

    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    if args.solver:
        print(json.dumps(solver_ab(args, cs)), flush=True)
        return 0
    import edyn_tpu_torch as et
    from edyn_tpu_torch.collision.kernels import unified_kernel as uk
    from edyn_tpu_torch.ops import overlap_count as ov
    from edyn_tpu_torch.shapes.params import ShapeType
    from edyn_tpu_torch.utils import cuda_lib
    from edyn_tpu_torch.utils.scenes import mixed_pile

    gpu = cs.gpu_line()
    cs.log(f"nvidia-smi: {gpu}")
    names = ["unified_kernel", "overlap_count"]
    old_paths = cuda_lib.build_libraries(names, verbose=True,
                                         src_dir=args.old[0])
    cuda_lib.build_libraries(names, verbose=True)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    old_k4 = ctypes.CDLL(str(old_paths["unified_kernel"])) \
        .edyn_collide_support
    old_k4.argtypes = [P, I, P, P, I, I, I, I, F, I, P, P]
    old_k4.restype = I
    old_k5 = ctypes.CDLL(str(old_paths["overlap_count"])).edyn_count_overlaps
    old_k5.argtypes = [P, P, P, I, P, P]
    old_k5.restype = I

    def k4_old(tbl, ka, kb, dims, rim):
        K = len(ka)
        out = torch.empty((48, K), dtype=torch.float32, device=tbl.device)
        rc = old_k4(tbl.data_ptr(), tbl.shape[1], ka.data_ptr(),
                    kb.data_ptr(), K, *dims, cs.THRESHOLD, int(rim),
                    out.data_ptr(), cuda_lib.stream(tbl))
        if rc:
            raise RuntimeError(f"old K4 launch failed ({rc})")
        return out.T.reshape(K, 4, 12)

    def k4_new(tbl, ka, kb, dims, rim):
        return uk.collide_support_unified(tbl, ka, kb, dims, cs.THRESHOLD,
                                          rim)

    def k5_old(amin, amax, valid):
        total = torch.empty((1,), dtype=torch.int64, device=amin.device)
        rc = old_k5(amin.data_ptr(), amax.data_ptr(), valid.data_ptr(),
                    amin.shape[0], total.data_ptr(), cuda_lib.stream(total))
        if rc:
            raise RuntimeError(f"old K5 launch failed ({rc})")
        return total

    def turns(fns, sets) -> dict:
        """Old, new, new, old: each a CUDA-graph time over the rotating
        input sets; returns both versions' times."""
        t = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            t[which].append(cs.device_ms([lambda s=s, f=fns[which]: f(*s)
                                          for s in sets]))
        return t

    def k4_case(label, tbl, ka, kb, dims, rim) -> dict:
        a = k4_old(tbl, ka, kb, dims, rim)
        b = k4_new(tbl, ka, kb, dims, rim)
        if not bool((a == b).all()):
            raise AssertionError(f"[{label}] old and new K4 differ")
        nbytes = 4 * tbl.numel() + 16 * len(ka) + 192 * len(ka)
        n_sets = max(2, -(-3 * cs.L2_BYTES // nbytes))
        sets = [(tbl, ka, kb, dims, rim)] + [
            (tbl.clone(), ka.clone(), kb.clone(), dims, rim)
            for _ in range(n_sets - 1)]
        t = turns({"old": k4_old, "new": k4_new}, sets)
        cs.log(f"[{label}] K4 rim_axes={rim}, {len(ka)} pairs: old "
               f"{[round(x * 1e3, 2) for x in t['old']]} us, new "
               f"{[round(x * 1e3, 2) for x in t['new']]} us (L2-cold, "
               f"{n_sets} input sets; new = all its launches)")
        return dict(pairs=len(ka), rim_axes=rim, n_sets=n_sets,
                    old_ms=t["old"], new_ms=t["new"])

    dev = torch.device("cuda")
    out = {"gpu": gpu, "k4": {}, "k5": {}}
    world = et.make_world(mixed_pile(n_bodies=args.n_bodies, seed=0)[0],
                          device=dev)
    tbl, dims = uk.pack_side_table_t(world.state)
    ka, kb = cs.random_pairs(world.state.capacity, cs.K4_PAIRS, 2, dev)
    for rim in (True, False):
        out["k4"][f"random, rim_axes={rim}"] = k4_case(
            "random pairs", tbl, ka, kb, dims, rim)
    world.step_n(args.steps)
    st = world.state
    tbl, dims = uk.pack_side_table_t(st)
    ka, kb = cs.unified_pairs(st)
    rim = ShapeType.CYLINDER in world.meta.types_present
    out["k4"]["landed pile"] = k4_case(f"landed pile, step {args.steps}",
                                       tbl, ka, kb, dims, rim)

    amin, amax, valid = cs.random_aabbs(65_573, 3, dev)
    n_old = int(k5_old(amin, amax, valid).item())
    n_new = int(ov.count_overlaps_tensor(amin, amax, valid).item())
    if n_old != n_new:
        raise AssertionError(f"old K5 counts {n_old}, new {n_new}")
    nbytes = 25 * amin.shape[0]
    n_sets = max(2, -(-3 * cs.L2_BYTES // nbytes))
    sets = [(amin, amax, valid)] + [
        (amin.clone(), amax.clone(), valid.clone())
        for _ in range(n_sets - 1)]
    t = turns({"old": k5_old, "new": ov.count_overlaps_tensor}, sets)
    cs.log(f"[random AABBs] K5, {amin.shape[0]} boxes ({n_new} pairs): old "
           f"{[round(x * 1e3, 2) for x in t['old']]} us, new "
           f"{[round(x * 1e3, 2) for x in t['new']]} us (L2-cold)")
    out["k5"]["random"] = dict(n=amin.shape[0], count=n_new, n_sets=n_sets,
                               old_ms=t["old"], new_ms=t["new"])
    print(json.dumps(out), flush=True)
    return 0


def solver_ab(args, cs) -> dict:
    """The segment sum, K2 and K3b of this checkout against those of each
    ``--old`` directory's ``solver_kernels.cu``, at the real step of
    ``mixed_pile(--n-bodies)`` landed for ``--steps`` steps
    (``chip_smoke.real_inputs``, the step's scatter plan):

    - ``segment_sum`` old and new on the terms of one fused K1 iteration
      and on those of one fused K2 iteration, into the bodies' deltas:
      equal to the bit, each timed as a CUDA-graph replay over rotating
      input copies that move at least three times the L2, in turns;
    - K2 as the kernel alone: the old ``ngs_kernel`` on gathered deltas
      (what the step launched before the fusion) against the new
      ``ngs_fused_kernel``, timed the same way;
    - one position iteration, old (gather, old ``ngs_kernel``,
      ``solver.index_sum``) against new (``ngs_fused_kernel``, new
      ``segment_sum``): deltas and errors equal to the bit; one call with
      its host work (CUDA events), in turns, and the device time of all
      its kernels (``torch.profiler``);
    - K3b alone, the old ``relvel_kernel`` on gathered velocities against
      the new ``relvel_fused_kernel`` (``relvel_fused``) reading them by
      index, L2-cold in turns; and one restitution outer pass, old (the
      gather, ``relvel_kernel``, the pass's glue in PyTorch, ``any`` read
      on the host) against new (``relvel_fused``, the flag read on the
      host): the rows' rhs and activity equal to the bit and the flag
      equal to ``any``, timed as the position iteration.

    The body velocities stand in for the position deltas, as in
    ``chip_smoke.check_fused``. Returns the times by directory."""
    import torch
    import edyn_tpu_torch as et
    from edyn_tpu_torch.config import CONTACT_POSITION_CORRECTION_RATE
    from edyn_tpu_torch.dynamics import scatter, solver
    from edyn_tpu_torch.dynamics import solver_kernels as sk
    from edyn_tpu_torch.dynamics.position import MAX_CORRECTION
    from edyn_tpu_torch.parallel.collectives import Mesh
    from edyn_tpu_torch.utils import cuda_lib
    from edyn_tpu_torch.utils.scenes import mixed_pile

    gpu = cs.gpu_line()
    cs.log(f"nvidia-smi: {gpu}")
    cuda_lib.build_libraries(["solver_kernels"], verbose=True)
    rate, mc = float(CONTACT_POSITION_CORRECTION_RATE), float(MAX_CORRECTION)
    dev = torch.device("cuda")
    world = et.make_world(mixed_pile(n_bodies=args.n_bodies, seed=0)[0],
                          device=dev)
    world.step_n(args.steps)
    inp, with_sr = cs.real_inputs(world)
    del world
    tbl, vel = inp["tbl"], inp["vel"]
    if tbl.dtype != torch.float32:
        raise TypeError("the earlier entries bound here are the float ones")
    C, Rp = tbl.shape
    mesh = Mesh((dev,))
    pack = solver.ShardPack.of_table(tbl, inp["ab"])
    plan = scatter.ScatterPlan.build([pack], inp["moves"], mesh)
    t, h = plan.shards[0], plan.hops[0]
    d0 = scatter.body_table(vel)

    def seg_new(terms, off, x):
        return sk.segment_sum(terms, off, x=x)

    def ngs_new(tbl, d, terms):
        return sk.ngs_iteration_fused(tbl, d, t.ab, t.pos, terms, terms, rate,
                                      mc)

    sk.solve_iteration_fused(tbl, inp["imp"], d0.clone(), t.ab, t.pos,
                             t.terms_a, t.terms_b, with_sr)
    k1_terms = t.terms_a.clone()
    ngs_new(tbl, d0.clone(), t.terms_a)
    k2_terms = t.terms_a.clone()
    ctx = SimpleNamespace(tbl=tbl, vel=vel, d0=d0, h=h, t=t, pack=pack,
                          plan=plan, mesh=mesh, k1_terms=k1_terms,
                          k2_terms=k2_terms)
    out = {"gpu": gpu, "Rp": Rp, "C": C, "N": vel.shape[0],
           "kept_terms": int(h.offsets[-1])}
    for old in args.old:
        path = cuda_lib.build_libraries(["solver_kernels"], verbose=True,
                                        src_dir=old)["solver_kernels"]
        lib = ctypes.CDLL(str(path))
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.edyn_segment_sum.argtypes = [P] * 5 + [I, P]
        lib.edyn_ngs_iteration.argtypes = [P, P, P, P, I, F, F, P]
        lib.edyn_relvel.argtypes = [P, P, P, I, P]

        def seg_old(terms, off, x, lib=lib):
            rc = lib.edyn_segment_sum(terms.data_ptr(), off.data_ptr(), None,
                                      x.data_ptr(), x.data_ptr(), x.shape[0],
                                      cuda_lib.stream(x))
            if rc:
                raise RuntimeError(f"old segment_sum launch failed ({rc})")
            return x

        def ngs_old(tbl, g, lib=lib):
            upd = torch.empty((12, Rp), dtype=tbl.dtype, device=tbl.device)
            err = torch.empty((1, Rp), dtype=tbl.dtype, device=tbl.device)
            rc = lib.edyn_ngs_iteration(tbl.data_ptr(), g.data_ptr(),
                                        upd.data_ptr(), err.data_ptr(), Rp,
                                        rate, mc, cuda_lib.stream(tbl))
            if rc:
                raise RuntimeError(f"old K2 launch failed ({rc})")
            return upd, err

        def relvel_old(tbl, g, lib=lib):
            out = torch.empty((1, Rp), dtype=tbl.dtype, device=tbl.device)
            rc = lib.edyn_relvel(tbl.data_ptr(), g.data_ptr(), out.data_ptr(),
                                 Rp, cuda_lib.stream(tbl))
            if rc:
                raise RuntimeError(f"old K3b launch failed ({rc})")
            return out

        out[old] = one_old(cs, ctx, seg_old, seg_new, ngs_old, ngs_new)
        out[old]["K3b"] = k3b_old_new(cs, ctx, relvel_old)
    return out


def k3b_old_new(cs, ctx, relvel_old) -> dict:
    """K3b against the earlier build's ``relvel_kernel`` on the inputs
    ``ctx`` (see ``solver_ab``)."""
    import torch
    from edyn_tpu_torch.dynamics import solver_kernels as sk
    tbl, vel, d0, t, pack, plan = (ctx.tbl, ctx.vel, ctx.d0, ctx.t, ctx.pack,
                                   ctx.plan)
    vel_t = vel.T.contiguous()
    dyn_buf = torch.empty((2, tbl.shape[1]), dtype=tbl.dtype,
                          device=tbl.device)

    def pass_old():
        relv = relvel_old(tbl, vel_t[:, pack.ab_p])
        valid, restit = tbl[55:56] > 0.5, tbl[56:57]
        active = valid & (relv < -0.005) & (restit > 0)
        dyn = torch.cat([-relv * (1.0 + restit), active.to(tbl.dtype)])
        return dyn, bool(torch.any(active))

    def pass_new():
        return cs.fused_pass(tbl, d0, t, plan, dyn_buf)

    (a, a_any), (b, b_any) = pass_old(), pass_new()
    if not (cs.bits_equal(a, b) and a_any == b_any):
        raise AssertionError("old and new restitution passes differ")
    g = vel_t[:, pack.ab_p].contiguous()
    # sized by the new kernel's bytes, the fewer: 13 table rows, endpoints
    k = n_sets(cs, tbl.element_size() * tbl.shape[1]
               * (sk.rows_read("relvel_fused") + 2) + 8 * tbl.shape[1])
    sets = [(tbl.clone(), g.clone(), d0.clone()) for _ in range(k)]
    gen = plan.next_generation()
    r = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        r[which].append(cs.device_ms(
            [lambda s=s: relvel_old(s[0], s[1]) for s in sets]
            if which == "old" else
            [lambda s=s: sk.relvel_fused(s[0], s[2], t.ab, t.flag, gen)
             for s in sets]))
    del sets
    calls = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        calls[which].append(cs.call_ms(pass_old if which == "old"
                                       else pass_new, 20))
    out = dict(n_sets=k, kernel_ms=r, any_active=a_any, pass_call_ms=calls,
               old_device_us=cs.profiled_us(pass_old),
               new_device_us=cs.profiled_us(pass_new))
    us = {w: [round(x * 1e3, 2) for x in r[w]] for w in r}
    cs.log(f"K3b alone, Rp {tbl.shape[1]}: old relvel_kernel {us['old']} "
           f"us, new relvel_fused_kernel {us['new']} us (L2-cold, {k} sets)")
    cs.log(f"one restitution outer pass: old (gather, relvel_kernel, glue, "
           f"any) {[round(x * 1e3, 1) for x in calls['old']]} us a call, "
           f"{out['old_device_us']} us on the device; new (relvel_fused, "
           f"flag read) {[round(x * 1e3, 1) for x in calls['new']]} us a "
           f"call, {out['new_device_us']} us on the device; bit-equal, a "
           f"row active: {a_any}")
    return out


def n_sets(cs, nbytes: int) -> int:
    """Input copies that together move at least three times the L2."""
    return max(2, -(-3 * cs.L2_BYTES // nbytes))


def one_old(cs, ctx, seg_old, seg_new, ngs_old, ngs_new) -> dict:
    """``solver_ab``'s comparisons against one earlier build, on the
    inputs ``ctx``."""
    from edyn_tpu_torch.dynamics import solver
    from edyn_tpu_torch.dynamics import solver_kernels as sk
    tbl, vel, d0, h, t = ctx.tbl, ctx.vel, ctx.d0, ctx.h, ctx.t
    pack, plan, mesh = ctx.pack, ctx.plan, ctx.mesh
    Rp = tbl.shape[1]

    def turns(fns) -> dict:
        """Old, new, new, old: each a CUDA-graph time over its rotating
        input sets (``fns[which]``: one call per set)."""
        r = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            r[which].append(cs.device_ms(fns[which]))
        return r

    out = {"segment_sum": {}}
    for label, terms in (("K1 terms", ctx.k1_terms),
                         ("K2 terms", ctx.k2_terms)):
        a = seg_old(terms, h.offsets, d0.clone())
        b = seg_new(terms, h.offsets, d0.clone())
        if not cs.bits_equal(a, b):
            raise AssertionError(f"[{label}] old and new segment_sum differ")
        k = n_sets(cs, terms.numel() * terms.element_size())
        sets = [(terms.clone(), h.offsets, d0.clone()) for _ in range(k)]
        r = turns({w: [lambda s=s, f=f: f(*s) for s in sets]
                   for w, f in (("old", seg_old), ("new", seg_new))})
        live = int((terms[:, :6] != 0).any(1).sum())
        out["segment_sum"][label] = dict(live_terms=live, n_sets=k, **r)
        cs.log(f"[{label}] segment_sum, {live} live of "
               f"{int(h.offsets[-1])} planned terms: old "
               f"{[round(x * 1e3, 2) for x in r['old']]} us, new "
               f"{[round(x * 1e3, 2) for x in r['new']]} us (L2-cold, "
               f"{k} input sets), bit-equal")
        del sets

    g = vel.T.contiguous()[:, pack.ab_p].contiguous()
    # sized by the bytes K2 moves (its 20 table rows, not the table's 97)
    k = n_sets(cs, tbl.element_size() * Rp
               * (sk.rows_read("ngs_iteration") + 1) + 8 * Rp)
    sets_old = [(tbl.clone(), g.clone()) for _ in range(k)]
    sets_new = [(s[0], d0.clone(), t.terms_a.clone()) for s in sets_old]
    r = turns({"old": [lambda s=s: ngs_old(*s) for s in sets_old],
               "new": [lambda s=s: ngs_new(*s) for s in sets_new]})
    del sets_old, sets_new
    out["ngs_kernel"] = dict(n_sets=k, **r)
    us = {w: [round(x * 1e3, 2) for x in r[w]] for w in r}
    cs.log(f"K2 alone, Rp {Rp}: old ngs_kernel {us['old']} us, new "
           f"ngs_fused_kernel {us['new']} us (L2-cold, {k} sets)")

    def iteration_old():
        x_t = vel.T.contiguous()
        upd, err = ngs_old(tbl, x_t[:, pack.ab_p])
        return err, solver.scatter_upd_t(x_t, pack.ab_p, upd).T

    def iteration_new():
        d = d0.clone()
        err = ngs_new(tbl, d, t.terms_a)
        return err, plan.add(d, mesh)[:, :6]

    (ea, xa), (eb, xb) = iteration_old(), iteration_new()
    if not (cs.bits_equal(ea, eb) and cs.bits_equal(xa.contiguous(),
                                                    xb.contiguous())):
        raise AssertionError("old and new position iterations differ")
    calls = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        fn = iteration_old if which == "old" else iteration_new
        calls[which].append(cs.call_ms(fn, 20))
    out["position_iteration"] = dict(
        call_ms=calls, old_device_us=cs.profiled_us(iteration_old),
        new_device_us=cs.profiled_us(iteration_new))
    cs.log(f"one position iteration: old (gather, ngs_kernel, index_sum) "
           f"{[round(x * 1e3, 1) for x in calls['old']]} us a call, "
           f"{out['position_iteration']['old_device_us']} us on the device; "
           f"new (ngs_fused_kernel, segment_sum) "
           f"{[round(x * 1e3, 1) for x in calls['new']]} us a call, "
           f"{out['position_iteration']['new_device_us']} us on the device; "
           "bit-equal")
    return out


if __name__ == "__main__":
    sys.exit(main())
