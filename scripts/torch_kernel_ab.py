#!/usr/bin/env python3
"""K4 and K5 against their first CUDA versions, in one process on one
card, timed in turns (old, new, new, old).

    python3 scripts/torch_kernel_ab.py --old <dir>

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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True,
                    help="directory with the earlier unified_kernel.cu and "
                         "overlap_count.cu")
    ap.add_argument("--n-bodies", type=int, default=10_000)
    ap.add_argument("--steps", type=int, default=120)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
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
                                         src_dir=args.old)
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


if __name__ == "__main__":
    sys.exit(main())
