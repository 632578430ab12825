#!/usr/bin/env python3
"""Compile-time variants of K4's per-pair kernel and of K5, each timed
against the shipped build on the same inputs, in turns, in one process on
one card.

    python3 scripts/torch_kernel_variants.py

The variants are text substitutions of the current sources, built with the
same flags (``utils/cuda_lib.py``) from ``build/variants/<tag>/``:
- K4's ``unified_kernel`` asking for 3 or 2 resident blocks of 128 threads
  a SM instead of 4 (``__launch_bounds__``), which leaves the compiler more
  registers a thread and so fewer spills;
- K5's ``overlap_kernel`` with 2 or 8 i-boxes a thread instead of 4 (``R``).

Each variant's output must equal the shipped build's. Inputs as in
``chip_smoke.py``: 190,000 random pairs of the fresh 10k pile's side table
(rim axes on; the per-pair kernel alone, after the shipped pre-pass and pair
order) and 65,573 random AABBs. Each time is a CUDA-graph replay over
rotating input copies that move at least three times the L2 (shipped,
variant, variant, shipped). Prints each build's registers, stack and spills
(``nvcc -Xptxas -v``) and one JSON object as its last line.
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# source: (kernel, shipped text, {tag: variant text})
VARIANTS = {
    "unified_kernel": ("unified_kernel", "__launch_bounds__(THREADS, 4)", {
        "blocks3": "__launch_bounds__(THREADS, 3)",
        "blocks2": "__launch_bounds__(THREADS, 2)"}),
    "overlap_count": ("overlap_kernel", "constexpr int R = 4;", {
        "boxes2": "constexpr int R = 2;",
        "boxes8": "constexpr int R = 8;"}),
}


def variant_source(name: str, tag: str, shipped: str, text: str) -> Path:
    """build/variants/<tag>/ with ``name``.cu, ``shipped`` replaced by
    ``text``, and the headers beside it."""
    from edyn_tpu_torch.utils import cuda_lib
    src = (cuda_lib.CSRC / f"{name}.cu").read_text()
    if src.count(shipped) != 1:
        raise RuntimeError(f"{name}.cu does not hold {shipped!r} once")
    d = Path(ROOT) / "build" / "variants" / tag
    d.mkdir(parents=True, exist_ok=True)
    (d / f"{name}.cu").write_text(src.replace(shipped, text))
    for hdr in cuda_lib.CSRC.glob("*.cuh"):
        shutil.copy(hdr, d)
    return d


def bind(path, signatures: dict):
    lib = ctypes.CDLL(str(path))
    for fn_name, args in signatures.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import edyn_tpu_torch as et
    from edyn_tpu_torch.collision.kernels import unified_kernel as uk
    from edyn_tpu_torch.ops import overlap_count as ov
    from edyn_tpu_torch.utils import cuda_lib
    from edyn_tpu_torch.utils.scenes import mixed_pile

    gpu = cs.gpu_line()
    cs.log(f"nvidia-smi: {gpu}")
    sigs = {"unified_kernel": {"edyn_collide_support":
                               uk.SIGNATURES["edyn_collide_support"]},
            "overlap_count": ov.SIGNATURES}
    libs, builds = {}, {}   # {source: {tag: ...}}
    for name, (kernel, shipped, tags) in VARIANTS.items():
        libs[name], builds[name] = {}, {}
        dirs = {"shipped": cuda_lib.CSRC}
        dirs.update({tag: variant_source(name, tag, shipped, text)
                     for tag, text in tags.items()})
        for tag, d in dirs.items():
            cuda_lib.BUILD_LOGS.pop(name, None)
            path = cuda_lib.build_libraries([name], verbose=True,
                                           src_dir=d)[name]
            libs[name][tag] = bind(path, sigs[name])
            # empty when this process found the library built already
            builds[name][tag] = cs.build_info(name, kernel)
            cs.log(f"[build] {name} {tag}: {builds[name][tag]}")

    def turns(fns, sets) -> dict:
        t = {"shipped": [], "variant": []}
        for which in ("shipped", "variant", "variant", "shipped"):
            t[which].append(cs.device_ms([lambda s=s, f=fns[which]: f(s)
                                          for s in sets]))
        return t

    dev = torch.device("cuda")
    out = {"gpu": gpu, "k4": {}, "k5": {}}

    # K4's per-pair kernel on random pairs of the fresh pile
    world = et.make_world(mixed_pile(n_bodies=10_000, seed=0)[0],
                          device=dev)
    tbl, dims = uk.pack_side_table_t(world.state)
    ka, kb = cs.random_pairs(world.state.capacity, cs.K4_PAIRS, 2, dev)
    feat, code, ids = uk.world_features(tbl, dims)
    perm = uk.pair_order(code, ids, ka, kb)
    K = len(ka)
    nbytes = 4 * feat.numel() + 24 * K + 192 * K
    n_sets = max(2, -(-3 * cs.L2_BYTES // nbytes))
    sets = [dict(f=f, a=a, b=b, p=p, o=torch.empty((K, 48), device=dev))
            for f, a, b, p in [(feat, ka, kb, perm)] + [
                (feat.clone(), ka.clone(), kb.clone(), perm.clone())
                for _ in range(n_sets - 1)]]

    def k4(tag):
        fn = libs["unified_kernel"][tag].edyn_collide_support

        def call(s):
            rc = fn(s["f"].data_ptr(), *dims, s["a"].data_ptr(),
                    s["b"].data_ptr(), s["p"].data_ptr(), K, cs.THRESHOLD, 1,
                    s["o"].data_ptr(), cuda_lib.stream(s["f"]))
            if rc:
                raise RuntimeError(f"K4 {tag} launch failed ({rc})")
        return call

    k4("shipped")(sets[0])
    want = sets[0]["o"].clone()
    for tag in VARIANTS["unified_kernel"][2]:
        k4(tag)(sets[0])
        if not torch.equal(sets[0]["o"], want):
            raise AssertionError(f"K4 {tag} differs from the shipped build")
        t = turns({"shipped": k4("shipped"), "variant": k4(tag)}, sets)
        cs.log(f"[K4 per-pair kernel, {K} random pairs] {tag}: "
               f"{[round(x * 1e3, 2) for x in t['variant']]} us, shipped "
               f"{[round(x * 1e3, 2) for x in t['shipped']]} us (L2-cold, "
               f"{n_sets} input sets)")
        out["k4"][tag] = dict(pairs=K, n_sets=n_sets, ms=t["variant"],
                              shipped_ms=t["shipped"],
                              build=builds["unified_kernel"][tag])
    out["k4"]["shipped_build"] = builds["unified_kernel"]["shipped"]
    del world, tbl, feat, sets

    # K5 on random AABBs
    amin, amax, valid = cs.random_aabbs(65_573, 3, dev)
    n_sets = max(2, -(-3 * cs.L2_BYTES // (25 * amin.shape[0])))
    sets = [dict(lo=a, hi=b, v=v,
                 n=torch.empty((1,), dtype=torch.int64, device=dev))
            for a, b, v in [(amin, amax, valid)] + [
                (amin.clone(), amax.clone(), valid.clone())
                for _ in range(n_sets - 1)]]

    def k5(tag):
        fn = libs["overlap_count"][tag].edyn_count_overlaps

        def call(s):
            rc = fn(s["lo"].data_ptr(), s["hi"].data_ptr(),
                    s["v"].data_ptr(), s["lo"].shape[0], s["n"].data_ptr(),
                    cuda_lib.stream(s["n"]))
            if rc:
                raise RuntimeError(f"K5 {tag} launch failed ({rc})")
        return call

    k5("shipped")(sets[0])
    want = int(sets[0]["n"].item())
    for tag in VARIANTS["overlap_count"][2]:
        k5(tag)(sets[0])
        if int(sets[0]["n"].item()) != want:
            raise AssertionError(f"K5 {tag} counts otherwise")
        t = turns({"shipped": k5("shipped"), "variant": k5(tag)}, sets)
        cs.log(f"[K5, {amin.shape[0]} random boxes] {tag}: "
               f"{[round(x * 1e3, 2) for x in t['variant']]} us, shipped "
               f"{[round(x * 1e3, 2) for x in t['shipped']]} us (L2-cold, "
               f"{n_sets} input sets)")
        out["k5"][tag] = dict(n=amin.shape[0], count=want, n_sets=n_sets,
                              ms=t["variant"], shipped_ms=t["shipped"],
                              build=builds["overlap_count"][tag])
    out["k5"]["shipped_build"] = builds["overlap_count"]["shipped"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
