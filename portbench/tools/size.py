"""Find, on the card, the capacities and the sweep window a configuration
needs so that nothing grows and no window alarm rises over a long drop.

    python3 portbench/tools/size.py --bodies 65531 --mode sweep \
        --frames 420 --seeds 1 2

Steps ``mixed_pile(bodies)`` from the drop with generous capacities
(``--max-pairs``, growth on), one dense step first when the mode is
"sweep", and prints one JSON line per seed: the most admitted pairs and
contact points of any frame, the grown capacities, every frame's
overflow, the narrowest 192 x 2^k window that raises no alarm at every
``--every``-th frame, and ms per frame.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))


def window_for(st, meta, window: int) -> int:
    from edyn_tpu_torch.collision.broadphase import find_pairs_sweep
    W = window
    while find_pairs_sweep(st, meta.max_pairs, W, meta.wide_cap)[5]:
        if W >= st.capacity:
            return -1
        W *= 2
    return W


def size(bodies: int, mode: str, frames: int, seed: int, max_pairs: int,
         every: int, window: int, device: str = "cuda") -> dict:
    import torch
    import edyn_tpu_torch as et
    from harness import scene
    t0 = time.perf_counter()
    b, _ = scene.build(et, scene.mixed_pile(bodies, seed))
    w = et.make_world(b, et.Settings(), max_pairs=max_pairs, device=device)
    w.meta = dataclasses.replace(w.meta, max_rows=max_pairs,
                                 bucket_cap=max_pairs // 2)
    if mode == "sweep":
        w.meta = dataclasses.replace(w.meta, broadphase_mode="dense")
        w.step()
        w.meta = dataclasses.replace(w.meta, broadphase_mode="sweep",
                                     sweep_window=window)
    else:
        w.meta = dataclasses.replace(w.meta, broadphase_mode=mode)
    if device == "cuda":
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    out = dict(bodies=bodies, mode=mode, seed=seed, build_s=build_s,
               pairs=[], points=[], overflow_frames=[], windows=[],
               ms=[])
    for f in range(frames):
        ts = time.perf_counter()
        w.step()
        st = w.state
        ovf = st.overflow.cpu().tolist()
        out["ms"].append(1e3 * (time.perf_counter() - ts))
        out["pairs"].append(int(st.contacts.sort_pvalid.sum()))
        out["points"].append(int(st.contacts.point_valid.sum()))
        if any(ovf):
            out["overflow_frames"].append([f, ovf])
        if mode == "sweep" and f % every == every - 1:
            out["windows"].append([f, window_for(st, w.meta, 192)])
    m = w.meta
    out.update(max_pairs=m.max_pairs, max_rows=m.max_rows,
               bucket_cap=m.bucket_cap, sweep_window=m.sweep_window,
               most_pairs=max(out["pairs"]), most_points=max(out["points"]),
               asleep=int(w.state.asleep.sum()),
               peak_bytes=(torch.cuda.max_memory_allocated()
                           if device == "cuda" else None))
    ms = out.pop("ms")
    out["ms_per_frame_by_tenth"] = [
        sum(ms[i * frames // 10:(i + 1) * frames // 10])
        / max(1, frames // 10) for i in range(10)]
    out["pairs"] = out["pairs"][::every]
    out["points"] = out["points"][::every]
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bodies", type=int, default=10_000)
    ap.add_argument("--mode", default="dense")
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1])
    ap.add_argument("--max-pairs", type=int, default=None)
    ap.add_argument("--every", type=int, default=30)
    ap.add_argument("--window", type=int, default=3072)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    import torch
    if a.device == "cuda":
        print(json.dumps(dict(torch=torch.__version__, cuda=torch.version.cuda,
                              device=torch.cuda.get_device_name(0))),
              flush=True)
    for seed in a.seeds:
        mp = a.max_pairs or 24 * a.bodies
        print(json.dumps(size(a.bodies, a.mode, a.frames, seed, mp,
                              a.every, a.window, a.device)),
              flush=True)


if __name__ == "__main__":
    main()
