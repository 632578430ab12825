#!/usr/bin/env python3
"""Which PyTorch operations of the port's contact stage give other bits on
the GPU than on the CPU, and where in the port they are called.

    python3 scripts/torch_device_diff.py

Steps ``mixed_pile(1000, seed=1)`` for 60 steps on the GPU (the pile is
landing), then runs the contact stage of the next step (AABBs to contact
rows, ``stepper.prepare_rows``) under a dispatch mode that repeats every
ATen operation on CPU copies of its inputs and compares the two results bit
for bit. Each operation is compared on the same inputs, so a difference is the
operation's own, not one carried in from an earlier operation. Prints, per
(operation, call site in ``edyn_tpu_torch``), the calls, the calls whose
result differs and the largest difference, most frequent first; then the
stage's end result on both devices (pair lists, contact points). Needs a
CUDA device. Writes ``chiprun_out/device_diff.json``.
"""
from __future__ import annotations

import collections
import json
import os
import sys
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BODIES, SETTLE = 1000, 60
# results with no defined value, or drawn at random
SKIP = ("empty", "empty_like", "empty_strided", "new_empty", "rand",
        "randn", "randint", "normal", "uniform", "bernoulli", "set_")


def _site() -> str:
    """The innermost frame of the port in the current stack."""
    for fr in reversed(traceback.extract_stack()):
        if "edyn_tpu_torch" in fr.filename:
            rel = fr.filename.split("edyn_tpu_torch" + os.sep, 1)[-1]
            return f"{rel}:{fr.lineno}"
    return "?"


def make_mode():
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves, tree_map

    def to_cpu(x):
        if isinstance(x, torch.Tensor) and x.is_cuda:
            return x.detach().cpu()
        if isinstance(x, torch.device) and x.type == "cuda":
            return torch.device("cpu")
        return x

    def differs(a, b):
        if a.dtype.is_floating_point:
            same = (a == b) | (torch.isnan(a) & torch.isnan(b))
            if bool(same.all()):
                return None
            d = (a.double() - b.double()).abs()
            d = torch.where(same, torch.zeros_like(d), d)
            return float(torch.nan_to_num(d, nan=float("inf")).max())
        return None if torch.equal(a, b) else float("nan")

    class DeviceDiff(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.stats = collections.defaultdict(
                lambda: {"calls": 0, "differ": 0, "max_abs": 0.0})

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func.overloadpacket.__name__
            on_card = any(isinstance(x, torch.Tensor) and x.is_cuda
                          for x in tree_leaves(args))
            if name in SKIP or not on_card:
                return func(*args, **kwargs)
            cargs = tree_map(to_cpu, args)
            ckw = tree_map(to_cpu, kwargs)
            out = func(*args, **kwargs)
            try:
                cout = func(*cargs, **ckw)
            except RuntimeError:
                return out
            outs = out if isinstance(out, (tuple, list)) else (out,)
            couts = cout if isinstance(cout, (tuple, list)) else (cout,)
            worst = None
            for a, b in zip(outs, couts):
                if isinstance(a, torch.Tensor) and a.shape == b.shape:
                    d = differs(a.detach().cpu(), b)
                    if d is not None:
                        worst = d if worst is None else max(worst, d)
            key = f"{func} @ {_site()}"
            s = self.stats[key]
            s["calls"] += 1
            if worst is not None:
                s["differ"] += 1
                if not worst <= s["max_abs"]:
                    s["max_abs"] = worst
            return out

    return DeviceDiff()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_device_diff: no CUDA device", file=sys.stderr)
        return 1
    import edyn_tpu_torch as et
    from edyn_tpu_torch.core.convert import state_from_numpy, state_to_numpy
    from edyn_tpu_torch.simulation import stepper
    from edyn_tpu_torch.utils.scenes import mixed_pile

    b, _ = mixed_pile(n_bodies=BODIES, seed=1)
    w = et.make_world(b, et.Settings(), device="cuda")
    w.step_n(SETTLE)
    tree = state_to_numpy(w.state)

    def fn(st):
        return stepper.prepare_rows(st, w.settings, w.meta)[1]

    mode = make_mode()
    with mode:
        mc = fn(state_from_numpy(tree, "cuda"))
    cpu = fn(state_from_numpy(tree, "cpu"))

    rows = sorted(({"op": k, **v} for k, v in mode.stats.items()
                   if v["differ"]), key=lambda r: -r["differ"])
    total = sum(v["calls"] for v in mode.stats.values())
    print(f"{total} operations traced, {len(rows)} (operation, site) keys "
          "with calls that differ:")
    for r in rows:
        print(f"  {r['differ']:5d}/{r['calls']:<5d} max {r['max_abs']:.3g}  "
              f"{r['op']}")

    live = cpu.valid & (cpu.point_valid.any(1) | mc.point_valid.cpu().any(1))
    same_pts = ((mc.point_valid.cpu() == cpu.point_valid).all(1)
                & ((mc.pivot_a.cpu() - cpu.pivot_a).abs().amax((1, 2))
                   < 1e-4))
    bitwise = {f: bool(torch.equal(getattr(mc, f).cpu(), getattr(cpu, f)))
               for f in ("key", "valid", "point_valid", "pivot_a",
                         "distance", "normal_impulse")}
    summary = {"bodies": BODIES, "settle": SETTLE,
               "ops_traced": total, "live_manifolds": int(live.sum()),
               "point_sets_differ": int((live & ~same_pts).sum()),
               "bitwise_equal": bitwise, "differing_ops": rows}
    print(f"live manifolds {summary['live_manifolds']}, point sets that "
          f"differ {summary['point_sets_differ']}, bitwise equal {bitwise}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "device_diff.json"),
              "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
