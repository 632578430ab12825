#!/usr/bin/env python3
"""Where a networked server's ``update()`` time goes, on one GPU.

    python3 scripts/torch_network_profile.py

Builds the port's kernels, then runs ``chip_smoke.py``'s phase 11
(``networked_path``: the landed 10k pile served to a spectator and a
player over byte channels) with timers around the parts of
``NetworkServer.update()``: the temporary-ownership check
(``_allowed_entities``), the snapshot imports (``apply_snapshot``), the
interest updates (``InterestState.update``), the snapshot exports
(``extract_snapshot``) and the encoding and sending of its packets (the
channels' ``send``). Each timer synchronises the device at both ends and
counts only while ``update()`` runs. Needs a CUDA device; prints one JSON
line: ms per frame of each part, of ``update()`` in all, and the calls.
"""
from __future__ import annotations

import collections
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_network_profile: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from edyn_tpu_torch.networking import interest, server
    from edyn_tpu_torch.utils import cuda_lib

    cuda_lib.build_libraries(chip_smoke.SOURCES)
    total = collections.defaultdict(float)
    calls = collections.Counter()
    inside = [False]

    def timed(name, fn, always=False):
        def wrapper(*a, **k):
            if not (inside[0] or always):
                return fn(*a, **k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if always:
                inside[0] = True
            try:
                return fn(*a, **k)
            finally:
                if always:
                    inside[0] = False
                torch.cuda.synchronize()
                total[name] += time.perf_counter() - t0
                calls[name] += 1
        return wrapper

    patches = [
        (server.NetworkServer, "update", "update() in all", True),
        (server.NetworkServer, "_allowed_entities", "ownership check",
         False),
        (server, "apply_snapshot", "snapshot import", False),
        (interest.InterestState, "update", "interest", False),
        (server, "extract_snapshot", "snapshot export", False),
        (chip_smoke.NetChannel, "send", "encode and send", False),
    ]
    saved = [(owner, attr, getattr(owner, attr))
             for owner, attr, _, _ in patches]
    for owner, attr, name, always in patches:
        setattr(owner, attr, timed(name, getattr(owner, attr), always))
    try:
        out, _ = chip_smoke.networked_path(torch.device("cuda"))
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    frames = out["server"]["frames"]
    print(json.dumps({
        "gpu": chip_smoke.gpu_line(), "frames": frames,
        "ms_per_frame": {k: 1e3 * v / frames for k, v in total.items()},
        "calls": dict(calls), "server": out["server"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
