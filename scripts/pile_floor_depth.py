#!/usr/bin/env python3
"""How deep the bodies of a falling ``mixed_pile``, ragdoll pile or
``rich_scene`` sink into the floor, in either package, step by step.

    JAX_PLATFORMS=cpu python3 scripts/pile_floor_depth.py --package jax \\
        --bodies 2000 --steps 120
    python3 scripts/pile_floor_depth.py --package torch --device cpu \\
        --bodies 2000 --steps 120
    JAX_PLATFORMS=cpu python3 scripts/pile_floor_depth.py --package jax \\
        --ragdolls 48 --steps 120
    JAX_PLATFORMS=cpu python3 scripts/pile_floor_depth.py --package jax \\
        --scene terrain --bodies 10000 --seed 0

Builds ``mixed_pile(--bodies, seed=--seed)`` with the Settings defaults
(or, with ``--ragdolls``, ``chip_smoke.ragdoll_pile`` of that many
ragdolls, with ``chip_smoke.ragdoll_settings`` in the port and the
defaults in the JAX package; or, with ``--scene terrain``,
``rich_scene(--bodies, seed=--seed)``, whose floor is its trimesh terrain:
there the depth is each dynamic body centre's height above the terrain
surface at its (x, z), ``chip_smoke.terrain_clearance``) and steps it one
step at a time, growing the
world after any step that dropped pairs (the port's policy; the JAX
package's own ``step`` checks every 16th step only). After each step it prints the lowest body centre, the lowest
body top (AABB) and the median centre of the dynamic bodies; the last line
is one JSON object with the per-step lowest centres. Only the chosen
package is imported, so the two runs are separate processes.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _world(package: str, n_bodies: int, seed: int, device: str,
           ragdolls: int = 0, scene: str = "pile"):
    if scene == "terrain":
        if package == "jax":
            import edyn_tpu as et
            from edyn_tpu.utils.scenes import rich_scene
            return et.make_world(rich_scene(n_bodies=n_bodies, seed=seed)[0])
        import edyn_tpu_torch as et
        from edyn_tpu_torch.utils.scenes import rich_scene
        return et.make_world(rich_scene(n_bodies=n_bodies, seed=seed)[0],
                             device=device)
    if ragdolls:
        from chip_smoke import ragdoll_pile
        if package == "jax":
            import edyn_tpu as et
            return et.make_world(ragdoll_pile(et, ragdolls, seed)[0])
        import edyn_tpu_torch as et
        from chip_smoke import ragdoll_settings
        return et.make_world(ragdoll_pile(et, ragdolls, seed)[0],
                             ragdoll_settings(), device=device)
    if package == "jax":
        import edyn_tpu as et
        from edyn_tpu.utils.scenes import mixed_pile
        b, _ = mixed_pile(n_bodies=n_bodies, seed=seed)
        return et.make_world(b)
    import edyn_tpu_torch as et
    from edyn_tpu_torch.utils.scenes import mixed_pile
    b, _ = mixed_pile(n_bodies=n_bodies, seed=seed)
    return et.make_world(b, device=device)


def _host(x):
    return x.cpu().numpy() if hasattr(x, "cpu") else __import__(
        "numpy").asarray(x)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--bodies", type=int, default=2000)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ragdolls", type=int, default=0,
                    help="a ragdoll pile of this many ragdolls instead")
    ap.add_argument("--device", default="cuda",
                    help="the port's device (torch only)")
    ap.add_argument("--scene", choices=("pile", "terrain"), default="pile",
                    help="terrain: rich_scene, depth under its terrain")
    a = ap.parse_args()
    import numpy as np
    import torch

    w = _world(a.package, a.bodies, a.seed, a.device, a.ragdolls, a.scene)
    if a.scene == "terrain":
        import importlib
        from chip_smoke import terrain_clearance
        scenes = importlib.import_module(
            ("edyn_tpu" if a.package == "jax" else "edyn_tpu_torch")
            + ".utils.scenes")
        clearance = terrain_clearance(scenes.rich_scene(
            n_bodies=a.bodies, seed=a.seed)[0].defs[0].shape, "cpu")
    t0 = time.perf_counter()
    lowest = []
    for i in range(a.steps):
        w.step(1)
        w._maybe_grow()
        st = w.state
        dyn = _host(st.is_dynamic)
        y = _host(st.pos)[dyn][:, 1]
        if a.scene == "terrain":
            y = clearance(torch.from_numpy(_host(st.pos)[dyn])).numpy()
        top = _host(st.aabb_max)[dyn][:, 1]
        lowest.append(float(y.min()))
        print(f"step {i + 1}: lowest centre {y.min():.5f}, lowest top "
              f"{top.min():.5f}, median centre {np.median(y):.5f}, "
              f"centres below 0: {int((y < 0).sum())}, max_pairs "
              f"{w.meta.max_pairs}", flush=True)
    print(json.dumps({"package": a.package, "bodies": a.bodies,
                      "ragdolls": a.ragdolls, "scene": a.scene,
                      "seed": a.seed, "steps": a.steps,
                      "seconds": time.perf_counter() - t0,
                      "lowest_centre": min(lowest),
                      "lowest_centre_final": lowest[-1],
                      "lowest_centre_per_step": lowest}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
