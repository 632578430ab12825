#!/usr/bin/env python3
"""How far one step of a ``mixed_pile`` (or ``rich_scene``) moves when every
body position (and orientation) is nudged by one float32 ulp, in either
package.

    JAX_PLATFORMS=cpu python3 scripts/ulp_sensitivity.py --package jax
    python3 scripts/ulp_sensitivity.py --package torch --device cpu
    python3 scripts/ulp_sensitivity.py --package torch --device cpu \
        --settle-device cuda --scene terrain --orn

Builds ``mixed_pile(1000, seed=1)``, steps it 60 steps (landing) and 240
(settled), and from each state takes one step and four more from copies
whose body positions were each moved one ulp up or down at random; with
``--orn``, four more whose orientations were. ``--scene terrain`` builds
``rich_scene(512)`` and takes the settled state only. The port may settle
on another device (``--settle-device``) and take the steps on
``--device``. Reports, per trial, the bodies whose pos, orn or linvel moved past the whole-step
tolerances of ``tests/test_torch_step.py`` (pos and orn rtol 1e-3 / atol
2e-3, linvel rtol 1e-3 / atol 5e-3), the largest changes, the manifolds
whose contact point set changed, and the deepest contact point that one of
the two steps keeps and the other drops. The JAX package steps with its
jitted step, the port with its own on ``--device``. Only the chosen package
is imported. Prints one JSON object per state.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

BODIES, SEED, SETTLE, TRIALS = 1000, 1, (60, 240), 4
TERRAIN_BODIES = 512
TOL = (("pos", 1e-3, 2e-3), ("orn", 1e-3, 2e-3), ("linvel", 1e-3, 5e-3))


def _package(name: str, device: str, scene: str, settle_device: str):
    """(world factory, one-step function, to-numpy, field replacer,
    state mover to the trial device)."""
    import numpy as np
    if name == "jax":
        import jax.numpy as jnp
        import edyn_tpu as et
        from edyn_tpu.simulation.stepper import physics_step
        from edyn_tpu.utils.scenes import mixed_pile, rich_scene

        def world():
            b = (rich_scene(n_bodies=TERRAIN_BODIES)[0] if scene == "terrain"
                 else mixed_pile(n_bodies=BODIES, seed=SEED)[0])
            return et.make_world(b)
        return (world, physics_step, np.asarray,
                lambda st, f, v: dataclasses.replace(
                    st, **{f: jnp.asarray(v)}), lambda st: st)
    import torch
    import edyn_tpu_torch as et
    from edyn_tpu_torch.core.convert import state_from_numpy, state_to_numpy
    from edyn_tpu_torch.simulation.stepper import physics_step
    from edyn_tpu_torch.utils.scenes import mixed_pile, rich_scene

    def world():
        b = (rich_scene(n_bodies=TERRAIN_BODIES)[0] if scene == "terrain"
             else mixed_pile(n_bodies=BODIES, seed=SEED)[0])
        return et.make_world(b, device=settle_device)
    return (world, physics_step, lambda x: x.cpu().numpy(),
            lambda st, f, v: dataclasses.replace(
                st, **{f: torch.as_tensor(v, device=st.pos.device)}),
            lambda st: state_from_numpy(state_to_numpy(st), device))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--device", default="cuda",
                    help="the port's device for the trial steps")
    ap.add_argument("--settle-device", default=None,
                    help="the port's device for settling (default: "
                         "--device)")
    ap.add_argument("--scene", choices=("pile", "terrain"), default="pile")
    ap.add_argument("--orn", action="store_true",
                    help="also nudge the orientations")
    a = ap.parse_args()
    import numpy as np

    make, step, host, with_field, move = _package(
        a.package, a.device, a.scene, a.settle_device or a.device)
    w = make()
    done = 0
    settles = (240,) if a.scene == "terrain" else SETTLE
    fields = ("pos", "orn") if a.orn else ("pos",)
    for settle in settles:
        w.step(settle - done)
        done = settle
        start = move(w.state)
        t0 = time.perf_counter()
        base = step(start, w.settings, w.meta)
        want = {f: host(getattr(base, f)) for f, _, _ in TOL}
        bm = base.contacts
        b_pv, b_d = host(bm.point_valid), host(bm.distance)
        trials = []
        for field in fields:
            val = host(getattr(start, field))
            for k in range(TRIALS):
                rise = np.random.default_rng(k).random(val.shape) < 0.5
                nudged = np.where(rise,
                                  np.nextafter(val, np.float32(np.inf)),
                                  np.nextafter(val, np.float32(-np.inf)))
                alt = step(with_field(start, field,
                                      nudged.astype(np.float32)),
                           w.settings, w.meta)
                moved = np.zeros(len(val), bool)
                worst = {}
                for f, rtol, atol in TOL:
                    d = np.abs(host(getattr(alt, f)) - want[f])
                    moved |= (d > atol + rtol * np.abs(want[f])).any(-1)
                    worst[f] = float(d.max())
                a_pv, a_d = host(alt.contacts.point_valid), host(
                    alt.contacts.distance)
                changed = (a_pv != b_pv).any(-1)
                # a slot's point set may be reordered: a dropped contact is
                # a manifold whose deepest valid point differs by > 1 mm
                deep_b = np.where(b_pv, b_d, np.inf).min(-1)
                deep_a = np.where(a_pv, a_d, np.inf).min(-1)
                gone = np.abs(np.minimum(deep_a, 1.0)
                              - np.minimum(deep_b, 1.0))
                i = int(np.argmax(gone))
                trials.append(dict(
                    nudged=field, seed=k,
                    bodies_past_tol=int(moved.sum()),
                    bodies_past_tol_ids=np.nonzero(moved)[0][:20].tolist(),
                    max_abs=worst,
                    manifolds_point_set_changed=int(changed.sum()),
                    deepest_change_m=float(gone[i]),
                    deepest_change_slot=i,
                    deepest_change=[float(deep_b[i]), float(deep_a[i])]))
        print(json.dumps({
            "package": a.package, "scene": a.scene,
            "bodies": TERRAIN_BODIES if a.scene == "terrain" else BODIES,
            "seed": None if a.scene == "terrain" else SEED,
            "settle": settle, "device": a.device,
            "settle_device": a.settle_device or a.device,
            "live_manifolds": int(b_pv.any(-1).sum()),
            "seconds": time.perf_counter() - t0, "trials": trials}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
