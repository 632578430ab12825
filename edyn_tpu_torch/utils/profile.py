"""Observability: per-phase timers and world counters (counterpart of
``edyn_tpu/utils/profile.py``).

Reference: the EDYN_PROFILE_* macro timers writing profile_timers /
profile_counters ctx structs (util/profile_util.hpp:10-27,
context/profile.hpp:8-27). ``profile_step`` runs one step's phases one by
one, synchronising the device before and after each (a diagnosis mode, not
the hot path), under the JAX package's phase names; counters are computed
from the state on demand. ``scripts/torch_step_profile.py`` is the fuller
tool: every phase and bucket inside the stepper, and the device's busy
share under ``torch.profiler``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass
class ProfileTimers:
    """reference: context/profile.hpp profile_timers."""
    broadphase: float = 0.0
    narrowphase: float = 0.0
    islands: float = 0.0
    restitution: float = 0.0
    prepare_constraints: float = 0.0
    solve: float = 0.0
    position_correction: float = 0.0
    step: float = 0.0


@dataclasses.dataclass
class ProfileCounters:
    """reference: context/profile.hpp profile_counters."""
    num_bodies: int = 0
    num_awake: int = 0
    num_manifolds: int = 0
    num_contact_points: int = 0
    num_constraints: int = 0
    num_islands: int = 0
    # capacity-overflow counters from the last step (0 = nothing truncated)
    dropped_broadphase_pairs: int = 0
    dropped_narrowphase_candidates: int = 0
    dropped_contact_rows: int = 0
    broadphase_window_alarms: int = 0
    dropped_manifold_slots: int = 0


def counters(state) -> ProfileCounters:
    host = lambda t: t.cpu().numpy()
    valid = host(state.valid)
    dyn = host(state.is_dynamic)
    asleep = host(state.asleep)
    labels = host(state.island_id)[dyn & valid]
    ovf = host(state.overflow)
    return ProfileCounters(
        num_bodies=int(valid.sum()),
        num_awake=int((dyn & ~asleep).sum()),
        num_manifolds=int(host(state.contacts.valid).sum()),
        num_contact_points=int(host(state.contacts.point_valid).sum()),
        num_constraints=int(host(state.joints.valid).sum()),
        num_islands=len(np.unique(labels)) if len(labels) else 0,
        dropped_broadphase_pairs=int(ovf[0]),
        dropped_narrowphase_candidates=int(ovf[1]),
        dropped_contact_rows=int(ovf[2]),
        broadphase_window_alarms=int(ovf[3]),
        dropped_manifold_slots=int(ovf[4]) if ovf.shape[0] > 4 else 0,
    )


def profile_step(world, repeats: int = 3) -> Dict[str, float]:
    """Run one step phase by phase and time each (ms, the mean of
    ``repeats`` calls after one untimed call), then the whole step
    (``full_step``)."""
    from ..collision.manifold import update_slots
    from ..collision.narrowphase import update_contacts
    from ..config import PAIR_SEPARATION_MARGIN
    from ..dynamics import islands as im
    from ..dynamics import scatter
    from ..dynamics import solver as sm
    from ..dynamics import solver_kernels as sk
    from ..dynamics.position import solve_positions_sharded
    from ..parallel.collectives import Mesh
    from ..shapes.aabb import compute_aabbs
    from ..simulation.stepper import broadphase, physics_step

    st = world.state
    meta = world.meta
    S = world.settings
    dev = st.device
    out = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(name, fn, *args):
        res = fn(*args)
        sync()
        t0 = time.perf_counter()
        for _ in range(repeats):
            res = fn(*args)
        sync()
        out[name] = (time.perf_counter() - t0) / repeats * 1e3
        return res

    amin, amax = timed("aabbs", lambda s: compute_aabbs(
        s.shape_type, s.origin_pos(), s.orn, s.convex, s.shape_index,
        s.mesh), st)
    swept = st.linvel * S.fixed_dt
    tmin = amin + torch.clamp(swept, max=0.0)
    tmax = amax + torch.clamp(swept, min=0.0)
    esc = torch.any((tmin < st.bp_aabb_min) | (tmax > st.bp_aabb_max),
                    dim=-1)[:, None]
    st = dataclasses.replace(
        st, aabb_min=amin, aabb_max=amax,
        bp_aabb_min=torch.where(esc, tmin - PAIR_SEPARATION_MARGIN,
                                st.bp_aabb_min),
        bp_aabb_max=torch.where(esc, tmax + PAIR_SEPARATION_MARGIN,
                                st.bp_aabb_max))
    keys, pa, pb, pv, _, _ = timed("broadphase",
                                   lambda s: broadphase(s, meta), st)
    man, _, _, _ = timed("manifold_carry", update_slots, st.contacts, keys,
                         pa, pb, pv)
    man, _ = timed("narrowphase", lambda s, m: update_contacts(
        s, m, S.collision_threshold, meta.types_present, meta.bucket_cap,
        S.fixed_dt, S.mesh_triangle_cull), st, man)
    st = timed("islands", lambda s, m: im.update_sleep(
        s, m, S.fixed_dt, S.enable_sleeping, meta.island_iters), st, man)
    rows = timed("prepare_constraints", lambda s, m: sm.build_contact_rows(
        s, m, S.fixed_dt, S.num_restitution_iterations > 0,
        S.mass_splitting, meta.has_spin_roll, meta.max_rows), st, man)
    tbl, a_p, b_p, Rp = sk.pack_rows_t(rows)
    ab_p = torch.cat([a_p, b_p])
    # the step's solve path: fused over a scatter plan on the card
    mesh = Mesh((dev,))
    packs = [sm.ShardPack.of_table(tbl, ab_p)]
    plan = scatter.for_step(st, packs, mesh)
    if S.num_restitution_iterations > 0:
        timed("restitution", lambda s: sm.solve_restitution_sharded(
            s, packs, mesh, S.num_restitution_iterations,
            S.num_individual_restitution_iterations, plan), st)

    def vel():
        imp_t = torch.zeros((6, Rp), dtype=tbl.dtype, device=dev)
        dvw = torch.zeros((st.capacity, 6), dtype=tbl.dtype, device=dev)
        return sm.solve_velocities(packs, [imp_t], dvw, rows.sA_n is not None,
                                   mesh, S.num_solver_velocity_iterations,
                                   plan)[1]

    timed("solve", vel)
    timed("position_correction", lambda s: solve_positions_sharded(
        s, packs, mesh, S.num_solver_position_iterations, plan), st)

    s0 = physics_step(world.state, S, meta)
    sync()
    t0 = time.perf_counter()
    for _ in range(repeats):
        s0 = physics_step(s0, S, meta)
    sync()
    out["full_step"] = (time.perf_counter() - t0) / repeats * 1e3
    return out
