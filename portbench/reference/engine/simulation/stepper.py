"""The fixed-dt simulation step (counterpart of
``edyn_tpu/simulation/stepper.py``; reference:
stepper_sequential.cpp:28-152, solver.cpp:387-468). Phase order:

  AABBs -> broadphase (or the pair-list carry) -> manifold slots ->
  narrowphase -> islands & sleep -> contact rows -> solve phase
  (restitution -> gravity -> rhs refresh -> joint rows -> warm start ->
  velocity iterations, each followed by the joint solve -> impulse
  writeback -> integrate -> position iterations -> joint positions)

The reference's copy steps the point, cone and hinge joints
(``constraints.joints.STEPPED``); ``physics_step`` refuses a world with
any other type.

PyTorch runs eagerly, so each device-side branch of the JAX step
(``lax.cond`` / ``while_loop``) is a host-synced Python branch here; each
site says so where it is taken.

The step runs over a mesh of devices (``parallel.Mesh``):
``SceneMeta.shard_mesh`` when set, else one shard on the state's device
(the reference's case). The dense broadphase's mask rows, the
narrowphase's manifold slots and the contact rows split into the shards'
contiguous ranges, each shard's kernels (K4, K3b, K3a, K1, K2) run on its
device, and every body-space sum is an ordered chain over the shards
(``solver.chain_index_sum``), so the result is the same, bit for bit, for
any number of shards. The rest (AABBs, the sweep and the pair-list carry,
manifold slots, islands, integration) runs on the home device,
shard 0's, where the state lives.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import torch

from ..collision.broadphase import (
    DENSE_LIMIT, decode_keys, find_pairs, find_pairs_sweep,
)
from ..collision.manifold import set_drop, update_slots
from ..collision.narrowphase import update_contacts_sharded
from ..config import PAIR_SEPARATION_MARGIN, Settings
from ..constraints import joints as joints_mod
from ..dynamics import islands as islands_mod
from ..dynamics import solver as solver_mod
from ..dynamics import solver_kernels as sk
from ..dynamics.position import solve_positions_sharded
from ..math import quat
from ..parallel.collectives import Mesh, gather, ranges
from ..shapes.aabb import compute_aabbs
from ..shapes.params import ShapeType


@dataclasses.dataclass(frozen=True)
class SceneMeta:
    """Static scene facts and padded capacities (field meanings as in
    ``edyn_tpu.SceneMeta``; the kernel-selection flags have no counterpart:
    the tensors' device selects the kernel)."""
    types_present: frozenset
    max_pairs: int
    bucket_cap: int | None = None
    island_iters: int = 4
    # "auto": dense up to DENSE_LIMIT bodies, sweep above (the JAX
    # package's rule); "dense"; "sweep" (find_pairs_sweep, sweep_window
    # bodies a window)
    broadphase_mode: str = "auto"
    sweep_window: int = 192
    wide_cap: int = 64
    max_rows: int | None = None
    has_spin_roll: bool = True
    has_joints: bool = False
    # a superset of the valid joints' types (the joint passes skip the rest)
    joint_types: frozenset = frozenset()
    sleep_gating: bool = True
    # optional user pair filter fn(state, i_idx, j_idx) -> bool tensor on
    # broadcastable index tensors, ANDed into the broadphase masks
    # (reference: settings.should_collide_func); it may read any state, so
    # it turns the pair-list carry off
    should_collide_fn: object = None
    # multi-device: the ``parallel.Mesh`` the step runs sharded over (set
    # by make_sharded_step; None: one shard on the state's device)
    shard_mesh: object = None


def apply_gravity(state, dt: float):
    """reference: include/edyn/sys/apply_gravity.hpp:12."""
    active = state.awake_dynamic
    linvel = torch.where(active[:, None], state.linvel + state.gravity * dt,
                         state.linvel)
    return dataclasses.replace(state, linvel=linvel)


def integrate_velocities(state, dv, dw, dt: float):
    """Apply solver deltas and integrate transforms (reference:
    island_solver.cpp:358-376)."""
    active = state.awake_dynamic
    linvel = torch.where(active[:, None], state.linvel + dv, state.linvel)
    angvel = torch.where(active[:, None], state.angvel + dw, state.angvel)
    moving = active | (state.is_kinematic & state.valid)
    pos = torch.where(moving[:, None], state.pos + linvel * dt, state.pos)
    orn = torch.where(moving[:, None], quat.integrate(state.orn, angvel, dt),
                      state.orn)
    return dataclasses.replace(state, linvel=linvel, angvel=angvel, pos=pos,
                               orn=orn)


def step_mesh(state, meta: SceneMeta) -> Mesh:
    """The mesh a step runs over: ``meta.shard_mesh``, else one shard on
    the state's device."""
    return meta.shard_mesh or Mesh((state.device,))


def broadphase(state, meta: SceneMeta):
    """The pair list of ``meta.broadphase_mode`` (stepper.py:326-340 in the
    JAX package): (keys, body_a, body_b, valid, dropped, window alarms).
    The dense mask is built by the shards of the step's mesh
    (``find_pairs``); the sweep runs on the home device."""
    mode = meta.broadphase_mode
    if mode == "auto":
        mode = "dense" if state.capacity <= DENSE_LIMIT else "sweep"
    if mode == "sweep":
        return find_pairs_sweep(state, meta.max_pairs, meta.sweep_window,
                                meta.wide_cap, meta.should_collide_fn)
    if mode != "dense":
        raise ValueError(f"broadphase_mode {mode!r}: auto, dense or sweep")
    return find_pairs(state, meta.max_pairs, meta.wide_cap,
                      meta.should_collide_fn, step_mesh(state, meta)) + (0,)


def prepare_rows(state, settings: Settings, meta: SceneMeta):
    """The step up to the contact rows: AABBs, broadphase, manifolds,
    narrowphase, islands and row building. Returns (state, man, rows,
    counters) where counters = (broadphase pairs dropped, narrowphase
    candidates dropped, manifold slots dropped, sweep window alarms)."""
    state, man, counters = prepare_contacts(state, settings, meta)
    rows = solver_mod.build_contact_rows(
        state, man, settings.fixed_dt, settings.num_restitution_iterations > 0,
        settings.mass_splitting, meta.has_spin_roll, meta.max_rows)
    return state, man, rows, counters


def prepare_contacts(state, settings: Settings, meta: SceneMeta):
    """``prepare_rows`` without the rows: (state, man, counters). The dense
    broadphase and the narrowphase run over the step's mesh."""
    dt = settings.fixed_dt
    amin, amax = compute_aabbs(state.shape_type, state.origin_pos(),
                               state.orn, state.convex, state.shape_index,
                               state.mesh)
    # carried pair-admission boxes: re-seated (swept tight box + margin)
    # only when the swept tight box escapes them
    swept = state.linvel * dt
    tmin = amin + torch.clamp(swept, max=0.0)
    tmax = amax + torch.clamp(swept, min=0.0)
    escaped = torch.any((tmin < state.bp_aabb_min)
                        | (tmax > state.bp_aabb_max), dim=-1)
    bp_min = torch.where(escaped[:, None], tmin - PAIR_SEPARATION_MARGIN,
                         state.bp_aabb_min)
    bp_max = torch.where(escaped[:, None], tmax + PAIR_SEPARATION_MARGIN,
                         state.bp_aabb_max)
    state = dataclasses.replace(state, aabb_min=amin, aabb_max=amax,
                                bp_aabb_min=bp_min, bp_aabb_max=bp_max)

    # pair-list carry: when no valid body's box re-seated, last step's
    # sorted pair list is what find_pairs would emit. Reused only when the
    # last step dropped no pair: a truncated list must be recomputed so the
    # drop keeps being reported until the world grows (unlike the JAX
    # package, whose carry reports 0 and so never grows). A user pair
    # filter turns the carry off (stepper.py:350-354 in the JAX package).
    # device branch (stepper.py:367 in the JAX package): host-synced here
    validb = state.valid & (state.shape_type != ShapeType.NONE)
    can_reuse = (meta.should_collide_fn is None
                 and bool(state.bp_carry_ok)
                 and not bool(torch.any(escaped & validb))
                 and int(state.overflow[0]) == 0)
    P = meta.max_pairs
    if can_reuse:
        keys = state.contacts.sort_key[:P]
        pvalid = state.contacts.sort_pvalid[:P]
        _, pa, pb = decode_keys(keys, state.capacity)
        bp_dropped = bp_alarms = 0
    else:
        keys, pa, pb, pvalid, bp_dropped, bp_alarms = broadphase(
            state, meta)
    state = dataclasses.replace(
        state, bp_carry_ok=torch.tensor(True, device=state.device))

    old = state.contacts
    man, edge_dropped, man_dropped, pairs_same = update_slots(
        old, keys, pa, pb, pvalid)
    # bodies whose near-contact manifold was destroyed must wake
    edge_wake = edge_dropped & torch.any(old.point_valid, -1)
    wake_bodies = torch.zeros((state.capacity,), dtype=torch.bool,
                              device=state.device)
    wake_bodies[old.body_a[edge_wake].long()] = True
    wake_bodies[old.body_b[edge_wake].long()] = True
    man, np_dropped = update_contacts_sharded(
        state, man, settings.collision_threshold, meta.types_present,
        meta.bucket_cap, dt, settings.mesh_triangle_cull,
        step_mesh(state, meta))

    # steady-state island skip: unchanged pair list and pointed mask for
    # >= 2*RESET_PERIOD steps
    pointed = man.valid & torch.any(man.point_valid, -1)
    steady = pairs_same and bool(torch.all(pointed == state.edge_pointed))
    stable_steps = (state.island_stable_steps + 1 if steady
                    else torch.zeros_like(state.island_stable_steps))
    state = dataclasses.replace(state, contacts=man, edge_pointed=pointed,
                                island_stable_steps=stable_steps)
    skip_labels = int(stable_steps) >= 2 * islands_mod.RESET_PERIOD
    state = islands_mod.update_sleep(state, man, dt, settings.enable_sleeping,
                                     meta.island_iters,
                                     wake_bodies=wake_bodies,
                                     skip_labels=skip_labels)
    return state, man, (bp_dropped, np_dropped, man_dropped, bp_alarms)


def solve_width(rows, meta: SceneMeta) -> int:
    """The sleep-gating ladder: the narrowest of R/8, 3R/4 and R (rounded up
    to 256, or to 256 x the shards under a mesh: stepper.py:431-432 in the
    JAX package) that holds the live rows. Numbers are identical in every tier. Device
    branch (stepper.py:452 in the JAX package): host-synced."""
    Rfull = rows.valid.shape[0]
    if not (meta.sleep_gating and meta.max_rows is not None):
        return Rfull
    quantum = 256 * (1 if meta.shard_mesh is None
                     else meta.shard_mesh.size)
    for num, den in ((1, 8), (3, 4)):
        Rs = max(quantum, -(-(Rfull * num // den) // quantum) * quantum)
        if Rs < Rfull and rows.count <= Rs:
            return Rs
    return Rfull


def physics_step(state, settings: Settings, meta: SceneMeta):
    """One fixed-dt step of the whole world, over ``meta.shard_mesh`` when
    it is set (the state then lives on its home device) and else as one
    shard on the state's device."""
    if meta.has_joints and not meta.joint_types <= joints_mod.STEPPED:
        raise ValueError("the reference steps the point, cone and hinge "
                         "joints only, not "
                         f"{sorted(t.name for t in meta.joint_types)}")
    dt = settings.fixed_dt
    use_rest = settings.num_restitution_iterations > 0
    mesh = step_mesh(state, meta)
    state, man, rows, (bp_dropped, np_dropped, man_dropped,
                       bp_alarms) = prepare_rows(state, settings, meta)
    state = _solve_phase(state, man, _shard_rows(rows, meta, mesh), settings,
                         meta, use_rest, mesh)
    return dataclasses.replace(
        state,
        step_count=state.step_count + 1,
        sim_time=state.sim_time + dt,
        overflow=torch.tensor([bp_dropped, np_dropped, rows.dropped,
                               bp_alarms, man_dropped], dtype=torch.int32,
                              device=state.device))


def _shard_rows(rows, meta: SceneMeta, mesh: Mesh) -> list:
    """The rows of the ladder's width (``solve_width``) cut into the
    shards' contiguous ranges, each on its shard's device. The rows are
    built once, at the table's full width: on the card a batched product's
    bits depend on the batch (ROADMAP P14), so rows built per shard would
    round otherwise."""
    width = solve_width(rows, meta)
    return [solver_mod.rows_range(rows, r0, r1, mesh.devices[s])
            for s, (r0, r1) in enumerate(ranges(width, mesh.size))]


def _solve_phase(state, man, parts, settings: Settings, meta: SceneMeta,
                 use_rest: bool, mesh: Mesh):
    """Everything row-dependent between narrowphase and the step epilogue
    (restitution -> gravity -> rhs refresh -> joint rows -> warm start ->
    velocity iterations, each followed by the joint solve -> impulse
    writeback -> integrate -> position iterations -> joint positions),
    over the shards' contact rows (``parts``, one ``ContactRows`` on each
    shard's device): each shard packs its table and runs its own K3b, K3a,
    K1 and K2; the deltas meet in ordered chains on the home device, where
    the joints (always at their full width), the impulse writeback and the
    integration run."""
    dt = settings.fixed_dt
    home = mesh.home
    packs = []
    for s, rows in enumerate(parts):
        with mesh.scope(s):
            packs.append(solver_mod.ShardPack.of_rows(rows))
    if use_rest:
        linvel, angvel = solver_mod.solve_restitution_sharded(
            state, packs, mesh, settings.num_restitution_iterations,
            settings.num_individual_restitution_iterations)
        state = dataclasses.replace(state, linvel=linvel, angvel=angvel)

    state = apply_gravity(state, dt)

    # refresh the rhs rows of the packed tables (rhs_n 48 | rhs_1 49 |
    # rhs_2 50; spin/roll rhs at C_BASE+27:30)
    with_sr = parts[0].sA_n is not None
    for s, p in enumerate(packs):
        with mesh.scope(s):
            vel = SimpleNamespace(linvel=state.linvel.to(p.device),
                                  angvel=state.angvel.to(p.device))
            rows = solver_mod.refresh_contact_rhs(parts[s], vel, dt,
                                                  use_rest)
            parts[s] = rows
            pad = p.Rp - rows.valid.shape[0]

            def prhs(*xs):
                return torch.nn.functional.pad(torch.stack(xs), (0, pad))

            p.tbl[48:51] = prhs(rows.rn.rhs, rows.r1.rhs, rows.r2.rhs)
            if with_sr:
                p.tbl[sk.C_BASE + 27:sk.C_BASE + 30] = prhs(
                    rows.rhs_spin, rows.rhs_roll1, rows.rhs_roll2)
    if meta.has_joints:
        jrows, new_jangle = joints_mod.build_joint_rows(
            state, dt, settings.mass_splitting, types=meta.joint_types,
            cone_cap=settings.cone_max_violation)
    else:
        jrows, new_jangle = None, state.joints.angle

    # warm start + velocity iterations; deltas travel transposed [6, N]
    N = state.capacity
    M, P = man.point_valid.shape
    j_imp = state.joints.impulses
    imp_packed = torch.cat([
        man.normal_impulse[..., None], man.friction_impulse,
        man.spin_impulse[..., None], man.roll_impulse], dim=-1)
    flat_imp = imp_packed.reshape(M * P, 6)
    imp6s = [flat_imp[rows.row_slot.to(home)].to(p.device)
             for rows, p in zip(parts, packs)]
    dvw = solver_mod.warm_start_sharded(
        parts, imp6s, torch.zeros((N, 6), dtype=state.dtype, device=home),
        mesh).to(home)
    if meta.has_joints:
        dvw = joints_mod.warm_start_joints(jrows, j_imp, dvw)
    imp_ts = [torch.nn.functional.pad(
        imp6, (0, 0, 0, p.Rp - imp6.shape[0])).T.contiguous()
        for imp6, p in zip(imp6s, packs)]

    def joint_pass(d):
        # the joint solve works on [N,6] deltas, after each contact
        # iteration's scatter-add
        nonlocal j_imp
        j_imp, d = joints_mod.solve_joints_once(jrows, j_imp, d)
        return d

    imp_ts, dvw = solver_mod.solve_velocities(
        packs, imp_ts, dvw, with_sr, mesh,
        settings.num_solver_velocity_iterations,
        joint_pass if meta.has_joints else None)

    # store applied impulses for next-step warm starting: one packed
    # scatter through the row compaction map, invalid rows dropped
    imp6 = gather([t.T[:rows.valid.shape[0]] for t, rows in zip(imp_ts, parts)],
                  home)
    valid = gather([rows.valid for rows in parts], home)
    slot = gather([rows.row_slot for rows in parts], home)
    slot_w = torch.where(valid, slot, torch.full_like(slot, M * P))
    flat = set_drop(flat_imp, slot_w, imp6).reshape(M, P, 6)
    man = dataclasses.replace(
        man,
        normal_impulse=flat[..., 0].contiguous(),
        friction_impulse=flat[..., 1:3].contiguous(),
        spin_impulse=flat[..., 3].contiguous(),
        roll_impulse=flat[..., 4:6].contiguous())
    joints = dataclasses.replace(state.joints, impulses=j_imp,
                                 angle=new_jangle)
    state = dataclasses.replace(state, contacts=man, joints=joints)

    state = integrate_velocities(state, dvw[:, 0:3], dvw[:, 3:6], dt)
    state = solve_positions_sharded(state, packs, mesh,
                                    settings.num_solver_position_iterations)
    if meta.has_joints:
        state = joints_mod.solve_joint_positions(
            state, settings.num_solver_position_iterations,
            types=meta.joint_types)
    return state
