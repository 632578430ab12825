"""Simulation islands and sleeping as masked label propagation
(counterpart of ``edyn_tpu/dynamics/islands.py``; reference:
src/edyn/simulation/island_manager.cpp). Only dynamic bodies connect
islands; an island sleeps when every member stays under the velocity
thresholds for ISLAND_TIME_TO_SLEEP seconds."""
from __future__ import annotations

import dataclasses

import torch

from ..config import (
    ISLAND_ANGULAR_SLEEP_THRESHOLD, ISLAND_LINEAR_SLEEP_THRESHOLD,
    ISLAND_TIME_TO_SLEEP,
)
from ..math import vec
from ..utils.profile import host

RESET_PERIOD = 8  # steps between label re-seeds (split correctness)


def _scatter_min(x, idx, src):
    return x.scatter_reduce(0, idx.long(), src, reduce="amin",
                            include_self=True)


def compute_islands(state, man, num_iters: int = 16):
    """Returns ``(labels, converged)``: per-body island labels, warm-started
    from last step's and re-seeded every RESET_PERIOD steps, and whether the
    last iteration changed nothing (a host bool)."""
    N = state.capacity
    dev = state.device
    dyn = state.is_dynamic
    ident = torch.arange(N, dtype=torch.int32, device=dev)
    reset = host("islands.step_count", int(state.step_count)) \
        % RESET_PERIOD == 0
    labels = ident if reset else torch.minimum(state.island_id, ident)
    labels = torch.where(state.island_id < 0, ident, labels)

    ca, cb = man.body_a.long(), man.body_b.long()
    cv = man.valid & torch.any(man.point_valid, -1)
    ja, jb = state.joints.body_a.long(), state.joints.body_b.long()
    jv = state.joints.valid
    ea = torch.cat([ca, ja])
    eb = torch.cat([cb, jb])
    ev = torch.cat([cv, jv]) & dyn[ea] & dyn[eb]
    E = ea.shape[0]
    eab = torch.cat([ea, eb])
    evv = torch.cat([ev, ev])
    idx_safe = torch.where(evv, eab, torch.zeros_like(eab))
    big = torch.full((E,), N, dtype=torch.int32, device=dev)
    prev = labels
    for _ in range(num_iters):
        prev = labels
        l2 = labels[eab]
        m = torch.where(ev, torch.minimum(l2[:E], l2[E:]), big)
        labels = _scatter_min(labels, idx_safe, torch.cat([m, m]))
        labels = torch.minimum(labels, labels[labels.long()])
    return labels, host("islands.converged",
                        bool(torch.all(labels == prev)))


def update_sleep(state, man, dt: float, enable: bool, num_iters: int = 4,
                 wake_bodies=None, skip_labels: bool = False):
    """Recompute island labels (skipped when ``skip_labels`` and the stored
    labels converged), advance sleep timers, derive the asleep mask and zero
    sleeping bodies' velocities."""
    N = state.capacity
    dev = state.device
    # device branch (islands.py:156 in the JAX package): host-synced here
    if skip_labels and host("islands.labels_stable",
                            bool(state.labels_stable)):
        labels, converged = state.island_id, True
    else:
        labels, converged = compute_islands(state, man, num_iters)
    converged_t = host("islands.converged_flag",
                       torch.tensor(converged, device=dev))
    if not enable:
        return dataclasses.replace(
            state, island_id=labels, labels_stable=converged_t,
            sleep_timer=torch.zeros_like(state.sleep_timer),
            asleep=torch.zeros_like(state.asleep))

    dyn = state.is_dynamic
    lin_ok = vec.length_sqr(state.linvel) < ISLAND_LINEAR_SLEEP_THRESHOLD ** 2
    ang_ok = vec.length_sqr(state.angvel) < ISLAND_ANGULAR_SLEEP_THRESHOLD ** 2
    body_ok = (lin_ok & ang_ok & ~state.sleeping_disabled) | ~dyn

    zero = torch.zeros_like(labels)
    # island_ok = AND over members as a min over {0, 1}
    island_ok = _scatter_min(
        torch.ones((N,), dtype=torch.int32, device=dev),
        torch.where(dyn, labels, zero),
        torch.where(dyn, body_ok, torch.ones_like(body_ok)).to(torch.int32))
    kin_moving = state.is_kinematic & ~(lin_ok & ang_ok)
    ea = torch.cat([man.body_a, state.joints.body_a]).long()
    eb = torch.cat([man.body_b, state.joints.body_b]).long()
    ev = torch.cat([man.valid & torch.any(man.point_valid, -1),
                    state.joints.valid])
    e_this = torch.cat([ea, eb])
    e_other = torch.cat([eb, ea])
    evv = torch.cat([ev, ev])
    wake = evv & kin_moving[e_this] & dyn[e_other]
    island_ok = _scatter_min(
        island_ok, torch.where(wake, labels[e_other], torch.zeros_like(
            labels[e_other])), (~wake).to(torch.int32))
    if wake_bodies is not None:
        force = wake_bodies & dyn
        island_ok = _scatter_min(island_ok, torch.where(force, labels, zero),
                                 (~force).to(torch.int32))

    my_ok = (island_ok[labels.long()] > 0) & dyn
    timer = torch.where(my_ok, state.sleep_timer + dt,
                        torch.zeros_like(state.sleep_timer))
    asleep = (timer >= ISLAND_TIME_TO_SLEEP) & dyn
    linvel = torch.where(asleep[:, None], torch.zeros_like(state.linvel),
                         state.linvel)
    angvel = torch.where(asleep[:, None], torch.zeros_like(state.angvel),
                         state.angvel)
    return dataclasses.replace(state, island_id=labels,
                               labels_stable=converged_t,
                               sleep_timer=timer, asleep=asleep,
                               linvel=linvel, angvel=angvel)


def exact_island_mask(state, seeds) -> torch.Tensor:
    """Exact island membership of the seed bodies, on the host: a bool [N]
    mask of every body connected to a seed through dynamic-dynamic contact
    or joint edges (union-find over the live edge list). The on-device
    labels are re-seeded every RESET_PERIOD steps and take 1-2 steps to
    re-converge, so API calls that need whole islands (``World.wake_up``)
    use this instead."""
    import numpy as np
    N = state.capacity
    dyn = state.is_dynamic.cpu().numpy()
    parent = np.arange(N, dtype=np.int64)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    man, jt = state.contacts, state.joints
    host = lambda t: t.cpu().numpy()
    ea = np.concatenate([host(man.body_a), host(jt.body_a)])
    eb = np.concatenate([host(man.body_b), host(jt.body_b)])
    pointed = host(man.valid) & host(man.point_valid).any(-1)
    ev = np.concatenate([pointed, host(jt.valid)])
    live = ev & dyn[ea] & dyn[eb]
    for a, b in zip(ea[live].tolist(), eb[live].tolist()):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb
    roots = {find(int(s)) for s in np.atleast_1d(np.asarray(seeds))}
    mask = np.fromiter((find(i) in roots for i in range(N)), bool, N)
    return torch.as_tensor(mask, device=state.device)
