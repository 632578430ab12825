"""AABB-of-interest management (counterpart of
``edyn_tpu/networking/interest.py``; reference:
src/edyn/networking/sys/update_aabbs_of_interest.cpp): each client sees the
entities whose AABBs intersect its interest box; enter/exit events drive
entity_entered/entity_exited packets."""
from __future__ import annotations

import numpy as np


def entities_in_aabb(state, center, half_extents) -> set:
    # host read: the boxes and the valid mask, each once per call (the
    # test runs in float64 as the JAX package's numpy does)
    amin = state.aabb_min.cpu().numpy()
    amax = state.aabb_max.cpu().numpy()
    valid = state.valid.cpu().numpy()
    lo = np.asarray(center) - np.asarray(half_extents)
    hi = np.asarray(center) + np.asarray(half_extents)
    # planes/terrain (huge AABBs) are always of interest, like the reference's
    # non-procedural tree queries
    inter = (amin <= hi).all(axis=1) & (amax >= lo).all(axis=1) & valid
    return set(np.nonzero(inter)[0].tolist())


class InterestState:
    """Tracks per-client interest set and produces enter/exit deltas."""

    def __init__(self, center=(0.0, 0.0, 0.0),
                 half_extents=(50.0, 50.0, 50.0)):
        self.center = np.asarray(center, np.float64)
        self.half_extents = np.asarray(half_extents, np.float64)
        self.current: set = set()
        # recenter on this entity every update (reference: aabb_oi_follow,
        # networking/comp/aabb_oi_follow.hpp)
        self.follow: int | None = None

    def update(self, state):
        if self.follow is not None:
            # host read: the followed body's row
            self.center = state.pos[self.follow].cpu().numpy().astype(
                np.float64)
        new = entities_in_aabb(state, self.center, self.half_extents)
        entered = new - self.current
        exited = self.current - new
        self.current = new
        return entered, exited
