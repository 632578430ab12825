"""Contact lifecycle events and AABB queries (counterpart of
``edyn_tpu/collision/events.py``; reference: the contact_started/ended
signals, Design.md:135-139, and include/edyn/collision/query_aabb.hpp).

With state snapshots, events are a set difference between two states'
manifold tables. Both functions read the tables on the host, as the JAX
module reads numpy.
"""
from __future__ import annotations

import numpy as np
import torch


def _touching_pairs(state) -> set:
    man = state.contacts
    # host read: the event sets are Python sets of body pairs
    valid = (man.valid & torch.any(man.point_valid, dim=1)).cpu().numpy()
    a = man.body_a.cpu().numpy()[valid]
    b = man.body_b.cpu().numpy()[valid]
    return set(zip(a.tolist(), b.tolist()))


def contact_events(prev_state, new_state):
    """(started, ended): sorted lists of (body_a, body_b) pairs whose
    manifolds gained or lost touching points between the two states."""
    before = _touching_pairs(prev_state)
    after = _touching_pairs(new_state)
    return sorted(after - before), sorted(before - after)


def query_aabb(state, lo, hi, include_non_procedural=True):
    """Sorted ids of the valid bodies whose AABB intersects [lo, hi]
    (dynamic bodies only unless ``include_non_procedural``)."""
    # compared in float64, as numpy compares float32 boxes with the
    # caller's floats
    lo_t = torch.as_tensor(np.asarray(lo, np.float64), device=state.device)
    hi_t = torch.as_tensor(np.asarray(hi, np.float64), device=state.device)
    m = (torch.all(state.aabb_min.double() <= hi_t, dim=1)
         & torch.all(state.aabb_max.double() >= lo_t, dim=1) & state.valid)
    if not include_non_procedural:
        m = m & state.is_dynamic
    # host read: the answer is a list of ids
    return torch.nonzero(m).flatten().cpu().tolist()
