"""Crafted manifold tables for the narrowphase's merge (``merge_kernel``):
each case sets up one rule of ``manifold.merge_points`` and of the frozen
pairs in a few slots, the rest of the table drawn from a seed. They are
fixtures, not part of the step: ``tests/test_torch_merge.py`` holds the
port's ``merge_points`` to the JAX package's on them and ``chip_smoke.py``
holds the merge kernel to the plain merge on the card, both importing them
from here. ``build(case, dtype, device)`` gives the inputs of
``merge_fresh`` and ``check(case, c, out)`` what the case must show in its
output.

Every float is drawn at float32, so a float64 case holds the same numbers
(the JAX package's merge rounds distances and impulses to float32)."""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from edyn_tpu_torch.core.state import (
    INVALID_KEY, KIND_DYNAMIC, KIND_STATIC, ContactTable, WorldState,
)
from edyn_tpu_torch.math import quat
from edyn_tpu_torch.shapes.params import ShapeType as S

DT = 1.0 / 60.0
CASES = ("nearest_tie", "claim_tie", "full_replace", "full_no_replace",
         "rolling_only", "break_normal", "break_tangent", "attachments",
         "frozen", "invalid", "random")
M_SLOTS = 16
E = 2.0 ** -7      # an offset inside the caching threshold, twice it outside
                   # the merging threshold; exact in binary


class Bodies:
    """The columns of a ``WorldState`` the merge reads."""
    origin_pos = WorldState.origin_pos
    is_dynamic = WorldState.is_dynamic

    def __init__(self, **cols):
        self.__dict__.update(cols)

    @property
    def dtype(self):
        return self.pos.dtype


def _axis_angle(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    return np.concatenate([axis * np.sin(angle / 2), [np.cos(angle / 2)]])


def bodies(dtype, device):
    """0 a static plane, 1 a rolling sphere (r 0.5), 2 a box with an
    offset centre of mass, 3 a rolling capsule."""
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32), dtype=dtype,
                                 device=device)
    return Bodies(
        pos=f32([[0, 0, 0], [0, 0.5, 0], [1.5, 0.75, 0.25], [-1, 0.6, 0]]),
        orn=f32([[0, 0, 0, 1], _axis_angle((0, 0, 1), 0.3),
                 _axis_angle((1, 1, 0), 0.7), _axis_angle((1, 0, 0), 1.1)]),
        angvel=f32([[0, 0, 0], [0, 0, -6], [0.5, -1, 2], [4, 0, 0]]),
        com=f32([[0, 0, 0], [0, 0, 0], [0.01, 0, 0], [0, 0, 0]]),
        shape_type=torch.tensor([S.PLANE, S.SPHERE, S.BOX, S.CAPSULE],
                                dtype=torch.int32, device=device),
        kind=torch.tensor([KIND_STATIC, KIND_DYNAMIC, KIND_DYNAMIC,
                           KIND_DYNAMIC], dtype=torch.int32, device=device),
        valid=torch.ones(4, dtype=torch.bool, device=device))


PAIRS = ((2, 0), (1, 0), (1, 2), (3, 0), (2, 3))


def _random(rng, dtype, device):
    """The seeded table and fresh points every case starts from."""
    M = M_SLOTS
    pair = rng.integers(0, len(PAIRS), M)
    ab = np.array([PAIRS[k] for k in pair], np.int32)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    pa = (f32(M, 4, 3) * 0.3)
    pb = (f32(M, 4, 3) * 0.3)
    step = rng.choice([0.0, 0.005, 0.03, 0.2], size=(M, 4, 1))
    n = f32(M, 4, 3)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    new = np.zeros((M, 4, 14), np.float32)
    new[..., 0:3] = pa + step * f32(M, 4, 3)
    new[..., 3:6] = pb + step * f32(M, 4, 3)
    new[..., 6:9] = n
    new[..., 9] = rng.integers(0, 3, (M, 4))
    new[..., 10] = f32(M, 4) * 0.01
    new[..., 11] = rng.random((M, 4)) < 0.6
    new[..., 12:14] = rng.choice([1.0, 0.5], size=(M, 4, 2))
    t = lambda x, dt=dtype: torch.tensor(np.asarray(x), dtype=dt,
                                         device=device)
    i32 = torch.int32
    table = ContactTable(
        key=t(np.arange(M), torch.int64), body_a=t(ab[:, 0], i32),
        body_b=t(ab[:, 1], i32), valid=t(np.ones(M, bool), torch.bool),
        sort_key=t(np.full(M, INVALID_KEY), torch.int64),
        sort_slot=t(np.full(M, M), i32),
        sort_pvalid=t(np.zeros(M, bool), torch.bool),
        point_valid=t(rng.random((M, 4)) < 0.7, torch.bool),
        pivot_a=t(pa), pivot_b=t(pb), local_normal=t(np.roll(n, 1, -1)),
        normal_attachment=t(rng.integers(0, 3, (M, 4)), i32),
        distance=t(f32(M, 4) * 0.01),
        lifetime=t(rng.integers(0, 50, (M, 4)), i32),
        normal_impulse=t(np.abs(f32(M, 4))),
        friction_impulse=t(f32(M, 4, 2)), spin_impulse=t(f32(M, 4)),
        roll_impulse=t(f32(M, 4, 2)),
        friction_scale=t(rng.choice([1.0, 0.75], size=(M, 4))),
        restitution_scale=t(rng.choice([1.0, 0.25], size=(M, 4))))
    return table, t(new), t(np.zeros(M, bool), torch.bool)


def _set(x, idx, v):
    x = x.clone()
    x[idx] = torch.as_tensor(v, dtype=x.dtype, device=x.device)
    return x


def _f32(v, like):
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return torch.tensor(np.asarray(v, np.float32).astype(np.float64),
                        dtype=like.dtype, device=like.device)


class _Slot:
    """Writes one slot of a case: its pair, carried and fresh points."""

    def __init__(self, c, m, a, b):
        self.c, self.m, self.a, self.b = c, m, a, b
        c.table = dataclasses.replace(
            c.table, body_a=_set(c.table.body_a, m, a),
            body_b=_set(c.table.body_b, m, b),
            point_valid=_set(c.table.point_valid, m, False))
        c.new_pts = _set(c.new_pts, (m, slice(None), 11), 0.0)

    def world(self, body, piv):
        """The world point of a pivot of ``body`` (pos - R com + R piv)."""
        bd = self.c.bodies
        org = bd.origin_pos()[body]
        return org + quat.rotate(bd.orn[body], piv)

    def local(self, body, w):
        bd = self.c.bodies
        return quat.rotate_inv(bd.orn[body], w - bd.origin_pos()[body])

    def carried(self, o, pa, gap=(0, 0, 0), pb=None, att=2,
                normal=(0, 1, 0)):
        """Carried point o at A's pivot ``pa``; B's pivot the same world
        point moved by ``gap`` (world), unless given."""
        t = self.c.table
        pa = _f32(pa, t.pivot_a)
        if pb is None:
            pb = self.local(self.b, self.world(self.a, pa) + _f32(gap, pa))
            pb = _f32(pb, pa)
        idx = (self.m, o)
        self.c.table = dataclasses.replace(
            t, point_valid=_set(t.point_valid, idx, True),
            pivot_a=_set(t.pivot_a, idx, pa),
            pivot_b=_set(t.pivot_b, idx, _f32(pb, pa)),
            local_normal=_set(t.local_normal, idx, _f32(normal, pa)),
            normal_attachment=_set(t.normal_attachment, idx, att))
        return pa

    def fresh(self, n, pa, pb, att=0, normal=(0, 1, 0), dist=-0.001):
        row = torch.zeros(14, dtype=self.c.new_pts.dtype)
        row[0:3] = torch.as_tensor(np.asarray(pa, np.float32))
        row[3:6] = torch.as_tensor(np.asarray(pb, np.float32))
        row[6:9] = torch.as_tensor(np.asarray(normal, np.float32))
        row[9], row[10], row[11] = att, float(np.float32(dist)), 1.0
        row[12:14] = 1.0
        self.c.new_pts = _set(self.c.new_pts, (self.m, n), row)


def _np(x):
    return x.detach().cpu().numpy().astype(np.float64)


def build(case: str, dtype=torch.float32, device="cpu", seed: int = 0):
    """``SimpleNamespace(bodies, table, new_pts, frozen, dt)``: the inputs
    of ``merge_fresh`` for ``case``."""
    rng = np.random.default_rng(seed + CASES.index(case))
    table, new_pts, frozen = _random(rng, dtype, device)
    c = SimpleNamespace(bodies=bodies(dtype, device), table=table,
                        new_pts=new_pts, frozen=frozen, dt=DT, marks={})
    if case == "nearest_tie":
        # carried 0 lies E from fresh 1 and fresh 2 (A's frame, exact):
        # fresh 1 wins; fresh 2, 2E from it, is appended
        s = _Slot(c, 0, 2, 0)
        pa = s.carried(0, (0.25, -0.25, 0.125))
        pb = _np(c.table.pivot_b[0, 0])
        for n, sgn in ((1, 1), (2, -1)):
            s.fresh(n, _np(pa) + (sgn * E, 0, 0), pb + (0.25, 0, 0))
    elif case == "claim_tie":
        # carried 0 and 1 lie E on either side of fresh 0: carried 0 takes
        # it, carried 1 stays unmatched and is kept
        s = _Slot(c, 0, 2, 0)
        mid = np.array([0.25, -0.25, 0.125])
        s.carried(0, mid + (E, 0, 0))
        s.carried(1, mid - (E, 0, 0))
        s.fresh(0, mid, _np(c.table.pivot_b[0, 0]) + (0.25, 0, 0))
    elif case in ("full_replace", "full_no_replace"):
        # four kept points on a 0.1 m square; a fresh point outside it
        # (replaces a corner) or at its centre (adds no area: dropped)
        s = _Slot(c, 0, 2, 0)
        for o, (x, z) in enumerate(((-1, -1), (1, -1), (1, 1), (-1, 1))):
            s.carried(o, (0.05 * x, -0.25, 0.05 * z))
        at = (0.25, -0.25, 0.0) if case == "full_replace" else \
            (0.0, -0.25, 0.0)
        s.fresh(0, at, _np(s.local(0, s.world(2, _f32(at, c.table.pivot_a)))))
    elif case == "rolling_only":
        # the sphere rolls: the fresh pivot is the carried one's material
        # point carried back by the rotation of one step, 0.05 m away in
        # the body frame, and the plane's pivot moved 0.05 m
        s = _Slot(c, 0, 1, 0)
        pa = s.carried(0, (0.0, -0.5, 0.0))
        bd = c.bodies
        prev = quat.integrate(bd.orn[1], bd.angvel[1], -DT)
        w = bd.origin_pos()[1] + quat.rotate(prev, pa)
        s.fresh(0, _np(s.local(1, w)),
                _np(c.table.pivot_b[0, 0]) + (0.05, 0, 0))
    elif case == "break_normal":
        # apart along the plane's normal by 0.03 (breaks), 0.01 (kept)
        # and -0.05 (penetrating: kept)
        s = _Slot(c, 0, 2, 0)
        for o, gap in enumerate((-0.03, -0.01, 0.05)):
            s.carried(o, (0.05 * o, -0.25, 0.0), gap=(0, gap, 0))
    elif case == "break_tangent":
        # apart along the plane by 0.03 (breaks) and 0.01 (kept)
        s = _Slot(c, 0, 2, 0)
        for o, gap in enumerate(((0.03, 0, 0), (0, 0, 0.01))):
            s.carried(o, (0.05 * o, -0.25, 0.0), gap=gap)
    elif case == "attachments":
        # carried normals attached to nothing, A and B; fresh points of
        # each attachment appended into an empty manifold
        s = _Slot(c, 0, 2, 3)
        for o in range(3):
            s.carried(o, (0.05 * o, -0.25, 0.0), gap=(0.0, 0.004, 0.003),
                      att=o, normal=(0.6, 0.8, 0.0))
        s = _Slot(c, 1, 3, 2)
        for n in range(3):
            s.fresh(n, (0.1 * n, 0, 0), (0, 0.1 * n, 0), att=n,
                    normal=(0.0, 0.6, 0.8))
    elif case == "frozen":
        # frozen valid slots keep every field; a frozen invalid one merges
        c.frozen = _set(c.frozen, slice(0, 5), True)
        c.table = dataclasses.replace(
            c.table, valid=_set(c.table.valid, 4, False))
    elif case == "invalid":
        # invalid slots take no fresh point and keep no point
        c.table = dataclasses.replace(
            c.table, valid=_set(c.table.valid, slice(0, 4), False))
        c.new_pts = _set(c.new_pts, (slice(0, 4), slice(None), 11), 1.0)
    return c


def check(case: str, c, out) -> list:
    """What ``case`` must show in the merged table ``out``: the failures
    (empty when it shows)."""
    t = c.table
    bad = []

    def need(cond, what):
        if not bool(cond):
            bad.append(f"{case}: {what}")

    pv = out.point_valid[0]
    if case == "nearest_tie":
        need(torch.equal(out.pivot_a[0, 0], c.new_pts[0, 1, 0:3]),
             "carried 0 adopts fresh 1")
        need(out.lifetime[0, 0] == t.lifetime[0, 0] + 1, "carried 0 kept")
        need(pv[1] and torch.equal(out.pivot_a[0, 1], c.new_pts[0, 2, 0:3]),
             "fresh 2 appended into slot 1")
    elif case == "claim_tie":
        need(torch.equal(out.pivot_a[0, 0], c.new_pts[0, 0, 0:3]),
             "carried 0 wins fresh 0")
        need(pv[1] and torch.equal(out.pivot_a[0, 1], t.pivot_a[0, 1]),
             "carried 1 kept unmatched")
    elif case == "full_replace":
        replaced = [o for o in range(4)
                    if torch.equal(out.pivot_a[0, o], c.new_pts[0, 0, 0:3])]
        need(len(replaced) == 1 and out.lifetime[0, replaced[0]] == 0
             and out.normal_impulse[0, replaced[0]] == 0,
             "one corner replaced, its impulses reset")
    elif case == "full_no_replace":
        need(torch.equal(out.pivot_a[0], t.pivot_a[0]) and pv.all(),
             "no corner replaced")
    elif case == "rolling_only":
        d2 = ((t.pivot_a[0, 0] - c.new_pts[0, 0, 0:3]) ** 2).sum()
        need(d2 > 0.04 ** 2, "no direct match")
        need(torch.equal(out.pivot_a[0, 0], c.new_pts[0, 0, 0:3])
             and out.lifetime[0, 0] == t.lifetime[0, 0] + 1
             and out.normal_impulse[0, 0] == t.normal_impulse[0, 0],
             "matched by rolling, impulses kept")
    elif case == "break_normal":
        need(pv.tolist() == [False, True, True, False], "0 breaks, 1-2 kept")
    elif case == "break_tangent":
        need(pv.tolist() == [False, True, False, False], "0 breaks, 1 kept")
    elif case == "attachments":
        d = out.distance[0, :3]
        need(d[0] != d[1] and d[1] != d[2] and out.point_valid[0, :3].all(),
             "the distances differ by attachment")
        need(out.normal_attachment[1, :3].tolist() == [0, 1, 2]
             and out.point_valid[1, :3].all(), "fresh points appended")
    elif case == "frozen":
        for f in ("point_valid", "pivot_a", "distance", "lifetime",
                  "normal_impulse"):
            need(torch.equal(getattr(out, f)[:4], getattr(t, f)[:4]),
                 f"frozen {f} kept")
        need(not out.point_valid[4].any(), "frozen invalid slot merged")
    elif case == "invalid":
        need(not out.point_valid[:4].any(), "invalid slots keep no point")
    return bad
