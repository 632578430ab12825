"""An independent check of a run's start and frames, written in NumPy from
the step's semantics (upstream edyn's: gravity on awake dynamic bodies,
semi-implicit Euler, the exponential-map orientation update, sleeping
islands that do not move), not from the program's code. It imports
nothing of the program and nothing of ``reference.engine``, and takes the
bodies' shapes and the walls from the benchmark's own scene description.

Two kinds of body can be judged without following a single contact:

- A free body: awake before the step, out of reach of every other body
  and every wall, and either moving faster than ``MIN_SPEED`` or quiet for
  less than ``TIME_TO_SLEEP`` less two steps (so that its island cannot
  fall asleep in this step; edyn's island time to sleep is 2 s). Its step
  is ballistic: ``v' = v + g dt``, ``w' = w``, ``x' = x + v' dt``,
  ``q' = normalize(exp(w' dt / 2) q)``.
- A body of a quiet group: a group of bodies linked by reach, all asleep
  before the step. No awake body can touch it, so its island stays asleep
  and nothing of it moves: the position it is read back with is the one it
  had, to the bit, its velocities are zero, and its orientation is the one
  it had up to rounding (the program may normalize every orientation
  again, which moves a quaternion by an ulp or so).

Reach is conservative: two bodies are within reach when their bounding
spheres (about the body's position, the centre of mass of every shape of
the scene) come within ``MARGIN`` plus twice the distance their relative
velocity (with one step of gravity) covers in a step. ``MARGIN`` is 0.1 m,
five times the widest band in which the engine keeps a contact (contact
points are made within the collision threshold of 0.01 m and kept within
the breaking threshold of 0.02 m; pairs are admitted within 1.3 times
that). A body in reach of anything is left to the step-by-step reference.

The start is judged the same way, against the scene description: every
body of the built world at its drawn position and orientation, at rest,
awake, with its material (friction 0.5, restitution 0.2, roll friction
0.005), unit mass, the configuration's gravity, and, for the spheres and
boxes, the inverse inertia of a solid of unit mass
(``start_bodies_differ``, limit 0: a body any of whose values lies further
than ``START_RTOL`` of it from the description's).

The numbers of the frames, each the largest over the checked frames:
``free_pos_gap_m``, ``free_orn_gap``, ``free_linvel_gap_mps``,
``free_angvel_gap_radps``: the largest component of a free body's gap;
``quiet_bodies_moved``: bodies of quiet groups whose position or velocity
changed (limit 0); ``quiet_orn_gap``: the largest component of a quiet
body's change of orientation; ``free_bodies_absent``: 1 when no checked
frame held a free body (the check would have judged nothing; limit 0).
"""
from __future__ import annotations

import numpy as np

MARGIN = 0.1
START_RTOL = 1e-5
MIN_SPEED = 0.05
TIME_TO_SLEEP = 2.0
FREE_GAPS = ("free_pos_gap_m", "free_orn_gap", "free_linvel_gap_mps",
             "free_angvel_gap_radps")
NUMBERS = FREE_GAPS + ("quiet_bodies_moved", "quiet_orn_gap",
                       "free_bodies_absent")


def bounding_radius(kind: int) -> float:
    """The radius about the centre of mass that holds every point of the
    scene's shape ``kind`` (sphere, box, capsule, cylinder, tetrahedron, as
    ``harness.scene.build`` makes them)."""
    from harness import scene
    return (0.15,
            float(np.linalg.norm((0.15, 0.12, 0.18))),
            0.1 + 0.15,
            float(np.hypot(0.12, 0.15)),
            float(np.linalg.norm(scene.TET, axis=1).max()))[int(kind)]


def quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The Hamilton product of quaternions stored x, y, z, w."""
    ax, ay, az, aw = np.moveaxis(a, -1, 0)
    bx, by, bz, bw = np.moveaxis(b, -1, 0)
    return np.stack([aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw,
                     aw * bw - ax * bx - ay * by - az * bz], -1)


def ballistic(pos, orn, linvel, angvel, gravity, dt, dtype=np.float64):
    """One step of free bodies, every number rounded to ``dtype``
    (float64 for the expectation; the control computes it in bfloat16)."""
    r = rounder(dtype)
    pos, orn, linvel, angvel = (r(np.asarray(x, np.float64))
                                for x in (pos, orn, linvel, angvel))
    g, dt_ = r(np.asarray(gravity, np.float64)), float(r(np.float64(dt)))
    v = r(linvel + r(g * dt_))
    x = r(pos + r(v * dt_))
    speed = np.linalg.norm(angvel, axis=-1, keepdims=True)
    half = r(speed * dt_ * 0.5)
    axis = np.divide(angvel, speed, out=np.zeros_like(angvel),
                     where=speed > 0)
    dq = r(np.concatenate([axis * np.sin(half), np.cos(half)], -1))
    q = r(quat_mul(dq, orn))
    q = r(q / np.linalg.norm(q, axis=-1, keepdims=True))
    return x, q, v, angvel


def rounder(dtype):
    if dtype == "bfloat16":
        import torch

        def r(x):
            return torch.as_tensor(np.asarray(x, np.float64)).to(
                torch.bfloat16).double().numpy()
        return r
    return lambda x: np.asarray(x, np.float64).astype(dtype).astype(
        np.float64)


def reach(desc: dict, pos, linvel, gravity, dt):
    """(pairs [k,2] of bodies in reach of each other, in reach of a wall
    [n]) over the scene's bodies, indexed from 0 in the scene's order."""
    from scipy.spatial import cKDTree
    radius = np.array([bounding_radius(k) for k in range(5)])[desc["kind"]]
    gdt = float(np.linalg.norm(gravity)) * dt
    speed = np.linalg.norm(linvel, axis=1)
    far = 2 * radius.max() + MARGIN + 2 * dt * (2 * speed.max() + gdt)
    pairs = cKDTree(pos).query_pairs(far, output_type="ndarray")
    if len(pairs):
        i, j = pairs[:, 0], pairs[:, 1]
        dist = np.linalg.norm(pos[i] - pos[j], axis=1)
        rel = np.linalg.norm(linvel[i] - linvel[j], axis=1) + gdt
        pairs = pairs[dist <= radius[i] + radius[j] + MARGIN + 2 * dt * rel]
    wall = np.zeros(len(pos), bool)
    for nrm, c in desc["planes"]:
        d = pos @ np.asarray(nrm, np.float64) - c
        wall |= d - radius <= MARGIN + 2 * dt * (speed + gdt)
    return pairs.reshape(-1, 2), wall


def quiet_groups(n: int, pairs, asleep) -> np.ndarray:
    """The bodies whose group (linked by reach) is all asleep."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    m = coo_matrix((np.ones(len(pairs)), (pairs[:, 0], pairs[:, 1])),
                   shape=(n, n))
    _, label = connected_components(m, directed=False)
    awake_groups = np.unique(label[~asleep])
    return asleep & ~np.isin(label, awake_groups)


def judge(desc: dict, gravity, dt, pre: dict, host, post_vel,
          dtype=np.float64) -> dict:
    """The numbers of one frame. ``pre``: the state before the step
    (``pos``, ``orn``, ``linvel``, ``angvel``, ``asleep``, ``sleep_timer``,
    host arrays over every slot); ``host``: the frame's read-back
    [slots, 7]; ``post_vel``: (linvel, angvel) after the step. With
    ``dtype`` other than float64 the expectation in that precision stands
    in the program's place (the control)."""
    s = len(desc["planes"])
    n = len(desc["kind"])
    body = slice(s, s + n)
    pos, orn = pre["pos"][body], pre["orn"][body]
    lin, ang = pre["linvel"][body], pre["angvel"][body]
    asleep = pre["asleep"][body].astype(bool)
    pairs, wall = reach(desc, pos, lin, gravity, dt)
    touched = wall.copy()
    touched[pairs.ravel()] = True
    young = pre["sleep_timer"][body] < TIME_TO_SLEEP - 2 * dt
    free = ~asleep & ~touched & (young | (np.linalg.norm(lin, axis=1)
                                          > MIN_SPEED))
    quiet = quiet_groups(n, pairs, asleep)

    expect = ballistic(pos[free], orn[free], lin[free], ang[free], gravity,
                       dt)
    if dtype == np.float64:
        got = (host[body, :3][free], host[body, 3:7][free],
               post_vel[0][body][free], post_vel[1][body][free])
        now = (host[body, :3][quiet], host[body, 3:7][quiet],
               post_vel[0][body][quiet], post_vel[1][body][quiet])
    else:
        got = ballistic(pos[free], orn[free], lin[free], ang[free], gravity,
                        dt, dtype)
        r = rounder(dtype)
        now = tuple(r(x[quiet]) for x in (pos, orn, lin, ang))
    out = {}
    for name, a, b in zip(FREE_GAPS, got, expect):
        d = np.abs(np.asarray(a, np.float64) - b)
        out[name] = float(np.nan_to_num(d, nan=np.inf).max(initial=0.0))
    was = (pos[quiet], np.zeros_like(lin[quiet]), np.zeros_like(ang[quiet]))
    moved = np.zeros(int(quiet.sum()), bool)
    for a, b in zip(now[:1] + now[2:], was):
        moved |= np.any(np.asarray(a, np.float64) != b, axis=1)
    out["quiet_bodies_moved"] = int(moved.sum())
    d = np.abs(np.asarray(now[1], np.float64) - orn[quiet])
    out["quiet_orn_gap"] = float(np.nan_to_num(d, nan=np.inf).max(
        initial=0.0))
    out["free_bodies"] = int(free.sum())
    out["quiet_bodies"] = int(quiet.sum())
    return out


def check(desc: dict, gravity, dt, frames, dtype=np.float64) -> dict:
    """The numbers over ``frames``, each (pre, host, post_vel) as
    ``judge`` takes them: the largest of each, the counts summed."""
    worst = dict.fromkeys(NUMBERS, 0)
    worst.update(free_bodies=0, quiet_bodies=0)
    for pre, host, post_vel in frames:
        g = judge(desc, gravity, dt, pre, host, post_vel, dtype)
        for k in FREE_GAPS + ("quiet_bodies_moved", "quiet_orn_gap"):
            worst[k] = max(worst[k], g[k])
        worst["free_bodies"] += g["free_bodies"]
        worst["quiet_bodies"] += g["quiet_bodies"]
    worst["free_bodies_absent"] = int(worst["free_bodies"] == 0)
    return worst


def solid_inverse_inertia(kind: int):
    """The diagonal of a unit-mass solid's inverse inertia about its centre
    of mass in its own frame, for the scene's spheres and boxes (None for
    the other shapes, which the start check does not judge by inertia)."""
    if kind == 0:
        return np.full(3, 1 / (0.4 * 0.15 ** 2))
    if kind == 1:
        h2 = np.square(2 * np.array([0.15, 0.12, 0.18]))
        return 12 / (h2.sum() - h2)
    return None


def start(desc: dict, gravity, built: dict, dtype=np.float64) -> dict:
    """``start_bodies_differ`` of a built world (host arrays of ``pos``,
    ``orn``, ``linvel``, ``angvel``, ``asleep``, ``mass_inv``,
    ``inertia_inv``, ``gravity``, ``friction``, ``restitution``,
    ``roll_friction`` over every slot), against the description. With
    ``dtype`` other than float64 the built values are first rounded to it
    (the control)."""
    r = rounder(dtype) if dtype != np.float64 else (
        lambda x: np.asarray(x, np.float64))
    s, n = len(desc["planes"]), len(desc["kind"])
    b = {k: r(v[s:s + n]) for k, v in built.items()}
    want = dict(pos=desc["pos"], orn=desc["orn"],
                linvel=np.zeros((n, 3)), angvel=np.zeros((n, 3)),
                mass_inv=np.ones(n), gravity=np.tile(gravity, (n, 1)),
                friction=np.full(n, 0.5), restitution=np.full(n, 0.2),
                roll_friction=np.full(n, 0.005))
    bad = b["asleep"].astype(bool).copy()
    for k, w in want.items():
        d = np.abs(b[k] - w).reshape(n, -1)
        bad |= np.any(d > START_RTOL * np.maximum(1.0, np.abs(w)).reshape(
            n, -1), axis=1)
    inv = b["inertia_inv"].reshape(n, 3, 3)
    for i, k in enumerate(desc["kind"]):
        diag = solid_inverse_inertia(k)
        if diag is not None:
            bad[i] |= bool(np.any(np.abs(inv[i] - np.diag(diag))
                                  > START_RTOL * diag.max()))
    return {"start_bodies_differ": int(bad.sum())}


START_FIELDS = ("pos", "orn", "linvel", "angvel", "asleep", "mass_inv",
                "inertia_inv", "gravity", "friction", "restitution",
                "roll_friction")
