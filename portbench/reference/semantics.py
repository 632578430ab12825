"""An independent check of a run's start and frames, written in NumPy from
the step's semantics (upstream edyn's: gravity on awake dynamic bodies,
semi-implicit Euler, the exponential-map orientation update, sleeping
islands that do not move, joints whose impulses act between their two
bodies), not from the program's code. It imports nothing of the program
and nothing of ``reference.engine``, and takes the bodies (radius, mass,
inertia, material), the joints and the walls from the benchmark's own
scene description (``harness.scene``).

A joint links its two bodies into one group. Three kinds of body can be
judged without following a single contact:

- A free body: a body of no joint, awake before the step, out of reach of
  every other body and every wall, and either moving faster than
  ``MIN_SPEED`` or quiet for less than ``TIME_TO_SLEEP`` less two steps
  (so that its island cannot fall asleep in this step; edyn's island time
  to sleep is 2 s). Its step is ballistic: ``v' = v + g dt``, ``w' = w``,
  ``x' = x + v' dt``, ``q' = normalize(exp(w' dt / 2) q)``.
- A free group: the bodies of a joint group, none static, each awake and
  moving or young as a free body is, and none in reach of a body outside
  the group or of a wall. Inside it joints and contacts push its bodies
  about, but every impulse acts on both of its bodies with their plain
  inverse masses, equal and opposite (mass splitting enters only a row's
  effective mass), and so do the position corrections. Its centre of mass
  (the description's masses) moves ballistically: ``v_cm' = v_cm + g dt``,
  ``x_cm' = x_cm + v_cm' dt``.
- A body of a quiet group: a group of bodies linked by reach or by a
  joint, all asleep before the step. No awake body can touch it, so its
  island stays asleep and nothing of it moves: the position it is read
  back with is the one it had, to the bit, its velocities are zero, and
  its orientation is the one it had up to rounding (the program may
  normalize every orientation again, which moves a quaternion by an ulp or
  so).

Reach is conservative: two bodies are within reach when their bounding
spheres (about the body's position, the centre of mass, with the
description's radius) come within ``MARGIN`` plus twice the distance their
relative velocity (with one step of gravity) covers in a step. ``MARGIN``
is 0.1 m, five times the widest band in which the engine keeps a contact
(contact points are made within the collision threshold of 0.01 m and
kept within the breaking threshold of 0.02 m; pairs are admitted within
1.3 times that). A body in reach of anything outside its group is left to
the step-by-step reference.

The start is judged the same way, against the scene description: every
body of the built world at its drawn position and orientation, at rest,
awake, with its material and mass, the configuration's gravity, and the
inverse inertia where the description gives it (``start_bodies_differ``,
limit 0: a body any of whose values lies further than ``START_RTOL`` of it
from the description's).

The numbers of the frames, each the largest over the checked frames:
``free_pos_gap_m``, ``free_orn_gap``, ``free_linvel_gap_mps``,
``free_angvel_gap_radps``: the largest component of a free body's gap;
``free_group_pos_gap_m``, ``free_group_linvel_gap_mps``: the largest
component of a free group's centre-of-mass gap; ``joint_pivot_gap_m``: the
largest distance, in the frame's read-back, between the two world-space
pivots of a joint that pins them together (``PINNED``);
``quiet_bodies_moved``: bodies of quiet groups whose position or velocity
changed (limit 0);
``quiet_orn_gap``: the largest component of a quiet body's change of
orientation; ``free_bodies_absent``: 1 when no checked frame held a free
body or a free group (the check would have judged nothing; limit 0).
"""
from __future__ import annotations

import numpy as np

MARGIN = 0.1
START_RTOL = 1e-5
MIN_SPEED = 0.05
TIME_TO_SLEEP = 2.0
FREE_GAPS = ("free_pos_gap_m", "free_orn_gap", "free_linvel_gap_mps",
             "free_angvel_gap_radps")
GROUP_GAPS = ("free_group_pos_gap_m", "free_group_linvel_gap_mps")
WORST = FREE_GAPS + GROUP_GAPS + ("joint_pivot_gap_m", "quiet_bodies_moved",
                                  "quiet_orn_gap")
NUMBERS = WORST + ("free_bodies_absent",)
COUNTS = ("free_bodies", "free_groups", "quiet_bodies")
# joint types whose rows hold their two pivots together (upstream edyn's
# point_constraint and hinge_constraint; its cone_constraint bounds only
# the angle between the two axes, and a rig pairs it with a point joint)
PINNED = ("point", "hinge")


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


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """``v`` rotated by the unit quaternions ``q`` (x, y, z, w)."""
    u, w = q[..., :3], q[..., 3:]
    t = 2 * np.cross(u, v)
    return v + w * t + np.cross(u, t)


def reach(desc: dict, pos, linvel, gravity, dt):
    """(pairs [k,2] of bodies in reach of each other, in reach of a wall
    [n]) over the scene's bodies, indexed from 0 in the scene's order."""
    from scipy.spatial import cKDTree
    radius = np.asarray(desc["radius"], np.float64)
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


def components(n: int, pairs) -> np.ndarray:
    """Each body's group [n] over the links ``pairs`` [k,2]."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    m = coo_matrix((np.ones(len(pairs)), (pairs[:, 0], pairs[:, 1])),
                   shape=(n, n))
    return connected_components(m, directed=False)[1]


def quiet_groups(n: int, pairs, asleep) -> np.ndarray:
    """The bodies whose group (linked by ``pairs``) is all asleep."""
    label = components(n, pairs)
    awake_groups = np.unique(label[~asleep])
    return asleep & ~np.isin(label, awake_groups)


def joint_links(desc: dict) -> np.ndarray:
    """[k,2]: the two bodies of each of the description's joints."""
    return np.array([(j["a"], j["b"]) for j in desc["joints"]],
                    np.int64).reshape(-1, 2)


def pivot_gap(desc: dict, pos, orn) -> float:
    """The largest distance between the two world-space pivots of a joint
    of ``PINNED`` type, at the poses ``pos`` [n,3], ``orn`` [n,4]."""
    js = [j for j in desc["joints"] if j["type"] in PINNED]
    if not js:
        return 0.0
    a = np.array([j["a"] for j in js])
    b = np.array([j["b"] for j in js])
    pa = np.array([j["pivot_a"] for j in js], np.float64)
    pb = np.array([j["pivot_b"] for j in js], np.float64)
    pos, orn = np.asarray(pos, np.float64), np.asarray(orn, np.float64)
    d = (pos[a] + quat_rotate(orn[a], pa)) - (pos[b] + quat_rotate(orn[b],
                                                                   pb))
    return float(np.nan_to_num(np.linalg.norm(d, axis=1), nan=np.inf).max())


def centres(label, mass, *xs):
    """The mass-weighted mean of each ``xs`` [k,3] over the groups
    ``label`` [k] (numbered from 0)."""
    total = np.bincount(label, mass)
    return tuple(np.stack([np.bincount(label, mass * x[:, c])
                           for c in range(3)], 1) / total[:, None]
                 for x in xs)


def judge(desc: dict, gravity, dt, pre: dict, host, post_vel,
          dtype=np.float64) -> dict:
    """The numbers of one frame. ``pre``: the state before the step
    (``pos``, ``orn``, ``linvel``, ``angvel``, ``asleep``, ``sleep_timer``,
    host arrays over every slot); ``host``: the frame's read-back
    [slots, 7]; ``post_vel``: (linvel, angvel) after the step. With
    ``dtype`` other than float64 the expectation in that precision stands
    in the program's place (the control; its joints' pivots are read at
    the poses before the step, in that precision)."""
    s = len(desc["planes"])
    n = len(desc["pos"])
    body = slice(s, s + n)
    pos, orn = pre["pos"][body], pre["orn"][body]
    lin, ang = pre["linvel"][body], pre["angvel"][body]
    asleep = pre["asleep"][body].astype(bool)
    pairs, wall = reach(desc, pos, lin, gravity, dt)
    links = joint_links(desc)
    group = components(n, links)
    jointed = np.bincount(group)[group] > 1
    touched = wall.copy()
    touched[pairs[group[pairs[:, 0]] != group[pairs[:, 1]]].ravel()] = True
    young = pre["sleep_timer"][body] < TIME_TO_SLEEP - 2 * dt
    able = ~asleep & ~touched & (young | (np.linalg.norm(lin, axis=1)
                                          > MIN_SPEED))
    able &= np.asarray(desc["mass"]) > 0
    free = able & ~jointed
    in_group = jointed & (np.bincount(group, ~able)[group] == 0)
    quiet = quiet_groups(n, np.concatenate([pairs, links]), asleep)

    expect = ballistic(pos[free], orn[free], lin[free], ang[free], gravity,
                       dt)
    sel = np.flatnonzero(in_group)
    label = np.unique(group[sel], return_inverse=True)[1]
    mass = np.asarray(desc["mass"], np.float64)[sel]
    g = np.asarray(gravity, np.float64)
    x_cm, v_cm = centres(label, mass, *(np.asarray(x[sel], np.float64)
                                        for x in (pos, lin)))
    v_want = v_cm + g * dt
    expect_cm = (x_cm + v_want * dt, v_want)
    if dtype == np.float64:
        got = (host[body, :3][free], host[body, 3:7][free],
               post_vel[0][body][free], post_vel[1][body][free])
        got_cm = centres(label, mass, *(np.asarray(x[sel], np.float64) for x
                                        in (host[body, :3],
                                            post_vel[0][body])))
        now = (host[body, :3][quiet], host[body, 3:7][quiet],
               post_vel[0][body][quiet], post_vel[1][body][quiet])
        pivots = pivot_gap(desc, host[body, :3], host[body, 3:7])
    else:
        got = ballistic(pos[free], orn[free], lin[free], ang[free], gravity,
                        dt, dtype)
        r = rounder(dtype)
        xc, vc = centres(label, mass, r(pos[sel]), r(lin[sel]))
        v = r(r(vc) + r(g * float(r(np.float64(dt)))))
        got_cm = (r(r(xc) + r(v * float(r(np.float64(dt))))), v)
        now = tuple(r(x[quiet]) for x in (pos, orn, lin, ang))
        pivots = pivot_gap(desc, r(pos), r(orn))
    out = {}
    for name, a, b in zip(FREE_GAPS + GROUP_GAPS, got + tuple(got_cm),
                          expect + expect_cm):
        d = np.abs(np.asarray(a, np.float64) - b)
        out[name] = float(np.nan_to_num(d, nan=np.inf).max(initial=0.0))
    out["joint_pivot_gap_m"] = pivots
    was = (pos[quiet], np.zeros_like(lin[quiet]), np.zeros_like(ang[quiet]))
    moved = np.zeros(int(quiet.sum()), bool)
    for a, b in zip(now[:1] + now[2:], was):
        moved |= np.any(np.asarray(a, np.float64) != b, axis=1)
    out["quiet_bodies_moved"] = int(moved.sum())
    d = np.abs(np.asarray(now[1], np.float64) - orn[quiet])
    out["quiet_orn_gap"] = float(np.nan_to_num(d, nan=np.inf).max(
        initial=0.0))
    out["free_bodies"] = int(free.sum())
    out["free_groups"] = int(label.max(initial=-1) + 1)
    out["quiet_bodies"] = int(quiet.sum())
    return out


def check(desc: dict, gravity, dt, frames, dtype=np.float64) -> dict:
    """The numbers over ``frames``, each (pre, host, post_vel) as
    ``judge`` takes them: the largest of each, the counts summed."""
    worst = dict.fromkeys(NUMBERS + COUNTS, 0)
    for pre, host, post_vel in frames:
        g = judge(desc, gravity, dt, pre, host, post_vel, dtype)
        for k in WORST:
            worst[k] = max(worst[k], g[k])
        for k in COUNTS:
            worst[k] += g[k]
    worst["free_bodies_absent"] = int(worst["free_bodies"]
                                      + worst["free_groups"] == 0)
    return worst


def start(desc: dict, gravity, built: dict, dtype=np.float64) -> dict:
    """``start_bodies_differ`` of a built world (host arrays of ``pos``,
    ``orn``, ``linvel``, ``angvel``, ``asleep``, ``mass_inv``,
    ``inertia_inv``, ``gravity``, ``friction``, ``restitution``,
    ``roll_friction`` over every slot), against the description. With
    ``dtype`` other than float64 the built values are first rounded to it
    (the control)."""
    r = rounder(dtype) if dtype != np.float64 else (
        lambda x: np.asarray(x, np.float64))
    s, n = len(desc["planes"]), len(desc["pos"])
    b = {k: r(v[s:s + n]) for k, v in built.items()}
    mass = np.asarray(desc["mass"], np.float64)
    mat = desc["material"]
    want = dict(pos=desc["pos"], orn=desc["orn"],
                linvel=np.zeros((n, 3)), angvel=np.zeros((n, 3)),
                mass_inv=np.divide(1.0, mass, out=np.zeros(n),
                                   where=mass > 0),
                gravity=np.tile(gravity, (n, 1)),
                friction=mat["friction"], restitution=mat["restitution"],
                roll_friction=mat["roll_friction"])
    bad = b["asleep"].astype(bool).copy()
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        d = np.abs(b[k] - w).reshape(n, -1)
        bad |= np.any(d > START_RTOL * np.maximum(1.0, np.abs(w)).reshape(
            n, -1), axis=1)
    diag = np.asarray(desc["inertia_inv"], np.float64)
    judged = ~np.isnan(diag).any(1)
    inv = b["inertia_inv"].reshape(n, 3, 3)[judged]
    diag = diag[judged]
    d = np.abs(inv - diag[:, :, None] * np.eye(3))
    bad[judged] |= np.any(d > (START_RTOL * diag.max(1))[:, None, None],
                          axis=(1, 2))
    return {"start_bodies_differ": int(bad.sum())}


START_FIELDS = ("pos", "orn", "linvel", "angvel", "asleep", "mass_inv",
                "inertia_inv", "gravity", "friction", "restitution",
                "roll_friction")
