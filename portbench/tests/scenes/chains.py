"""Jointed chains: a test scene with the joints of a ragdoll, which the
tests add to a copy of the benchmark as a later configuration would add
its scene (``scenes/chains.py``).

``n_chains`` chains of ``links`` bodies (capsules, boxes and spheres in
turn, of masses 1, 1.5 and 2 kg), each chain straight along one random
direction near the vertical, its top body ``height`` metres up (every
other chain ``stagger`` metres higher), on a grid of pitch ``pitch`` in a
plane-walled bin. Consecutive links are joined at the point halfway
between their centres: a point and a cone joint (axis down the chain, span
0.5) after an even link, a hinge (axis across the chain, limits -1 to 1
rad) after an odd one, each with the pair's collision turned off.
Friction 0.8, restitution 0, roll friction 0.005, as the ragdoll's. Every
shape has its centre of mass at its origin, so a pivot given in the
body's frame is given relative to its centre of mass.
"""
from __future__ import annotations

import numpy as np

from harness.scene import rng_for

SEG = 0.3          # distance between consecutive links' centres
CAPSULE = (0.05, 0.1)
BOX_HALF = (0.1, 0.06, 0.08)
SPHERE = 0.08
MASS = (1.0, 1.5, 2.0)


def quat_rotate(q, v):
    u, w = q[:3], q[3]
    t = 2 * np.cross(u, v)
    return v + w * t + np.cross(u, t)


def describe(seed: int, n_chains: int, links: int = 6, height: float = 2.5,
             stagger: float = 0.0, pitch: float = 1.0,
             bin_half: float = 3.0) -> dict:
    rng = rng_for(seed)
    planes = [((0, 1, 0), 0.0)] + [
        (nrm, -bin_half)
        for nrm in ((1, 0, 0), (-1, 0, 0), (0, 0, 1), (0, 0, -1))]
    side = int(np.ceil(np.sqrt(n_chains)))
    n = n_chains * links
    pos, orn = np.zeros((n, 3)), np.zeros((n, 4))
    kind = np.arange(n) % links % 3
    joints = []
    for c in range(n_chains):
        iz, ix = divmod(c, side)
        axis = rng.normal(size=3)
        angle = rng.uniform(0.0, 0.4)
        q = np.concatenate([np.sin(angle / 2) * axis / np.linalg.norm(axis),
                            [np.cos(angle / 2)]])
        top = np.array([(ix - (side - 1) / 2) * pitch,
                        height + c % 2 * stagger,
                        (iz - (side - 1) / 2) * pitch])
        top += rng.uniform(-0.05, 0.05, 3)
        for k in range(links):
            i = c * links + k
            pos[i] = top + quat_rotate(q, np.array([0.0, -k * SEG, 0.0]))
            orn[i] = q
            if k == 0:
                continue
            pin = dict(a=i - 1, b=i, pivot_a=(0.0, -SEG / 2, 0.0),
                       pivot_b=(0.0, SEG / 2, 0.0))
            if k % 2:
                joints.append(dict(pin, type="point"))
                joints.append(dict(pin, type="cone", axis=(0.0, -1.0, 0.0),
                                   span=0.5))
            else:
                joints.append(dict(pin, type="hinge", axis=(1.0, 0.0, 0.0),
                                   limits=(-1.0, 1.0)))
    mass = np.array(MASS)[kind]
    radius = np.array([sum(CAPSULE), float(np.linalg.norm(BOX_HALF)),
                       SPHERE])[kind]
    h2 = np.square(2 * np.array(BOX_HALF))
    inertia = np.full((n, 3), np.nan)
    inertia[kind == 1] = 12 / (h2.sum() - h2) / mass[kind == 1, None]
    inertia[kind == 2] = 1 / (0.4 * SPHERE ** 2 * mass[kind == 2, None])
    return dict(scene="chains", planes=planes, kind=kind, pos=pos, orn=orn,
                radius=radius, mass=mass, inertia_inv=inertia,
                material=dict(friction=np.full(n, 0.8),
                              restitution=np.zeros(n),
                              roll_friction=np.full(n, 0.005)),
                joints=joints)


def build(pkg, desc: dict):
    b = pkg.WorldBuilder()
    for nrm, c in desc["planes"]:
        b.make_rigidbody(pkg.RigidBodyDef(
            kind=pkg.KIND_STATIC, shape=pkg.PlaneShape(nrm, c),
            material=pkg.Material(friction=0.6)))
    shapes = (pkg.CapsuleShape(*CAPSULE, axis=1), pkg.BoxShape(BOX_HALF),
              pkg.SphereShape(SPHERE))
    mat = desc["material"]
    ids = []
    for k, p, q, m, f, r, rf in zip(
            desc["kind"], desc["pos"], desc["orn"], desc["mass"],
            mat["friction"], mat["restitution"], mat["roll_friction"]):
        ids.append(b.make_rigidbody(pkg.RigidBodyDef(
            mass=float(m), shape=shapes[k], position=tuple(p),
            orientation=tuple(q),
            material=pkg.Material(friction=float(f), restitution=float(r),
                                  roll_friction=float(rf)))))
    for j in desc["joints"]:
        a, b_ = ids[j["a"]], ids[j["b"]]
        if j["type"] == "point":
            pkg.make_point_constraint(b, a, b_, j["pivot_a"], j["pivot_b"],
                                      disable_collision=True)
        elif j["type"] == "cone":
            pkg.make_cone_constraint(b, a, b_, j["pivot_a"], j["pivot_b"],
                                     j["axis"], j["axis"], j["span"],
                                     j["span"])
        else:
            pkg.make_hinge_constraint(b, a, b_, j["pivot_a"], j["pivot_b"],
                                      j["axis"], j["axis"], *j["limits"],
                                      has_limit=True, disable_collision=True)
    return b, ids


def small(params: dict, n_bodies: int) -> dict:
    links = params.get("links", 6)
    return dict(params, n_chains=max(1, n_bodies // links))
