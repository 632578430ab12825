"""The mixed pile: the frozen scene of the pile cells.

It draws the same bodies, from the same seed and in the same order of
draws, as ``edyn_tpu_torch.utils.scenes.mixed_pile`` did when the benchmark
was written (and, before it, the repository's ``bench.py`` pile): a floor
plane and four inward walls; spheres, boxes, capsules, cylinders and
tetrahedra on a jittered grid with random orientations, unit mass,
friction 0.5, restitution 0.2, roll friction 0.005; no joints. A later
change to the program's scene helpers does not change the benchmark's
scene.

Parameters (a configuration's ``scene`` entry): ``n_bodies``, and
optionally ``spacing``, ``bin_half`` and ``polyhedra`` (False puts spheres
of radius 0.12 in the tetrahedra's place).
"""
from __future__ import annotations

import numpy as np

from harness.scene import rng_for

TET = np.array([[0.15, 0.15, 0.15], [0.15, -0.15, -0.15],
                [-0.15, 0.15, -0.15], [-0.15, -0.15, 0.15]], np.float32)
BOX_HALF = (0.15, 0.12, 0.18)
# the radius about the centre of mass that holds every point of each kind
# (sphere, box, capsule, cylinder, tetrahedron)
RADIUS = (0.15,
          float(np.linalg.norm(BOX_HALF)),
          0.1 + 0.15,
          float(np.hypot(0.12, 0.15)),
          float(np.linalg.norm(TET, axis=1).max()))


def solid_inverse_inertia() -> np.ndarray:
    """[5,3]: the diagonal of a unit-mass solid's inverse inertia about its
    centre of mass in its own frame, for the spheres and boxes; NaN for the
    kinds the start check does not judge by inertia."""
    out = np.full((5, 3), np.nan)
    out[0] = 1 / (0.4 * 0.15 ** 2)
    h2 = np.square(2 * np.array(BOX_HALF))
    out[1] = 12 / (h2.sum() - h2)
    return out


def describe(seed: int, n_bodies: int, spacing: float = 0.55,
             bin_half: float | None = None, polyhedra: bool = True) -> dict:
    """The pile as arrays: ``planes`` [(normal, constant)], and per body
    ``kind`` (i % 5: sphere, box, capsule, cylinder, tetrahedron),
    ``pos`` [n,3] and ``orn`` [n,4] (xyzw), float64, with the general
    keys every scene gives (``harness.scene``)."""
    rng = rng_for(seed)
    if bin_half is None:
        bin_half = max(4.0, 0.18 * float(n_bodies) ** (1 / 3) * 6)
    planes = [((0, 1, 0), 0.0)] + [
        (nrm, -bin_half)
        for nrm in ((1, 0, 0), (-1, 0, 0), (0, 0, 1), (0, 0, -1))]
    side = int(np.ceil(n_bodies ** (1 / 3)))
    pos = np.zeros((n_bodies, 3))
    orn = np.zeros((n_bodies, 4))
    i = 0
    for ix in range(side):
        for iy in range(side):
            for iz in range(side):
                if i >= n_bodies:
                    break
                jitter = rng.uniform(-0.05, 0.05, 3)
                pos[i] = ((ix - side / 2) * spacing + jitter[0],
                          1.0 + iy * spacing + jitter[1],
                          (iz - side / 2) * spacing + jitter[2])
                q = rng.normal(size=4)
                orn[i] = q / np.linalg.norm(q)
                i += 1
    kind = np.arange(n_bodies) % 5
    radius = np.array(RADIUS)
    if not polyhedra:
        radius[4] = 0.12
    inertia = solid_inverse_inertia()
    return dict(scene="mixed_pile", planes=planes, kind=kind, pos=pos,
                orn=orn, polyhedra=polyhedra, radius=radius[kind],
                mass=np.ones(n_bodies), inertia_inv=inertia[kind],
                material=dict(friction=np.full(n_bodies, 0.5),
                              restitution=np.full(n_bodies, 0.2),
                              roll_friction=np.full(n_bodies, 0.005)),
                joints=[])


def build(pkg, desc: dict):
    """A ``pkg.WorldBuilder`` holding ``desc``'s bodies, in the order the
    scene draws them (the walls first). Returns (builder, dynamic ids)."""
    b = pkg.WorldBuilder()
    for nrm, c in desc["planes"]:
        b.make_rigidbody(pkg.RigidBodyDef(
            kind=pkg.KIND_STATIC, shape=pkg.PlaneShape(nrm, c),
            material=pkg.Material(friction=0.6)))
    shapes = (pkg.SphereShape(0.15), pkg.BoxShape(BOX_HALF),
              pkg.CapsuleShape(0.1, 0.15), pkg.CylinderShape(0.12, 0.15),
              pkg.PolyhedronShape(TET) if desc["polyhedra"]
              else pkg.SphereShape(0.12))
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
    return b, ids


def small(params: dict, n_bodies: int) -> dict:
    """The parameters of a pile of ``n_bodies`` otherwise as ``params``."""
    return dict(params, n_bodies=n_bodies)
