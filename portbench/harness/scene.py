"""The benchmark's frozen scenes, as plain descriptions built through any
package with the engine's builder API.

``mixed_pile`` draws the same bodies, from the same seed and in the same
order of draws, as ``edyn_tpu_torch.utils.scenes.mixed_pile`` did when the
benchmark was written (and, before it, the repository's ``bench.py`` pile):
a floor plane and four inward walls; spheres, boxes, capsules, cylinders
and tetrahedra on a jittered grid with random orientations; restitution
0.2, roll friction 0.005. A later change to the program's scene helpers
does not change the benchmark's scene.
"""
from __future__ import annotations

import numpy as np

TET = np.array([[0.15, 0.15, 0.15], [0.15, -0.15, -0.15],
                [-0.15, 0.15, -0.15], [-0.15, -0.15, 0.15]], np.float32)


def rng_for(seed: int) -> np.random.Generator:
    """A generator for any whole-number seed, negative or past 64 bits."""
    return np.random.default_rng(int(seed) % (1 << 64))


def mixed_pile(n_bodies: int, seed: int, spacing: float = 0.55,
               bin_half: float | None = None, polyhedra: bool = True) -> dict:
    """The pile as arrays: ``planes`` [(normal, constant)], and per body
    ``kind`` (i % 5: sphere, box, capsule, cylinder, tetrahedron),
    ``pos`` [n,3] and ``orn`` [n,4] (xyzw), float64."""
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
    return dict(planes=planes, kind=np.arange(n_bodies) % 5, pos=pos,
                orn=orn, polyhedra=polyhedra)


def build(pkg, desc: dict):
    """A ``pkg.WorldBuilder`` holding ``desc``'s bodies, in the order the
    scene draws them (the walls first). Returns (builder, dynamic ids)."""
    b = pkg.WorldBuilder()
    for nrm, c in desc["planes"]:
        b.make_rigidbody(pkg.RigidBodyDef(
            kind=pkg.KIND_STATIC, shape=pkg.PlaneShape(nrm, c),
            material=pkg.Material(friction=0.6)))
    shapes = (pkg.SphereShape(0.15), pkg.BoxShape((0.15, 0.12, 0.18)),
              pkg.CapsuleShape(0.1, 0.15), pkg.CylinderShape(0.12, 0.15),
              pkg.PolyhedronShape(TET) if desc["polyhedra"]
              else pkg.SphereShape(0.12))
    ids = []
    for k, p, q in zip(desc["kind"], desc["pos"], desc["orn"]):
        ids.append(b.make_rigidbody(pkg.RigidBodyDef(
            mass=1.0, shape=shapes[k], position=tuple(p),
            orientation=tuple(q),
            material=pkg.Material(friction=0.5, restitution=0.2,
                                  roll_friction=0.005))))
    return b, ids


SCENES = {"mixed_pile": mixed_pile}


def describe(scene: dict, seed: int) -> dict:
    """The description of a configuration's ``scene`` entry."""
    params = {k: v for k, v in scene.items() if k != "kind"}
    return SCENES[scene["kind"]](seed=seed, **params)
