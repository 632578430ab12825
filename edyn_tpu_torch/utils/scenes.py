"""Benchmark scenes. ``mixed_pile`` draws the same bodies, from the same
seed, as ``edyn_tpu.utils.scenes.mixed_pile``; ``joint_chain`` builds the
same chain as ``edyn_tpu.utils.scenes.joint_chain``."""
from __future__ import annotations

import numpy as np

from ..constraints.api import make_hinge_constraint
from ..core.builder import Material, RigidBodyDef, WorldBuilder
from ..core.state import KIND_STATIC
from ..shapes.params import (
    BoxShape, CapsuleShape, CylinderShape, PlaneShape, PolyhedronShape,
    SphereShape,
)


def mixed_pile(n_bodies: int = 10_000, seed: int = 0, bin_half: float = None,
               polyhedra: bool = True):
    """Mixed-shape pile into a plane-walled bin: a floor and 4 inward walls;
    spheres, boxes, capsules, cylinders and tetrahedra on a jittered grid
    with random orientations; restitution 0.2, roll friction 0.005."""
    rng = np.random.default_rng(seed)
    b = WorldBuilder()
    b.make_rigidbody(RigidBodyDef(
        kind=KIND_STATIC, shape=PlaneShape((0, 1, 0), 0.0),
        material=Material(friction=0.6)))
    if bin_half is None:
        bin_half = max(4.0, 0.18 * float(n_bodies) ** (1 / 3) * 6)
    for nrm in ((1, 0, 0), (-1, 0, 0), (0, 0, 1), (0, 0, -1)):
        b.make_rigidbody(RigidBodyDef(
            kind=KIND_STATIC, shape=PlaneShape(nrm, -bin_half),
            material=Material(friction=0.6)))

    tet = PolyhedronShape(np.array(
        [[0.15, 0.15, 0.15], [0.15, -0.15, -0.15],
         [-0.15, 0.15, -0.15], [-0.15, -0.15, 0.15]], np.float32))
    ids = []
    side = int(np.ceil(n_bodies ** (1 / 3)))
    spacing = 0.55
    i = 0
    for ix in range(side):
        for iy in range(side):
            for iz in range(side):
                if i >= n_bodies:
                    break
                kind = i % 5
                if kind == 0:
                    shape = SphereShape(0.15)
                elif kind == 1:
                    shape = BoxShape((0.15, 0.12, 0.18))
                elif kind == 2:
                    shape = CapsuleShape(0.1, 0.15)
                elif kind == 3:
                    shape = CylinderShape(0.12, 0.15)
                else:
                    shape = tet if polyhedra else SphereShape(0.12)
                jitter = rng.uniform(-0.05, 0.05, 3)
                pos = ((ix - side / 2) * spacing + jitter[0],
                       1.0 + iy * spacing + jitter[1],
                       (iz - side / 2) * spacing + jitter[2])
                ids.append(b.make_rigidbody(RigidBodyDef(
                    mass=1.0, shape=shape, position=pos,
                    orientation=_random_quat(rng),
                    material=Material(friction=0.5, restitution=0.2,
                                      roll_friction=0.005))))
                i += 1
    return b, ids


def joint_chain(n_links: int = 8):
    """Hinge chain hanging from a static anchor (BASELINE config 4)."""
    b = WorldBuilder()
    anchor = b.make_rigidbody(RigidBodyDef(
        kind=KIND_STATIC, position=(0, 5, 0), shape=None, material=None))
    prev = anchor
    ids = []
    for i in range(n_links):
        link = b.make_rigidbody(RigidBodyDef(
            mass=1.0, shape=CapsuleShape(0.05, 0.2),
            position=(0.5 + i * 0.5, 5.0, 0.0),
            material=Material(friction=0.5)))
        make_hinge_constraint(
            b, prev, link,
            pivot_a=(0.25, 0, 0) if i > 0 else (0, 0, 0),
            pivot_b=(-0.25, 0, 0),
            axis_a=(0, 0, 1), axis_b=(0, 0, 1))
        ids.append(link)
        prev = link
    return b, ids


def _random_quat(rng):
    q = rng.normal(size=4)
    return tuple(q / np.linalg.norm(q))
