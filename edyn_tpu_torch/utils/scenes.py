"""Benchmark and test scenes. ``mixed_pile`` and ``rich_scene`` draw the
same bodies, from the same seed, as their namesakes in
``edyn_tpu.utils.scenes``; ``hello_world``, ``box_stack``, ``grid_mesh``
and ``joint_chain`` build the same scenes."""
from __future__ import annotations

import numpy as np

from ..constraints.api import make_hinge_constraint
from ..core.builder import Material, RigidBodyDef, WorldBuilder
from ..core.state import KIND_STATIC
from ..shapes.params import (
    BoxShape, CapsuleShape, CylinderShape, MeshShape, PlaneShape,
    PolyhedronShape, SphereShape,
)


def hello_world():
    """One dynamic box onto a static ground plane (reference:
    examples/hello_world/hello_world.cpp:16-35)."""
    b = WorldBuilder()
    b.make_rigidbody(RigidBodyDef(
        kind=KIND_STATIC, shape=PlaneShape((0, 1, 0), 0.0),
        material=Material(friction=0.5)))
    box = b.make_rigidbody(RigidBodyDef(
        mass=10.0, shape=BoxShape((0.2, 0.2, 0.2)), position=(0, 3, 0),
        material=Material(friction=0.8)))
    return b, box


def box_stack(n: int = 10, half: float = 0.2, spacing: float = 1.001):
    """A vertical stack of n boxes on a plane."""
    b = WorldBuilder()
    b.make_rigidbody(RigidBodyDef(
        kind=KIND_STATIC, shape=PlaneShape((0, 1, 0), 0.0),
        material=Material(friction=0.7)))
    ids = []
    for i in range(n):
        ids.append(b.make_rigidbody(RigidBodyDef(
            mass=1.0, shape=BoxShape((half, half, half)),
            position=(0.0, half + 2 * half * spacing * i, 0.0),
            material=Material(friction=0.7))))
    return b, ids


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


def grid_mesh(nx: int = 8, nz: int = 8, size: float = 1.0, height_fn=None):
    """Triangulated height grid, wound to face +y."""
    xs = np.arange(nx) * size - (nx - 1) * size / 2
    zs = np.arange(nz) * size - (nz - 1) * size / 2
    verts = np.asarray([(x, height_fn(x, z) if height_fn else 0.0, z)
                        for x in xs for z in zs], np.float32)
    tris = []
    for i in range(nx - 1):
        for j in range(nz - 1):
            a = i * nz + j
            bb = (i + 1) * nz + j
            c = i * nz + (j + 1)
            d = (i + 1) * nz + (j + 1)
            # cross(v1-v0, v2-v0) points +y: mesh contacts are one-sided
            tris.append((a, c, bb))
            tris.append((c, d, bb))
    return verts, np.asarray(tris, np.int64)


def terrain_height(x, z):
    """The height field ``rich_scene``'s terrain samples at its vertices."""
    return 0.15 * np.sin(0.4 * x) * np.cos(0.4 * z)


def rich_scene(n_bodies: int = 4096, seed: int = 1, n_chains: int = 4,
               chain_links: int = 6, mesh_n: int = 24):
    """The full-surface scene: a trimesh terrain (``mesh_n`` x ``mesh_n``
    vertices over [-extent, extent]^2), four wall planes, a mixed-shape
    pile over the terrain and hinge chains hanging beside it. Returns
    (builder, dynamic body ids)."""
    rng = np.random.default_rng(seed)
    b = WorldBuilder()
    extent = max(8.0, 0.55 * float(n_bodies) ** (1 / 3) * 2.5)
    cell = 2 * extent / (mesh_n - 1)
    verts, tris = grid_mesh(mesh_n, mesh_n, cell, height_fn=terrain_height)
    b.make_rigidbody(RigidBodyDef(
        kind=KIND_STATIC, shape=MeshShape(verts, tris),
        material=Material(friction=0.6)))
    for nrm in ((1, 0, 0), (-1, 0, 0), (0, 0, 1), (0, 0, -1)):
        b.make_rigidbody(RigidBodyDef(
            kind=KIND_STATIC, shape=PlaneShape(nrm, -extent),
            material=Material(friction=0.6)))
    ids = []
    side = int(np.ceil(n_bodies ** (1 / 3)))
    spacing = 0.55
    i = 0
    for ix in range(side):
        for iy in range(side):
            for iz in range(side):
                if i >= n_bodies:
                    break
                shape = (SphereShape(0.15), BoxShape((0.15, 0.12, 0.18)),
                         CapsuleShape(0.1, 0.15),
                         CylinderShape(0.12, 0.15))[i % 4]
                jitter = rng.uniform(-0.05, 0.05, 3)
                pos = ((ix - side / 2) * spacing + jitter[0],
                       1.5 + iy * spacing + jitter[1],
                       (iz - side / 2) * spacing + jitter[2])
                ids.append(b.make_rigidbody(RigidBodyDef(
                    mass=1.0, shape=shape, position=pos,
                    orientation=_random_quat(rng),
                    material=Material(friction=0.5, restitution=0.1))))
                i += 1
    # hanging hinge chains spread around the pile
    for c in range(n_chains):
        x0 = (c - n_chains / 2) * 3.0
        y0 = 4.0 + side * spacing
        prev = b.make_rigidbody(RigidBodyDef(
            kind=KIND_STATIC, position=(x0, y0, extent / 2), shape=None,
            material=None))
        for i_l in range(chain_links):
            link = b.make_rigidbody(RigidBodyDef(
                mass=1.0, shape=CapsuleShape(0.05, 0.2),
                position=(x0 + 0.5 + i_l * 0.5, y0, extent / 2),
                material=Material(friction=0.5)))
            make_hinge_constraint(
                b, prev, link,
                pivot_a=(0.25, 0, 0) if i_l > 0 else (0, 0, 0),
                pivot_b=(-0.25, 0, 0),
                axis_a=(0, 0, 1), axis_b=(0, 0, 1))
            ids.append(link)
            prev = link
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
