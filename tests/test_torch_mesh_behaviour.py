"""The JAX package's trimesh behaviour tests (``tests/test_mesh.py``) on
the port's CPU ``World``: the same scenes, steps and assertions, as cases of one
parametrised test, the first three here and the rest in
``test_torch_mesh_behaviour_b.py`` (files of at most four tests run after
the suite's long files of few tests: see ``test_torch_joint_behaviour.py``).
The worlds run on one CPU thread (their tensors are too small to share)."""
import numpy as np
import pytest
import torch

import edyn_tpu_torch as et


def make_grid_mesh(nx=8, nz=8, size=1.0, height_fn=None):
    """``tests/test_mesh.py``'s height grid, its triangles wound to face
    +y."""
    xs = np.arange(nx) * size - (nx - 1) * size / 2
    zs = np.arange(nz) * size - (nz - 1) * size / 2
    verts = np.asarray([(x, height_fn(x, z) if height_fn else 0.0, z)
                        for x in xs for z in zs], np.float32)
    tris = []
    for i in range(nx - 1):
        for j in range(nz - 1):
            a, b = i * nz + j, (i + 1) * nz + j
            c, d = i * nz + (j + 1), (i + 1) * nz + (j + 1)
            tris.append((a, b, c))
            tris.append((c, b, d))
    tris = np.asarray(tris, np.int64)
    n = np.cross(verts[tris[:, 1]] - verts[tris[:, 0]],
                 verts[tris[:, 2]] - verts[tris[:, 0]])
    flip = n[:, 1] < 0
    tris[flip] = tris[flip][:, [0, 2, 1]]
    return verts, tris


def terrain_world(height_fn=None, bodies=(), settings=et.Settings()):
    verts, tris = make_grid_mesh(10, 10, 1.0, height_fn)
    b = et.WorldBuilder()
    b.make_rigidbody(et.RigidBodyDef(
        kind=et.KIND_STATIC, shape=et.MeshShape(verts, tris),
        material=et.Material(friction=0.7)))
    ids = [b.make_rigidbody(d) for d in bodies]
    return et.make_world(b, settings, device="cpu"), ids


def sphere_rests_on_flat_terrain():
    w, (ball,) = terrain_world(bodies=[et.RigidBodyDef(
        mass=1.0, shape=et.SphereShape(0.3), position=(0.3, 2.0, 0.2),
        material=et.Material(friction=0.6, roll_friction=0.01))])
    w.step(240)
    pos = w.position(ball)
    assert abs(pos[1] - 0.3) < 0.05, pos
    assert np.linalg.norm(w.linvel(ball)) < 0.05


def box_rests_on_flat_terrain_no_edge_snag():
    """A box sliding across interior triangle edges catches no ghost
    normals (Voronoi internal-edge rejection)."""
    w, (box,) = terrain_world(bodies=[et.RigidBodyDef(
        mass=1.0, shape=et.BoxShape((0.3, 0.2, 0.3)),
        position=(-2.0, 0.25, 0.0), linvel=(3.0, 0, 0),
        material=et.Material(friction=0.05), sleeping_disabled=True)])
    ys = []
    for _ in range(120):
        w.step()
        ys.append(float(w.position(box)[1]))
    assert max(ys[10:]) < 0.35, max(ys[10:])
    assert abs(ys[-1] - 0.2) < 0.05
    assert 1.5 < float(w.position(box)[0]) - (-2.0) < 3.5


def sphere_rolls_into_valley():
    w, (ball,) = terrain_world(
        height_fn=lambda x, z: 0.15 * (x * x) / 4.0,
        bodies=[et.RigidBodyDef(
            mass=1.0, shape=et.SphereShape(0.3), position=(-3.0, 1.5, 0.0),
            material=et.Material(friction=0.4))])
    reached_valley = False
    for _ in range(60):
        w.step(10)
        x = abs(float(w.position(ball)[0]))
        assert x < 4.0, "ball escaped the bowl"
        if x < 1.0:
            reached_valley = True
    assert reached_valley
    assert float(w.position(ball)[1]) < 1.2


def polyhedron_on_terrain(settings=et.Settings()):
    tet = et.PolyhedronShape(np.array(
        [[0.2, 0.2, 0.2], [0.2, -0.2, -0.2],
         [-0.2, 0.2, -0.2], [-0.2, -0.2, 0.2]], np.float32))
    w, (body,) = terrain_world(bodies=[et.RigidBodyDef(
        mass=1.0, shape=tet, position=(0.1, 1.5, -0.1),
        material=et.Material(friction=0.6))], settings=settings)
    w.step(300)
    ys = []
    for _ in range(60):
        w.step()
        ys.append(float(w.position(body)[1]))
    assert 0.0 < ys[-1] < 0.4, ys[-1]
    assert max(ys) - min(ys) < 0.03, (min(ys), max(ys))


def per_triangle_materials_two_zones():
    """Identical boxes slide much farther on the low-friction zone of the
    terrain (per-vertex -> per-triangle friction scales in the contact
    rows)."""
    verts, tris = make_grid_mesh(20, 6, 1.0)
    vf = np.where(verts[:, 2] < 0, 0.02, 1.0).astype(np.float32)
    b = et.WorldBuilder()
    b.make_rigidbody(et.RigidBodyDef(
        kind=et.KIND_STATIC,
        shape=et.MeshShape(verts, tris, vertex_friction=vf),
        material=et.Material(friction=0.8)))
    kick = (4.0, 0.0, 0.0)
    ice = b.make_rigidbody(et.RigidBodyDef(
        mass=1.0, shape=et.BoxShape((0.2, 0.2, 0.2)),
        position=(-8.0, 0.21, -1.5), linvel=kick,
        material=et.Material(friction=0.8)))
    asphalt = b.make_rigidbody(et.RigidBodyDef(
        mass=1.0, shape=et.BoxShape((0.2, 0.2, 0.2)),
        position=(-8.0, 0.21, 1.5), linvel=kick,
        material=et.Material(friction=0.8)))
    w = et.make_world(b, device="cpu")
    w.step(120)
    slide_ice = float(w.position(ice)[0]) + 8.0
    slide_asp = float(w.position(asphalt)[0]) + 8.0
    assert slide_asp < slide_ice - 1.0, (slide_ice, slide_asp)
    assert abs(float(w.linvel(asphalt)[0])) < 0.1


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def raycast_mesh():
    w, _ = terrain_world()
    w.step(1)
    hit = w.raycast((0.25, 5.0, 0.25), (0.25, -5.0, 0.25))
    assert hit["entity"] == 0
    np.testing.assert_allclose(hit["fraction"], 0.5, atol=1e-3)
    np.testing.assert_allclose(hit["normal"], [0, 1, 0], atol=1e-3)


CASES = [sphere_rests_on_flat_terrain, box_rests_on_flat_terrain_no_edge_snag,
         sphere_rolls_into_valley, polyhedron_on_terrain,
         per_triangle_materials_two_zones, raycast_mesh]


@pytest.mark.parametrize("case", CASES[:3], ids=lambda f: f.__name__)
def test_behaviour(case):
    case()


def test_polyhedron_on_terrain_with_triangle_cull():
    """``polyhedron_on_terrain`` under its own assertions with the port's
    opt-in triangle cull (``Settings.mesh_triangle_cull``, ROADMAP P9):
    the candidate triangles beside the body no longer give it contact
    points (R10), and the tetrahedron rests. Without the cull the case
    fails on the port (``test_torch_mesh_behaviour_b.py``)."""
    polyhedron_on_terrain(et.Settings(mesh_triangle_cull=True))
