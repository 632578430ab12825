"""The JAX package's compound behaviour tests (``tests/test_compound.py``)
on the port's CPU ``World``: the same scenes, steps and assertions, as cases of one
parametrised test, the first three here and the rest in
``test_torch_compound_behaviour_b.py`` (files of at most four tests run after
the suite's long files of few tests: see ``test_torch_joint_behaviour.py``).
The worlds run on one CPU thread (their tensors are too small to share)."""
import numpy as np
import pytest

import edyn_tpu_torch as et
from edyn_tpu_torch.shapes.compound import compound_mass_properties

from test_torch_mesh_behaviour import make_grid_mesh, one_thread  # noqa: F401


def dumbbell():
    return et.CompoundShape(children=[
        (et.SphereShape(0.25), (-0.5, 0, 0), (0, 0, 0, 1)),
        (et.SphereShape(0.25), (0.5, 0, 0), (0, 0, 0, 1)),
        (et.BoxShape((0.5, 0.08, 0.08)), (0, 0, 0), (0, 0, 0, 1)),
    ])


def floor(b):
    b.make_rigidbody(et.RigidBodyDef(
        kind=et.KIND_STATIC, shape=et.PlaneShape((0, 1, 0), 0.0),
        material=et.Material(friction=0.6)))


def world(b, device="cpu"):
    return et.make_world(b, device=device)


def compound_rests_on_plane(device="cpu"):
    b = et.WorldBuilder()
    floor(b)
    body = b.make_rigidbody(et.RigidBodyDef(
        mass=2.0, shape=dumbbell(), position=(0, 1.5, 0),
        material=et.Material(friction=0.6)))
    w = world(b, device)
    w.step(240)
    # rests on its two sphere ends
    assert abs(float(w.position(body)[1]) - 0.25) < 0.05


def convex_vs_compound(device="cpu"):
    b = et.WorldBuilder()
    floor(b)
    b.make_rigidbody(et.RigidBodyDef(
        mass=2.0, shape=dumbbell(), position=(0, 0.25, 0),
        material=et.Material(friction=0.6)))
    ball = b.make_rigidbody(et.RigidBodyDef(
        mass=0.5, shape=et.SphereShape(0.2), position=(0.4, 2.0, 0.0),
        material=et.Material(friction=0.4, roll_friction=0.01)))
    w = world(b, device)
    hit_compound = False
    for _ in range(240):
        w.step()
        if float(w.position(ball)[1]) > 0.3 and \
                abs(float(w.linvel(ball)[0])) > 0.05:
            hit_compound = True
    assert hit_compound, "ball never bounced off the compound"
    assert float(w.position(ball)[1]) > 0.05  # no tunnelling


def compound_vs_compound(device="cpu"):
    b = et.WorldBuilder()
    floor(b)
    d = dumbbell()
    b.make_rigidbody(et.RigidBodyDef(
        mass=2.0, shape=d, position=(0, 0.25, 0),
        material=et.Material(friction=0.6)))
    upper = b.make_rigidbody(et.RigidBodyDef(
        mass=2.0, shape=d, position=(0, 1.5, 0),
        orientation=(0, np.sin(np.pi / 4), 0, np.cos(np.pi / 4)),  # crossed
        material=et.Material(friction=0.6)))
    w = world(b, device)
    w.step(300)
    y = float(w.position(upper)[1])
    assert 0.4 < y < 0.9, f"upper dumbbell should rest crossed on lower: {y}"


def compound_inertia_reasonable(device="cpu"):
    I, com = compound_mass_properties(dumbbell(), 2.0)
    # dumbbell: I about the long axis (x) much smaller than about y/z
    assert I[0, 0] < I[1, 1] * 0.5
    assert abs(com[0]) < 1e-6


def compound_rests_on_trimesh(device="cpu"):
    verts, tris = make_grid_mesh(10, 10, 1.0)
    b = et.WorldBuilder()
    b.make_rigidbody(et.RigidBodyDef(
        kind=et.KIND_STATIC, shape=et.MeshShape(verts, tris),
        material=et.Material(friction=0.7)))
    body = b.make_rigidbody(et.RigidBodyDef(
        mass=2.0, shape=dumbbell(), position=(0, 1.0, 0),
        material=et.Material(friction=0.7)))
    w = world(b, device)
    w.step(240)
    # rests on its two sphere ends on the flat mesh (it may roll about its
    # sphere axis; it must not sink, bounce or slide along that axis)
    assert abs(float(w.position(body)[1]) - 0.25) < 0.05
    v = np.asarray(w.linvel(body))
    assert abs(v[1]) < 0.05, v
    assert abs(v[0]) < 0.1, v


def compound_raycast_hits_children(device="cpu"):
    """A raycast against a compound tests each child's own geometry
    (reference: raycast.cpp:323)."""
    b = et.WorldBuilder()
    body = b.make_rigidbody(et.RigidBodyDef(
        kind=et.KIND_STATIC, shape=dumbbell(), position=(0, 0, 0)))
    w = world(b, device)
    # down onto the left sphere child (centre (-0.5, 0, 0), r 0.25)
    out = w.raycast((-0.5, 2.0, 0.0), (-0.5, -2.0, 0.0))
    assert out["entity"] == body
    np.testing.assert_allclose(out["fraction"], (2.0 - 0.25) / 4.0,
                               atol=1e-3)
    np.testing.assert_allclose(out["normal"], [0, 1, 0], atol=1e-3)
    # down onto the thin bar (half height 0.08)
    out = w.raycast((0.0, 2.0, 0.0), (0.0, -2.0, 0.0))
    assert out["entity"] == body
    np.testing.assert_allclose(out["fraction"], (2.0 - 0.08) / 4.0,
                               atol=1e-3)
    # between the spheres above the bar: a miss
    out = w.raycast((-0.25, 2.0, 0.2), (-0.25, -2.0, 0.2))
    assert out["entity"] == -1


CASES = [compound_rests_on_plane, convex_vs_compound, compound_vs_compound,
         compound_inertia_reasonable, compound_rests_on_trimesh,
         compound_raycast_hits_children]


@pytest.mark.parametrize("case", CASES[:3], ids=lambda f: f.__name__)
def test_behaviour(case):
    case()
