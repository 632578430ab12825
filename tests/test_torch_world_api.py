"""The port's live-world API against the JAX package's, on one state.

``live_scene`` (a plane, a trimesh, a compound and every convex shape,
with spare slots) is built in both packages; the port's CPU world steps it
until its bodies touch, and that state is carried into a JAX state
(``test_torch_step.to_jax``), so neither package runs a JAX step here.
Then:
- each mutator (setters, spawn into a free slot, destroy, the sleep API)
  is applied in both packages to the same state, and every field of the
  two results must be equal (inverse inertias within 1 ulp of float32),
  with the scene facts (``SceneMeta``) and the settings they change;
- ``query_aabb``, ``manifold_between`` and ``contact_events`` answer
  alike on that state;
- ``step_with_events`` reports a contact that starts and one that ends in
  the same call (the states it diffs stay snapshots);
- the port's ``World`` has every public method of the JAX ``World``.
The raycast is held against the JAX one in ``test_torch_raycast.py``, on
the same scene.
"""
import importlib

import numpy as np
import pytest
import torch

import edyn_tpu as ej
import edyn_tpu_torch as et
from edyn_tpu.collision import events as jev
from edyn_tpu_torch.collision import events as tev
from edyn_tpu_torch.core.convert import state_from_numpy, state_to_numpy
from test_torch_step import jtree, one_thread, to_jax  # noqa: F401

SETTLE = 60
SPARE = 8
ULP_FIELDS = ("inertia_inv",)
# the world-space inverse inertia R I^-1 R^T differs by an ulp between the
# packages (XLA's CPU matrix products fuse multiply-adds, torch's do not),
# and an impulse's angular velocity is that matrix times a vector
MATVEC_CASES = ("apply_impulse", "apply_torque_impulse")
MATVEC_RTOL = 1e-6


def live_scene(pkg):
    """A plane, a raised 8 x 8 trimesh, two compounds and three each of
    spheres, boxes, capsules, cylinders and tetrahedra dropped onto them
    from a seeded grid. Returns (builder, ids by kind)."""
    scenes = importlib.import_module(pkg.__name__ + ".utils.scenes")
    rng = np.random.default_rng(7)
    b = pkg.WorldBuilder()
    ids = {"plane": b.make_rigidbody(pkg.RigidBodyDef(
        kind=pkg.KIND_STATIC, shape=pkg.PlaneShape((0, 1, 0), 0.0),
        material=pkg.Material(friction=0.6)))}
    verts, tris = scenes.grid_mesh(8, 8, 1.0)
    ids["mesh"] = b.make_rigidbody(pkg.RigidBodyDef(
        kind=pkg.KIND_STATIC, shape=pkg.MeshShape(verts, tris),
        position=(8.0, 0.5, 0.0), material=pkg.Material(friction=0.7)))
    tet = pkg.PolyhedronShape(np.array(
        [[0.25, 0.25, 0.25], [0.25, -0.25, -0.25],
         [-0.25, 0.25, -0.25], [-0.25, -0.25, 0.25]], np.float32))
    comp = pkg.CompoundShape(children=[
        (pkg.SphereShape(0.2), (0.0, 0.0, 0.0), (0, 0, 0, 1)),
        (pkg.BoxShape((0.15, 0.15, 0.15)), (0.4, 0.0, 0.0), (0, 0, 0, 1))])
    shapes = {"sphere": pkg.SphereShape(0.25),
              "box": pkg.BoxShape((0.2, 0.25, 0.3)),
              "capsule": pkg.CapsuleShape(0.15, 0.25),
              "cylinder": pkg.CylinderShape(0.2, 0.2, 1),
              "tet": tet, "compound": comp}
    k = 0
    for name, shape in shapes.items():
        for j in range(2 if name == "compound" else 3):
            x = -3.0 + 1.2 * (k % 6) + (8.0 if k % 2 else 0.0)
            z = -1.5 + 1.5 * (k // 6)
            q = rng.normal(size=4)
            ids.setdefault(name, []).append(b.make_rigidbody(pkg.RigidBodyDef(
                mass=1.0 + 0.5 * j, shape=shape,
                position=(x, 1.2 + 0.3 * (k % 3), z),
                orientation=tuple(q / np.linalg.norm(q)),
                material=pkg.Material(friction=0.5, restitution=0.1))))
            k += 1
    return b, ids


class Live:
    """The scene in both packages, and the port's settled state as a numpy
    tree."""

    def __init__(self):
        bj, self.ids = live_scene(ej)
        bt, _ = live_scene(et)
        cap = len(bj.defs) + SPARE
        self.jw = ej.make_world(bj, capacity=cap)
        self.tw = et.make_world(bt, capacity=cap, device="cpu")
        self.jstate0, self.jmeta, self.jset = (self.jw.state, self.jw.meta,
                                               self.jw.settings)
        self.tmeta, self.tset = self.tw.meta, self.tw.settings
        self.trees = []
        for _ in range(SETTLE):
            self.tw.step()
            self.trees.append(state_to_numpy(self.tw.state))
        self.tree = self.trees[-1]

    def worlds(self, tree=None):
        """Both worlds reset to ``tree`` (default: the settled state)."""
        tree = self.tree if tree is None else tree
        self.jw.state = to_jax(tree, self.jstate0)
        self.jw.meta, self.jw.settings = self.jmeta, self.jset
        self.tw.state = state_from_numpy(tree, "cpu")
        self.tw.meta, self.tw.settings = self.tmeta, self.tset
        return self.jw, self.tw


@pytest.fixture(scope="module")
def live():
    return Live()


def assert_same_state(jstate, tstate, near=()):
    """Every field of the two states equal; inverse inertias within 1 ulp
    of float32, the fields in ``near`` within ``MATVEC_RTOL``."""
    want, got = jtree(jstate), state_to_numpy(tstate)
    assert want.keys() == got.keys()
    for name in want:
        w, g = want[name], got[name]
        pairs = ([(f"{name}.{k}", w[k], g[k]) for k in w]
                 if isinstance(w, dict) else [(name, w, g)])
        for label, a, b in pairs:
            a = np.asarray(a)
            assert a.shape == b.shape, label
            if name in ULP_FIELDS:
                ulp = np.spacing(np.abs(a).astype(np.float32))
                assert (np.abs(a - b) <= ulp).all(), label
            elif name in near:
                np.testing.assert_allclose(b, a, rtol=MATVEC_RTOL, atol=0,
                                           err_msg=label)
            else:
                np.testing.assert_array_equal(b, a, err_msg=label)


# each case: (name, mutation(world, pkg, ids))
MUTATIONS = [
    ("set_center_of_mass", lambda w, p, ids: w.set_center_of_mass(
        ids["box"][0], (0.05, -0.02, 0.01))),
    ("set_roll_direction", lambda w, p, ids: w.set_roll_direction(
        ids["cylinder"][1], (0.0, 0.0, 1.0))),
    ("apply_impulse", lambda w, p, ids: w.apply_impulse(
        ids["box"][1], (1.0, 2.0, -3.0), (0.1, 0.0, 0.2))),
    ("apply_torque_impulse", lambda w, p, ids: w.apply_torque_impulse(
        ids["capsule"][0], (0.3, -0.2, 0.1))),
    ("set_position", lambda w, p, ids: w.set_position(
        ids["sphere"][0], (1.0, 3.0, 1.0))),
    ("set_position_and_orientation", lambda w, p, ids: w.set_position(
        ids["tet"][2], (-1.0, 2.5, 0.5), (0.0, 0.38268343, 0.0, 0.9238795))),
    ("set_velocity", lambda w, p, ids: w.set_velocity(
        ids["tet"][0], (0.5, 1.0, 0.0), (0.0, 2.0, -1.0))),
    ("set_velocity_linear_only", lambda w, p, ids: w.set_velocity(
        ids["sphere"][2], linvel=(0.0, 4.0, 0.0))),
    ("exclude_collision", lambda w, p, ids: w.exclude_collision(
        ids["box"][0], ids["sphere"][1]).exclude_collision(
        ids["sphere"][1], ids["box"][0])),
    ("set_mass", lambda w, p, ids: w.set_mass(ids["box"][2], 3.0)),
    ("set_inertia_diagonal", lambda w, p, ids: w.set_inertia(
        ids["box"][2], (0.2, 0.3, 0.4))),
    ("set_inertia_full", lambda w, p, ids: w.set_inertia(
        ids["capsule"][1], [[0.3, 0.01, 0.0], [0.01, 0.2, 0.02],
                            [0.0, 0.02, 0.25]])),
    ("set_friction", lambda w, p, ids: w.set_friction(
        ids["cylinder"][0], 0.3)),
    ("set_gravity_default", lambda w, p, ids: w.set_gravity(
        (0.0, -2.0, 0.5))),
    ("set_gravity_body", lambda w, p, ids: w.set_gravity(
        (1.0, -1.0, 0.0), ids["sphere"][1])),
    ("set_kind_static", lambda w, p, ids: w.set_kind(
        ids["box"][0], p.KIND_STATIC)),
    ("set_kind_kinematic", lambda w, p, ids: w.set_kind(
        ids["cylinder"][2], p.KIND_KINEMATIC)),
    ("set_kind_static_then_dynamic", lambda w, p, ids: w.set_kind(
        ids["capsule"][2], p.KIND_STATIC).set_kind(
        ids["capsule"][2], p.KIND_DYNAMIC, mass=2.5)),
    ("set_shape_sphere", lambda w, p, ids: w.set_shape(
        ids["box"][1], p.SphereShape(0.3))),
    ("set_shape_cylinder", lambda w, p, ids: w.set_shape(
        ids["sphere"][0], p.CylinderShape(0.2, 0.3, 2))),
    ("spawn_sphere", lambda w, p, ids: w.spawn(p.RigidBodyDef(
        mass=2.0, shape=p.SphereShape(0.3), position=(0.0, 4.0, 0.0),
        linvel=(0.0, -1.0, 0.0)))),
    ("spawn_box_center_of_mass", lambda w, p, ids: w.spawn(p.RigidBodyDef(
        mass=1.5, shape=p.BoxShape((0.1, 0.2, 0.3)),
        position=(1.0, 3.0, 0.0), orientation=(0.1, 0.2, 0.3, 0.9),
        angvel=(0.0, 1.0, 0.0), center_of_mass=(0.02, 0.0, -0.01),
        material=p.Material(friction=0.4, spin_friction=0.01)))),
    ("spawn_polyhedron", lambda w, p, ids: w.spawn(p.RigidBodyDef(
        mass=1.0, shape=p.PolyhedronShape(np.array(
            [[0.25, 0.25, 0.25], [0.25, -0.25, -0.25],
             [-0.25, 0.25, -0.25], [-0.25, -0.25, 0.25]], np.float32)),
        position=(-2.0, 3.0, 1.0), collision_group=2, collision_mask=5),
        poly_index=0)),
    ("spawn_static_and_no_material", lambda w, p, ids: w.spawn(
        p.RigidBodyDef(kind=p.KIND_STATIC, shape=p.BoxShape((1, 0.1, 1)),
                       position=(0.0, 5.0, 3.0), material=None,
                       sleeping_disabled=True, networked=True))),
    ("destroy", lambda w, p, ids: w.destroy(ids["compound"][0])),
    ("destroy_then_spawn_reuses_slot", lambda w, p, ids: w.destroy(
        ids["tet"][1]).spawn(p.RigidBodyDef(
            mass=1.0, shape=p.CapsuleShape(0.1, 0.2, 2),
            position=(0.5, 2.0, 0.5)))),
    ("wake_set", lambda w, p, ids: w.put_to_sleep().wake_set(
        {ids["box"][2], ids["sphere"][1]})),
    ("wake_set_empty", lambda w, p, ids: w.put_to_sleep().wake_set(set())),
    ("put_to_sleep", lambda w, p, ids: w.put_to_sleep()),
    ("put_to_sleep_some", lambda w, p, ids: w.put_to_sleep(
        [ids["box"][0], ids["plane"], ids["compound"][1]])),
    ("wake_up", lambda w, p, ids: w.put_to_sleep().wake_up(ids["box"][0])),
]


@pytest.mark.parametrize("mutation", MUTATIONS, ids=lambda m: m[0])
def test_mutator_parity(live, mutation):
    name, fn = mutation
    jw, tw = live.worlds()
    rj = fn(jw, ej, live.ids)
    rt = fn(tw, et, live.ids)
    if not isinstance(rj, ej.World):
        assert rj == rt  # a spawn's slot
    assert_same_state(jw.state, tw.state,
                      ("angvel",) if name in MATVEC_CASES else ())
    assert jw.meta.types_present == tw.meta.types_present
    assert jw.meta.has_spin_roll == tw.meta.has_spin_roll
    assert jw.settings.gravity == tw.settings.gravity
    for i in (None, live.ids["sphere"][1], live.ids["box"][0]):
        np.testing.assert_array_equal(tw.get_gravity(i), jw.get_gravity(i))


def test_queries_and_events_parity(live):
    """query_aabb, manifold_between (every table slot's pair and some
    pairs without one) and contact_events answer alike."""
    jw, tw = live.worlds()
    rng = np.random.default_rng(3)
    for _ in range(20):
        c = rng.uniform((-4, -0.5, -3), (12, 2.5, 3))
        h = rng.uniform(0.1, 2.5, 3)
        for inc in (True, False):
            assert tw.query_aabb(c - h, c + h, inc) == \
                jw.query_aabb(c - h, c + h, inc)
    man = live.tree["contacts"]
    pairs = {(int(a), int(b)) for a, b, v in zip(
        man["body_a"], man["body_b"], man["valid"]) if v}
    assert len(pairs) > 10
    pairs |= {(0, 1), (2, 30), (5, 5)}
    touching = 0
    for a, b in sorted(pairs):
        want, got = jw.manifold_between(b, a), tw.manifold_between(b, a)
        assert (want is None) == (got is None), (a, b)
        assert tw.manifold_exists(a, b) == jw.manifold_exists(a, b)
        if want is None:
            continue
        touching += 1
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=f"{(a, b)} {k}")
    assert touching > 10
    for i, j in ((10, SETTLE - 1), (30, 40), (SETTLE - 1, 0)):
        prev, new = live.trees[i], live.trees[j]
        want = jev.contact_events(to_jax(prev, live.jstate0),
                                  to_jax(new, live.jstate0))
        got = tev.contact_events(state_from_numpy(prev, "cpu"),
                                 state_from_numpy(new, "cpu"))
        assert got == want
    assert want[0] == [] and want[1] != []


def test_step_with_events_start_and_end_in_one_call():
    """One call in which a body that rests on the floor is teleported away
    (its contact ends) and a falling body lands (its contact starts): both
    events come out, so the state kept before the step was not written by
    the step or the setters."""
    b = et.WorldBuilder()
    b.make_rigidbody(et.RigidBodyDef(
        kind=et.KIND_STATIC, shape=et.PlaneShape((0, 1, 0), 0.0)))
    rest = b.make_rigidbody(et.RigidBodyDef(
        mass=1.0, shape=et.SphereShape(0.2), position=(0.0, 0.2, 0.0)))
    drop = b.make_rigidbody(et.RigidBodyDef(
        mass=1.0, shape=et.SphereShape(0.2), position=(3.0, 0.25, 0.0),
        sleeping_disabled=True))
    w = et.make_world(b, device="cpu")
    w.step(2)
    assert w.manifold_exists(0, rest) and not w.manifold_exists(0, drop)
    before = w.state
    pos0 = before.pos.clone()
    w.set_position(rest, (-3.0, 5.0, 0.0))
    started, ended = w.step_with_events(8)
    assert (0, drop) in started, started
    assert (0, rest) in ended, ended
    assert torch.equal(before.pos, pos0)


def test_world_has_every_public_method():
    def methods(cls):
        return {n for n in dir(cls) if not n.startswith("_")
                and callable(getattr(cls, n))}
    missing = methods(ej.World) - methods(et.World)
    assert not missing, sorted(missing)
