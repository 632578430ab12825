"""The JAX package's joint and ragdoll behaviour tests (``tests/
test_joints.py``, ``tests/test_ragdoll.py``) on the port's CPU ``World``:
the same scenes, steps and assertions, as cases of one parametrised test.

All 18 cases are defined here; a tiny jointed world takes ~0.08 s a step
on a CPU, so they run in six files of at most four cases each: this file,
``test_torch_joint_behaviour_b.py``, ``_hinges.py``, ``_hinges_b.py``,
``_ragdoll.py`` and ``_ragdoll_b.py``. (pytest-xdist's ``--dist loadfile``
queues files by their number of tests, so files of four or fewer run after
the suite's long files of few tests, such as ``tests/test_sharding.py``,
and fill the workers around them.) The worlds run on one CPU thread (their
tensors are too small to share)."""
import dataclasses

import numpy as np
import pytest
import torch

import edyn_tpu_torch as et
from edyn_tpu_torch.math import quat
from edyn_tpu_torch.utils import scenes
from edyn_tpu_torch.utils.ragdoll import RagdollDef, make_ragdoll


def world(b, settings=None, **kw):
    return et.make_world(b, settings or et.Settings(), device="cpu", **kw)


def anchored(shape, position, **kw):
    """A builder with a static amorphous anchor at (0, 2, 0) and one body."""
    b = et.WorldBuilder(**kw)
    anchor = b.make_rigidbody(et.RigidBodyDef(
        kind=et.KIND_STATIC, position=(0, 2, 0), shape=None, material=None))
    body = b.make_rigidbody(et.RigidBodyDef(
        mass=1.0, shape=shape, position=position, sleeping_disabled=True))
    return b, anchor, body


def distance_constraint_holds_length():
    b, anchor, bob = anchored(et.SphereShape(0.1), (1.0, 2.0, 0.0))
    et.make_distance_constraint(b, anchor, bob, (0, 0, 0), (0, 0, 0), 1.0)
    w = world(b)
    w.step(300)
    d = np.linalg.norm(w.position(bob) - np.array([0, 2, 0]))
    assert abs(d - 1.0) < 0.05, d
    assert w.position(bob)[1] < 2.0


def point_constraint_pivot_stays():
    b, anchor, rod = anchored(et.CapsuleShape(0.05, 0.5), (0.5, 2.0, 0.0))
    et.make_point_constraint(b, anchor, rod, (0, 0, 0), (-0.5, 0, 0))
    w = world(b)
    for _ in range(10):
        w.step(30)
        piv = (w.state.pos[rod] + quat.rotate(
            w.state.orn[rod], torch.tensor([-0.5, 0.0, 0.0]))).numpy()
        assert np.linalg.norm(piv - [0, 2, 0]) < 0.05, piv


def hinge_constraint_axis_locked():
    b, anchor, rod = anchored(et.CapsuleShape(0.05, 0.4), (0.4, 2.0, 0.0))
    et.make_hinge_constraint(b, anchor, rod, (0, 0, 0), (-0.4, 0, 0),
                             (0, 0, 1), (0, 0, 1))
    w = world(b)
    for _ in range(6):
        w.step(50)
        assert abs(w.position(rod)[2]) < 0.02, "left its plane"
        av = w.angvel(rod)
        assert abs(av[0]) < 0.5 and abs(av[1]) < 0.5


def hinge_limit():
    b, anchor, rod = anchored(et.CapsuleShape(0.05, 0.4), (0.4, 2.0, 0.0))
    et.make_hinge_constraint(b, anchor, rod, (0, 0, 0), (-0.4, 0, 0),
                             (0, 0, 1), (0, 0, 1), has_limit=True,
                             limit_min=-0.3, limit_max=0.3)
    w = world(b)
    w.step(240)
    p = w.position(rod)
    angle = np.arctan2(-p[1] + 2.0, p[0])
    assert angle < 0.45, f"swung past limit: {angle}"


def hinge_limit_restitution_bounce():
    def run(rest, w0=8.0):
        b, anchor, rod = anchored(et.CapsuleShape(0.05, 0.4),
                                  (0.4, 2.0, 0.0))
        et.make_hinge_constraint(b, anchor, rod, (0, 0, 0), (-0.4, 0, 0),
                                 (0, 0, 1), (0, 0, 1), has_limit=True,
                                 limit_min=-0.25, limit_max=0.25,
                                 limit_restitution=rest)
        w = world(b, et.Settings(gravity=(0, 0, 0)))
        # spin the rod about the pivot toward the +limit
        st = w.state
        angvel, linvel = st.angvel.clone(), st.linvel.clone()
        angvel[rod] = torch.tensor([0.0, 0.0, w0])
        linvel[rod] = torch.tensor([0.0, 0.4 * w0, 0.0])
        w.state = dataclasses.replace(st, angvel=angvel, linvel=linvel)
        speeds = []
        for _ in range(25):
            w.step(1)
            speeds.append(float(w.angvel(rod)[2]))
        return np.asarray(speeds)

    s0, s5, s1 = run(0.0), run(0.5), run(1.0)
    assert s0.min() > -0.35, f"e=0 should not bounce: {s0.min()}"
    assert s5.min() < -0.5, f"e=0.5 should bounce: {s5.min()}"
    assert s1.min() < s5.min() - 0.5, (s1.min(), s5.min())


def soft_distance_spring_oscillates_and_damps():
    b = et.WorldBuilder()
    anchor = b.make_rigidbody(et.RigidBodyDef(
        kind=et.KIND_STATIC, position=(0, 3, 0), shape=None, material=None))
    bob = b.make_rigidbody(et.RigidBodyDef(
        mass=1.0, shape=et.SphereShape(0.1), position=(0, 2.0, 0),
        sleeping_disabled=True))
    et.make_soft_distance_constraint(b, anchor, bob, (0, 0, 0), (0, 0, 0),
                                     distance=1.0, stiffness=200.0,
                                     damping=5.0)
    w = world(b)
    w.step(600)
    y = float(w.position(bob)[1])
    assert abs(y - (3.0 - 1.049)) < 0.1, y
    assert np.linalg.norm(w.linvel(bob)) < 0.2


def cone_constraint_limits_swing():
    b, anchor, rod = anchored(et.CapsuleShape(0.05, 0.4), (0.4, 2.0, 0.0))
    et.make_point_constraint(b, anchor, rod, (0, 0, 0), (-0.4, 0, 0))
    et.make_cone_constraint(b, anchor, rod, (0, 0, 0), (-0.4, 0, 0),
                            axis_a=(1, 0, 0), axis_b=(1, 0, 0),
                            span_y=0.4, span_z=0.4)
    w = world(b)
    w.step(300)
    ax = quat.rotate(w.state.orn[rod], torch.tensor([1.0, 0, 0])).numpy()
    angle = np.arccos(np.clip(ax[0], -1, 1))
    assert angle < 0.7, f"swung outside cone: {angle}"


def joint_chain_hangs():
    b, ids = scenes.joint_chain(6)
    w = world(b)
    w.step(400)
    assert w.position(ids[-1])[1] < 5.0
    for a, bb in zip(ids[:-1], ids[1:]):
        gap = np.linalg.norm(w.position(a) - w.position(bb))
        assert gap < 0.7, f"chain broke: {gap}"


def null_constraint_shares_island():
    b = et.WorldBuilder()
    x = b.make_rigidbody(et.RigidBodyDef(
        mass=1.0, shape=et.SphereShape(0.1), position=(0, 0, 0),
        gravity=(0, 0, 0)))
    y = b.make_rigidbody(et.RigidBodyDef(
        mass=1.0, shape=et.SphereShape(0.1), position=(5, 0, 0),
        gravity=(0, 0, 0)))
    et.make_null_constraint(b, x, y)
    w = world(b)
    w.step(5)
    assert int(w.state.island_id[x]) == int(w.state.island_id[y])


def _static_anchor(b):
    return b.make_rigidbody(et.RigidBodyDef(
        kind=et.KIND_STATIC, shape=et.SphereShape(0.05), position=(0, 2, 0)))


def generic_linear_limit_slider():
    b = et.WorldBuilder(gravity=(0.0, 0.0, 0.0))
    anchor = _static_anchor(b)
    slider = b.make_rigidbody(et.RigidBodyDef(
        mass=1.0, shape=et.BoxShape((0.1, 0.1, 0.1)), position=(0, 2, 0),
        linvel=(2.0, 0, 0)))
    et.make_generic_constraint(
        b, anchor, slider, (0, 0, 0), (0, 0, 0),
        linear_dofs=(et.dof(offset_min=-0.5, offset_max=0.5),
                     et.dof(), et.dof()))
    w = world(b)
    xs = []
    for _ in range(90):
        w.step(1)
        xs.append(float(w.position(slider)[0]))
    assert max(abs(x) for x in xs) < 0.56, max(xs)
    assert max(xs) > 0.44, max(xs)
    assert abs(float(w.position(slider)[1]) - 2.0) < 1e-2
    assert abs(float(w.position(slider)[2])) < 1e-2


def generic_linear_spring_oscillates():
    b = et.WorldBuilder(gravity=(0.0, 0.0, 0.0))
    anchor = _static_anchor(b)
    m = b.make_rigidbody(et.RigidBodyDef(
        mass=1.0, shape=et.BoxShape((0.1, 0.1, 0.1)), position=(0.4, 2, 0)))
    et.make_generic_constraint(
        b, anchor, m, (0, 0, 0), (0, 0, 0),
        linear_dofs=(et.dof(limit_enabled=False, spring_stiffness=30.0,
                            damping=0.3),
                     et.dof(), et.dof()),
        disable_collision=True)
    w = world(b)
    xs = []
    for _ in range(240):
        w.step(1)
        xs.append(float(w.position(m)[0]))
    assert min(xs[:80]) < -0.1
    assert abs(xs[-1]) < 0.15, xs[-1]


def generic_angular_friction_spins_down():
    b = et.WorldBuilder(gravity=(0.0, 0.0, 0.0))
    anchor = _static_anchor(b)
    m = b.make_rigidbody(et.RigidBodyDef(
        mass=1.0, shape=et.BoxShape((0.2, 0.2, 0.2)), position=(0, 2, 0),
        angvel=(5.0, 0, 0)))
    et.make_generic_constraint(
        b, anchor, m, (0, 0, 0), (0, 0, 0),
        linear_dofs=(et.dof(), et.dof(), et.dof()),
        angular_dofs=(et.dof(limit_enabled=False, friction=0.2),
                      et.dof(limit_enabled=False),
                      et.dof(limit_enabled=False)))
    w = world(b)
    w0 = float(w.angvel(m)[0])
    spds = []
    for _ in range(120):
        w.step(1)
        spds.append(float(w.angvel(m)[0]))
    assert spds[30] < w0 * 0.8
    assert abs(spds[-1]) < 0.5, spds[-1]


def hinge_bump_stop_soft_landing():
    def run(bump_k):
        b = et.WorldBuilder(gravity=(0.0, 0.0, 0.0))
        anchor = _static_anchor(b)
        arm = b.make_rigidbody(et.RigidBodyDef(
            mass=1.0, shape=et.BoxShape((0.4, 0.05, 0.05)),
            position=(0.5, 2, 0), angvel=(0, 0, 3.0), linvel=(0, 1.5, 0)))
        et.make_hinge_constraint(
            b, anchor, arm, (0, 0, 0), (-0.5, 0, 0), (0, 0, 1), (0, 0, 1),
            limit_min=-1.0, limit_max=1.0, has_limit=True,
            bump_stop_stiffness=bump_k, bump_stop_angle=0.4)
        w = world(b)
        angs = []
        for _ in range(60):
            w.step(1)
            p = np.asarray(w.position(arm)) - np.array([0, 2, 0])
            angs.append(np.arctan2(p[1], p[0]))
        return np.asarray(angs)

    hard, soft = run(0.0), run(60.0)
    assert hard.max() < 1.15 and soft.max() < 1.15
    assert soft.max() < hard.max() - 0.05, (soft.max(), hard.max())


def cvjoint_twist_limits_and_bend_spring():
    b = et.WorldBuilder(gravity=(0.0, 0.0, 0.0))
    anchor = _static_anchor(b)
    m = b.make_rigidbody(et.RigidBodyDef(
        mass=1.0, shape=et.BoxShape((0.1, 0.1, 0.3)), position=(0, 2, 0.6),
        angvel=(0, 0, 4.0)))
    et.make_cvjoint_constraint(
        b, anchor, m, (0, 0, 0.3), (0, 0, -0.3), (0, 0, 1), (0, 0, 1),
        twist_min=-0.4, twist_max=0.4)
    w = world(b)
    w.step(90)
    ang = float(w.state.joints.angle[0])
    assert abs(ang) < 0.5, ang
    wz = float(w.angvel(m)[2])
    assert abs(wz) < 0.6, wz


def cvjoint_twist_lock_transmits_rotation():
    b = et.WorldBuilder(gravity=(0.0, 0.0, 0.0))
    drv = b.make_rigidbody(et.RigidBodyDef(
        kind=et.KIND_KINEMATIC, shape=et.CylinderShape(0.2, 0.3, axis=2),
        position=(0, 2, 0), angvel=(0, 0, 3.0)))
    out = b.make_rigidbody(et.RigidBodyDef(
        mass=1.0, shape=et.CylinderShape(0.2, 0.3, axis=2),
        position=(0, 2, 0.8)))
    et.make_cvjoint_constraint(b, drv, out, (0, 0, 0.4), (0, 0, -0.4),
                               (0, 0, 1), (0, 0, 1))
    w = world(b)
    w.step(60)
    wz = float(w.angvel(out)[2])
    assert abs(wz - 3.0) < 0.2, wz


def runtime_joint_create_and_destroy():
    b = et.WorldBuilder()
    anchor = b.make_rigidbody(et.RigidBodyDef(
        kind=et.KIND_STATIC, shape=et.SphereShape(0.1), position=(0, 5, 0)))
    ball = b.make_rigidbody(et.RigidBodyDef(
        mass=1.0, shape=et.SphereShape(0.2), position=(0, 3, 0),
        sleeping_disabled=True))
    w = world(b, max_joints=4)
    j = et.make_distance_constraint(w, anchor, ball, (0, 0, 0), (0, 0, 0),
                                    distance=2.0)
    w.step(120)
    d = float(np.linalg.norm(w.position(ball) - w.position(anchor)))
    assert abs(d - 2.0) < 0.1, f"runtime joint not enforced: d={d}"
    w.destroy_joint(j)
    w.step(60)
    d = float(np.linalg.norm(w.position(ball) - w.position(anchor)))
    assert d > 2.3, f"destroyed joint still constrains: d={d}"


def runtime_joint_into_joint_free_world():
    b = et.WorldBuilder(gravity=(0.0, 0.0, 0.0))
    a = b.make_rigidbody(et.RigidBodyDef(
        mass=1.0, shape=et.SphereShape(0.2), position=(0, 0, 0),
        sleeping_disabled=True))
    c = b.make_rigidbody(et.RigidBodyDef(
        mass=1.0, shape=et.SphereShape(0.2), position=(1, 0, 0),
        linvel=(1.0, 0, 0), sleeping_disabled=True))
    w = world(b, max_joints=2)
    assert not w.meta.has_joints
    et.make_distance_constraint(w, a, c, (0, 0, 0), (0, 0, 0), distance=1.0)
    assert w.meta.has_joints
    w.step(60)
    d = float(np.linalg.norm(w.position(c) - w.position(a)))
    assert abs(d - 1.0) < 0.15, d


def ragdoll_drops_and_holds_together():
    b = et.WorldBuilder()
    b.make_rigidbody(et.RigidBodyDef(
        kind=et.KIND_STATIC, shape=et.PlaneShape((0, 1, 0), 0.0),
        material=et.Material(friction=0.8)))
    rag = make_ragdoll(b, RagdollDef(position=(0, 0.3, 0)))
    w = world(b)
    w.step(240)
    pos = np.array([w.position(i) for i in rag.bodies()])
    assert pos[:, 1].min() > -0.05, pos[:, 1].min()
    assert np.abs(pos).max() < 5.0, "ragdoll exploded"
    d_head = np.linalg.norm(w.position(rag.head) - w.position(rag.torso_upper))
    assert d_head < 0.5, d_head
    d_knee = np.linalg.norm(w.position(rag.upper_leg_left)
                            - w.position(rag.lower_leg_left))
    assert d_knee < 0.5, d_knee


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = [soft_distance_spring_oscillates_and_damps,
         distance_constraint_holds_length, generic_linear_limit_slider,
         cvjoint_twist_limits_and_bend_spring,
         cvjoint_twist_lock_transmits_rotation,
         runtime_joint_into_joint_free_world, null_constraint_shares_island]
HINGE_CASES = [joint_chain_hangs, point_constraint_pivot_stays,
               hinge_constraint_axis_locked, hinge_bump_stop_soft_landing,
               hinge_limit_restitution_bounce]
RAGDOLL_CASES = [ragdoll_drops_and_holds_together,
                 generic_linear_spring_oscillates,
                 cone_constraint_limits_swing, hinge_limit,
                 runtime_joint_create_and_destroy,
                 generic_angular_friction_spins_down]


@pytest.mark.parametrize("case", CASES[:4], ids=lambda f: f.__name__)
def test_behaviour(case):
    case()
