"""Module parity of the port's joints (``edyn_tpu_torch.constraints``) with
the JAX package's, on the CPU.

- Both packages' ``finalize`` on one builder holding every joint type and
  option variant give bit-equal joint tables, and ``state_from_numpy``
  carries a stepped jointed state across bit for bit.
- ``build_joint_rows`` (every ``JointRows`` field and the new tracked
  angle), ``warm_start_joints``, ``solve_joints_once``,
  ``solve_joint_positions`` and ``apply_gravity_joints`` on random poses and
  velocities from a numpy seed, with some bodies asleep and spare (invalid)
  joint slots, one case per joint type and variant and one with all of
  them. The JAX functions run op by op (``jax.disable_jit``). The velocity
  functions get the same rows in both packages, so each is held alone.
- Skipping absent joint types is exact; the tracked hinge angle across
  +-pi, the cone row's cap (ROADMAP R8), islands and sleep over joint
  edges, and the import rule.

Tolerances: row fields rtol 1e-5, atol 1e-5 (``tA``/``tB`` differ by the
inertia products' rounding, ~1e-7 relative); the velocity functions
rtol 1e-6, atol 1e-6; positions after 3 NGS iterations rtol 1e-5, atol
1e-5; the tracked angle atol 1e-5.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import edyn_tpu as ej
from edyn_tpu.constraints import joints as JJ
from edyn_tpu.dynamics import islands as jislands

import edyn_tpu_torch as et
from edyn_tpu_torch.constraints import joints as TJ
from edyn_tpu_torch.core.convert import state_from_numpy, state_to_numpy
from edyn_tpu_torch.dynamics import islands as tislands

from test_torch_step import jtree, one_thread, to_jax  # noqa: F401

DT = 1.0 / 60.0
ROWS_TOL = dict(rtol=1e-5, atol=1e-5)
VEL_TOL = dict(rtol=1e-6, atol=1e-6)


def _hinge(**kw):
    return lambda p, b, x, y: p.make_hinge_constraint(
        b, x, y, (0.2, 0, 0), (-0.2, 0, 0), (0, 0, 1), (0, 0.3, 1), **kw)


def _generic(**kw):
    return lambda p, b, x, y: p.make_generic_constraint(
        b, x, y, (0.1, 0, 0), (-0.1, 0, 0), **kw)


def _cv(**kw):
    return lambda p, b, x, y: p.make_cvjoint_constraint(
        b, x, y, (0, 0, 0.3), (0, 0, -0.3), (0, 0, 1), (0, 0, 1), **kw)


# one joint factory call per variant: (package, builder, body a, body b)
VARIANTS = {
    "distance": lambda p, b, x, y: p.make_distance_constraint(
        b, x, y, (0.1, 0, 0), (-0.1, 0.05, 0), 0.8),
    "soft_distance": lambda p, b, x, y: p.make_soft_distance_constraint(
        b, x, y, (0, 0, 0), (0, 0.1, 0), distance=1.0, stiffness=200.0,
        damping=5.0),
    "point": lambda p, b, x, y: p.make_point_constraint(
        b, x, y, (0.2, 0, 0), (-0.2, 0, 0.1)),
    "hinge": _hinge(),
    "hinge_limit": _hinge(has_limit=True, limit_min=-0.4, limit_max=0.6,
                          limit_restitution=0.3),
    "hinge_friction_damping": _hinge(friction_torque=0.5, damping=0.2),
    "hinge_spring": _hinge(spring_stiffness=20.0, rest_angle=0.3),
    "hinge_bump_stop": _hinge(has_limit=True, limit_min=-1.0, limit_max=1.0,
                              bump_stop_stiffness=60.0, bump_stop_angle=0.4),
    "cone": lambda p, b, x, y: p.make_cone_constraint(
        b, x, y, (0.2, 0, 0), (-0.2, 0, 0), axis_a=(1, 0, 0),
        axis_b=(1, 0, 0), span_y=0.05, span_z=0.08),
    "generic_locked": _generic(),
    "generic_slider": lambda p, b, x, y: _generic(linear_dofs=(
        p.dof(offset_min=-0.5, offset_max=0.5, limit_restitution=0.2,
              bump_stop_size=0.1, bump_stop_stiffness=50.0),
        p.dof(), p.dof()))(p, b, x, y),
    "generic_linear_spring": lambda p, b, x, y: _generic(linear_dofs=(
        p.dof(limit_enabled=False, spring_stiffness=30.0, damping=0.3,
              rest=0.1),
        p.dof(limit_enabled=False, friction=0.2), p.dof()))(p, b, x, y),
    "generic_angular": lambda p, b, x, y: _generic(angular_dofs=(
        p.dof(limit_enabled=False, friction=0.2),
        p.dof(offset_min=-0.3, offset_max=0.3, bump_stop_size=0.1,
              bump_stop_stiffness=20.0, limit_restitution=0.1),
        p.dof(limit_enabled=False, spring_stiffness=5.0, damping=0.1,
              rest=0.2)))(p, b, x, y),
    "generic_lock_angular": _generic(lock_angular=(True, False, True),
                                     frame_b=(0.0, 0.0, 0.38268343,
                                              0.92387953)),
    "cvjoint": _cv(),
    "cvjoint_twist_limit": _cv(
        twist_min=-0.4, twist_max=0.4, twist_restitution=0.3,
        twist_bump_stop_angle=0.1, twist_bump_stop_stiffness=40.0,
        twist_friction_torque=0.2, twist_damping=0.1),
    "cvjoint_springs": _cv(
        twist_rest_angle=0.2, twist_stiffness=10.0, rest_direction=(0, 1, 1),
        bend_stiffness=5.0, bend_friction_torque=0.1, bend_damping=0.05),
    "null": lambda p, b, x, y: p.make_null_constraint(b, x, y),
    "gravity": lambda p, b, x, y: p.make_gravity_constraint(b, x, y),
}
# body pairs the joints of one case take in turn: static anchors 0 and 1,
# dynamic bodies 2-11 (3 and 4 asleep in the random states)
PAIRS = [(0, 2), (2, 3), (3, 4), (1, 5), (5, 6), (6, 7), (8, 9), (9, 10),
         (10, 11), (11, 2)]
N_BODIES = 12
SPARE = 2  # invalid joint slots at the end of the table


def scene(pkg, names):
    """Two static anchors and ten dynamic bodies of several shapes and
    masses, with the joints of ``names`` in turn on PAIRS."""
    b = pkg.WorldBuilder()
    b.make_rigidbody(pkg.RigidBodyDef(
        kind=pkg.KIND_STATIC, position=(0, 5, 0), shape=None, material=None))
    b.make_rigidbody(pkg.RigidBodyDef(
        kind=pkg.KIND_STATIC, shape=pkg.SphereShape(0.05),
        position=(3, 5, 0)))
    shapes = (pkg.BoxShape((0.2, 0.1, 0.15)), pkg.SphereShape(0.15),
              pkg.CapsuleShape(0.05, 0.3), pkg.CylinderShape(0.1, 0.2))
    for i in range(N_BODIES - 2):
        b.make_rigidbody(pkg.RigidBodyDef(
            mass=0.5 + 0.4 * i, shape=shapes[i % 4],
            position=(0.4 * i, 4.0, 0.1 * i)))
    for k, name in enumerate(names):
        x, y = PAIRS[k % len(PAIRS)]
        VARIANTS[name](pkg, b, x, y)
    return b


def _tables_equal(tj, jj):
    for f in dataclasses.fields(jj):
        np.testing.assert_array_equal(getattr(tj, f.name).cpu().numpy(),
                                      np.asarray(getattr(jj, f.name)),
                                      err_msg=f.name)


def test_finalize_tables_bit_equal():
    names = list(VARIANTS)
    jst = scene(ej, names).finalize(max_joints=len(names) + SPARE)
    tst = scene(et, names).finalize(max_joints=len(names) + SPARE,
                                    device="cpu")
    _tables_equal(tst.joints, jst.joints)
    assert int(tst.joints.valid.sum()) == len(names)
    np.testing.assert_array_equal(tst.exclusions.numpy(),
                                  np.asarray(jst.exclusions))


def test_state_round_trip_bit_equal():
    """A jointed state stepped until its angles and impulses are not zero,
    held in a JAX state, crosses to the port and back bit for bit. (The
    steps are the port's on the CPU, carried into the JAX package's state
    structure: no compile of the JAX step.)"""
    J = len(VARIANTS) + SPARE
    tw = et.make_world(scene(et, list(VARIANTS)), max_joints=J,
                       device="cpu")
    tw.step(5)
    like = scene(ej, list(VARIANTS)).finalize(max_joints=J)
    tree = jtree(to_jax(state_to_numpy(tw.state), like))
    assert np.abs(tree["joints"]["impulses"]).max() > 0
    assert np.abs(tree["joints"]["angle"]).max() > 0
    back = state_to_numpy(state_from_numpy(tree, "cpu"))
    for name, val in tree.items():
        if isinstance(val, dict):
            for k, v in val.items():
                np.testing.assert_array_equal(back[name][k], v, err_msg=k)
        else:
            np.testing.assert_array_equal(back[name], val, err_msg=name)


def _random_states(names, seed, spread):
    """(JAX state, port state) of ``scene(names)`` with random poses and
    velocities, bodies 3 and 4 asleep, random carried angles and impulses.
    ``spread`` bounds each body's rotation angle from identity."""
    rng = np.random.default_rng(seed)
    J = len(names) + SPARE
    st = scene(ej, names).finalize(max_joints=J)
    n = st.capacity
    dyn = np.asarray(st.is_dynamic)
    pos = np.asarray(st.pos) + rng.normal(0, 0.2, (n, 3)) * dyn[:, None]
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = rng.uniform(0, spread, n) * dyn
    orn = np.concatenate([axis * np.sin(ang / 2)[:, None],
                          np.cos(ang / 2)[:, None]], 1)
    linvel = rng.normal(0, 1.0, (n, 3)) * dyn[:, None]
    angvel = rng.normal(0, 2.0, (n, 3)) * dyn[:, None]
    asleep = np.zeros(n, bool)
    asleep[[3, 4]] = True
    jt = st.joints
    angle = np.where(np.asarray(jt.valid), rng.uniform(-4, 4, J), 0.0)
    imp = rng.normal(0, 0.1, (J, 24)) * np.asarray(jt.valid)[:, None]
    f = lambda x: jnp.asarray(np.asarray(x, np.float32))
    st = dataclasses.replace(
        st, pos=f(pos), orn=f(orn), linvel=f(linvel), angvel=f(angvel),
        asleep=jnp.asarray(asleep),
        joints=dataclasses.replace(jt, angle=f(angle), impulses=f(imp)))
    return st, state_from_numpy(jtree(st), "cpu")


def _rows_to_torch(rows):
    out = {}
    for fld in dataclasses.fields(rows):
        x = torch.as_tensor(np.array(getattr(rows, fld.name)))
        out[fld.name] = x.long() if fld.name in ("a", "b", "ab") else x
    return TJ.JointRows(**out)


# cases: one per variant, and every variant in one table (later rows of
# other types write the same slots). Random orientations swing the cones
# anywhere: the port's default cone row is the JAX package's, unbounded
# (R8; the opt-in cap is held in test_cone_violation_is_capped).
CASES = [[n] * 6 for n in VARIANTS] + [list(VARIANTS)]
IDS = list(VARIANTS) + ["all"]


@pytest.fixture(scope="module", params=range(len(CASES)), ids=IDS)
def case(request):
    names = CASES[request.param]
    jst, tst = _random_states(names, seed=request.param, spread=np.pi)
    with jax.disable_jit():
        jrows, jangle = JJ.build_joint_rows(jst, DT)
    trows, tangle = TJ.build_joint_rows(tst, DT)
    return dict(names=names, jst=jst, tst=tst, jrows=jrows, jangle=jangle,
                trows=trows, tangle=tangle,
                rng=np.random.default_rng(100 + request.param))


def test_build_joint_rows(case):
    jr, tr = case["jrows"], case["trows"]
    for fld in dataclasses.fields(jr):
        got = getattr(tr, fld.name).numpy()
        want = np.asarray(getattr(jr, fld.name))
        if got.dtype == bool or fld.name in ("a", "b", "ab", "group"):
            np.testing.assert_array_equal(got, want, err_msg=fld.name)
        else:
            np.testing.assert_allclose(got, want, err_msg=fld.name,
                                       **ROWS_TOL)
    np.testing.assert_allclose(case["tangle"].numpy(),
                               np.asarray(case["jangle"]), rtol=0, atol=1e-5)
    rvalid = np.asarray(jr.valid).reshape(-1, 24)
    if case["names"][0] not in ("null", "gravity"):
        # rows exist, and none for a joint whose bodies both sleep or for
        # the spare slots
        assert rvalid.any()
        assert not rvalid[-SPARE:].any()
        jvalid = np.asarray(case["jst"].joints.valid)
        sleeping = np.isin(np.asarray(case["jst"].joints.body_a), [3, 4]) \
            & np.isin(np.asarray(case["jst"].joints.body_b), [3, 4])
        assert not rvalid[jvalid & sleeping].any()


def test_warm_start_and_solve_once(case):
    jr = case["jrows"]
    tr = _rows_to_torch(jr)
    rng = case["rng"]
    N = case["jst"].capacity
    J = jr.rhs.shape[0] // 24
    dvw = rng.normal(0, 0.5, (N, 6)).astype(np.float32)
    imp = (rng.normal(0, 0.2, (J, 24)).astype(np.float32))
    with jax.disable_jit():
        jw = JJ.warm_start_joints(jr, jnp.asarray(imp), jnp.asarray(dvw))
        ji, jd = JJ.solve_joints_once(jr, jnp.asarray(imp), jw)
    tw = TJ.warm_start_joints(tr, torch.as_tensor(imp), torch.as_tensor(dvw))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **VEL_TOL)
    ti, td = TJ.solve_joints_once(tr, torch.as_tensor(imp), torch.as_tensor(
        np.asarray(jw)))
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **VEL_TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **VEL_TOL)


def test_solve_joint_positions(case):
    with jax.disable_jit():
        want = JJ.solve_joint_positions(case["jst"], 3)
    got = TJ.solve_joint_positions(case["tst"], 3)
    for f in ("pos", "orn"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)


def test_apply_gravity_joints(case):
    """Masses of 1e9 and no velocity, so the pull shows in float32."""
    jst = dataclasses.replace(
        case["jst"], linvel=jnp.zeros_like(case["jst"].linvel),
        mass_inv=jnp.where(case["jst"].mass_inv > 0, 1e-9, 0.0))
    tst = state_from_numpy(jtree(jst), "cpu")
    with jax.disable_jit():
        want = np.asarray(JJ.apply_gravity_joints(jst, DT).linvel)
    got = TJ.apply_gravity_joints(tst, DT).linvel.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    assert (np.abs(want).max() > 1e-4) == ("gravity" in case["names"])


ALL_TYPES = frozenset(TJ.JointType)


def test_type_skip_is_exact(case):
    """Skipping the sections of absent joint types changes no bit of the
    rows, the angles or the corrected poses."""
    rows, angle = TJ.build_joint_rows(case["tst"], DT)
    pos = TJ.solve_joint_positions(case["tst"], 3)
    rows_all, angle_all = TJ.build_joint_rows(case["tst"], DT,
                                              types=ALL_TYPES)
    pos_all = TJ.solve_joint_positions(case["tst"], 3, types=ALL_TYPES)
    for fld in dataclasses.fields(rows):
        assert torch.equal(getattr(rows, fld.name),
                           getattr(rows_all, fld.name)), fld.name
    assert torch.equal(angle, angle_all)
    assert torch.equal(pos.pos, pos_all.pos)
    assert torch.equal(pos.orn, pos_all.orn)


def test_type_skip_is_exact_over_ragdoll_steps():
    """Ten whole steps of two ragdolls dropped on the floor (point, cone
    and hinge joints only), with and without the skip: equal bit for
    bit."""
    from chip_smoke import ragdoll_pile

    def run(types=None):
        w = et.make_world(ragdoll_pile(et, 2, seed=0, layers=1)[0],
                          device="cpu")
        assert w.meta.joint_types == {TJ.JointType.POINT, TJ.JointType.CONE,
                                      TJ.JointType.HINGE}
        if types is not None:
            w.meta = dataclasses.replace(w.meta, joint_types=types)
        w.step(10)
        return w.state

    skip = run()
    full = run(ALL_TYPES)
    for f in ("pos", "orn", "linvel", "angvel"):
        assert torch.equal(getattr(skip, f), getattr(full, f)), f
    for f in ("impulses", "angle"):
        assert torch.equal(getattr(skip.joints, f), getattr(full.joints, f))


@pytest.mark.parametrize("carried,turn", [
    (np.pi - 0.01, np.pi + 0.02), (-np.pi + 0.01, -np.pi - 0.02),
    (3 * np.pi - 0.01, 3 * np.pi + 0.02), (0.3, 0.35)])
def test_hinge_angle_across_pi(carried, turn):
    """A z-axis hinge (both frames the factory's for z) whose body B has
    turned by ``turn`` about z, from a carried angle near it: the tracked
    angle follows continuously across +-pi (a floored modulo; a truncated
    one jumps by 2 pi)."""
    st = scene(ej, ["hinge"]).finalize(max_joints=1)
    q = np.array([0, 0, np.sin(turn / 2), np.cos(turn / 2)], np.float32)
    orn = np.tile(np.array([0, 0, 0, 1], np.float32), (st.capacity, 1))
    orn[2] = q
    jt = st.joints
    jst = dataclasses.replace(
        st, orn=jnp.asarray(orn), joints=dataclasses.replace(
            jt, frame_b=jt.frame_a,
            params=jt.params.at[0, 9].set(1.0).at[0, 0].set(-10.0)
            .at[0, 1].set(10.0),
            angle=jnp.asarray([carried], jnp.float32)))
    tst = state_from_numpy(jtree(jst), "cpu")
    with jax.disable_jit():
        jr, ja = JJ.build_joint_rows(jst, DT)
    tr, ta = TJ.build_joint_rows(tst, DT)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ta.numpy(), [turn], rtol=0, atol=1e-4)
    np.testing.assert_allclose(tr.rhs.numpy(), np.asarray(jr.rhs), **ROWS_TOL)


def test_cone_violation_is_capped():
    """ROADMAP R8: with B's axis 89 degrees from A's, the JAX package's cone
    row asks for thousands of rad/s. The port's default row is the same,
    bit for bit; with ``cone_cap`` it holds the violation at the cap and is
    otherwise the same row."""
    st = scene(ej, ["cone"]).finalize(max_joints=1)
    turn = np.deg2rad(89.0)
    orn = np.tile(np.array([0, 0, 0, 1], np.float32), (st.capacity, 1))
    orn[2] = [0, 0, np.sin(turn / 2), np.cos(turn / 2)]
    jst = dataclasses.replace(st, orn=jnp.asarray(orn))
    tst = state_from_numpy(jtree(jst), "cpu")
    with jax.disable_jit():
        jr, _ = JJ.build_joint_rows(jst, DT)
    tr, _ = TJ.build_joint_rows(tst, DT)
    cap = 2.0
    tc, _ = TJ.build_joint_rows(tst, DT, cone_cap=cap)
    slot = 8  # the cone row
    want = float(np.asarray(jr.rhs)[slot])
    assert bool(tc.valid[slot]) and bool(np.asarray(jr.valid)[slot])
    # no angular velocity: rhs is the bias alone
    assert want > 1e3
    np.testing.assert_array_equal(tr.rhs.numpy(), np.asarray(jr.rhs))
    np.testing.assert_allclose(float(tc.rhs[slot]), cap * 0.5 / DT * TJ.ERP,
                               rtol=1e-6)
    mask = np.ones(24 * 1, bool)
    mask[slot] = False
    np.testing.assert_array_equal(tc.rhs.numpy()[mask],
                                  np.asarray(jr.rhs)[mask])


def test_cone_cap_setting_reaches_the_step():
    """``Settings.cone_max_violation`` caps the cone row inside the step: a
    cone swung 89 degrees gets back far less angular velocity in one step
    with the cap than without it."""
    turn = np.deg2rad(89.0)
    spins = []
    for cap in (None, 2.0):
        b = scene(et, ["cone"])
        w = et.make_world(b, et.Settings(gravity=(0, 0, 0),
                                         cone_max_violation=cap),
                          device="cpu")
        orn = w.state.orn.clone()
        orn[2] = torch.tensor([0, 0, np.sin(turn / 2), np.cos(turn / 2)])
        w.state = dataclasses.replace(w.state, orn=orn)
        w.step()
        spins.append(float(torch.linalg.vector_norm(w.state.angvel[2])))
    assert spins[1] < 0.1 * spins[0], spins


def test_islands_and_sleep_over_joints():
    """Island labels, sleep timers and the asleep mask from joint edges
    only (no contacts), and the label skip once labels are stable."""
    names = ["null", "point", "hinge", "null", "distance", "null"]
    jst, _ = _random_states(names, seed=7, spread=1.0)
    quiet = np.zeros((jst.capacity, 3), np.float32)
    jst = dataclasses.replace(
        jst, linvel=jnp.asarray(quiet), angvel=jnp.asarray(quiet),
        asleep=jnp.zeros_like(jst.asleep),
        sleep_timer=jnp.full_like(jst.sleep_timer, 1.99),
        step_count=jnp.asarray(8, jnp.int32))
    # one island keeps moving: its members' timers reset, the rest sleep
    jst = dataclasses.replace(jst, linvel=jst.linvel.at[6].set(1.0))
    tst = state_from_numpy(jtree(jst), "cpu")
    for skip in (False, True):
        with jax.disable_jit():
            want = jislands.update_sleep(jst, jst.contacts, DT, True, 4,
                                         skip_labels=jnp.asarray(skip))
        got = tislands.update_sleep(tst, tst.contacts, DT, True, 4,
                                    skip_labels=skip)
        for f in ("island_id", "asleep", "sleep_timer", "labels_stable",
                  "linvel"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)
        jst, tst = want, got
    asleep = np.asarray(jst.asleep)
    assert asleep[2:].any() and not asleep[[5, 6, 7]].any()
    for seed in (2, 6, 8):
        np.testing.assert_array_equal(
            tislands.exact_island_mask(tst, [seed]).numpy(),
            np.asarray(jislands.exact_island_mask(jst, [seed])))


def test_world_joint_api_resets_island_stability():
    """``_add_joint``, ``destroy_joint`` and ``wake_up`` on live worlds of
    both packages, from a state with stable labels, the pair-list carry on
    and bodies 8-11 asleep, leave the same flags, sleep state and table."""
    worlds = []
    for pkg, kw in ((ej, {}), (et, {"device": "cpu"})):
        w = pkg.make_world(scene(pkg, ["point", "null"]), max_joints=4, **kw)
        st = w.state
        sleeping = np.zeros(st.capacity, bool)
        sleeping[8:] = True
        arr = ((lambda x: jnp.asarray(x)) if pkg is ej
               else (lambda x: torch.as_tensor(x)))
        w.state = dataclasses.replace(
            st, asleep=arr(sleeping),
            sleep_timer=arr(np.where(sleeping, 2.5, 0.0).astype(np.float32)),
            island_stable_steps=arr(np.int32(20)),
            labels_stable=arr(True), bp_carry_ok=arr(True))
        VARIANTS["hinge"](pkg, w, 8, 9)
        w.destroy_joint(0)
        w.wake_up(10)
        worlds.append(w)
    jw, tw = worlds
    for f in ("island_stable_steps", "labels_stable", "bp_carry_ok",
              "asleep", "sleep_timer"):
        np.testing.assert_array_equal(getattr(tw.state, f).numpy(),
                                      np.asarray(getattr(jw.state, f)),
                                      err_msg=f)
    assert tw.state.asleep.numpy().tolist()[8:] == [False, False, False,
                                                    True]
    assert tw.meta.has_joints
    _tables_equal(tw.state.joints, jw.state.joints)


def test_port_imports_neither_jax_nor_edyn_tpu():
    code = ("import sys\n"
            "import edyn_tpu_torch.constraints.joints\n"
            "import edyn_tpu_torch.constraints.api\n"
            "import edyn_tpu_torch.utils.ragdoll\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'edyn_tpu' or "
            "m.startswith('edyn_tpu.')]\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                   timeout=120)
