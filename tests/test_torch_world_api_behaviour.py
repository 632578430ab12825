"""The JAX package's world-API and sleep tests on the port's CPU ``World``:
``tests/test_world_api.py`` (the cases at :10-129; the overflow test stays
the JAX package's, ROADMAP R1) and the ``tests/test_simulation.py`` cases
that call the setters, spawn, destroy and the sleep API. The same scenes,
steps and assertions, as cases of one parametrised test: the first four
here, the rest in ``test_torch_world_api_behaviour_b.py``, ``_c.py`` and
``_d.py`` (files of at most four tests, see
``test_torch_joint_behaviour.py``). The worlds run on one CPU thread."""
import dataclasses

import numpy as np
import pytest
import torch

import edyn_tpu_torch as et
from edyn_tpu_torch.dynamics.islands import RESET_PERIOD
from edyn_tpu_torch.utils import scenes
from test_torch_step import one_thread  # noqa: F401


def world(builder, **kw):
    return et.make_world(builder, device="cpu", **kw)


def settle(w, steps):
    w.step(steps)
    w.block_until_ready()
    return w


# --- tests/test_world_api.py -------------------------------------------
def change_kind_dynamic_to_static_and_back():
    b, box = scenes.hello_world()
    w = world(b)
    w.step(30)
    y0 = float(w.position(box)[1])
    w.set_kind(box, et.KIND_STATIC)
    w.step(60)
    assert abs(float(w.position(box)[1]) - y0) < 1e-5, "static body moved"
    w.set_kind(box, et.KIND_DYNAMIC, mass=10.0)
    w.step(30)
    assert float(w.position(box)[1]) < y0 - 0.05, "dynamic body didn't fall"


def gravity_api():
    b = et.WorldBuilder()
    ball = b.make_rigidbody(et.RigidBodyDef(
        mass=1.0, shape=et.SphereShape(0.1), position=(0, 100, 0),
        sleeping_disabled=True))
    custom = b.make_rigidbody(et.RigidBodyDef(
        mass=1.0, shape=et.SphereShape(0.1), position=(5, 100, 0),
        gravity=(0.0, -1.0, 0.0), sleeping_disabled=True))
    w = world(b)
    assert np.allclose(w.get_gravity(), (0, -9.8, 0))
    w.set_gravity((0.0, -2.0, 0.0))
    assert np.allclose(w.get_gravity(), (0, -2.0, 0))
    assert np.allclose(w.get_gravity(ball), (0, -2.0, 0))
    assert np.allclose(w.get_gravity(custom), (0, -1.0, 0))
    w.step(60)
    dt = w.settings.fixed_dt
    assert abs(float(w.linvel(ball)[1]) + 2.0 * 60 * dt) < 1e-3
    assert abs(float(w.linvel(custom)[1]) + 1.0 * 60 * dt) < 1e-3


def mass_inertia_friction_setters():
    b, box = scenes.hello_world()
    w = world(b)
    w.set_mass(box, 2.0)
    w.apply_impulse(box, (2.0, 0.0, 0.0))
    assert abs(float(w.linvel(box)[0]) - 1.0) < 1e-6
    w.set_inertia(box, (2.0, 2.0, 2.0))
    w.apply_torque_impulse(box, (0.0, 4.0, 0.0))
    assert abs(float(w.angvel(box)[1]) - 2.0) < 1e-6
    w.set_friction(box, 0.123)
    assert abs(float(w.state.friction[box]) - 0.123) < 1e-6


def manifold_between():
    b, box = scenes.hello_world()
    w = world(b)
    w.step(1)
    assert not w.manifold_exists(0, box)   # still airborne
    w.step(239)
    m = w.manifold_between(0, box)
    assert m is not None and w.manifold_exists(box, 0)
    assert m["num_points"] >= 1
    live = m["point_valid"]
    # the normal points towards body_a, the plane
    assert np.allclose(m["normal"][live], (0, -1, 0), atol=0.05)
    assert np.all(np.abs(m["position"][live][:, 1]) < 0.05)
    assert np.all(m["normal_impulse"][live] >= 0)


def set_shape():
    b, box = scenes.hello_world()
    w = world(b)
    w.step(240)
    assert abs(w.position(box)[1] - 0.2) < 0.05
    w.set_shape(box, et.SphereShape(0.4))
    w.wake_up(box)
    w.step(240)
    assert abs(w.position(box)[1] - 0.4) < 0.05, w.position(box)


def destroy_rigidbody():
    b, box = scenes.hello_world()
    w = world(b, capacity=8)
    w.step(60)
    w.destroy(box)
    w.step(5)
    assert int(w.state.contacts.valid.sum()) == 0
    new = w.spawn(et.RigidBodyDef(mass=1.0, shape=et.SphereShape(0.2),
                                  position=(0, 2, 0)))
    assert new == box  # the slot is reused
    w.step(30)
    assert float(w.position(new)[1]) < 2.0


def query_aabb():
    b, box = scenes.hello_world()
    w = world(b)
    w.step(1)
    found = w.query_aabb((-1, 2, -1), (1, 4, 1), include_non_procedural=False)
    assert found == [box]
    found = w.query_aabb((10, 10, 10), (11, 11, 11),
                         include_non_procedural=False)
    assert found == []


def contact_events():
    b, box = scenes.hello_world()
    w = world(b)
    started_total, ended_total = [], []
    for _ in range(10):
        started, ended = w.step_with_events(30)
        started_total += started
        ended_total += ended
    assert (0, box) in started_total, started_total


# --- tests/test_simulation.py ------------------------------------------
def destroyed_support_wakes_sleeping_stack():
    b, ids = scenes.box_stack(2)
    w = world(b)
    settle(w, 90)
    w.put_to_sleep()
    w.step(2)
    assert all(w.is_asleep(i) for i in ids)
    top = ids[1]
    y0 = float(w.position(top)[1])
    w.destroy(ids[0])
    w.step(30)
    assert not w.is_asleep(top), "manifold-drop wake did not fire"
    assert float(w.position(top)[1]) < y0 - 0.02, "top box did not fall"


def sleeping_and_wake_on_impulse():
    b, box = scenes.hello_world()
    w = world(b)
    settle(w, 240)
    assert w.is_asleep(box)
    w.apply_impulse(box, (0, 50.0, 0))
    assert not w.is_asleep(box)
    w.step(2)
    assert float(w.linvel(box)[1]) > 0.1


def force_sleep_mid_settle_sticks():
    b, ids = scenes.mixed_pile(n_bodies=64)
    w = world(b)
    settle(w, 60)  # touching and piled, not yet asleep
    assert int(w.state.contacts.valid.sum()) > 0
    w.put_to_sleep()
    pos0 = w.state.pos.numpy().copy()
    w.step(6)
    dyn = w.state.is_dynamic.numpy()
    asleep = w.state.asleep.numpy()
    assert asleep[dyn].mean() > 0.95, \
        f"force-slept pile re-woke: {asleep[dyn].mean():.2f} asleep"
    np.testing.assert_allclose(w.state.pos.numpy()[dyn], pos0[dyn],
                               atol=1e-6)


def teleport_away_wakes_old_neighbors():
    b, ids = scenes.box_stack(2)
    w = world(b)
    settle(w, 90)
    w.put_to_sleep()
    w.step(2)
    assert all(w.is_asleep(i) for i in ids)
    top, bottom = ids[1], ids[0]
    st = w.state
    pos = st.pos.clone()
    pos[top] = torch.tensor([50.0, 5.0, 0.0])
    w.state = dataclasses.replace(st, pos=pos)
    w.wake_up(top)
    w.step(3)
    assert not w.is_asleep(bottom), "pointed-manifold drop did not wake"


def island_steady_skip_engages_and_resets():
    b, ids = scenes.mixed_pile(n_bodies=48)
    w = world(b, capacity=len(b.defs) + 8, max_joints=4)
    settle(w, 60)
    w.put_to_sleep()
    w.step(2 * RESET_PERIOD + 6)
    assert int(w.state.island_stable_steps) >= 2 * RESET_PERIOD, \
        f"stability counter stuck at {int(w.state.island_stable_steps)}"
    assert bool(w.state.labels_stable)
    labels = w.state.island_id.numpy().copy()
    w.step(4)  # the skip reuses the stored labels verbatim
    np.testing.assert_array_equal(w.state.island_id.numpy(), labels)
    dyn = w.state.is_dynamic.numpy()
    assert w.state.asleep.numpy()[dyn].mean() > 0.95
    # a lifecycle edit the step cannot see must invalidate the skip
    j = et.make_distance_constraint(w, ids[0], ids[1], (0, 0, 0), (0, 0, 0),
                                    5.0)
    assert int(w.state.island_stable_steps) == 0
    assert not bool(w.state.labels_stable)
    w.destroy_joint(j)
    assert int(w.state.island_stable_steps) == 0


CASES = [change_kind_dynamic_to_static_and_back, gravity_api,
         mass_inertia_friction_setters, manifold_between, set_shape,
         destroy_rigidbody, query_aabb, contact_events,
         destroyed_support_wakes_sleeping_stack,
         sleeping_and_wake_on_impulse, force_sleep_mid_settle_sticks,
         teleport_away_wakes_old_neighbors,
         island_steady_skip_engages_and_resets]


@pytest.mark.parametrize("case", CASES[:4], ids=lambda f: f.__name__)
def test_behaviour(case):
    case()
