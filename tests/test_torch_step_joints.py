"""Whole-step parity of the PyTorch port with the JAX package on jointed
scenes without contacts (the method and tolerances of
``test_torch_step.py``; the ragdoll pile, with contacts, is in
``test_torch_step_ragdolls.py``).

- ``joint_chain(6)``: a hinge chain hanging from a static anchor. Every
  third step of its first 30 is held without the 1-ulp rule: pos, orn and
  linvel at the whole-step tolerances, and the joints' tracked angles and
  impulses too (each op-by-op JAX step takes seconds). The start states
  are the port's own CPU trajectory carried into JAX states.
- Runtime joints: ``make_distance_constraint`` and ``make_hinge_constraint``
  on a live ``World`` (``_add_joint`` into spare ``max_joints`` slots), then
  ``destroy_joint``, in both packages, each followed by steps compared
  the same way; the JAX world advances by the op-by-op reference step of
  each comparison.
"""
import importlib

import numpy as np
import pytest

import edyn_tpu as ej
import edyn_tpu_torch as et
from edyn_tpu_torch.core.convert import state_from_numpy

from test_torch_step import (  # noqa: F401
    Trajectory, eager_cache, jtree, one_thread,
)


def chain6(pkg):
    scenes = importlib.import_module(pkg.__name__ + ".utils.scenes")
    return scenes.joint_chain(6)[0]


def ball_pair(pkg):
    """An anchor and two balls, no joints: joints come at run time."""
    b = pkg.WorldBuilder(gravity=(0.0, -9.8, 0.0))
    b.make_rigidbody(pkg.RigidBodyDef(
        kind=pkg.KIND_STATIC, shape=pkg.SphereShape(0.1), position=(0, 5, 0)))
    for x in (0.0, 1.0):
        b.make_rigidbody(pkg.RigidBodyDef(
            mass=1.0, shape=pkg.SphereShape(0.2), position=(x, 3, 0),
            linvel=(0.5, 0, 0), sleeping_disabled=True))
    return b


@pytest.fixture(scope="module")
def chain(eager_cache):  # noqa: F811
    return Trajectory(30, chain6, source="port")


@pytest.mark.parametrize("step", range(0, 30, 3))
def test_chain_step_parity(chain, step):
    assert chain.tw.meta.has_joints
    chain.check_step(step, ulp_rule=False)


def test_runtime_joints_parity(eager_cache):  # noqa: F811
    """Joints made and destroyed on live worlds of both packages: the
    tables stay equal, and every step from the JAX state agrees."""
    tr = Trajectory(0, ball_pair, max_joints=3)
    jw, tw = tr.jw, tr.tw
    assert not jw.meta.has_joints and not tw.meta.has_joints

    def both(fn):
        return fn(ej, jw), fn(et, tw)

    def step_both(n):
        for _ in range(n):
            tr.check_from(jw.state, 0, ulp_rule=False)
            jw.state = tr.last
            tw.state = state_from_numpy(jtree(jw.state), "cpu")

    ja, ta = both(lambda p, w: p.make_distance_constraint(
        w, 0, 1, (0, 0, 0), (0, 0, 0), distance=2.0))
    jb, tb = both(lambda p, w: p.make_hinge_constraint(
        w, 1, 2, (0.5, 0, 0), (-0.5, 0, 0), (0, 0, 1), (0, 0, 1),
        has_limit=True, limit_min=-0.5, limit_max=0.5))
    assert (ja, jb) == (ta, tb) == (0, 1)
    assert tw.meta.has_joints and jw.meta.has_joints
    for f in ("jtype", "body_a", "body_b", "valid", "pivot_a", "pivot_b",
              "frame_a", "frame_b", "params", "impulses", "angle"):
        np.testing.assert_array_equal(getattr(tw.state.joints, f).numpy(),
                                      np.asarray(getattr(jw.state.joints, f)))
    for f in ("asleep", "sleep_timer", "island_stable_steps",
              "labels_stable", "bp_carry_ok"):
        np.testing.assert_array_equal(getattr(tw.state, f).numpy(),
                                      np.asarray(getattr(jw.state, f)))
    step_both(3)
    both(lambda p, w: w.destroy_joint(0))
    for f in ("jtype", "valid", "impulses", "angle"):
        np.testing.assert_array_equal(getattr(tw.state.joints, f).numpy(),
                                      np.asarray(getattr(jw.state.joints, f)))
    step_both(2)
