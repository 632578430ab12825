"""Whole-step parity of the PyTorch port with the JAX package on a 64-body
``mixed_pile``, and the port's overflow reporting.

Per-step parity: the JAX world steps with its jitted step to produce the
start states; from each of them both packages take one step, the JAX
package's ``physics_step_impl`` evaluated op by op (``jax.disable_jit``)
and the port on the CPU, and pos, orn and linvel must agree at the
tolerances of ``tests/test_pallas_solver.py``. The op-by-op evaluation is
the reference because XLA's fused CPU code contracts multiplies and adds
into FMAs, and contact generation picks among near-equal candidate
features: a 1-ulp change of an input flips which contact points a box or
cylinder pair keeps, and from step 26 on the jitted step differs from the
op-by-op one by up to 0.1 m/s in a single step, while the port agrees with
the op-by-op step to about 1e-6. Where a contact is that sensitive the port
can differ from the op-by-op step too (step 42: a sphere-cylinder pivot);
``check_step`` then accepts the difference only within the reference's own
1-ulp sensitivity. Steps 0-19 are here, 20-59 in
``test_torch_step_landing.py`` and ``test_torch_step_pile.py`` (one file
each, so the test workers share the cost).
"""
import dataclasses
import importlib

import jax
import numpy as np
import pytest

import edyn_tpu as ej
from edyn_tpu.simulation.stepper import physics_step_impl

import edyn_tpu_torch as et
from edyn_tpu_torch.core.convert import state_from_numpy
from edyn_tpu_torch.core.state import WorldState
from edyn_tpu_torch.simulation.stepper import physics_step
from edyn_tpu_torch.utils.scenes import mixed_pile as t_mixed_pile

# tests/test_pallas_solver.py:157-161 (orn held at the pos tolerance)
TOL = {"pos": (1e-3, 2e-3), "orn": (1e-3, 2e-3), "linvel": (1e-3, 5e-3)}
# a joint's tracked angle at the pos tolerance, its impulses at linvel's
JOINT_TOL = {"angle": (1e-3, 2e-3), "impulses": (1e-3, 5e-3)}
PORT_FIELDS = [f.name for f in dataclasses.fields(WorldState)]


def jtree(state) -> dict:
    """The JAX state as the port's numpy tree (its fields, its sub-tables as
    nested dicts)."""
    out = {}
    for name in PORT_FIELDS:
        v = getattr(state, name)
        out[name] = ({g.name: np.asarray(getattr(v, g.name))
                      for g in dataclasses.fields(v)}
                     if dataclasses.is_dataclass(v) else np.asarray(v))
    return out


def pile64(pkg):
    """The 64-body ``mixed_pile`` builder of a package (``ej`` or ``et``)."""
    scenes = importlib.import_module(pkg.__name__ + ".utils.scenes")
    return scenes.mixed_pile(n_bodies=64, seed=0)[0]


class Trajectory:
    """A scene in the JAX package, stepped with its jitted step, and the
    port's world of the same scene (for its settings and meta). ``scene``
    builds the scene's builder through a package's public names; the
    worlds are made with ``world_kw``."""

    def __init__(self, n_steps: int, scene=pile64, **world_kw):
        self.jw = ej.make_world(scene(ej), **world_kw)
        self.tw = et.make_world(scene(et), device="cpu", **world_kw)
        jm, tm = self.jw.meta, self.tw.meta
        for f in ("types_present", "max_pairs", "bucket_cap", "max_rows",
                  "has_spin_roll", "has_joints", "island_iters", "wide_cap",
                  "sleep_gating"):
            assert getattr(jm, f) == getattr(tm, f), f
        self.states = [self.jw.state]
        for _ in range(n_steps):
            self.jw.step()
            self.states.append(self.jw.state)

    def jax_step(self, start):
        with jax.disable_jit():
            return physics_step_impl(start, self.jw.settings, self.jw.meta)

    def check_step(self, i: int, ulp_rule: bool = True):
        """One step from the JAX state at step i in both packages.

        A body outside the tolerances passes only if the reference itself
        is that sensitive there (and ``ulp_rule`` allows it): nudging the
        positions of the bodies outside the tolerances by one ulp, either
        way, must move the JAX step's result by at least half the port's
        difference, in every component that is outside the tolerances."""
        return self.check_from(self.states[i], i, ulp_rule)

    def check_from(self, start, i: int, ulp_rule: bool = True):
        """``check_step`` from any JAX state ``start`` (``i`` labels it)."""
        want = self.jax_step(start)
        got = physics_step(state_from_numpy(jtree(start), "cpu"),
                           self.tw.settings, self.tw.meta)
        np.testing.assert_array_equal(got.asleep.numpy(),
                                      np.asarray(want.asleep))
        np.testing.assert_array_equal(got.overflow.numpy(),
                                      np.asarray(want.overflow))
        diff, bad = {}, np.zeros(start.capacity, bool)
        for f, (rtol, atol) in TOL.items():
            w = np.asarray(getattr(want, f))
            diff[f] = np.abs(getattr(got, f).numpy() - w)
            bad |= (diff[f] > atol + rtol * np.abs(w)).any(-1)
        assert ulp_rule or not bad.any(), (
            f"step {i}: bodies {np.nonzero(bad)[0]} outside the tolerances")
        if not ulp_rule:
            for f, (rtol, atol) in JOINT_TOL.items():
                np.testing.assert_allclose(
                    getattr(got.joints, f).numpy(),
                    np.asarray(getattr(want.joints, f)), rtol=rtol,
                    atol=atol, err_msg=f"step {i}: joints.{f}")
        if bad.any():
            pos = np.asarray(start.pos)
            sens = {f: np.zeros_like(d) for f, d in diff.items()}
            for to in (np.float32(np.inf), np.float32(-np.inf)):
                nudged = pos.copy()
                nudged[bad] = np.nextafter(pos[bad], to)
                alt = self.jax_step(dataclasses.replace(
                    start, pos=jax.numpy.asarray(nudged)))
                for f in sens:
                    sens[f] = np.maximum(sens[f], np.abs(
                        np.asarray(getattr(alt, f))
                        - np.asarray(getattr(want, f))))
            for f, (rtol, atol) in TOL.items():
                w = np.abs(np.asarray(getattr(want, f)))[bad]
                over = diff[f][bad] > np.maximum(atol + rtol * w,
                                                 2 * sens[f][bad])
                assert not over.any(), (
                    f"step {i}: {f} of bodies {np.nonzero(bad)[0]} differs "
                    f"by {diff[f][bad].max()}, beyond twice the reference's "
                    f"own 1-ulp sensitivity {sens[f][bad].max()}")
        return int(np.asarray(want.contacts.point_valid).sum())


@pytest.fixture(scope="module")
def eager_cache():
    """Op-by-op JAX compiles one small program per primitive; keep them in
    the persistent compilation cache for this module's run."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, 0.0)
    yield
    jax.config.update(key, old)


@pytest.fixture(scope="module")
def trajectory(eager_cache):
    return Trajectory(20)


@pytest.mark.parametrize("step", range(0, 20))
def test_step_parity(trajectory, step):
    trajectory.check_step(step)


def test_free_run_parity(trajectory):
    """20 steps of each package from the same start, each on its own."""
    bt, _ = t_mixed_pile(n_bodies=64, seed=0)
    tw = et.make_world(bt, device="cpu")
    tw.step(20)
    want = trajectory.states[20]
    for f, (rtol, atol) in TOL.items():
        np.testing.assert_allclose(getattr(tw.state, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=rtol, atol=atol, err_msg=f)


def _sphere_grid():
    """A plane under a 6x6 grid of touching spheres: 36 plane contacts plus
    the lateral neighbour overlaps, far more than 8 pairs."""
    b = et.WorldBuilder()
    b.make_rigidbody(et.RigidBodyDef(
        kind=et.KIND_STATIC, shape=et.PlaneShape((0, 1, 0), 0.0)))
    for i in range(6):
        for j in range(6):
            b.make_rigidbody(et.RigidBodyDef(
                mass=1.0, shape=et.SphereShape(0.55),
                position=(i * 1.0, 0.5, j * 1.0)))
    return b


def test_overflow_counters_surface_truncation():
    """An undersized pair list is reported on every step until the world
    grows: the pair-list carry is reused only after a step that dropped
    nothing (the JAX package's carry reports 0 after the first step)."""
    w = et.make_world(_sphere_grid(), max_pairs=8, device="cpu")
    w.auto_grow = False
    w.step(1)
    assert w.overflow_counters()["broadphase_pairs"] > 0
    w.step(1)
    assert w.overflow_counters()["broadphase_pairs"] > 0
    assert w.meta.max_pairs == 8

    b2 = et.WorldBuilder()
    b2.make_rigidbody(et.RigidBodyDef(
        kind=et.KIND_STATIC, shape=et.PlaneShape((0, 1, 0), 0.0)))
    b2.make_rigidbody(et.RigidBodyDef(
        mass=1.0, shape=et.SphereShape(0.5), position=(0, 0.49, 0)))
    w2 = et.make_world(b2, device="cpu")
    w2.step(2)
    assert all(v == 0 for v in w2.overflow_counters().values())


def test_overflow_grows_the_world():
    """The world grows after the step that dropped pairs, and from then on
    holds every pair a world sized right from the start holds."""
    w = et.make_world(_sphere_grid(), max_pairs=8, device="cpu")
    w.step_n(1)
    assert w.meta.max_pairs > 8
    assert w.state.contacts.key.shape[0] == w.meta.max_pairs
    # the carried pair list is the truncated one: the next step rebuilds it
    assert not bool(w.state.bp_carry_ok)
    ref = et.make_world(_sphere_grid(), device="cpu")
    w.step_n(20)
    ref.step_n(21)
    assert w.overflow_counters()["broadphase_pairs"] == 0
    assert int(w.state.contacts.valid.sum()) == \
        int(ref.state.contacts.valid.sum()) > 36
    assert float(w.state.pos[1:, 1].min()) > 0.5  # resting on the plane
