"""Whole-step parity of the PyTorch port with the JAX package on a 64-body
``mixed_pile``, the parity of its collision and island stages on that pile,
and the port's overflow reporting. One reference trajectory serves every
case: the JAX step is compiled once, and its first op-by-op step is paid
once.

Per-step parity: the JAX world steps with its jitted step to produce the
start states; from each of the first 60 both packages take one step, the
JAX package's ``physics_step_impl`` evaluated op by op (``jax.disable_jit``)
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
1-ulp sensitivity. Steps 0-19 fall, 20-39 make the first contacts, 40-59
hold the pile in contact.

Collision and islands, on the landed pile (steps 55 and 60): the dense
broadphase, the manifold slot table, the point merge, the three narrowphase
buckets of the main path, the whole narrowphase, and islands and sleep.
The JAX functions run op by op here too; the port runs on the CPU, one
thread (the suite runs several workers).
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import edyn_tpu as ej
from edyn_tpu.collision import broadphase as jbp
from edyn_tpu.collision import manifold as jman
from edyn_tpu.collision import narrowphase as jnp_phase
from edyn_tpu.collision.kernels import box_box as jbox
from edyn_tpu.collision.kernels import plane_unified as jplane
from edyn_tpu.collision.kernels import support as jsup
from edyn_tpu.collision.kernels import support_sat as jsat
from edyn_tpu.dynamics import islands as jisl
from edyn_tpu.simulation.stepper import physics_step_impl

import edyn_tpu_torch as et
from edyn_tpu_torch.collision import broadphase as tbp
from edyn_tpu_torch.collision import manifold as tman
from edyn_tpu_torch.collision import narrowphase as tnp_phase
from edyn_tpu_torch.collision.kernels import box_box as tbox
from edyn_tpu_torch.collision.kernels import plane_unified as tplane
from edyn_tpu_torch.collision.kernels import support as tsup
from edyn_tpu_torch.collision.kernels import support_sat as tsat
from edyn_tpu_torch.core.convert import state_from_numpy, state_to_numpy
from edyn_tpu_torch.core.state import WorldState
from edyn_tpu_torch.dynamics import islands as tisl
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
        if isinstance(v, dict):  # the user components
            out[name] = {k: np.asarray(x) for k, x in v.items()}
        elif dataclasses.is_dataclass(v):
            out[name] = {g.name: np.asarray(getattr(v, g.name))
                         for g in dataclasses.fields(v)}
        else:
            out[name] = np.asarray(v)
    return out


def pile64(pkg):
    """The 64-body ``mixed_pile`` builder of a package (``ej`` or ``et``)."""
    scenes = importlib.import_module(pkg.__name__ + ".utils.scenes")
    return scenes.mixed_pile(n_bodies=64, seed=0)[0]


def to_jax(tree: dict, like):
    """The JAX WorldState holding a port state's numpy tree
    (``state_to_numpy``), on the structure (and the other fields) of the
    JAX state ``like``."""
    kw = {}
    for name, val in tree.items():
        cur = getattr(like, name)
        if isinstance(cur, dict):  # the user components
            kw[name] = {k: jnp.asarray(v) for k, v in val.items()}
        elif isinstance(val, dict):
            kw[name] = dataclasses.replace(cur, **{
                k: jnp.asarray(v) for k, v in val.items()})
        else:
            kw[name] = jnp.asarray(val)
    return dataclasses.replace(like, **kw)


class Trajectory:
    """A scene in both packages and the start states of its checks.
    ``scene`` builds the scene's builder through a package's public names;
    the worlds are made with ``world_kw``. The start states are the JAX
    package's jitted trajectory (``source="jax"``) or the port's own CPU
    trajectory carried into JAX states (``source="port"``, which costs no
    compile of the JAX step); either way every check steps both packages
    from the same state."""

    def __init__(self, n_steps: int, scene=pile64, source: str = "jax",
                 **world_kw):
        self.jw = ej.make_world(scene(ej), **world_kw)
        self.tw = et.make_world(scene(et), device="cpu", **world_kw)
        jm, tm = self.jw.meta, self.tw.meta
        for f in ("types_present", "max_pairs", "bucket_cap", "max_rows",
                  "has_spin_roll", "has_joints", "island_iters", "wide_cap",
                  "sleep_gating"):
            assert getattr(jm, f) == getattr(tm, f), f
        self.states = [self.jw.state]
        self._contacts = {}
        for _ in range(n_steps):
            if source == "jax":
                self.jw.step()
                self.states.append(self.jw.state)
            else:
                self.tw.step()
                self.states.append(to_jax(state_to_numpy(self.tw.state),
                                          self.jw.state))
        # the JAX meta holds for every start state: no growth on the way
        assert self.tw.meta.max_pairs == tm.max_pairs

    def jax_step(self, start):
        with jax.disable_jit():
            return physics_step_impl(start, self.jw.settings, self.jw.meta)

    def check_step(self, i: int, ulp_rule: bool = True):
        """One step from the JAX state at step i in both packages.

        A body outside the tolerances passes only if the reference itself
        is that sensitive there (and ``ulp_rule`` allows it): nudging the
        positions of the bodies outside the tolerances by one ulp, either
        way, must move the JAX step's result by at least half the port's
        difference, in every component that is outside the tolerances.
        Returns the reference's contact points after the step; a step
        checked once is not checked again."""
        if (i, ulp_rule) not in self._contacts:
            self._contacts[i, ulp_rule] = self.check_from(self.states[i], i,
                                                          ulp_rule)
        return self._contacts[i, ulp_rule]

    def check_from(self, start, i: int, ulp_rule: bool = True):
        """``check_step`` from any JAX state ``start`` (``i`` labels it).
        The reference's result stays in ``self.last``."""
        want = self.last = self.jax_step(start)
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


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's CPU tensors of a test are too small to share between
    threads, and the suite runs several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trajectory(eager_cache):
    return Trajectory(60)


@pytest.mark.parametrize("step", range(0, 60))
def test_step_parity(trajectory, step):
    trajectory.check_step(step)


@pytest.mark.parametrize("step,least", [(39, 50), (59, 150)])
def test_steps_have_contacts(trajectory, step, least):
    """The first contacts (step 39) and the pile in contact (step 59)."""
    assert trajectory.check_step(step) > least


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


# -- collision and islands on the landed pile ---------------------------

THRESHOLD = 0.01  # Settings.collision_threshold


@pytest.fixture(scope="module")
def pile(trajectory):
    """The JAX states at steps 55 and 60, and the port's copies of them."""
    tr = trajectory
    js = {k: tr.states[k] for k in (55, 60)}
    ts = {k: state_from_numpy(jtree(s), "cpu") for k, s in js.items()}
    return tr, js, ts


def ttable(state, tab):
    """A port contact table as the JAX package's numpy columns."""
    return state_to_numpy(dataclasses.replace(state, contacts=tab))["contacts"]


def jtable(tab):
    return {f.name: np.asarray(getattr(tab, f.name))
            for f in dataclasses.fields(tab)}


def assert_tables_equal(got, want, atol=0.0):
    for k, w in want.items():
        if atol and w.dtype.kind == "f":
            np.testing.assert_allclose(got[k], w, rtol=0, atol=atol,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def jax_keys(k):
    k = np.asarray(k).astype(np.int64)
    k[k == np.iinfo(np.uint32).max] = np.iinfo(np.int64).max
    return k


@pytest.mark.parametrize("row_block,max_pairs", [(2048, None), (16, None),
                                                 (2048, 40)])
def test_broadphase_pairs(pile, monkeypatch, row_block, max_pairs):
    tr, js, ts = pile
    P = max_pairs or tr.jw.meta.max_pairs
    monkeypatch.setattr(tbp, "ROW_BLOCK", row_block)
    with jax.disable_jit():
        k, a, b, v, d = jbp.find_pairs(js[60], P, tr.jw.meta.broadphase_block,
                                       None, wide_cap=tr.jw.meta.wide_cap)
    tk, ta, tb, tv, td = tbp.find_pairs(ts[60], P, tr.tw.meta.wide_cap)
    np.testing.assert_array_equal(tk.numpy(), jax_keys(k))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(v))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(a))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(b))
    assert td == int(d)
    assert int(np.asarray(v).sum()) > 100 if max_pairs is None else td > 0


@pytest.mark.parametrize("case", ["changed", "unchanged"])
def test_update_slots(pile, case):
    """Slots of the step-55 table against the pair list of step 60 (pairs
    come and go) or of step 55 itself (the unchanged-pair-set fast path)."""
    tr, js, ts = pile
    P = tr.jw.meta.max_pairs
    src = 60 if case == "changed" else 55
    with jax.disable_jit():
        k, a, b, v, _ = jbp.find_pairs(js[src], P, tr.jw.meta.broadphase_block,
                                       None, wide_cap=tr.jw.meta.wide_cap)
        want, wdrop, wn, wsame = jman.update_slots(js[55].contacts, k, a, b, v)
    tk, ta, tb, tv, _ = tbp.find_pairs(ts[src], P, tr.tw.meta.wide_cap)
    got, gdrop, gn, gsame = tman.update_slots(ts[55].contacts, tk, ta, tb, tv)
    assert gsame == bool(wsame) == (case == "unchanged")
    assert gn == int(wn)
    np.testing.assert_array_equal(gdrop.numpy(), np.asarray(wdrop))
    assert_tables_equal(ttable(ts[55], got), jtable(want))
    if case == "changed":
        assert int(np.asarray(wdrop).sum()) > 0


def test_merge_points_inheritance(pile):
    """Fresh points near, far from and beside the carried ones: slots,
    lifetimes and inherited impulses exactly equal."""
    tr, js, ts = pile
    man = js[60].contacts
    M = man.key.shape[0]
    rng = np.random.default_rng(5)
    old_a = np.asarray(man.pivot_a)
    step = rng.choice([0.0, 0.005, 0.03, 0.2], size=(M, 4, 1))
    new = dict(
        new_pivot_a=(old_a + step * rng.normal(size=old_a.shape)),
        new_pivot_b=(np.asarray(man.pivot_b)
                     + step * rng.normal(size=old_a.shape)),
        new_local_normal=np.asarray(man.local_normal),
        new_attachment=np.asarray(man.normal_attachment),
        new_distance=rng.normal(size=(M, 4)) * 0.01,
        new_point_valid=rng.random((M, 4)) < 0.6,
        scales=np.ones((M, 4, 2)))
    new = {k: np.array(v, np.float32 if v.dtype == np.float64 else v.dtype)
           for k, v in new.items()}
    st = js[60]
    org = np.asarray(st.origin_pos())
    rolling = np.asarray(st.shape_type) == 1
    ba, bb = np.asarray(man.body_a), np.asarray(man.body_b)
    orn, w = np.asarray(st.orn), np.asarray(st.angvel)
    pose = tuple(np.array(p) for p in (org[ba], orn[ba], w[ba], rolling[ba],
                                       org[bb], orn[bb], w[bb], rolling[bb]))
    with jax.disable_jit():
        want = jman.merge_points(man, **{k: jnp.asarray(v)
                                         for k, v in new.items()},
                                 pose=tuple(jnp.asarray(p) for p in pose),
                                 dt=1 / 60)
    got = tman.merge_points(ts[60].contacts,
                            **{k: torch.from_numpy(v) for k, v in new.items()},
                            pose=tuple(torch.from_numpy(p) for p in pose),
                            dt=1 / 60)
    g, wt = ttable(ts[60], got), jtable(want)
    for k in ("point_valid", "lifetime", "normal_attachment",
              "normal_impulse", "friction_impulse", "spin_impulse",
              "roll_impulse"):
        np.testing.assert_array_equal(g[k], wt[k], err_msg=k)
    assert_tables_equal(g, wt, atol=1e-6)
    kept = np.asarray(man.point_valid) & np.asarray(want.point_valid)
    assert (np.asarray(want.normal_impulse)[kept] != 0).any()


def _bucket_pairs(st, bucket):
    man = st.contacts
    ta = np.asarray(st.shape_type)[np.asarray(man.body_a)]
    tb = np.asarray(st.shape_type)[np.asarray(man.body_b)]
    cls, swap = jnp_phase.classify(jnp.asarray(ta), jnp.asarray(tb))
    tcls, tswap = tnp_phase.classify(torch.from_numpy(ta),
                                     torch.from_numpy(tb))
    live = np.asarray(man.valid)
    np.testing.assert_array_equal(tcls.numpy()[live], np.asarray(cls)[live])
    np.testing.assert_array_equal(tswap.numpy()[live], np.asarray(swap)[live])
    sel = np.nonzero(live & (np.asarray(cls) == bucket))[0]
    a, b = np.asarray(man.body_a)[sel], np.asarray(man.body_b)[sel]
    sw = np.asarray(swap)[sel]
    return np.where(sw, b, a), np.where(sw, a, b)


BUCKETS = {
    "unified": (jnp_phase.B_UNIFIED,
                lambda A, B: jsat.collide_support(A, B, THRESHOLD,
                                                  rim_axes=True),
                lambda A, B: tsat.collide_support(A, B, THRESHOLD,
                                                  rim_axes=True)),
    "boxbox": (jnp_phase.B_BOXBOX,
               lambda A, B: jbox.collide_box_box(A.pos, A.orn, A.params,
                                                 B.pos, B.orn, B.params,
                                                 THRESHOLD),
               lambda A, B: tbox.collide_box_box(A.pos, A.orn, A.params,
                                                 B.pos, B.orn, B.params,
                                                 THRESHOLD)),
    "plane": (jnp_phase.B_PLANE,
              lambda A, B: jplane.collide_convex_plane(A, B, THRESHOLD),
              lambda A, B: tplane.collide_convex_plane(A, B, THRESHOLD)),
}


@pytest.mark.parametrize("bucket", list(BUCKETS))
def test_narrowphase_bucket(pile, bucket):
    """Each bucket kernel on the landed pile's pairs of its class: points at
    atol 1e-4. The JAX kernel runs at its bucket's width in the step
    (``update_contacts``' budget), the pairs padded with copies of the
    first, so its op-by-op programs are the step's."""
    tr, js, ts = pile
    cls, jfn, tfn = BUCKETS[bucket]
    ka, kb = _bucket_pairs(js[60], cls)
    assert len(ka) > 3
    meta = tr.jw.meta
    M = js[60].contacts.key.shape[0]
    width = (min(2 * meta.bucket_cap, M) if cls == jnp_phase.B_UNIFIED
             else max(512, meta.bucket_cap // 4))
    pad = lambda k: np.concatenate([k, np.full(width - len(k), k[0])])
    with jax.disable_jit():
        packed, dims = jsup.pack_side_table(js[60])
        want = jfn(jsup.side_from_packed(packed[pad(ka)], dims),
                   jsup.side_from_packed(packed[pad(kb)], dims))
    want = jax.tree_util.tree_map(lambda x: x[:len(ka)], want)
    tpacked, tdims = tsup.pack_side_table(ts[60])
    got = tfn(tsup.side_from_packed(tpacked[torch.from_numpy(ka)], tdims),
              tsup.side_from_packed(tpacked[torch.from_numpy(kb)], tdims))
    pv = np.asarray(want.point_valid)
    np.testing.assert_array_equal(got.point_valid.numpy(), pv)
    assert pv.sum() >= 4
    np.testing.assert_array_equal(got.attachment.numpy()[pv],
                                  np.asarray(want.attachment)[pv])
    for f in ("pivot_a", "pivot_b", "normal", "distance"):
        np.testing.assert_allclose(getattr(got, f).numpy()[pv],
                                   np.asarray(getattr(want, f))[pv],
                                   rtol=0, atol=1e-4, err_msg=f)


@pytest.mark.parametrize("chunk", [32768, 8])
def test_update_contacts(pile, monkeypatch, chunk):
    """The whole narrowphase with the merge, in one chunk or in chunks of
    8 pairs. On the CPU the UNIFIED bucket is ``support_sat``, as the JAX
    package's CPU step runs its jnp path: K4's wrapper is never called."""
    tr, js, ts = pile
    monkeypatch.setattr(tnp_phase, "CHUNK", chunk)

    def refuse(*a, **k):
        raise AssertionError("K4 called on the CPU path")
    monkeypatch.setattr(tnp_phase, "collide_support_unified", refuse)
    meta = tr.jw.meta
    with jax.disable_jit():
        want, wdrop = jnp_phase.update_contacts(
            js[60], js[60].contacts, THRESHOLD, meta.types_present,
            meta.bucket_cap, 1 / 60, pallas_mode=False)
    got, gdrop = tnp_phase.update_contacts(
        ts[60], ts[60].contacts, THRESHOLD, tr.tw.meta.types_present,
        tr.tw.meta.bucket_cap, 1 / 60)
    assert gdrop == int(wdrop)
    g, w = ttable(ts[60], got), jtable(want)
    for k in ("point_valid", "lifetime", "normal_attachment"):
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    pv = w["point_valid"]
    assert pv.sum() > 100
    for k in ("pivot_a", "pivot_b", "local_normal", "distance",
              "normal_impulse", "friction_impulse", "roll_impulse"):
        np.testing.assert_allclose(g[k][pv], w[k][pv], rtol=0, atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("step_count", [64, 61])
def test_islands_and_sleep(pile, step_count):
    """Labels from a re-seed (step 64) and warm-started (61); sleep timers
    set so that some islands fall asleep and one is woken."""
    tr, js, ts = pile
    st = js[60]
    rng = np.random.default_rng(7)
    N = st.capacity
    timer = np.where(rng.random(N) < 0.7, 1.99, 0.5).astype(np.float32)
    slow = rng.random(N) < 0.8
    lin = np.where(slow[:, None], 1e-3, 1.0) * np.asarray(st.linvel)
    wake = np.zeros(N, bool)
    wake[20] = True
    x = jtree(st)
    x.update(sleep_timer=timer, linvel=lin.astype(np.float32),
             angvel=np.zeros_like(x["angvel"]),
             step_count=np.int32(step_count))
    jst = dataclasses.replace(st, sleep_timer=jnp.asarray(timer),
                              linvel=jnp.asarray(x["linvel"]),
                              angvel=jnp.asarray(x["angvel"]),
                              step_count=jnp.int32(step_count))
    tst = state_from_numpy(x, "cpu")
    with jax.disable_jit():
        labels, conv = jisl.compute_islands(jst, jst.contacts, 4)
        want = jisl.update_sleep(jst, jst.contacts, 1 / 60, True, 4,
                                 wake_bodies=jnp.asarray(wake))
    tlabels, tconv = tisl.compute_islands(tst, tst.contacts, 4)
    got = tisl.update_sleep(tst, tst.contacts, 1 / 60, True, 4,
                            wake_bodies=torch.from_numpy(wake))
    np.testing.assert_array_equal(tlabels.numpy(), np.asarray(labels))
    assert tconv == bool(conv)
    for f in ("island_id", "asleep", "sleep_timer", "linvel", "angvel"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert bool(np.asarray(want.asleep).any())
    assert not np.asarray(want.asleep).all()
