"""Parity of the PyTorch port's collision and island stages with the JAX
package, on the 64-body ``mixed_pile`` after it has landed: the dense
broadphase, the manifold slot table, the point merge, the three narrowphase
buckets of the main path, and islands and sleep.

The JAX functions run op by op (``jax.disable_jit``): contact generation
picks among near-equal candidate features, and XLA's fused CPU code rounds
differently (see ``test_torch_step.py``). The port runs on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edyn_tpu.collision import broadphase as jbp
from edyn_tpu.collision import manifold as jman
from edyn_tpu.collision import narrowphase as jnp_phase
from edyn_tpu.collision.kernels import box_box as jbox
from edyn_tpu.collision.kernels import plane_unified as jplane
from edyn_tpu.collision.kernels import support as jsup
from edyn_tpu.collision.kernels import support_sat as jsat
from edyn_tpu.dynamics import islands as jisl

from edyn_tpu_torch.collision import broadphase as tbp
from edyn_tpu_torch.collision import manifold as tman
from edyn_tpu_torch.collision import narrowphase as tnp_phase
from edyn_tpu_torch.collision.kernels import box_box as tbox
from edyn_tpu_torch.collision.kernels import plane_unified as tplane
from edyn_tpu_torch.collision.kernels import support as tsup
from edyn_tpu_torch.collision.kernels import support_sat as tsat
from edyn_tpu_torch.core.convert import state_from_numpy, state_to_numpy
from edyn_tpu_torch.dynamics import islands as tisl

from test_torch_step import Trajectory, eager_cache, jtree  # noqa: F401

THRESHOLD = 0.01  # Settings.collision_threshold


@pytest.fixture(scope="module")
def pile(eager_cache):  # noqa: F811
    """The JAX states at steps 55 and 60, and the port's copies of them."""
    tr = Trajectory(60)
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
    atol 1e-4."""
    tr, js, ts = pile
    cls, jfn, tfn = BUCKETS[bucket]
    ka, kb = _bucket_pairs(js[60], cls)
    assert len(ka) > 3
    with jax.disable_jit():
        packed, dims = jsup.pack_side_table(js[60])
        want = jfn(jsup.side_from_packed(packed[ka], dims),
                   jsup.side_from_packed(packed[kb], dims))
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
