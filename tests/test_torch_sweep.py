"""The sort-and-sweep broadphase of the port (``collision/broadphase.py``
``find_pairs_sweep``) against the JAX package's, and against the port's
dense path: the copy of ``tests/test_sweep_broadphase.py``.

The same ``mixed_pile(96)`` is built in both packages; the port steps it
on the CPU and each checked state is carried into a JAX state, so both
sweeps see the same admission boxes. Keys, validity, drops and window
alarms are integers and must be equal."""
import dataclasses

import numpy as np
import pytest
import torch

import edyn_tpu as ej
import edyn_tpu_torch as et
from edyn_tpu.collision import broadphase as jbp
from edyn_tpu.utils import scenes as jscenes
from edyn_tpu_torch.collision import broadphase as tbp
from edyn_tpu_torch.core.convert import state_to_numpy
from edyn_tpu_torch.simulation import stepper
from edyn_tpu_torch.utils import scenes as tscenes
from test_torch_step import jax_keys, one_thread, to_jax  # noqa: F401

CHECK_STEPS = (1, 20, 45, 90)


def jfilter(state, i, j):
    return ((i + 2 * j) % 5) != 0


def tfilter(state, i, j):
    return ((i + 2 * j) % 5) != 0


@pytest.fixture(scope="module")
def states():
    """The port's CPU states of the pile at CHECK_STEPS, each also as a
    JAX state; and the port world's meta."""
    jw = ej.make_world(jscenes.mixed_pile(n_bodies=96)[0])
    tw = et.make_world(tscenes.mixed_pile(n_bodies=96)[0], device="cpu")
    out, done = {}, 0
    for k in CHECK_STEPS:
        tw.step(k - done)
        done = k
        out[k] = (tw.state, to_jax(state_to_numpy(tw.state), jw.state))
    return out, tw.meta


@pytest.mark.parametrize("step", CHECK_STEPS)
@pytest.mark.parametrize("window,filtered", [(192, False), (6, False),
                                             (192, True)])
def test_sweep_matches_jax_sweep(states, step, window, filtered):
    """Sorted keys, bodies, validity, drops and alarms equal to the JAX
    package's ``find_pairs_sweep``; a window of 6 truncates the scan and
    raises alarms; a user filter is ANDed into both masks."""
    st, meta = states[0][step][0], states[1]
    js = states[0][step][1]
    P = meta.max_pairs
    k, a, b, v, d, al = jbp.find_pairs_sweep(
        js, P, window, meta.wide_cap, jfilter if filtered else None)
    tk, ta, tb, tv, td, tal = tbp.find_pairs_sweep(
        st, P, window, meta.wide_cap, tfilter if filtered else None)
    np.testing.assert_array_equal(tk.numpy(), jax_keys(k))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(a))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(v))
    assert (td, tal) == (int(d), int(al))
    assert int(tv.sum()) > (50 if step >= 45 else 5)
    if window == 6 and step == 1:
        assert tal > 0  # the dropped pile overlaps along every axis


@pytest.mark.parametrize("step", (20, 90))
def test_dense_filter_matches_jax(states, step):
    """The dense path with the user filter against the JAX package's."""
    st, js = states[0][step]
    meta = states[1]
    k, a, b, v, d = jbp.find_pairs(js, meta.max_pairs, 256, jfilter,
                                   wide_cap=meta.wide_cap)
    tk, ta, tb, tv, td = tbp.find_pairs(st, meta.max_pairs, meta.wide_cap,
                                        tfilter)
    np.testing.assert_array_equal(tk.numpy(), jax_keys(k))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(v))
    assert td == int(d)


def test_dense_vs_sweep_equivalence():
    """tests/test_sweep_broadphase.py on the port, held harder: the two
    paths' pair keys equal at every one of the 90 steps, and the
    trajectories equal."""
    b, ids = tscenes.mixed_pile(n_bodies=96)
    w_d = et.make_world(b, device="cpu")
    w_d.meta = dataclasses.replace(w_d.meta, broadphase_mode="dense")
    b2, _ = tscenes.mixed_pile(n_bodies=96)
    w_s = et.make_world(b2, device="cpu")
    w_s.meta = dataclasses.replace(w_s.meta, broadphase_mode="sweep")
    for i in range(90):
        kd, *_ = stepper.broadphase(w_d.state, w_d.meta)
        ks, *_ = stepper.broadphase(w_d.state, w_s.meta)
        assert torch.equal(kd, ks), i
        w_d.step()
        w_s.step()
        assert torch.equal(w_d.state.contacts.sort_key,
                           w_s.state.contacts.sort_key), i
    assert w_d.overflow_counters()["broadphase_pairs"] == 0
    assert w_s.overflow_counters()["broadphase_pairs"] == 0
    kd = w_d.state.contacts.key[w_d.state.contacts.valid]
    ks = w_s.state.contacts.key[w_s.state.contacts.valid]
    np.testing.assert_array_equal(np.sort(kd.numpy()), np.sort(ks.numpy()))
    np.testing.assert_allclose(w_d.state.pos[ids].numpy(),
                               w_s.state.pos[ids].numpy(), atol=1e-4)


def test_auto_mode_and_key_limit():
    """"auto" takes the dense path up to the JAX package's DENSE_LIMIT; both
    paths refuse a capacity beyond its pair-key limit, as the JAX package's
    do."""
    assert tbp.DENSE_LIMIT == jbp.DENSE_LIMIT == tbp.MAX_BODIES_FOR_KEYS \
        == jbp.MAX_BODIES_FOR_KEYS == 65536
    b, _ = tscenes.mixed_pile(n_bodies=20)
    w = et.make_world(b, device="cpu")
    assert w.meta.broadphase_mode == "auto"
    st = w.state
    big = dataclasses.replace(st, pos=torch.zeros((65537, 3)))
    for fn in (lambda: tbp.find_pairs(big, 16),
               lambda: tbp.find_pairs_sweep(big, 16)):
        with pytest.raises(AssertionError):
            fn()
    with pytest.raises(ValueError):
        stepper.broadphase(st, dataclasses.replace(w.meta,
                                                   broadphase_mode="tree"))
