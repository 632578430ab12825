"""The JAX package's custom pair-filter test (``tests/test_world_api.py::
test_custom_should_collide_fn``) on the port's CPU ``World``, with the
carry it turns off and a filter that keeps some pairs, on both
broadphases. A file of at most four tests (see
``test_torch_joint_behaviour.py``); the worlds run on one CPU thread."""
import dataclasses

import torch

import edyn_tpu_torch as et
from edyn_tpu_torch.core.state import INVALID_KEY
from edyn_tpu_torch.simulation import stepper
from edyn_tpu_torch.utils import scenes
from test_torch_step import one_thread  # noqa: F401


def no_collide(state, i_idx, j_idx):
    # elementwise contract: i/j broadcastable index tensors
    shape = torch.broadcast_shapes(i_idx.shape, j_idx.shape)
    return torch.zeros(shape, dtype=torch.bool, device=state.device)


def test_custom_should_collide_fn():
    """reference: settings.should_collide_func override."""
    b, box = scenes.hello_world()
    w = et.make_world(b, device="cpu")
    w.meta = dataclasses.replace(w.meta, should_collide_fn=no_collide)
    w.step(120)
    assert float(w.position(box)[1]) < -1.0, "custom filter was ignored"


def test_custom_filter_turns_the_carry_off(monkeypatch):
    """The filter may read any state, so every step recomputes the pair
    list (the JAX step's stepper.py:350-354); without it a resting box
    reuses the carried list."""
    calls = []
    real = stepper.broadphase
    monkeypatch.setattr(stepper, "broadphase",
                        lambda st, meta: calls.append(1) or real(st, meta))
    counts = {}
    for name, fn in (("default", None),
                     ("filter", lambda st, i, j: i >= 0)):
        b, _ = scenes.hello_world()
        w = et.make_world(b, device="cpu")
        w.meta = dataclasses.replace(w.meta, should_collide_fn=fn)
        calls.clear()
        w.step(240)
        counts[name] = len(calls)
    assert counts["filter"] == 240, counts
    assert counts["default"] < 120, counts


def test_filter_keeps_the_pairs_it_allows():
    """A filter that refuses the pairs of one body removes exactly those
    from the dense and the sweep broadphase."""
    b, ids = scenes.mixed_pile(n_bodies=40, seed=2)
    w = et.make_world(b, device="cpu")
    w.step(30)
    st, meta = w.state, w.meta
    banned = int(ids[7])

    def keep(state, i, j):
        return (i != banned) & (j != banned)

    for mode in ("dense", "sweep"):
        m0 = dataclasses.replace(meta, broadphase_mode=mode)
        m1 = dataclasses.replace(m0, should_collide_fn=keep)
        k0, a0, b0 = stepper.broadphase(st, m0)[:3]
        k1 = stepper.broadphase(st, m1)[0]
        live = k0 != INVALID_KEY
        want = k0[live & (a0 != banned) & (b0 != banned)]
        assert bool(((a0 == banned) | (b0 == banned))[live].any()), mode
        got = k1[k1 != INVALID_KEY]
        assert torch.equal(got, want), mode
