"""The port's checkpoints against the JAX package's, on one state.

``live_scene`` (``test_torch_world_api``: a plane, a trimesh, two
compounds and every convex shape) is built in both packages with two user
components; the port's CPU world steps it until its bodies touch, and that
state is carried into a JAX state (``test_torch_step.to_jax``), so no JAX
step runs here. Then, all exact (every leaf equal, its dtype too):
- a JAX checkpoint loads into the port, and a port checkpoint into the JAX
  package, with and without a template; both packages write the same keys,
  shapes and dtypes (pair keys and collision bits uint32) and settings;
- a format-5 file (no ``bp_carry_ok``) and a format-3-shaped one (no
  manifold sort view, carried boxes, island tracking, and a 4-counter
  overflow) backfill to the same state in both packages;
- a port round trip is bit-equal, and the resumed world steps 5 steps
  equal to the world that was saved, on the CPU; a world whose manifold
  table grew resumes with its widths (``resume_world``);
- formats outside 3..6 are refused.
"""
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

import edyn_tpu as ej
import edyn_tpu_torch as et
from edyn_tpu.serialization import checkpoint as jck
from edyn_tpu_torch.core.convert import state_to_numpy
from edyn_tpu_torch.serialization import checkpoint as tck
from test_torch_step import jtree, one_thread, to_jax  # noqa: F401
from test_torch_world_api import live_scene

SETTLE = 20


def with_user(pkg):
    b, _ = live_scene(pkg)
    b.register_component("steer", default=0.25, replicate="input")
    b.register_component("tag", shape=(2,), dtype=np.int32, default=3)
    return b


@pytest.fixture(scope="module")
def worlds():
    """(JAX world, port CPU world) holding the same state after SETTLE port
    steps, with user columns written."""
    jw = ej.make_world(with_user(ej), capacity=40)
    tw = et.make_world(with_user(et), capacity=40, device="cpu")
    tw.step(SETTLE)
    rng = np.random.default_rng(3)
    tw.state = dataclasses.replace(tw.state, user={
        "steer": torch.as_tensor(rng.normal(size=40).astype(np.float32)),
        "tag": torch.as_tensor(rng.integers(0, 9, (40, 2)).astype(
            np.int32))})
    jw.state = to_jax(state_to_numpy(tw.state), jw.state)
    return jw, tw


def assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
    assert got.shape == want.shape, (path, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=path)


def npz(blob):
    d = np.load(io.BytesIO(blob))
    return {k: d[k] for k in d.files}


def rewrite(blob, fmt, drop=(), replace=None):
    """The checkpoint ``blob`` as format ``fmt``, without the keys ``drop``
    and with ``replace`` {key: array}."""
    d = npz(blob)
    head = json.loads(bytes(d.pop("__meta__")).decode())
    head["format"] = fmt
    for k in drop:
        d.pop(k)
    d.update(replace or {})
    d["__meta__"] = np.frombuffer(json.dumps(head).encode(), np.uint8)
    buf = io.BytesIO()
    np.savez_compressed(buf, **d)
    return buf.getvalue()


def test_jax_checkpoint_loads_into_port(worlds):
    jw, tw = worlds
    blob = jck.world_to_bytes(jw.state, jw.settings)
    for template in (None, tw.state):
        st, settings = tck.world_from_bytes(blob, template, device="cpu")
        assert_trees_equal(state_to_numpy(st), jtree(jw.state))
        assert settings == et.Settings()
    assert sorted(st.user) == ["steer", "tag"]


def test_port_checkpoint_loads_into_jax(worlds):
    jw, tw = worlds
    blob = tck.world_to_bytes(tw.state, tw.settings, tw.meta)
    for template in (None, jw.state):
        st, settings = jck.world_from_bytes(blob, template)
        assert_trees_equal(jtree(st), state_to_numpy(tw.state))
        assert settings == ej.Settings()


def test_same_keys_dtypes_and_settings(worlds):
    jw, tw = worlds
    got = npz(tck.world_to_bytes(tw.state, tw.settings))
    want = npz(jck.world_to_bytes(jw.state, jw.settings))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        if k != "__meta__":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert json.loads(bytes(got["__meta__"])) == json.loads(
        bytes(want["__meta__"]))
    for k in ("contacts/key", "contacts/sort_key", "group", "mask"):
        assert got[k].dtype == np.uint32, k


@pytest.mark.parametrize("fmt", [5, 3])
def test_old_formats_backfill_alike(worlds, fmt):
    jw, _ = worlds
    blob = jck.world_to_bytes(jw.state, jw.settings)
    if fmt == 5:
        old = rewrite(blob, 5, drop=("bp_carry_ok",))
    else:
        d = npz(blob)
        old = rewrite(blob, 3, drop=(
            "bp_aabb_min", "bp_aabb_max", "contacts/sort_key",
            "contacts/sort_slot", "contacts/sort_pvalid", "edge_pointed",
            "labels_stable", "island_stable_steps", "bp_carry_ok"),
            replace={"overflow": d["overflow"][:4]})
    jst, _ = jck.world_from_bytes(old)
    tst, _ = tck.world_from_bytes(old, device="cpu")
    assert_trees_equal(state_to_numpy(tst), jtree(jst))
    tree = state_to_numpy(tst)
    assert not tree["bp_carry_ok"]
    if fmt == 3:
        assert (tree["bp_aabb_min"] == np.float32(1e30)).all()
        keys = npz(blob)["contacts/key"]
        np.testing.assert_array_equal(tree["contacts"]["sort_key"],
                                      np.sort(keys))
        assert tree["overflow"].shape == (5,)


def test_round_trip_steps_as_saved(worlds):
    _, tw = worlds
    blob = tck.world_to_bytes(tw.state, tw.settings, tw.meta)
    st, _ = tck.world_from_bytes(blob, device="cpu")
    assert_trees_equal(state_to_numpy(st), state_to_numpy(tw.state))
    live = et.World(tw.state, tw.settings, tw.meta)
    resumed = tck.resume_world(blob, device="cpu")
    assert resumed.meta == live.meta
    live.step(5)
    resumed.step(5)
    assert_trees_equal(state_to_numpy(resumed.state),
                       state_to_numpy(live.state))


def sphere_cluster(n=40):
    """A plane and n unit spheres overlapping in one cluster: every pair
    touches, more pairs than the 16 a body that ``make_world`` sizes the
    manifold table for (the landed 10k pile's case)."""
    rng = np.random.default_rng(5)
    b = et.WorldBuilder()
    b.make_rigidbody(et.RigidBodyDef(kind=et.KIND_STATIC,
                                     shape=et.PlaneShape((0, 1, 0), 0.0)))
    for p in rng.uniform(-0.3, 0.3, (n, 3)):
        b.make_rigidbody(et.RigidBodyDef(mass=1.0, shape=et.SphereShape(0.5),
                                         position=tuple(p + (0, 2, 0))))
    return b


def test_resumed_world_keeps_grown_widths():
    """A world whose manifold table grew resumes with the widths it grew
    to, not the narrower ones ``derive_meta`` gives its state, and steps
    as the live world does."""
    w = et.make_world(sphere_cluster(), device="cpu")
    start = w.meta.max_pairs
    w.step(2)
    assert w.meta.max_pairs > start
    assert w.state.contacts.key.shape[0] == w.meta.max_pairs
    blob = tck.world_to_bytes(w.state, w.settings, w.meta)
    head = json.loads(bytes(npz(blob)["__meta__"]).decode())
    assert head["widths"] == {
        "max_pairs": w.meta.max_pairs, "bucket_cap": w.meta.bucket_cap,
        "max_rows": w.meta.max_rows}
    r = tck.resume_world(blob, device="cpu")
    assert r.meta == w.meta
    assert et.derive_meta(r.state).max_pairs == start
    w.step(5)
    r.step(5)
    assert_trees_equal(state_to_numpy(r.state), state_to_numpy(w.state))


@pytest.mark.parametrize("fmt", [2, 7])
def test_unsupported_format_refused(worlds, fmt):
    _, tw = worlds
    blob = rewrite(tck.world_to_bytes(tw.state), fmt)
    with pytest.raises(ValueError, match="unsupported"):
        tck.world_from_bytes(blob, device="cpu")
