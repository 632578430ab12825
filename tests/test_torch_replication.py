"""The port's replication layer against the JAX package's, on one state.

The state is ``test_torch_checkpoint``'s: ``live_scene`` with two user
components, stepped by the port on the CPU and carried into a JAX state.
On it both packages run the same calls, and the results must be equal
(exact, dtypes too): ``extract_snapshot`` of every component,
``apply_snapshot`` with a remap, an ownership filter and NaN rows,
``get_component``/``set_component`` on built-in and user columns,
``InputHistory.apply``, ``entities_in_aabb`` and ``InterestState``
(following a body). ``EntityMap``, ``SnapshotPolicy``/
``policy_from_world`` and ``ClockSync`` are pure Python in both and are
driven through the same calls.
"""
import dataclasses

import numpy as np
import pytest

from edyn_tpu.networking import clock_sync as jcs
from edyn_tpu.networking import input_history as jih
from edyn_tpu.networking import interest as jint
from edyn_tpu.networking import packets as jpk
from edyn_tpu.replication import entity_map as jem
from edyn_tpu.replication import exporter as jex
from edyn_tpu.replication import snapshot as jsn
from edyn_tpu_torch.core.convert import state_to_numpy
from edyn_tpu_torch.networking import clock_sync as tcs
from edyn_tpu_torch.networking import input_history as tih
from edyn_tpu_torch.networking import interest as tint
from edyn_tpu_torch.networking import packets as tpk
from edyn_tpu_torch.replication import entity_map as tem
from edyn_tpu_torch.replication import exporter as tex
from edyn_tpu_torch.replication import snapshot as tsn
from test_torch_checkpoint import assert_trees_equal, worlds  # noqa: F401
from test_torch_step import jtree, one_thread  # noqa: F401

ENTITIES = [3, 1, 7, 20, 0, 33]
COMPONENTS = list(tsn.CREATION_COMPONENTS) + ["steer", "tag"]


def same_state(jstate, tstate):
    assert_trees_equal(state_to_numpy(tstate), jtree(jstate))


def random_pool(name, like, rng):
    """Values for component ``name`` shaped and typed like ``like``."""
    if like.dtype == bool:
        return rng.random(like.shape) < 0.5
    if np.issubdtype(like.dtype, np.integer):
        hi = 3 if name in ("kind",) else 7
        return rng.integers(0, hi, like.shape).astype(like.dtype)
    return rng.normal(size=like.shape).astype(like.dtype)


@pytest.mark.parametrize("entities", [ENTITIES, sorted(ENTITIES), []])
def test_extract_snapshot(worlds, entities):
    jw, tw = worlds
    js = jsn.extract_snapshot(jw.state, entities, COMPONENTS, timestamp=2.5)
    ts = tsn.extract_snapshot(tw.state, entities, COMPONENTS, timestamp=2.5)
    assert ts.timestamp == js.timestamp
    assert_trees_equal({"e": ts.entities, **ts.pools},
                       {"e": js.entities, **js.pools})


def test_apply_snapshot_remap_filter_and_nan(worlds):
    """Remote ids through an EntityMap (one unmapped), an ownership
    filter, and NaN/Inf rows rejected per entity."""
    jw, tw = worlds
    rng = np.random.default_rng(11)
    like = jsn.extract_snapshot(jw.state, ENTITIES, COMPONENTS)
    pools = {k: random_pool(k, v, rng) for k, v in like.pools.items()}
    pools["position"][1, 2] = np.nan
    pools["linvel"][3, 0] = np.inf
    remote = np.asarray([100 + e for e in ENTITIES], np.int32)
    remote[4] = 999   # not in the map
    for emap_cls, snap_cls, mod, w in ((jem.EntityMap, jsn.RegistrySnapshot,
                                        jsn, jw),
                                       (tem.EntityMap, tsn.RegistrySnapshot,
                                        tsn, tw)):
        emap = emap_cls()
        for e in ENTITIES:
            emap.insert(100 + e, e)
        snap = snap_cls(entities=remote, pools={k: v.copy()
                                                for k, v in pools.items()})
        out = mod.apply_snapshot(w.state, snap, emap,
                                 only_entities={1, 7, 20, 0, 33})
        out = mod.apply_snapshot(out, snap_cls(
            entities=np.asarray([5], np.int32),
            pools={"orientation": np.array([[np.nan, 0, 0, 1]],
                                            np.float32)}))
        if mod is jsn:
            jout = out
        else:
            tout = out
    same_state(jout, tout)
    # the NaN and Inf rows kept their old values
    t = state_to_numpy(tout)
    assert np.isfinite(t["pos"]).all() and np.isfinite(t["linvel"]).all()


@pytest.mark.parametrize("name", ["position", "inertia_inv", "group",
                                  "kind", "has_material", "roll_direction",
                                  "steer", "tag"])
def test_get_and_set_component(worlds, name):
    jw, tw = worlds
    assert_trees_equal(
        state_to_numpy(tw.state)["user"].get(name) if name in ("steer",
                                                             "tag")
        else tsn.leaf_to_numpy(tsn.COMPONENT_COLUMNS[name],
                               tsn.get_component(tw.state, name)),
        np.asarray(jsn.get_component(jw.state, name)))
    rng = np.random.default_rng(len(name))
    like = np.asarray(jsn.get_component(jw.state, name))[[2, 9]]
    vals = random_pool(name, like, rng)
    if name == "group":
        vals = np.array([0xFFFFFFF0, 5], np.uint32)
    same_state(jsn.set_component(jw.state, name, [2, 9], vals),
               tsn.set_component(tw.state, name, [2, 9], vals))


def test_unknown_and_builtin_names(worlds):
    jw, tw = worlds
    for mod, st in ((jsn, jw.state), (tsn, tw.state)):
        with pytest.raises(KeyError):
            mod.get_component(st, "nope")
        with pytest.raises(KeyError):
            mod.set_component(st, "nope", [0], [1.0])
    from edyn_tpu_torch.core.builder import WorldBuilder
    with pytest.raises(ValueError):
        WorldBuilder().register_component("position")


def test_entity_map_policy_and_clock_sync(worlds):
    jw, tw = worlds
    maps = jem.EntityMap(), tem.EntityMap()
    for m in maps:
        for r, l in ((10, 1), (11, 2), (12, 3), (11, 4)):
            m.insert(r, l)
        m.erase_local(3)
        m.erase_local(77)
    assert [vars(m) for m in maps[:1]] == [vars(m) for m in maps[1:]]
    assert len(maps[0]) == len(maps[1])
    jp, tp = jex.policy_from_world(jw), tex.policy_from_world(tw)
    assert tp.policies == jp.policies == {**jex.DEFAULT_POLICIES,
                                          "steer": "input"}
    for attr in ("transient", "reliable", "creation", "input"):
        assert getattr(tp, attr) == getattr(jp, attr), attr
    deltas = []
    for cs_mod, pk_mod in ((jcs, jpk), (tcs, tpk)):
        cs = cs_mod.ClockSync()
        now = 100.0
        for k in range(11):
            req = cs.make_request(now)
            resp = pk_mod.TimeResponse(timestamp=now + 0.03 * k + 42.0,
                                       id=req.id, origin_time=req.timestamp)
            now += 0.05 + 0.01 * k
            cs.process_response(resp, now)
        deltas.append((cs.time_delta, cs.count, cs.to_local(200.0)))
    assert deltas[0] == deltas[1]


def test_interest(worlds):
    jw, tw = worlds
    boxes = [((0, 0, 0), (50, 50, 50)), ((8, 1, 0), (1.0, 1.0, 1.0)),
             ((-3, 1.2, -1.5), (0.3, 0.3, 0.3)), ((500, 5, 0), (1, 1, 1))]
    for c, h in boxes:
        assert tint.entities_in_aabb(tw.state, c, h) == \
            jint.entities_in_aabb(jw.state, c, h)
    seqs = []
    for mod, w in ((jint, jw), (tint, tw)):
        it = mod.InterestState(center=(0, 0, 0), half_extents=(1.5, 2, 1.5))
        out = [it.update(w.state)]
        it.follow = 9
        out.append(it.update(w.state))
        it.half_extents = np.asarray((0.5, 0.5, 0.5))
        out.append(it.update(w.state))
        seqs.append((out, it.center.tolist()))
    assert seqs[0] == seqs[1]


def test_input_history_apply(worlds):
    """Records written inside [t, t+dt) land, others wait; remote ids go
    through the map; records of unmapped ids are skipped."""
    jw, tw = worlds
    recs = [(0.10, "steer", [2, 5], [0.5, -0.5]),
            (0.12, "tag", [7], [[1, 2]]),
            (0.15, "steer", [9], [1.5]),
            (0.30, "steer", [3], [9.0]),
            (0.11, "position", [20], [[1.0, 2.0, 3.0]])]
    outs = []
    for ih, emap_cls, w in ((jih, jem.EntityMap, jw), (tih, tem.EntityMap,
                                                      tw)):
        hist = ih.InputHistory()
        for t, comp, ent, vals in recs:
            v = np.asarray(vals, np.int32 if comp == "tag" else np.float32)
            hist.record(ih.InputRecord(timestamp=t, component=comp,
                                       entities=np.asarray(ent, np.int32),
                                       values=v))
        st = hist.apply(w.state, 0.1, 1 / 60)
        emap = emap_cls()
        emap.insert(9, 11)
        st = hist.apply(st, 0.1 + 1 / 60, 1 / 30, emap=emap)
        outs.append(st)
        assert [r.timestamp for r in hist.since(0.12)] == [0.12, 0.15, 0.30]
    same_state(*outs)
