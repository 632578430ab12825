"""The step's spans and counters (``edyn_tpu_torch.utils.profile``) on a
small CPU world: the span tree of one step, tracing off against on, the
clock the spans share with ``torch.profiler``, and the counters (host
syncs, restitution passes) from one thread and from two."""
import dataclasses
import sys
import threading

import pytest
import torch

import edyn_tpu_torch as et
from edyn_tpu_torch.collision import narrowphase
from edyn_tpu_torch.core.builder import Material, RigidBodyDef, WorldBuilder
from edyn_tpu_torch.core.state import KIND_STATIC
from edyn_tpu_torch.shapes.params import BoxShape, PlaneShape, SphereShape
from edyn_tpu_torch.utils import profile
from test_torch_step import one_thread  # noqa: F401

PHASES = ("aabbs", "broadphase", "manifold_slots", "narrowphase", "islands",
          "rows", "solve")
SOLVE = ("scatter_plan", "restitution", "rhs_refresh", "warm_start",
         "velocity", "writeback_integrate", "position")
CLASSES = ("UNIFIED", "BOXBOX", "PLANE")


def _scene(bounce: float = 0.0, drop: float = 0.0):
    """A box on the plane, a box on it and a sphere against the lower
    box's side and on the plane (one pair of each bucket class: PLANE,
    BOXBOX, UNIFIED), all at rest; with ``drop`` the sphere moves down at
    that speed, and every body has the restitution ``bounce``."""
    b = WorldBuilder()
    mat = lambda: Material(restitution=bounce)
    b.make_rigidbody(RigidBodyDef(kind=KIND_STATIC, material=mat(),
                                  shape=PlaneShape((0, 1, 0), 0.0)))
    for y in (0.2, 0.6):
        b.make_rigidbody(RigidBodyDef(shape=BoxShape((0.2, 0.2, 0.2)),
                                      position=(0.0, y, 0.0),
                                      material=mat()))
    b.make_rigidbody(RigidBodyDef(
        shape=SphereShape(0.2), position=(0.4, 0.2, 0.0),
        linvel=(0.0, -drop, 0.0), material=mat()))
    return et.make_world(b, device="cpu")


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree)
                for x in _leaves(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return []


@pytest.fixture(autouse=True)
def fresh():
    profile.reset()
    yield
    profile.reset()


def test_one_step_records_the_span_tree(monkeypatch):
    w = _scene()
    selected = []
    live = narrowphase.live_classes

    def spy(state, man):
        out = live(state, man)
        selected.append(out[0])
        return out
    monkeypatch.setattr(narrowphase, "live_classes", spy)
    with profile.enable():
        w.step()
    rec = profile.recorded()
    assert rec["steps"] == 1
    last = rec["last"]
    assert last[0]["name"] == "step" and last[0]["parent"] == -1
    assert len({s["step"] for s in last}) == 1
    names = [s["name"] for s in last]
    children = lambda p: [s["name"] for s in last if s["parent"] == p]
    assert children(0) == list(PHASES)
    np_i, solve_i = names.index("narrowphase"), names.index("solve")
    assert children(np_i) == (["narrowphase.classify"]
                              + [f"narrowphase.{c}" for c in CLASSES]
                              + ["narrowphase.merge"])
    assert [n for n in children(solve_i) if n in SOLVE] == list(SOLVE)
    for s in last[1:]:
        p = last[s["parent"]]
        for clock in ("host", "device"):
            assert p[f"{clock}_t0_ns"] <= s[f"{clock}_t0_ns"] \
                <= s[f"{clock}_t1_ns"] <= p[f"{clock}_t1_ns"]
    spans = rec["spans"]
    assert all(spans[n]["count"] == 1 for n in PHASES + SOLVE)
    assert all(t["self_ms"] >= 0 for t in spans.values())
    step = spans["step"]
    tiled = sum(spans[n]["device_ms"] for n in PHASES) + step["self_ms"]
    assert tiled == pytest.approx(step["device_ms"], rel=1e-9)
    # the buckets' pairs: the classified live pairs of each class
    (cls,) = selected
    for b, name in narrowphase.CLASS_NAMES.items():
        want = int((cls == b).sum())
        assert rec["counters"].get(f"bucket_pairs.{name}", 0) == want
        if name in CLASSES:
            assert want >= 1
            assert spans[f"narrowphase.{name}"]["attrs"] == {"pairs": want}


def test_tracing_off_records_nothing_and_steps_the_same():
    w = _scene(bounce=0.5, drop=2.0)
    start = w.state
    w.step()
    assert profile.recorded()["steps"] == 0
    assert profile.recorded()["counters"] == {}
    off = w.state
    w.state = start
    with profile.enable():
        w.step()
    assert profile.recorded()["steps"] == 1
    on = w.state
    a, b = _leaves(off), _leaves(on)
    assert len(a) == len(b) > 20
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_spans_share_the_profilers_clock():
    w = _scene()
    w.step()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        w.step()
    rec = profile.recorded()
    assert rec["steps"] == 1
    marks: dict = {}
    for e in prof.profiler.kineto_results.events():
        marks.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    seen: dict = {}
    slack = 50_000
    for s in rec["last"]:
        k = seen[s["name"]] = seen.get(s["name"], -1) + 1
        lo, hi = sorted(marks[s["name"]])[k]
        assert lo - slack <= s["host_t0_ns"] <= s["host_t1_ns"] \
            <= hi + slack, s["name"]


def test_counters_from_one_thread_and_two():
    # the sphere hits the plane and the box at 3 m/s: one restitution
    # pass, then a pass that finds no row approaching and exits
    w = _scene(bounce=1.0, drop=3.0)
    with profile.enable():
        w.step()
    c = profile.recorded()["counters"]
    assert c["restitution_passes"] == 1
    assert c["host_syncs.restitution.any_active"] == 2
    assert c["host_syncs"] == sum(v for k, v in c.items()
                                  if k.startswith("host_syncs."))
    assert float(w.state.linvel[3, 1]) > 0

    # two threads stepping two worlds lose no count
    worlds = [_scene(bounce=1.0, drop=3.0), _scene()]
    starts = [x.state for x in worlds]
    alone = []
    for x in worlds:
        profile.reset()
        with profile.enable():
            x.step(4)
        alone.append(profile.recorded())
    profile.reset()
    for x, st in zip(worlds, starts):
        x.state = st
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with profile.enable():
            threads = [threading.Thread(target=x.step, args=(4,))
                       for x in worlds]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    both = profile.recorded()
    assert both["steps"] == 8
    want = dict(alone[0]["counters"])
    for k, v in alone[1]["counters"].items():
        want[k] = want.get(k, 0) + v
    assert both["counters"] == want
    assert {k: v["count"] for k, v in both["spans"].items()} == {
        k: alone[0]["spans"].get(k, {"count": 0})["count"]
        + alone[1]["spans"].get(k, {"count": 0})["count"]
        for k in set(alone[0]["spans"]) | set(alone[1]["spans"])}

    # more threads than cores, each recording small steps of its own
    def tiny():
        for _ in range(500):
            with profile.step(torch.device("cpu")):
                with profile.span("tiny"):
                    profile.count("tiny")
                    profile.host("tiny")

    profile.reset()
    sys.setswitchinterval(1e-6)
    try:
        with profile.enable():
            threads = [threading.Thread(target=tiny) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    rec = profile.recorded()
    assert rec["steps"] == rec["spans"]["tiny"]["count"] == 16 * 500
    assert rec["counters"] == {"tiny": 8000, "host_syncs": 8000,
                               "host_syncs.tiny": 8000}
