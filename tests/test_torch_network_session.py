"""One scripted client-server session in each package, side by side.

A server world (a plane and 7 spheres) and a client world (the same
builder, its spheres destroyed, so both packages' worlds share one
compiled JAX step) talk over byte channels (``encode_packet``/
``decode_packet``, lossless; the server's packets arrive 3 frames late, so
the client replays each snapshot forward). The client creates an 8th
sphere and records a ``"steer"`` input every 5th frame; 60 frames at
60 Hz, each stepping both worlds once. Extrapolation runs inline with no
wall-clock limit, so the session is deterministic.

Held: the sequence of packets in each direction (their kinds and entity
lists) is equal in both packages (exact); the float pools they carry, and
the worlds' transforms at the end, agree within the whole-step tolerances
of ``tests/test_torch_step.py`` (``TOL``; the other floats at the
``linvel`` tolerance), the integer and bool pools exactly; the server's
``"steer"`` column is equal (exact) and holds the client's last input.
"""
import importlib

import numpy as np
import pytest

import edyn_tpu as ej
import edyn_tpu.networking as jnet
import edyn_tpu_torch as et
import edyn_tpu_torch.networking as tnet
from edyn_tpu.networking import wire as jwire
from edyn_tpu_torch.networking import wire as twire
from test_torch_step import TOL, one_thread  # noqa: F401

FRAMES = 60
DELAY = 3          # frames the server's packets take to arrive
CAPACITY = 16
N_SERVER = 7


def builder(pkg):
    b = pkg.WorldBuilder()
    b.make_rigidbody(pkg.RigidBodyDef(
        kind=pkg.KIND_STATIC, shape=pkg.PlaneShape((0, 1, 0), 0.0),
        material=pkg.Material(friction=0.6)))
    for i in range(N_SERVER):
        b.make_rigidbody(pkg.RigidBodyDef(
            mass=1.0 + 0.1 * i, shape=pkg.SphereShape(0.4 + 0.02 * i),
            position=(2.0 * i - 6.0, 0.6 + 0.5 * i, 0.3 * i),
            linvel=(0.2 * i, 0.0, -0.1 * i), networked=True,
            material=pkg.Material(friction=0.5, restitution=0.1)))
    b.register_component("steer", default=0.0, replicate="input")
    return b


class Channel:
    """Bytes only, every packet delivered ``delay`` frames after it was
    sent; keeps the decoded packets it carried."""

    def __init__(self, wire, delay=0):
        self.wire = wire
        self.delay = delay
        self.frame = 0
        self.queue = []
        self.log = []

    def send(self, packet):
        raw = self.wire.encode_packet(packet)
        assert isinstance(raw, bytes)
        self.queue.append((self.frame + self.delay, raw))

    def drain(self, handler, now):
        due = [r for f, r in self.queue if f <= self.frame]
        self.queue = [(f, r) for f, r in self.queue if f > self.frame]
        for raw in due:
            p = self.wire.decode_packet(raw)
            self.log.append((self.frame, p))
            handler(p, now)


def session(pkg, net, wire, make_world):
    server_world = make_world(builder(pkg))
    client_world = make_world(builder(pkg))
    for i in range(1, N_SERVER + 1):
        client_world.destroy(i)
    up, down = Channel(wire), Channel(wire, DELAY)
    server = net.NetworkServer(server_world)
    server.register_client(1, down.send)
    client = net.NetworkClient(client_world, up.send,
                               enable_extrapolation=True,
                               background_extrapolation=False,
                               extrapolation_time_limit=1e9)
    ball = client.create_entity(pkg.RigidBodyDef(
        mass=1.0, shape=pkg.SphereShape(0.5), position=(8.0, 2.0, 0.0),
        material=pkg.Material(friction=0.5)))
    # count the client's inline replays (their steps) through its module
    cmod = importlib.import_module(net.__name__ + ".client")
    replays = []

    def counted(*a, **k):
        out = cmod_extrapolate(*a, **k)
        replays.append(out[1])
        return out

    cmod_extrapolate, cmod.extrapolate = cmod.extrapolate, counted
    inputs = []
    try:
        run_frames(server, client, server_world, client_world, up, down,
                   ball, inputs)
    finally:
        cmod.extrapolate = cmod_extrapolate
    return dict(up=up.log, down=down.log, server=server_world,
                client=client_world, ball=ball, emap=client.entity_map,
                last=inputs[-1], replays=replays)


def run_frames(server, client, server_world, client_world, up, down, ball,
               inputs):
    dt = 1 / 60
    for f in range(FRAMES):
        now = (f + 1) * dt
        up.frame = down.frame = f
        if f % 5 == 0:
            inputs.append(np.array([0.05 * (f + 1)], np.float32))
            client.record_input(now, "steer", [ball], inputs[-1])
        client.update(now)
        up.drain(lambda p, t: server.receive(1, p, t), now)
        server_world.step(1)
        server.update(now)
        down.drain(client.receive, now)
        client_world.step(1)


def _snapshots(p):
    snap = getattr(p, "snapshot", None)
    return [snap] if snap is not None else []


def entity_lists(p):
    out = [np.asarray(s.entities).tolist() for s in _snapshots(p)]
    for f in ("entities", "pairs", "owners", "ids"):
        if hasattr(p, f):
            v = getattr(p, f)
            out.append(sorted(v.items()) if isinstance(v, dict)
                       else np.asarray(v).tolist())
    for r in getattr(p, "records", []):
        out.append((r.component, np.asarray(r.entities).tolist()))
    return out


def hold_pools(a, b, where):
    for name in a.pools:
        x, y = np.asarray(a.pools[name]), np.asarray(b.pools[name])
        assert x.dtype == y.dtype and x.shape == y.shape, (where, name)
        if np.issubdtype(x.dtype, np.floating):
            key = {"position": "pos", "orientation": "orn"}.get(name,
                                                               "linvel")
            rtol, atol = TOL[key]
            np.testing.assert_allclose(x, y, rtol=rtol, atol=atol,
                                       err_msg=f"{where}: {name}")
        else:
            np.testing.assert_array_equal(x, y, err_msg=f"{where}: {name}")


@pytest.fixture(scope="module")
def sessions():
    jax_run = session(ej, jnet, jwire,
                      lambda b: ej.make_world(b, capacity=CAPACITY))
    port_run = session(et, tnet, twire, lambda b: et.make_world(
        b, capacity=CAPACITY, device="cpu"))
    return jax_run, port_run


@pytest.mark.parametrize("direction", ["up", "down"])
def test_same_packets(sessions, direction):
    j, t = sessions[0][direction], sessions[1][direction]
    assert [(f, type(p).__name__, entity_lists(p)) for f, p in t] == \
        [(f, type(p).__name__, entity_lists(p)) for f, p in j]
    kinds = {type(p).__name__ for _, p in t}
    if direction == "down":
        assert {"ServerSettings", "EntityEntered", "UpdateEntityMap",
                "TransientSnapshot", "GeneralSnapshot",
                "TimeResponse"} <= kinds
    else:
        assert {"ClientCreatedEntity", "TransientSnapshot", "InputSnapshot",
                "TimeRequest"} <= kinds
    for (f, pj), (_, pt) in zip(j, t):
        for sj, st in zip(_snapshots(pj), _snapshots(pt)):
            hold_pools(sj, st, f"frame {f} {type(pj).__name__}")
        for rj, rt in zip(getattr(pj, "records", []),
                          getattr(pt, "records", [])):
            np.testing.assert_array_equal(rt.values, rj.values)


def test_worlds_and_input_agree(sessions):
    j, t = sessions
    # every delivered transient snapshot was replayed, alike in both
    assert t["replays"] == j["replays"] and len(t["replays"]) > 10
    assert min(t["replays"]) >= DELAY - 1
    assert t["ball"] == j["ball"]
    assert t["emap"].rem2loc == j["emap"].rem2loc
    for w in ("server", "client"):
        jst, tst = j[w].state, t[w].state
        np.testing.assert_array_equal(tst.valid.numpy(),
                                      np.asarray(jst.valid))
        valid = tst.valid.numpy()
        for f, key in (("pos", "pos"), ("orn", "orn"), ("linvel", "linvel")):
            rtol, atol = TOL[key]
            np.testing.assert_allclose(
                getattr(tst, f).numpy()[valid],
                np.asarray(getattr(jst, f))[valid], rtol=rtol, atol=atol,
                err_msg=f"{w}.{f}")
    srv_ball = t["emap"].to_remote(t["ball"])
    steer = t["server"].state.user["steer"].numpy()
    np.testing.assert_array_equal(steer,
                                  np.asarray(j["server"].state.user["steer"]))
    assert steer[srv_ball] != 0.0
    assert abs(float(np.asarray(
        t["client"].state.user["steer"])[t["ball"]]) - float(t["last"][0])) \
        < 1e-7
