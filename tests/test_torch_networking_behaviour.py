"""The JAX package's networking tests (``tests/test_networking.py``, all
16) on the port's CPU worlds, and four of the port's own: the batched
spawn of an ``EntityEntered`` packet against one-by-one spawns, the
opt-in convex-row repair of ROADMAP R13 (``Settings.pool_convex_rows``),
a replicated user component entering a client (R15), and a background
replay merged after one of its entities exited (R16).
Each case is the JAX test's body with the port's names and
``device="cpu"``; a file runs at most four (``CASES[0:4]`` here, the
others in ``test_torch_networking_behaviour_{b,c,d,e}.py``)."""
import dataclasses
import math
import time

import numpy as np
import pytest
import torch

import edyn_tpu_torch as et
from edyn_tpu_torch.networking import NetworkClient, NetworkServer
from edyn_tpu_torch.networking import packets as pk
from edyn_tpu_torch.replication.entity_map import EntityMap
from edyn_tpu_torch.replication.snapshot import (
    CREATION_COMPONENTS, RegistrySnapshot, apply_snapshot, extract_snapshot,
)
from edyn_tpu_torch.serialization.checkpoint import (
    world_from_bytes, world_to_bytes,
)
from test_torch_step import one_thread  # noqa: F401


def _empty_world(capacity=32, settings=et.Settings()):
    b = et.WorldBuilder()
    b.make_rigidbody(et.RigidBodyDef(
        kind=et.KIND_STATIC, shape=et.PlaneShape((0, 1, 0), 0.0),
        material=et.Material(friction=0.6)))
    return et.make_world(b, settings, capacity=capacity, device="cpu")


class Channel:
    """Direct packet pipe with optional latency."""
    def __init__(self, latency=0.0):
        self.latency = latency
        self.queue = []

    def send(self, packet):
        self.queue.append(packet)

    def drain(self, handler, now):
        pending = list(self.queue)
        self.queue.clear()
        for p in pending:
            handler(p, now)


def snapshot_export_import_roundtrip():
    w1 = _empty_world()
    ball = w1.spawn(et.RigidBodyDef(mass=2.0, shape=et.SphereShape(0.5),
                                    position=(1, 5, 2), linvel=(1, 2, 3)))
    snap = extract_snapshot(w1.state, [ball],
                            components=("position", "linvel", "orientation",
                                        "angvel"))
    w2 = _empty_world()
    ball2 = w2.spawn(et.RigidBodyDef(mass=2.0, shape=et.SphereShape(0.5)))
    emap = EntityMap()
    emap.insert(ball, ball2)
    w2.state = apply_snapshot(w2.state, snap, emap)
    np.testing.assert_allclose(w2.position(ball2), [1, 5, 2], atol=1e-6)
    np.testing.assert_allclose(w2.linvel(ball2), [1, 2, 3], atol=1e-6)


def snapshot_rejects_nan():
    w = _empty_world()
    ball = w.spawn(et.RigidBodyDef(mass=1.0, shape=et.SphereShape(0.5),
                                   position=(0, 5, 0)))
    snap = RegistrySnapshot(
        entities=np.array([ball], np.int32),
        pools={"position": np.array([[np.nan, 1.0, 0.0]], np.float32)})
    w.state = apply_snapshot(w.state, snap)
    assert torch.isfinite(w.state.pos[ball]).all()
    np.testing.assert_allclose(w.position(ball), [0, 5, 0], atol=1e-6)


def clock_sync():
    from edyn_tpu_torch.networking.clock_sync import ClockSync
    cs = ClockSync()
    offset = 42.0
    now = 100.0
    for _ in range(5):
        req = cs.make_request(now)
        rtt = 0.1
        server_time = now + rtt / 2 + offset
        resp = pk.TimeResponse(timestamp=server_time, id=req.id,
                               origin_time=req.timestamp)
        now += rtt
        cs.process_response(resp, now)
        now += 0.9
    assert abs(cs.time_delta - offset) < 1e-3
    assert abs(cs.to_local(now + offset) - now) < 1e-3


def client_server_entity_sync_and_streaming():
    server_world = _empty_world()
    client_world = _empty_world()
    to_client = Channel()
    to_server = Channel()
    server = NetworkServer(server_world)
    server.register_client(1, to_client.send)
    client = NetworkClient(client_world, to_server.send,
                           enable_extrapolation=False)
    now = 0.0
    ball = client.create_entity(et.RigidBodyDef(
        mass=1.0, shape=et.SphereShape(0.5), position=(0, 5, 0),
        material=et.Material(friction=0.5)))
    dt = 1 / 60
    for step in range(120):
        now += dt
        client.update(now)
        to_server.drain(lambda p, t: server.receive(1, p, t), now)
        server_world.step(1)
        server.update(now)
        to_client.drain(client.receive, now)
    assert client.entity_map.has_local(ball)
    srv_ball = client.entity_map.to_remote(ball)
    assert float(server_world.position(srv_ball)[1]) < 5.0
    assert len(client.owned) == 1


def server_streams_to_observer_client():
    server_world = _empty_world()
    ball = server_world.spawn(et.RigidBodyDef(
        mass=1.0, shape=et.SphereShape(0.5), position=(0, 5, 0),
        material=et.Material(friction=0.5), networked=True))
    client_world = _empty_world()
    to_client = Channel()
    to_server = Channel()
    server = NetworkServer(server_world)
    server.register_client(1, to_client.send)
    client = NetworkClient(client_world, to_server.send,
                           enable_extrapolation=False)
    now = 0.0
    dt = 1 / 60
    for step in range(90):
        now += dt
        client.update(now)
        to_server.drain(lambda p, t: server.receive(1, p, t), now)
        server_world.step(1)
        client_world.step(1)
        server.update(now)
        to_client.drain(client.receive, now)
    assert client.entity_map.has_remote(ball)
    loc = client.entity_map.to_local(ball)
    d = abs(float(client_world.position(loc)[1])
            - float(server_world.position(ball)[1]))
    assert d < 0.5, f"client desynced by {d}"


def ownership_rejected():
    server_world = _empty_world()
    ball = server_world.spawn(et.RigidBodyDef(
        mass=1.0, shape=et.SphereShape(0.5), position=(0, 5, 0),
        networked=True))
    server = NetworkServer(server_world)
    sent = []
    server.register_client(1, sent.append)
    snap = extract_snapshot(server_world.state, [ball], ("position",))
    snap.pools["position"][:] = [99.0, 99.0, 99.0]
    c = server.clients[1]
    c.entity_map.insert(ball, ball)
    server.receive(1, pk.TransientSnapshot(timestamp=0.0, snapshot=snap), 0.0)
    server.update(10.0)
    assert abs(float(server_world.position(ball)[0])) < 1.0


def aabb_of_interest_packet_and_follow():
    w = _empty_world()
    near = w.spawn(et.RigidBodyDef(mass=1.0, shape=et.SphereShape(0.5),
                                   position=(0, 5, 0), networked=True))
    remote = w.spawn(et.RigidBodyDef(mass=1.0, shape=et.SphereShape(0.5),
                                     position=(500, 5, 0), networked=True))
    w.step(1)
    server = NetworkServer(w)
    sent = []
    server.register_client(1, sent.append)
    server.update(0.0)
    entered = {e for p in sent if isinstance(p, pk.EntityEntered)
               for e in p.snapshot.entities}
    assert near in entered and remote not in entered
    sent.clear()
    server.receive(1, pk.SetAabbOfInterest(lo=(450, -50, -50),
                                           hi=(550, 50, 50)), 1.0)
    server.update(1.0)
    entered = {e for p in sent if isinstance(p, pk.EntityEntered)
               for e in p.snapshot.entities}
    exited = {e for p in sent if isinstance(p, pk.EntityExited)
              for e in p.entities}
    assert remote in entered and near in exited
    c = server.clients[1]
    c.interest.follow = near
    w.set_position(near, (100.0, 5.0, 0.0))
    w.step(1)
    server.update(2.0)
    np.testing.assert_allclose(c.interest.center,
                               np.asarray(w.position(near), np.float64),
                               atol=1e-5)


def action_history_roundtrip():
    def boost(state, e, payload):
        linvel = state.linvel.clone()
        linvel[e] += torch.as_tensor(payload, dtype=linvel.dtype)
        return dataclasses.replace(state, linvel=linvel)

    server_world = _empty_world()
    client_world = _empty_world()
    to_client, to_server = Channel(), Channel()
    server = NetworkServer(server_world).register_action_handler(boost)
    server.register_client(1, to_client.send)
    client = NetworkClient(client_world, to_server.send,
                           enable_extrapolation=False)
    client.register_action_handler(boost)
    now = 0.0
    dt = 1 / 60
    ball = client.create_entity(et.RigidBodyDef(
        mass=1.0, shape=et.SphereShape(0.5), position=(0, 5, 0),
        gravity=(0.0, 0.0, 0.0), sleeping_disabled=True))
    for _ in range(10):
        now += dt
        client.update(now)
        to_server.drain(lambda p, t: server.receive(1, p, t), now)
        server.update(now)
        to_client.drain(client.receive, now)
    client.record_action(now, ball, (5.0, 0.0, 0.0))
    assert abs(float(client_world.linvel(ball)[0]) - 5.0) < 1e-5
    for _ in range(120):
        now += dt
        client.update(now)
        to_server.drain(lambda p, t: server.receive(1, p, t), now)
        server.update(now)
        to_client.drain(client.receive, now)
    srv_ball = client.entity_map.to_remote(ball)
    c = server.clients[1]
    assert len(c.action_history.entries) == 1, "re-sends not deduped"
    assert len(c.action_applied) == 1, "action not executed exactly once"
    assert abs(float(server_world.linvel(srv_ball)[0]) - 5.0) < 0.1, \
        server_world.linvel(srv_ball)


def orientation_discontinuity_smoothing():
    cw = _empty_world()
    ball = cw.spawn(et.RigidBodyDef(mass=1.0, shape=et.SphereShape(0.5),
                                    position=(0, 5, 0), networked=True))
    client = NetworkClient(cw, lambda p: None, enable_extrapolation=False)
    client.entity_map.insert(ball, ball)
    q_new = np.array([0.0, 0.0, math.sin(math.pi / 4),
                      math.cos(math.pi / 4)], np.float32)
    snap = RegistrySnapshot(
        entities=np.array([ball], np.int32),
        pools={"orientation": q_new[None, :]})
    client.receive(pk.TransientSnapshot(timestamp=0.0, snapshot=snap), 0.0)
    assert abs(float(np.dot(cw.state.orn[ball].numpy(), q_new))) > 0.999
    po = client.presentation_orientation(ball)
    assert abs(float(po[3])) > 0.999, po
    for k in range(200):
        client.update(0.1 + 0.01 * k)
    po = client.presentation_orientation(ball)
    assert abs(float(np.dot(po, q_new))) > 0.999, po


def playout_delay_announced_to_client():
    w = _empty_world()
    to_client = Channel()
    server = NetworkServer(w)
    server.register_client(1, to_client.send)
    cw = _empty_world()
    client = NetworkClient(cw, lambda p: None, enable_extrapolation=False)
    empty = RegistrySnapshot(entities=np.zeros((0,), np.int32), pools={})
    server.receive(1, pk.TransientSnapshot(timestamp=9.0, snapshot=empty),
                   10.0)
    to_client.drain(client.receive, 10.0)
    assert client.server_playout_delay > 0.0
    for k in range(1, 60):
        server.receive(1, pk.TransientSnapshot(
            timestamp=10.0 * k + 9.0, snapshot=empty), 10.0 * k + 10.0)
    to_client.drain(client.receive, 600.0)
    converged = client.server_playout_delay
    n_before = len(to_client.queue)
    server.receive(1, pk.TransientSnapshot(timestamp=609.0, snapshot=empty),
                   610.0)
    later = [p for p in to_client.queue[n_before:]
             if isinstance(p, pk.SetPlayoutDelay)]
    assert not later, "announcement fired without a significant delay change"
    assert abs(converged - min(1.0 * 1.2, 1.0)) < 0.1


def query_entity_response():
    w = _empty_world()
    ball = w.spawn(et.RigidBodyDef(mass=1.0, shape=et.SphereShape(0.5),
                                   position=(3, 5, 7), networked=True))
    w.step(1)
    to_client = Channel()
    to_server = Channel()
    server = NetworkServer(w)
    server.register_client(1, to_client.send)
    cw = _empty_world()
    client = NetworkClient(cw, to_server.send, enable_extrapolation=False)
    server.update(0.0)
    to_client.drain(client.receive, 0.0)
    assert client.entity_map.has_remote(ball)
    qid = client.query_entity([(ball, ["position", "linvel"])])
    to_server.drain(lambda p, t: server.receive(1, p, t), 1.0)
    to_client.drain(client.receive, 1.0)
    snap = client.query_responses[qid]
    assert set(snap.pools) == {"position", "linvel"}
    assert list(snap.entities) == [ball]
    np.testing.assert_allclose(snap.pools["position"][0],
                               np.asarray(w.position(ball)), atol=1e-6)
    qid2 = client.query_entity([(999, ["position"])])
    to_server.drain(lambda p, t: server.receive(1, p, t), 2.0)
    to_client.drain(client.receive, 2.0)
    assert len(client.query_responses[qid2].entities) == 0


def temporary_ownership():
    w = _empty_world()
    owned = w.spawn(et.RigidBodyDef(
        mass=1.0, shape=et.SphereShape(0.5), position=(0, 0.5, 0),
        networked=True))
    prop = w.spawn(et.RigidBodyDef(
        mass=1.0, shape=et.SphereShape(0.5), position=(0, 1.5, 0),
        networked=True))
    far = w.spawn(et.RigidBodyDef(
        mass=1.0, shape=et.SphereShape(0.5), position=(20, 0.5, 0),
        networked=True))
    w.step(10)
    server = NetworkServer(w)
    c = server.register_client(1, lambda p: None)
    c.owned.add(owned)
    for e in (owned, prop, far):
        c.entity_map.insert(e, e)

    def send_move(entities, xs, now):
        snap = extract_snapshot(w.state, entities, ("position",))
        snap.pools["position"][:, 0] = xs
        server.receive(1, pk.TransientSnapshot(timestamp=now, snapshot=snap),
                       now)
        server.update(now + 10.0)

    send_move([prop, far], [5.0, 50.0], 0.0)
    assert abs(float(w.position(prop)[0]) - 5.0) < 1e-4, \
        "island companion not accepted under temporary ownership"
    assert abs(float(w.position(far)[0]) - 20.0) < 1e-4, \
        "unreachable entity accepted"
    w.set_position(prop, (0.0, 1.5, 0.0))
    w.step(10)
    other = w.spawn(et.RigidBodyDef(
        mass=1.0, shape=et.SphereShape(0.5), position=(0, 2.5, 0),
        networked=True))
    c2 = server.register_client(2, lambda p: None)
    c2.owned.add(other)
    w.step(10)
    send_move([prop], [7.0], 100.0)
    assert abs(float(w.position(prop)[0])) < 1.0, "contested island accepted"
    c.allow_full_ownership = False
    w.destroy(other)
    w.step(10)
    send_move([prop], [9.0], 200.0)
    assert abs(float(w.position(prop)[0])) < 1.0
    send_move([owned], [3.0], 300.0)
    assert abs(float(w.position(owned)[0]) - 3.0) < 1e-4


def checkpoint_roundtrip():
    from edyn_tpu_torch.utils.scenes import box_stack
    b, ids = box_stack(5)
    w = et.make_world(b, device="cpu")
    w.step(30)
    blob = world_to_bytes(w.state, w.settings)
    state2, settings2 = world_from_bytes(blob, device="cpu")
    np.testing.assert_allclose(w.state.pos.numpy(), state2.pos.numpy())
    np.testing.assert_allclose(w.state.contacts.normal_impulse.numpy(),
                               state2.contacts.normal_impulse.numpy())
    assert settings2.fixed_dt == w.settings.fixed_dt
    w2 = et.World(state2, settings2, w.meta)
    w.step(10)
    w2.step(10)
    np.testing.assert_allclose(w.state.pos.numpy(), w2.state.pos.numpy(),
                               atol=1e-6)


def background_extrapolation_off_receive_path():
    client_world = _empty_world()
    ball = client_world.spawn(et.RigidBodyDef(
        mass=1.0, shape=et.SphereShape(0.5), position=(0, 5, 0),
        material=et.Material(friction=0.5), networked=True))
    client = NetworkClient(client_world, lambda p: None,
                           enable_extrapolation=True,
                           background_extrapolation=True,
                           extrapolation_time_limit=30.0)
    client.entity_map.insert(100, ball)
    client_world.step(1)
    client_world.block_until_ready()
    snap = extract_snapshot(client_world.state, [ball],
                            ("position", "linvel"))
    snap.entities = np.array([100], np.int32)
    snap.pools["position"][:] = [0.0, 8.0, 0.0]
    snap.pools["linvel"][:] = [0.0, 0.0, 0.0]
    dt = client_world.settings.fixed_dt
    now = 21 * dt
    t0 = time.perf_counter()
    client.receive(pk.TransientSnapshot(timestamp=dt, snapshot=snap), now)
    recv_time = time.perf_counter() - t0
    assert recv_time < 0.05, f"receive() blocked for {recv_time*1e3:.1f} ms"
    deadline = time.time() + 60
    while time.time() < deadline:
        client.update(now)
        y = float(client_world.position(ball)[1])
        if abs(y - 5.0) > 0.3:
            break
        time.sleep(0.05)
    y = float(client_world.position(ball)[1])
    assert 6.5 < y < 8.0, f"extrapolated y={y}"
    worker = client._extrap_worker
    assert worker.error is None and worker.replays >= 1
    client.close()


def extrapolation_wall_clock_limit():
    from edyn_tpu_torch.networking.extrapolation import extrapolate
    w = _empty_world()
    ball = w.spawn(et.RigidBodyDef(
        mass=1.0, shape=et.SphereShape(0.5), position=(0, 5, 0),
        material=et.Material(friction=0.5), networked=True))
    w.step(1)
    w.block_until_ready()
    snap = extract_snapshot(w.state, [ball], ("position", "linvel"))
    dt = w.settings.fixed_dt
    state, steps, timed_out = extrapolate(
        w, snap, None, 0.0, 20 * dt, time_limit=1e-6)
    assert timed_out and steps < 20


def adaptive_presentation_delay_converges():
    from edyn_tpu_torch.simulation.presentation import Presentation
    w = _empty_world()
    pres = Presentation(w, adaptive=True)
    dt = w.settings.fixed_dt
    rng = np.random.default_rng(0)
    for k in range(300):
        sim_t = k * dt
        w.state = dataclasses.replace(
            w.state, sim_time=w.state.sim_time * 0 + sim_t)
        render_t = sim_t + 0.05 + 0.02 * rng.random()
        pres.observe(render_t)
    assert pres.presentation_delay >= 0.05 - 1e-6, pres.presentation_delay
    assert pres.presentation_delay <= 0.1, pres.presentation_delay
    assert abs(pres.presentation_delay / dt - round(
        pres.presentation_delay / dt)) < 1e-3


# -- the port's own --------------------------------------------------------

def _shapes_world(settings=et.Settings(), capacity=24):
    """A plane, and far away a static box, cylinder and tetrahedron that
    set the convex table's widths and the polyhedron table."""
    b = et.WorldBuilder()
    b.make_rigidbody(et.RigidBodyDef(
        kind=et.KIND_STATIC, shape=et.PlaneShape((0, 1, 0), 0.0)))
    for x, shape in ((100.0, et.BoxShape((0.5, 0.5, 0.5))),
                     (-100.0, et.CylinderShape(0.5, 0.5)),
                     (0.0, TET)):
        b.make_rigidbody(et.RigidBodyDef(kind=et.KIND_STATIC, shape=shape,
                                         position=(x, 0.0, 100.0)))
    return et.make_world(b, settings, capacity=capacity, device="cpu")


TET = et.PolyhedronShape(np.array(
    [[0.4, 0.4, 0.4], [0.4, -0.4, -0.4], [-0.4, 0.4, -0.4],
     [-0.4, -0.4, 0.4]], np.float32))


def _entered_pools(n_rows=9):
    """Creation pools of spheres, boxes, cylinders and tetrahedra of a
    server world (the tetrahedra at the polyhedron table's index 0)."""
    srv = _shapes_world()
    shapes = [et.SphereShape(0.3), et.BoxShape((0.5, 0.5, 0.5)),
              et.CylinderShape(0.5, 0.5)]
    ents = []
    for k in range(n_rows):
        if k % 4 == 3:
            ents.append(srv.spawn(et.RigidBodyDef(
                mass=1.0, shape=TET, position=(3.0 * k, 1.0, 0.0)),
                poly_index=0))
        else:
            ents.append(srv.spawn(et.RigidBodyDef(
                mass=1.0 + k, shape=shapes[k % 4], position=(3.0 * k, 2.0,
                                                             0.0))))
    return extract_snapshot(srv.state, ents, CREATION_COMPONENTS)


def batched_entered_spawn_equals_one_by_one():
    """``_spawn_batch_from_pools`` gives the state and slots of spawning
    the rows one by one (``_spawn_from_pools``), into free slots that are
    not contiguous, with and without the convex rows; a client's
    ``EntityEntered`` takes that path."""
    from edyn_tpu_torch.core.convert import state_to_numpy
    from edyn_tpu_torch.networking.client import (
        _spawn_batch_from_pools, _spawn_from_pools,
    )
    snap = _entered_pools()
    for convex_rows in (False, True):
        w = _shapes_world()
        for k in range(6):   # holes at 6 and 8
            w.spawn(et.RigidBodyDef(mass=1.0, shape=et.SphereShape(0.2),
                                    position=(2.0 * k, 5.0, -5.0)))
        w.destroy(6)
        w.destroy(8)
        one, slots_one = w.state, []
        for row in range(len(snap.entities)):
            one, slot = _spawn_from_pools(
                one, {k: v[row] for k, v in snap.pools.items()}, convex_rows)
            slots_one.append(slot)
        batch, slots = _spawn_batch_from_pools(w.state, snap.pools,
                                               len(snap.entities),
                                               convex_rows)
        assert slots == slots_one and slots[:2] == [6, 8]
        a, b = state_to_numpy(batch), state_to_numpy(one)
        for name in a:
            for k, x in (a[name].items() if isinstance(a[name], dict)
                         else [(None, a[name])]):
                y = b[name][k] if k is not None else b[name]
                np.testing.assert_array_equal(x, y, err_msg=f"{name}/{k}")
        client = NetworkClient(w, lambda p: None, enable_extrapolation=False)
        w.set_settings(pool_convex_rows=convex_rows)
        client.receive(pk.EntityEntered(timestamp=0.0, snapshot=snap), 0.0)
        assert [client.entity_map.to_local(int(e))
                for e in snap.entities] == slots
        for name in ("pos", "shape_type", "valid", "inertia_inv"):
            np.testing.assert_array_equal(getattr(w.state, name).numpy(),
                                          getattr(batch, name).numpy())
        np.testing.assert_array_equal(w.state.convex.verts.numpy(),
                                      batch.convex.verts.numpy())


def pool_convex_rows_repair():
    """ROADMAP R13: a box a client spawns from pools keeps the convex row
    its slot held (a point), so it sinks into the plane and a sphere
    dropped on it falls through, as in the JAX client; with
    ``Settings(pool_convex_rows=True)`` the box rests at its half extent
    and holds the sphere."""
    rest = {}
    for repair in (False, True):
        srv = _shapes_world()
        box = srv.spawn(et.RigidBodyDef(mass=1.0,
                                        shape=et.BoxShape((0.5, 0.5, 0.5)),
                                        position=(0.0, 0.5, 0.0),
                                        networked=True))
        cw = _shapes_world(et.Settings(pool_convex_rows=repair))
        client = NetworkClient(cw, lambda p: None, enable_extrapolation=False)
        client.receive(pk.EntityEntered(timestamp=0.0, snapshot=(
            extract_snapshot(srv.state, [box], CREATION_COMPONENTS))), 0.0)
        ball = cw.spawn(et.RigidBodyDef(mass=1.0, shape=et.SphereShape(0.25),
                                        position=(0.1, 2.0, 0.0)))
        cw.step(90)
        loc = client.entity_map.to_local(box)
        rest[repair] = (float(cw.position(loc)[1]),
                        float(cw.position(ball)[1]))
    assert rest[False][0] < 0.1 and rest[False][1] < 0.3, rest
    assert abs(rest[True][0] - 0.5) < 0.01, rest
    assert abs(rest[True][1] - 1.25) < 0.02, rest


def replicated_user_component_enters():
    """ROADMAP R15: a user component with a "reliable" policy rides the
    creation pools of ``EntityEntered``; the JAX client raises KeyError
    there, the port's writes the entered body's user column."""
    def world():
        b = et.WorldBuilder()
        b.make_rigidbody(et.RigidBodyDef(
            kind=et.KIND_STATIC, shape=et.PlaneShape((0, 1, 0), 0.0)))
        b.register_component("paint", default=0.0, replicate="reliable")
        return et.make_world(b, capacity=8, device="cpu")

    sw, cw = world(), world()
    ball = sw.spawn(et.RigidBodyDef(mass=1.0, shape=et.SphereShape(0.5),
                                    position=(0, 2, 0), networked=True))
    from edyn_tpu_torch.replication.snapshot import set_component
    sw.state = set_component(sw.state, "paint", [ball], [0.75])
    sent = []
    server = NetworkServer(sw)
    server.register_client(1, sent.append)
    client = NetworkClient(cw, lambda p: None, enable_extrapolation=False)
    server.update(0.0)
    assert any("paint" in p.snapshot.pools for p in sent
               if isinstance(p, pk.EntityEntered))
    for p in sent:
        client.receive(p, 0.0)
    loc = client.entity_map.to_local(ball)
    assert float(cw.state.user["paint"][loc]) == 0.75


def replay_merge_after_exit():
    """ROADMAP R16: a background replay that finishes after one of its
    entities exited merges the others; the JAX client raises KeyError."""
    cw = _empty_world()
    a = cw.spawn(et.RigidBodyDef(mass=1.0, shape=et.SphereShape(0.5),
                                 position=(0, 5, 0), networked=True))
    b = cw.spawn(et.RigidBodyDef(mass=1.0, shape=et.SphereShape(0.5),
                                 position=(3, 5, 0), networked=True))
    client = NetworkClient(cw, lambda p: None, enable_extrapolation=True,
                           background_extrapolation=True,
                           extrapolation_time_limit=30.0)
    client.entity_map.insert(100, a)
    client.entity_map.insert(101, b)
    cw.step(1)
    snap = extract_snapshot(cw.state, [a, b], ("position", "linvel"))
    snap.entities = np.array([100, 101], np.int32)
    snap.pools["position"][:, 1] = 8.0
    dt = cw.settings.fixed_dt
    client.receive(pk.TransientSnapshot(timestamp=dt, snapshot=snap),
                   6 * dt)
    worker = client._extrap_worker
    deadline = time.time() + 60
    while worker.replays < 1 and time.time() < deadline:
        time.sleep(0.02)
    assert worker.replays == 1
    client.receive(pk.EntityExited(timestamp=0.0, entities=[101]), 6 * dt)
    client.update(6 * dt)
    assert not bool(cw.state.valid[b])
    assert float(cw.position(a)[1]) > 7.0
    client.close()
    assert worker.error is None


CASES = [snapshot_export_import_roundtrip, snapshot_rejects_nan, clock_sync,
         client_server_entity_sync_and_streaming,
         server_streams_to_observer_client, ownership_rejected,
         aabb_of_interest_packet_and_follow, action_history_roundtrip,
         orientation_discontinuity_smoothing,
         playout_delay_announced_to_client, query_entity_response,
         temporary_ownership, checkpoint_roundtrip,
         background_extrapolation_off_receive_path,
         extrapolation_wall_clock_limit,
         adaptive_presentation_delay_converges,
         batched_entered_spawn_equals_one_by_one, pool_convex_rows_repair,
         replicated_user_component_enters, replay_merge_after_exit]


@pytest.mark.parametrize("case", CASES[0:4], ids=lambda f: f.__name__)
def test_behaviour(case):
    case()
