"""The JAX package's byte-level networking tests with worlds
(``tests/test_wire.py``: the lossy channel, the server-side input replay
and its ownership check, a user component through steps and a checkpoint)
on the port's CPU worlds, every packet crossing as bytes."""
import numpy as np
import pytest

import edyn_tpu_torch as et
from edyn_tpu_torch.networking import NetworkClient, NetworkServer
from edyn_tpu_torch.networking import packets as pk
from edyn_tpu_torch.networking.input_history import InputRecord
from edyn_tpu_torch.networking.wire import decode_packet, encode_packet
from test_torch_step import one_thread  # noqa: F401


class BytesChannel:
    """Transport that ONLY carries bytes, dropping a deterministic fraction
    of unreliable frames (reliable ones model a retransmitting transport)."""

    def __init__(self, loss=0.0, seed=0):
        self.loss = loss
        self.rng = np.random.RandomState(seed)
        self.queue = []

    def send(self, packet):
        raw = encode_packet(packet)
        assert isinstance(raw, bytes)
        if not pk.should_send_reliably(packet) and self.rng.rand() < self.loss:
            return
        self.queue.append(raw)

    def drain(self, handler, now):
        pending, self.queue = self.queue, []
        for raw in pending:
            handler(decode_packet(raw), now)


def _world(capacity=32, with_steer=False):
    b = et.WorldBuilder()
    b.make_rigidbody(et.RigidBodyDef(
        kind=et.KIND_STATIC, shape=et.PlaneShape((0, 1, 0), 0.0),
        material=et.Material(friction=0.6)))
    if with_steer:
        b.register_component("steer", shape=(), default=0.0)
    return et.make_world(b, capacity=capacity, device="cpu")


def test_client_server_over_lossy_bytes_channel():
    server_world = _world()
    client_world = _world()
    to_client = BytesChannel(loss=0.3, seed=1)
    to_server = BytesChannel(loss=0.3, seed=2)
    server = NetworkServer(server_world)
    server.register_client(1, to_client.send)
    client = NetworkClient(client_world, to_server.send,
                           enable_extrapolation=False)
    now = 0.0
    ball = client.create_entity(et.RigidBodyDef(
        mass=1.0, shape=et.SphereShape(0.5), position=(0, 5, 0),
        material=et.Material(friction=0.5)))
    dt = 1 / 60
    for _ in range(120):
        now += dt
        client.update(now)
        to_server.drain(lambda p, t: server.receive(1, p, t), now)
        server_world.step(1)
        server.update(now)
        to_client.drain(client.receive, now)
    assert client.entity_map.has_local(ball)
    srv_ball = client.entity_map.to_remote(ball)
    assert float(server_world.position(srv_ball)[1]) < 5.0


def test_input_history_replay_server_side():
    server_world = _world(with_steer=True)
    client_world = _world(with_steer=True)
    to_client = BytesChannel()
    to_server = BytesChannel(loss=0.5, seed=3)
    server = NetworkServer(server_world)
    server.register_client(1, to_client.send)
    client = NetworkClient(client_world, to_server.send,
                           enable_extrapolation=False)
    now = 0.0
    car = client.create_entity(et.RigidBodyDef(
        mass=1.0, shape=et.SphereShape(0.4), position=(0, 1, 0)))
    dt = 1 / 60
    for step in range(120):
        now += dt
        if step == 60:
            client.record_input(now, "steer", [car], np.array([0.77]))
        client.update(now)
        to_server.drain(lambda p, t: server.receive(1, p, t), now)
        server_world.step(1)
        server.update(now)
        to_client.drain(client.receive, now)
    assert abs(float(client_world.state.user["steer"][car]) - 0.77) < 1e-6
    srv_car = client.entity_map.to_remote(car)
    assert abs(float(server_world.state.user["steer"][srv_car])
               - 0.77) < 1e-6


def test_input_replay_ownership_enforced():
    server_world = _world(with_steer=True)
    intruder = server_world.spawn(et.RigidBodyDef(
        mass=1.0, shape=et.SphereShape(0.3), position=(2, 1, 0),
        networked=True))
    server = NetworkServer(server_world)
    server.register_client(1, lambda p: None)
    rec = InputRecord(timestamp=0.0, component="steer",
                      entities=np.array([intruder], np.int32),
                      values=np.array([9.9], np.float32))
    server.receive(1, pk.InputSnapshot(timestamp=0.0, records=[rec]), 0.0)
    server.update(1.0)
    assert float(server_world.state.user["steer"][intruder]) == 0.0


def test_user_component_rides_the_step_and_checkpoint():
    w = _world(with_steer=True)
    body = w.spawn(et.RigidBodyDef(mass=1.0, shape=et.SphereShape(0.5),
                                   position=(0, 3, 0)))
    from edyn_tpu_torch.replication.snapshot import set_component
    w.state = set_component(w.state, "steer", [body], np.array([0.5]))
    w.step(3)
    assert abs(float(w.state.user["steer"][body]) - 0.5) < 1e-6
    from edyn_tpu_torch.serialization.checkpoint import (
        world_from_bytes, world_to_bytes)
    blob = world_to_bytes(w.state, w.settings)
    state2, _ = world_from_bytes(blob, device="cpu")
    assert abs(float(state2.user["steer"][body]) - 0.5) < 1e-6
