"""The port's float64 mode (reference: EDYN_DOUBLE_PRECISION,
include/edyn/math/scalar.hpp:9-15): ``torch.set_default_dtype(
torch.float64)`` before a world is built, and every state leaf, spawn
write and step output is float64. The port's copy of ``tests/test_x64.py``'s
scenario, plus the parts the JAX scenario cannot reach (its jitted x64
step fails, ROADMAP R2): every counter int32, spawns, runtime joints, the
sweep broadphase and checkpoints at float64, and a step that follows the
state's dtype whatever the default. A fixture sets the default dtype and
restores it; the worlds run on one CPU thread."""
import dataclasses

import numpy as np
import pytest
import torch

import edyn_tpu_torch as et
from edyn_tpu_torch.config import scalar_dtype
from edyn_tpu_torch.dynamics import solver_kernels as sk
from edyn_tpu_torch.networking import packets, wire
from edyn_tpu_torch.replication import snapshot as tsn
from edyn_tpu_torch.serialization.checkpoint import (world_from_bytes,
                                                     world_to_bytes)
from edyn_tpu_torch.utils import scenes
from test_torch_step import one_thread  # noqa: F401


@pytest.fixture
def f64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def box_stack(pkg=et):
    b = pkg.WorldBuilder()
    b.make_rigidbody(pkg.RigidBodyDef(
        kind=pkg.KIND_STATIC, shape=pkg.PlaneShape((0, 1, 0), 0),
        material=pkg.Material(friction=0.8)))
    stack = [b.make_rigidbody(pkg.RigidBodyDef(
        mass=1.0, shape=pkg.BoxShape((0.5, 0.5, 0.5)),
        position=(0.0, 0.55 + 1.08 * k, 0.0),
        material=pkg.Material(friction=0.8, restitution=0.0)))
        for k in range(4)]
    return b, stack


def leaves(x, name="state"):
    if isinstance(x, torch.Tensor):
        yield name, x
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from leaves(v, f"{name}[{k}]")
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from leaves(getattr(x, f.name), f"{name}.{f.name}")


def assert_f64(st):
    bad = [n for n, t in leaves(st)
           if t.is_floating_point() and t.dtype != torch.float64]
    assert not bad, bad
    for n in ("overflow", "step_count", "island_stable_steps"):
        assert getattr(st, n).dtype == torch.int32, n


def test_double_precision_world(f64):
    """tests/test_x64.py's scenario on the port."""
    assert scalar_dtype() == torch.float64
    b, stack = box_stack()
    w = et.make_world(b, device="cpu")
    # construction
    for name in ("pos", "orn", "linvel", "angvel", "mass_inv", "inertia_inv"):
        assert getattr(w.state, name).dtype == torch.float64, name
    assert_f64(w.state)
    # the step
    w.step(30)
    assert_f64(w.state)
    # mutators keep the dtype
    w.set_position(stack[0], np.asarray(w.position(stack[0])))
    w.apply_impulse(stack[0], (0.0, 0.0, 0.0))
    assert w.state.pos.dtype == torch.float64
    assert w.state.linvel.dtype == torch.float64
    # the 4-box stack stays standing at double precision
    w.step(60)
    pos = w.state.pos.numpy()
    for k, e in enumerate(stack):
        assert abs(pos[e][1] - (0.5 + 1.0 * k)) < 0.2, (k, pos[e][1])
    w.step_n(5)
    assert_f64(w.state)
    assert all(v == 0 for v in w.overflow_counters().values())


def test_f64_spawns_joints_sweep_and_checkpoints(f64):
    """A spawn, a runtime joint, the sweep broadphase, a checkpoint round
    trip and a snapshot packet keep float64; a host value is written at
    float64, not rounded through float32."""
    b, stack = box_stack()
    w = et.make_world(b, capacity=8, max_joints=2, device="cpu")
    w.meta = dataclasses.replace(w.meta, broadphase_mode="sweep")
    s = w.spawn(et.RigidBodyDef(mass=1.0, shape=et.SphereShape(0.3),
                                position=(2.0, 0.1 + 1e-9, 0.0)))
    assert float(w.state.pos[s, 1]) == 0.1 + 1e-9
    et.make_point_constraint(w, stack[2], stack[3], pivot_a=(0, 0.5, 0),
                             pivot_b=(0, -0.5, 0))
    w.step(20)
    assert_f64(w.state)
    blob = world_to_bytes(w.state, w.settings, w.meta)
    st, _ = world_from_bytes(blob, device="cpu")
    assert_f64(st)
    for f in ("pos", "orn", "linvel", "angvel"):
        assert torch.equal(getattr(st, f), getattr(w.state, f)), f
    # a snapshot packet carries float64 pools (the wire's dtype codes) and
    # writes them back without rounding
    snap = tsn.extract_snapshot(w.state, stack + [s])
    raw = wire.encode_packet(packets.TransientSnapshot(timestamp=1.0,
                                                       snapshot=snap))
    back = wire.decode_packet(raw).snapshot
    assert back.pools["position"].dtype == np.float64
    st = tsn.apply_snapshot(dataclasses.replace(
        w.state, pos=torch.zeros_like(w.state.pos)), back)
    assert torch.equal(st.pos[stack + [s]], w.state.pos[stack + [s]])


@pytest.mark.parametrize("built,stepped", [(torch.float32, torch.float64),
                                           (torch.float64, torch.float32)])
def test_the_step_follows_the_state_dtype(built, stepped):
    """A world built at one default dtype and stepped under the other keeps
    its dtype and steps to the same bits as under its own."""
    old = torch.get_default_dtype()
    try:
        states = []
        for during in (built, stepped):
            torch.set_default_dtype(built)
            w = et.make_world(scenes.mixed_pile(n_bodies=24, seed=3)[0],
                              device="cpu")
            torch.set_default_dtype(during)
            w.step(12)
            states.append(w.state)
    finally:
        torch.set_default_dtype(old)
    a, b = states
    assert [t.dtype for _, t in leaves(a)] == [t.dtype for _, t in leaves(b)]
    for f in ("pos", "orn", "linvel", "angvel"):
        assert getattr(b, f).dtype == built
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_kernel_wrappers_keep_float64():
    """On the CPU the wrappers take the plain versions at the tensors'
    dtype: float64 in, float64 out, no cast to float32."""
    rng = np.random.default_rng(0)
    Rp, C = 256, sk.C_BASE + sk.C_SR
    tbl = torch.from_numpy(rng.normal(size=(C, Rp)))
    g = torch.from_numpy(rng.normal(size=(6, 2 * Rp)))
    imp, upd = sk.solve_iteration(tbl, torch.zeros((6, Rp),
                                                   dtype=torch.float64),
                                  g, True)
    assert imp.dtype == upd.dtype == torch.float64
    assert sk.relvel(tbl, g).dtype == torch.float64
    upd, err = sk.ngs_iteration(tbl, g, 0.2, 0.05)
    assert upd.dtype == err.dtype == torch.float64
