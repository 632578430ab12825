"""The port's sharded step against its own unsharded step, on the CPU.

``edyn_tpu_torch.parallel.make_sharded_step`` over meshes of 1, 2 and 8
CPU "devices" must give the unsharded ``physics_step``'s state bit for bit
(``torch.equal`` on every leaf, every step) on the three scenes of the
JAX package's ``tests/test_sharding.py``, at that test's sizes: the 56-body
pile, a small ``rich_scene`` (trimesh, hinge chains) under the sweep
broadphase, each from its 25th step on, when the first contacts form, and
a mostly-asleep pile whose solve takes the sleep ladder's narrow tier
under the mesh; at 8 shards also with every shard's part of each sum a
hop of its own (``make_mesh(..., hop_each_shard=True)``), the path of
shards on distinct cards. The ordered chain that makes this so
(``solver.chain_index_sum``) is held against ``index_add`` alone.
"""
import dataclasses

import numpy as np
import pytest
import torch

import edyn_tpu_torch as et
from edyn_tpu_torch.dynamics.solver import chain_index_sum
from edyn_tpu_torch.parallel import (
    gather_state, make_mesh, make_sharded_step, shard_state,
)
from edyn_tpu_torch.parallel.collectives import ranges
from edyn_tpu_torch.simulation import stepper
from edyn_tpu_torch.simulation.stepper import physics_step
from edyn_tpu_torch.utils.scenes import mixed_pile, rich_scene

N_DEV = 8
# steps held bit-equal, from a start stepped unsharded into first contact
# (25 steps; the asleep pile: 40, put to sleep, two woken, 1)
STEPS = {"pile": 15, "rich_sweep": 15, "asleep": 3}
LEAD = 25


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The scenes are small and the suite runs several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def leaves(x, name="state"):
    """(path, tensor) of every tensor of a state."""
    if isinstance(x, torch.Tensor):
        yield name, x
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from leaves(v, f"{name}[{k}]")
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from leaves(getattr(x, f.name), f"{name}.{f.name}")


def _capacity(builder):
    return -(-len(builder.defs) // N_DEV) * N_DEV


def scene(name):
    """The world of tests/test_sharding.py's case ``name``, at its sizes
    and settings, on the CPU, at the start of the checked steps."""
    if name == "pile":
        b, _ = mixed_pile(n_bodies=56)
        return et.make_world(b, capacity=_capacity(b), max_pairs=1024,
                             max_joints=N_DEV, device="cpu").step(LEAD)
    if name == "rich_sweep":
        b, _ = rich_scene(n_bodies=48, n_chains=2, chain_links=4, mesh_n=8)
        w = et.make_world(b, capacity=_capacity(b), max_pairs=1024,
                          device="cpu")
        w.meta = dataclasses.replace(w.meta, broadphase_mode="sweep")
        assert w.meta.has_joints
        return w.step(LEAD)
    b, ids = mixed_pile(n_bodies=56)
    # max_rows 4096 > the sharded ladder quantum (256 x 8): a narrow tier
    # exists under the mesh
    w = et.make_world(b, capacity=_capacity(b), max_pairs=4096,
                      max_joints=N_DEV, device="cpu")
    assert w.meta.sleep_gating and w.meta.max_rows is not None
    w.step(40)
    w.put_to_sleep()
    w.wake_set({ids[0], ids[1]})
    return w.step(1)


@pytest.fixture(scope="module")
def references():
    """Per scene: the world and the unsharded states of its steps."""
    out = {}
    for name, n in STEPS.items():
        w = scene(name)
        states = [w.state]
        for _ in range(n):
            states.append(physics_step(states[-1], w.settings, w.meta))
        out[name] = (w, states)
    return out


@pytest.mark.parametrize("merge", [True, False])
@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_chain_index_sum_equals_index_add(k, merge):
    """The chain over k contiguous row ranges gives ``index_add`` over all
    rows, bit for bit, with repeated and random targets, the parts merged
    into one call or each a hop; along either dimension."""
    g = np.random.default_rng(k)
    N, R = 37, 1000
    x = torch.as_tensor(g.standard_normal((N, 6)), dtype=torch.float32)
    idx = torch.as_tensor(g.integers(0, N, R))
    src = torch.as_tensor(g.standard_normal((R, 6)) * 10.0 ** g.integers(
        -6, 6, (R, 1)), dtype=torch.float32)
    want = x.index_add(0, idx, src)
    got = chain_index_sum(x, [(idx[r0:r1], src[r0:r1])
                              for r0, r1 in ranges(R, k)], merge=merge)
    assert torch.equal(got, want)
    got_t = chain_index_sum(x.T.contiguous(), [
        (idx[r0:r1], src[r0:r1].T) for r0, r1 in ranges(R, k)], dim=1,
        merge=merge)
    assert torch.equal(got_t, want.T)
    assert sum(r1 - r0 for r0, r1 in ranges(R, k)) == R


@pytest.mark.parametrize("k,hops", [(1, False), (2, False), (8, False),
                                    (8, True)],
                         ids=["k1", "k2", "k8", "k8-hops"])
@pytest.mark.parametrize("name", list(STEPS))
def test_sharded_step_is_bit_equal(references, name, k, hops):
    w, states = references[name]
    mesh = make_mesh([torch.device("cpu")] * k, hop_each_shard=hops)
    step, got = make_sharded_step(mesh, states[0], w.settings, w.meta)
    for i in range(1, len(states)):
        got = step(got)
        bad = [n for (n, a), (_, b) in zip(leaves(got), leaves(states[i]))
               if not torch.equal(a, b)]
        assert not bad, f"{name}, k={k}: step {i} differs at {bad[:8]}"
    assert int(got.overflow.abs().sum()) == 0
    assert int(got.contacts.point_valid.sum()) > 0
    # the round trip of the state through the mesh changes nothing
    back = gather_state(shard_state(mesh, states[-1]))
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(leaves(back), leaves(states[-1])))


def test_narrow_tier_taken_under_the_mesh(references, monkeypatch):
    """On the mostly-asleep pile the sharded solve takes the ladder's
    narrowest tier, at the JAX package's width with quantum 256 x 8."""
    w, states = references["asleep"]
    widths = []
    real = stepper.solve_width
    monkeypatch.setattr(stepper, "solve_width",
                        lambda rows, meta: widths.append(
                            (rows.valid.shape[0], real(rows, meta)))
                        or widths[-1][1])
    step, dev_state = make_sharded_step(
        make_mesh([torch.device("cpu")] * N_DEV), states[0], w.settings,
        w.meta)
    step(dev_state)
    (r_full, width), = widths
    quantum = 256 * N_DEV
    tier0 = max(quantum, -(-(r_full // 8) // quantum) * quantum)
    assert tier0 < r_full
    assert width == tier0, (width, tier0, r_full)
