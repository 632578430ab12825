"""K4, the UNIFIED narrowphase bucket as one kernel: the port's plain version
``collide_support_plain`` against the JAX package's Pallas kernel
``collide_support_pallas``. (The CPU narrowphase, which runs the jnp
bucket ``support_sat`` and never K4, is held against the JAX jnp path by
``test_torch_collision.py::test_update_contacts``.)

Inputs: two 24-body worlds of random spheres, boxes, capsules and cylinders
(``test_pallas_narrowphase._random_world``'s scene, own copy) with 128
random pairs each, and a world of hand-built tie cases (axis-aligned box on
box, cylinder cap on cap, capsule parallel to a box edge, sphere on a box
face) with all its ordered pairs: one block of columns per ``rim_axes``
value, so the TPU kernel compiles once for each.

Tolerances:
- Against the TPU kernel's body evaluated op by op (``_make_kernel`` under
  ``jax.disable_jit``): every output element within atol 1e-5 on pairs
  whose point-validity pattern agrees, and at most 1% of pairs differing
  (a different selection among tied features). The plain version follows
  the same operations in the same order; it is bit-equal here.
- Against ``collide_support_pallas(interpret=True)``: its compiled XLA body
  contracts multiplies and adds into FMAs and so picks another tied vertex
  or axis on ~13% of random pairs, as it does against its own op-by-op
  evaluation. There the test holds the contract of
  ``tests/test_pallas_narrowphase.py`` (contact existence on < 1% of pairs,
  deepest depth within 5e-4, its normal within 2e-3, point counts within 1
  on > 97% of shallow pairs), and checks that every pair beyond atol 1e-5
  differs just as much between the JAX kernel's two evaluations.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import edyn_tpu as ej
from edyn_tpu.collision.kernels import pallas_unified as pu

from edyn_tpu_torch.collision.kernels import unified_kernel as uk
from edyn_tpu_torch.core.convert import state_from_numpy

from test_torch_step import jtree

THRESH = 0.02
BLK = pu.BLK


def _random_world(seed, n=24):
    rng = np.random.RandomState(seed)
    b = ej.WorldBuilder()
    shapes = [
        lambda: ej.SphereShape(0.2 + 0.3 * rng.rand()),
        lambda: ej.BoxShape(0.15 + 0.3 * rng.rand(3)),
        lambda: ej.CapsuleShape(0.1 + 0.2 * rng.rand(),
                                0.2 + 0.3 * rng.rand()),
        lambda: ej.CylinderShape(0.1 + 0.2 * rng.rand(),
                                 0.2 + 0.3 * rng.rand()),
    ]
    for i in range(n):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        b.make_rigidbody(ej.RigidBodyDef(
            mass=1.0, shape=shapes[i % 4](),
            position=tuple(rng.randn(3) * 0.5), orientation=tuple(q)))
    return ej.make_world(b, ej.Settings())


def _tie_world():
    """Resting configurations whose features tie exactly: aligned boxes
    stacked and offset, cylinders cap on cap (axis y), a capsule lying
    along a box's top edge direction, a sphere on a box face."""
    b = ej.WorldBuilder()
    s = np.sin(np.pi / 4)
    bodies = [
        (ej.BoxShape((0.5, 0.5, 0.5)), (0.0, 0.0, 0.0), (0, 0, 0, 1)),
        (ej.BoxShape((0.5, 0.5, 0.5)), (0.0, 0.995, 0.0), (0, 0, 0, 1)),
        (ej.BoxShape((0.3, 0.2, 0.4)), (0.25, 1.69, 0.1), (0, 0, 0, 1)),
        (ej.CylinderShape(0.4, 0.3, 1), (3.0, 0.0, 0.0), (0, 0, 0, 1)),
        (ej.CylinderShape(0.4, 0.3, 1), (3.0, 0.595, 0.0), (0, 0, 0, 1)),
        (ej.CylinderShape(0.25, 0.2, 1), (3.1, 1.09, 0.05), (0, 0, 0, 1)),
        (ej.BoxShape((0.6, 0.3, 0.6)), (6.0, 0.0, 0.0), (0, 0, 0, 1)),
        (ej.CapsuleShape(0.1, 0.4), (6.0, 0.398, 0.2), (0, 0, 0, 1)),
        (ej.CapsuleShape(0.1, 0.4, 2), (6.5, 0.399, 0.0), (0, 0, 0, 1)),
        (ej.SphereShape(0.25), (6.0, 0.549, -0.3), (0, 0, 0, 1)),
        (ej.BoxShape((0.5, 0.5, 0.5)), (9.0, 0.0, 0.0), (0, s, 0, s)),
        (ej.BoxShape((0.5, 0.5, 0.5)), (9.0, 0.999, 0.0), (0, 0, 0, 1)),
    ]
    for shape, pos, orn in bodies:
        b.make_rigidbody(ej.RigidBodyDef(mass=1.0, shape=shape, position=pos,
                                         orientation=orn))
    return ej.make_world(b, ej.Settings())


def _pairs(seed, N):
    rng = np.random.RandomState(100 + seed)
    ka = rng.randint(0, N, size=BLK)
    kb = rng.randint(0, N, size=BLK)
    return ka, np.where(kb == ka, (kb + 1) % N, kb)


class _Out:
    def __setitem__(self, key, value):
        self.value = value


@pytest.fixture(scope="module")
def cases():
    """Per world: the JAX state, the port's copy; the gathered columns of
    all pairs side by side; each evaluation's outputs per rim_axes."""
    worlds = [_random_world(0), _random_world(1), _tie_world()]
    states = [w.state for w in worlds]
    ports = [state_from_numpy(jtree(s), "cpu") for s in states]
    cols_a, cols_b, tcols_a, tcols_b = [], [], [], []
    dims = None
    for i, (js, ts) in enumerate(zip(states, ports)):
        N = js.capacity
        if i < 2:
            ka, kb = _pairs(i, N)
        else:
            ka, kb = (np.array(x) for x in zip(*[
                (a, b) for a in range(N) for b in range(N) if a != b]))
        jt, dims = pu.pack_side_table_t(js)
        tt, tdims = uk.pack_side_table_t(ts)
        assert tdims == dims
        cols_a.append(np.asarray(jt)[:, ka])
        cols_b.append(np.asarray(jt)[:, kb])
        tcols_a.append(tt[:, torch.from_numpy(ka)])
        tcols_b.append(tt[:, torch.from_numpy(kb)])
    K = sum(c.shape[1] for c in cols_a)
    Kp = -(-K // BLK) * BLK
    a = np.pad(np.concatenate(cols_a, 1), ((0, 0), (0, Kp - K)), mode="edge")
    b = np.pad(np.concatenate(cols_b, 1), ((0, 0), (0, Kp - K)), mode="edge")
    ta, tb = torch.cat(tcols_a, 1), torch.cat(tcols_b, 1)
    out = {}
    for rim in (True, False):
        interp = np.asarray(pu.collide_support_pallas(
            jnp.asarray(a), jnp.asarray(b), dims, THRESH, rim_axes=rim,
            interpret=True))[:K]
        sink = _Out()
        with jax.disable_jit():
            pu._make_kernel(dims, THRESH, rim)(jnp.asarray(a[:, :K]),
                                               jnp.asarray(b[:, :K]), sink)
        eager = np.asarray(sink.value).T.reshape(K, 4, 12)
        plain = uk.collide_support_plain(ta, tb, dims, THRESH, rim).numpy()
        out[rim] = dict(interp=interp, eager=eager, plain=plain)
    return dict(states=states, ports=ports, out=out,
                n_ties=cols_a[2].shape[1])


@pytest.mark.parametrize("world", [0, 1, 2])
def test_pack_side_table_t(cases, world):
    jt, jd = pu.pack_side_table_t(cases["states"][world])
    tt, td = uk.pack_side_table_t(cases["ports"][world])
    assert td == jd
    assert tt.shape[0] == uk.table_rows(td)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def _pair_diff(got, want):
    """Per pair: validity pattern equal, largest elementwise difference."""
    same_valid = (got[..., 11] == want[..., 11]).all(-1)
    return same_valid, np.abs(got - want).reshape(len(got), -1).max(-1)


@pytest.mark.parametrize("rim", [True, False])
def test_plain_matches_tpu_kernel_op_by_op(cases, rim):
    o = cases["out"][rim]
    same, diff = _pair_diff(o["plain"], o["eager"])
    assert (same & (diff <= 1e-5)).mean() >= 0.99, np.nonzero(diff > 1e-5)
    # the tie cases make contacts, several points each
    ties = o["plain"][-cases["n_ties"]:]
    assert (ties[..., 11].sum(-1) >= 2).sum() >= 6


@pytest.mark.parametrize("rim", [True, False])
def test_plain_meets_interpret_contract(cases, rim):
    o = cases["out"][rim]
    got, want = o["plain"], o["interp"]
    pv_g, pv_w = got[..., 11] > 0.5, want[..., 11] > 0.5
    d_g = np.where(pv_g, got[..., 10], 1e9)
    d_w = np.where(pv_w, want[..., 10], 1e9)
    has_g, has_w = pv_g.any(-1), pv_w.any(-1)
    assert (has_g != has_w).mean() < 0.01
    both = has_g & has_w
    assert both.sum() > 50
    np.testing.assert_allclose(d_g.min(-1)[both], d_w.min(-1)[both],
                               atol=5e-4)
    pick = lambda x, d: np.take_along_axis(
        x[..., 6:9], d.argmin(-1)[:, None, None].repeat(3, -1), 1)[:, 0]
    np.testing.assert_allclose(pick(got, d_g)[both], pick(want, d_w)[both],
                               atol=2e-3)
    shallow = both & (d_w.min(-1) > -0.05)
    assert (np.abs(pv_g.sum(-1) - pv_w.sum(-1))[shallow] <= 1).mean() > 0.97
    # where the port and the compiled kernel differ, the kernel differs as
    # much from its own op-by-op evaluation
    _, diff = _pair_diff(got, want)
    _, self_diff = _pair_diff(o["eager"], want)
    far = diff > 1e-5
    assert (self_diff[far] > 1e-5).all()


def test_wrapper_on_cpu_is_plain(cases):
    ts = cases["ports"][2]
    tt, dims = uk.pack_side_table_t(ts)
    N = ts.capacity
    ka = torch.arange(N).repeat_interleave(N)
    kb = torch.arange(N).repeat(N)
    keep = ka != kb
    ka, kb = ka[keep], kb[keep]
    uk.reset_launch_counts()
    got = uk.collide_support_unified(tt, ka, kb, dims, THRESH, True)
    want = uk.collide_support_plain(tt[:, ka], tt[:, kb], dims, THRESH, True)
    assert torch.equal(got, want)
    assert uk.LAUNCHES["collide_support"] == 0
    uk.check_caps(dims)
    with pytest.raises(NotImplementedError, match="caps"):
        uk.check_caps((9, 4, 6))
