"""K4, the UNIFIED narrowphase bucket as one kernel: the port's plain version
``collide_support_plain`` against the JAX package's Pallas kernel
``collide_support_pallas``. (The CPU narrowphase, which runs the jnp
bucket ``support_sat`` and never K4, is held against the JAX jnp path by
``test_torch_step.py::test_update_contacts``.)

Inputs: two 24-body worlds of random spheres, boxes, capsules and cylinders
(``test_pallas_narrowphase._random_world``'s scene, own copy) with 128
random pairs each, and a world of hand-built tie cases (axis-aligned box on
box, cylinder cap on cap, capsule parallel to a box edge, sphere on a box
face) with all its ordered pairs: one block of columns per ``rim_axes``
value, so the TPU kernel compiles once for each.

The CUDA kernel's redesign (a per-body pre-pass, the pairs run class by
class at their real widths) rests on three CPU facts held here bit for bit:
the plain version at a class's real widths equals it at the padded widths
(a fourth world with every kind of mixed_pile, tetrahedra included, gives
every class); the plain pre-pass's world features are the ones the plain
version derives per pair; the pair order is a stable grouping by class.

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

from test_torch_step import jtree, one_thread  # noqa: F401

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


# ---------------------------------------------------------------------------
# the redesign's exactness: real widths, world features, pair order
# ---------------------------------------------------------------------------

KINDS = {"sphere": 1, "box": 2, "capsule": 3, "cylinder": 4,
         "tetrahedron": 6}   # ShapeType of each convex kind


def _tet_world():
    """Every convex kind of mixed_pile, its tetrahedron included (own
    copy), 15 bodies in a loose cluster."""
    rng = np.random.RandomState(7)
    tet = ej.PolyhedronShape(np.array(
        [[0.15, 0.15, 0.15], [0.15, -0.15, -0.15],
         [-0.15, 0.15, -0.15], [-0.15, -0.15, 0.15]], np.float32))
    shapes = [ej.SphereShape(0.12), ej.BoxShape((0.12, 0.1, 0.14)),
              ej.CapsuleShape(0.08, 0.12), ej.CylinderShape(0.1, 0.12), tet]
    b = ej.WorldBuilder()
    for i in range(15):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        b.make_rigidbody(ej.RigidBodyDef(
            mass=1.0, shape=shapes[i % 5],
            position=tuple(rng.randn(3) * 0.2), orientation=tuple(q)))
    return ej.make_world(b, ej.Settings())


@pytest.fixture(scope="module")
def class_cases(cases):
    """Per world (the three above and the tetrahedron world): the port's
    side table, its widths, every ordered pair of distinct bodies, the
    pairs' shape kinds, the plain pre-pass, and the plain version at the
    padded widths per rim_axes."""
    ports = list(cases["ports"]) + [
        state_from_numpy(jtree(_tet_world().state), "cpu")]
    out = []
    for st in ports:
        tbl, dims = uk.pack_side_table_t(st)
        N = st.capacity
        ka = torch.arange(N).repeat_interleave(N)
        kb = torch.arange(N).repeat(N)
        keep = ka != kb
        ka, kb = ka[keep], kb[keep]
        feat, code, ids = uk.world_features_plain(tbl, dims)
        padded = {rim: uk.collide_support_plain(tbl[:, ka], tbl[:, kb], dims,
                                                THRESH, rim)
                  for rim in (True, False)}
        out.append(dict(tbl=tbl, dims=dims, ka=ka, kb=kb,
                        types=st.shape_type, feat=feat, code=code, ids=ids,
                        padded=padded))
    return out


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("rim", [True, False])
@pytest.mark.parametrize("kind_b", list(KINDS))
@pytest.mark.parametrize("kind_a", list(KINDS))
def test_plain_at_real_widths_is_bit_equal(class_cases, kind_a, kind_b,
                                           rim):
    """A class's columns repacked at the class's real widths (for each of
    V, F, E the larger of its sides' real counts) give the padded widths'
    outputs bit for bit, and so does each side repacked at its own real
    counts (a sphere side at V 1 against a tetrahedron's V 4, edge crosses
    cut to A's E x B's E): skipping masked lanes per side, as the CUDA
    kernel does, changes nothing."""
    n_pairs = 0
    for w in class_cases:
        sel = ((w["types"][w["ka"]] == KINDS[kind_a])
               & (w["types"][w["kb"]] == KINDS[kind_b])).nonzero()[:, 0]
        if not len(sel):
            continue
        ka, kb = w["ka"][sel], w["kb"][sel]
        cols_a, cols_b = w["tbl"][:, ka], w["tbl"][:, kb]
        want = _bits(w["padded"][rim][sel])
        widths = uk.class_widths(w["feat"], ka, kb)
        assert bool((widths == widths[0]).all())
        real = tuple(int(x) for x in widths[0])
        assert all(r <= d for r, d in zip(real, w["dims"]))
        got = uk.collide_support_plain(
            uk.repack_columns(cols_a, w["dims"], real),
            uk.repack_columns(cols_b, w["dims"], real), real, THRESH, rim)
        assert torch.equal(_bits(got), want)
        counts = uk.feature_counts(w["feat"])
        sides = []
        for cols, body in ((cols_a, ka), (cols_b, kb)):
            assert bool((counts[body] == counts[body][0]).all())
            own = tuple(int(x) for x in counts[body][0])
            sides.append(uk.world_side(
                uk.repack_columns(cols, w["dims"], own), own))
        got = uk.collide_sides_plain(*sides, THRESH, rim)
        assert torch.equal(_bits(got), want)
        n_pairs += len(sel)
    assert n_pairs > 0


@pytest.mark.parametrize("world", [0, 1, 2, 3])
def test_world_features_are_plain_versions_world(class_cases, world):
    """The pre-pass's plain version: each body's row holds, bit for bit, the
    world vertices, faces, edges and disc axis that collide_support_plain
    derives from that body's column per pair, with the masks, the real
    counts and the class code."""
    w = class_cases[world]
    tbl, dims = w["tbl"], w["dims"]
    V, F, E = dims
    feat, code, ids = uk.world_features(tbl, dims)  # CPU: the plain version
    assert torch.equal(_bits(feat), _bits(w["feat"]))
    assert torch.equal(ids, w["ids"])
    assert feat.shape == (tbl.shape[1], uk.feature_row(dims))
    assert uk.feature_row(dims) % 4 == 0
    ka = w["ka"]
    S = uk._unpack(tbl[:, ka], dims)
    vw, wax, fw, ew = uk._world(S)
    rows = feat[ka]

    def block(o, G):   # [K, 4G] -> (x, y, z) [G, K] and mask [G, K]
        q = rows[:, o:o + 4 * G].reshape(-1, G, 4)
        return tuple(q[..., c].T for c in range(3)), q[..., 3].T > 0.5

    for got, want in [((rows[:, c] for c in range(3)), S["pos"]),
                      ((rows[:, c] for c in (4, 5, 6, 7)), S["orn"]),
                      ((rows[:, c] for c in (8, 9, 10)), wax),
                      ((rows[:, c] for c in (3, 11)),
                       (S["radius"], S["disc_r"]))]:
        for g, x in zip(got, want):
            assert torch.equal(_bits(g), _bits(x[0]))
    o = uk.HDR
    for G, xyz, mask in ((V, vw, S["vert_mask"]), (F, fw, S["face_mask"]),
                         (E, ew, S["edge_mask"])):
        got, m = block(o, G)
        for g, x in zip(got, xyz):
            assert torch.equal(_bits(g), _bits(x))
        assert torch.equal(m, mask)
        o += 4 * G
    counts = uk.feature_counts(feat)
    for c, mask in enumerate((S["vert_mask"], S["face_mask"],
                              S["edge_mask"])):
        n = counts[ka, c]
        idx = torch.arange(mask.shape[0])[:, None]
        assert bool((~mask | (idx < n[None])).all())     # all True before
        if c:
            assert bool(((n == 0) | mask[(n - 1).clamp(min=0),
                                         torch.arange(len(n))]).all())
    assert bool((counts[:, 0] >= 1).all())
    want_code = (counts.clamp(max=15) * torch.tensor([1, 16, 256])).sum(1) \
        | ((tbl[8] > 1e-9).to(torch.int64) << 12)
    assert torch.equal(code.to(torch.int64), want_code)
    assert torch.equal(feat[:, 15].contiguous().view(torch.int32), code)


@pytest.mark.parametrize("world", [0, 3])
def test_pair_order_groups_classes_stably(class_cases, world):
    """The pair order is a permutation that lists the pairs class by class
    (ascending class numbers of A, then B), each class in table order; its
    inverse restores the table order; one class shares its real widths and
    disc flags on each side; the wrapper on the CPU launches nothing."""
    w = class_cases[world]
    ka, kb, code, ids = w["ka"], w["kb"], w["code"], w["ids"]
    # a shuffled pair list, so that table order is not already sorted
    g = torch.Generator().manual_seed(world)
    shuf = torch.randperm(len(ka), generator=g)
    ka, kb = ka[shuf], kb[shuf]
    uk.reset_launch_counts()
    perm = uk.pair_order(code, ids, ka, kb)
    assert not any(uk.LAUNCHES.values())
    K = len(ka)
    assert torch.equal(torch.sort(perm).values, torch.arange(K))
    # class numbers: the codes present, numbered in code order
    present = torch.unique(code)
    n = int(ids[uk.NCODES])
    assert n == min(len(present), uk.MAX_SIDE) and n > 1
    assert torch.equal(ids[present.long()].long(),
                       torch.arange(len(present)).clamp(max=uk.MAX_SIDE - 1))
    bins = uk.pair_bins_plain(code, ids, ka, kb)
    assert torch.equal(bins.long(), ids[code[ka].long()].long() * n
                       + ids[code[kb].long()].long())
    bs = bins[perm]
    assert bool((bs[1:] >= bs[:-1]).all())               # grouped, ascending
    same = bs[1:] == bs[:-1]
    assert bool((perm[1:][same] > perm[:-1][same]).all())  # stable
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(K)
    assert torch.equal(ka[perm][inv], ka) and torch.equal(kb[perm][inv], kb)
    counts = uk.feature_counts(w["feat"])
    disc = w["tbl"][8] > 1e-9
    for b in torch.unique(bins):
        s = bins == b
        for side in (ka[s], kb[s]):
            assert bool((counts[side] == counts[side][0]).all())
            assert bool((disc[side] == disc[side][0]).all())
