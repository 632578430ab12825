"""The card's fused solver iterations and their scatter plan, on the CPU.

On the card K1's, K3a's and K2's iterations run as the fused kernel (the
endpoint gather inside it, the update terms written where the step's
``dynamics.scatter.ScatterPlan`` puts them) and ``segment_sum`` (each
body's terms added in ``solver.index_sum``'s order on the card); each
restitution outer pass is one fused K3b (the velocities read by the plan's
endpoints, the pass's rhs, activity and early-exit flag written). Here
the wrappers take their plain versions, which are held:

- the plan against a direct stable sort of the endpoint list;
- ``segment_sum_plain`` against a Python loop in the card's order, to the
  bit, and with a start value against one hop of
  ``solver.chain_index_sum``, to the bit;
- the fused plain iterations against the JAX package's Pallas kernels
  (interpret mode) with an XLA gather and scatter-add, and the fused
  K3b against ``relvel_pallas`` and the JAX pass's glue;
- the planned velocity and position loops against the unfused ones
  summed in the card's order, to the bit, over one shard, three, and three
  with a hop each; the planned restitution pre-pass the same way;
- whole steps taken through the plan against the CPU's own step.

The CUDA kernels are held against these plain versions, and against the
unfused path, on the card by ``chip_smoke.py``.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import edyn_tpu_torch as et
from edyn_tpu.dynamics import pallas_solver as ps
from edyn_tpu_torch.config import CONTACT_POSITION_CORRECTION_RATE
from edyn_tpu_torch.dynamics import position as tposition
from edyn_tpu_torch.dynamics import scatter
from edyn_tpu_torch.dynamics import solver as tsolver
from edyn_tpu_torch.dynamics import solver_kernels as sk
from edyn_tpu_torch.parallel import make_mesh, make_sharded_step
from edyn_tpu_torch.parallel.collectives import Mesh, ranges
from edyn_tpu_torch.simulation import stepper
from edyn_tpu_torch.utils.scenes import mixed_pile

from test_torch_sharding_behaviour import leaves
from test_torch_solver import _bodies, jax_rows, port_rows, random_rows
from test_torch_step import TOL as STEP_TOL
from test_torch_step import one_thread  # noqa: F401

CPU = torch.device("cpu")
N = 48          # bodies of random_rows
STATIC = (0, 5)  # bodies given zero inverse mass and inertia
RATE = float(CONTACT_POSITION_CORRECTION_RATE)
MAX_CORR = tposition.MAX_CORRECTION


def static_rows(seed, with_sr=True, R=96):
    """``random_rows`` whose sides on the STATIC bodies have zero inverse
    mass and inertia (their terms are exactly zero, as a plane's)."""
    d = random_rows(R=R, N=N, with_sr=with_sr, seed=seed)
    for side, end in (("A", "a"), ("B", "b")):
        on = np.isin(d[end], STATIC)
        d[f"inv_m{side}"][on] = 0.0
        for r in ("rn", "r1", "r2"):
            d[r][f"t{side}"][on] = 0.0
        if with_sr:
            for k in ("n", "t1", "t2"):
                d[f"s{side}_{k}"][on] = 0.0
    return d


def moves():
    m = torch.ones((N,), dtype=torch.bool)
    m[list(STATIC)] = False
    return m


def shard_packs(rows, k):
    """The rows cut into k contiguous shards, each packed."""
    return [tsolver.ShardPack.of_rows(tsolver.rows_range(rows, r0, r1))
            for r0, r1 in ranges(rows.valid.shape[0], k)]


def card_order_sum(x, index, src):
    """``solver.index_sum`` as the card adds, one body at a time: its live
    terms (a component not zero) summed from zero in index order, then
    added to x; x kept where no term is live."""
    out = x.clone()
    for b in range(x.shape[0]):
        g, live = torch.zeros_like(x[b]), False
        for i in torch.nonzero(index == b).flatten().tolist():
            if bool((src[i] != 0).any()):
                g, live = g + src[i], True
        if live:
            out[b] = x[b] + g
    return out


def bits_equal(a, b):
    """Equal to the bit (signed zeros apart too)."""
    it = torch.int64 if a.dtype == torch.float64 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.contiguous().view(it),
                                              b.contiguous().view(it))


@pytest.mark.parametrize("k,hops", [(1, False), (3, False), (3, True)],
                         ids=["k1", "k3", "k3-hops"])
def test_plan_is_a_stable_sort_of_the_endpoints(k, hops):
    """Each kept term's position is its rank in a stable sort of its hop's
    endpoint list by target; terms of invalid rows and into bodies that
    cannot move are left out (-1); each body's segment holds its kept
    terms; parts on one device are one hop unless each is a hop."""
    rows = port_rows(static_rows(seed=1))
    packs = shard_packs(rows, k)
    mesh = Mesh((CPU,) * k, hop_each_shard=hops)
    plan = scatter.ScatterPlan.build(packs, moves(), mesh)
    assert len(plan.hops) == (2 * k if hops else 1)
    parts = [(p.a_p, p.tbl[55]) for p in packs] + \
        [(p.b_p, p.tbl[55]) for p in packs]
    groups = [[q] for q in parts] if hops else [parts]
    got = [t.pos[:p.Rp] for t, p in zip(plan.shards, packs)] + \
        [t.pos[p.Rp:] for t, p in zip(plan.shards, packs)]
    got = [torch.cat(got[i:i + len(g)]) for i, g in
           zip(np.cumsum([0] + [len(g) for g in groups]), groups)]
    left_out = set()
    for hop, group, pos in zip(plan.hops, groups, got):
        idx = torch.cat([i for i, _ in group]).numpy()
        valid = torch.cat([v for _, v in group]).numpy() > 0.5
        keep = valid & ~np.isin(idx, STATIC)
        left_out |= {"invalid"} if (~valid).any() else set()
        left_out |= {"static"} if (valid & ~keep).any() else set()
        order = np.argsort(np.where(keep, idx, N), kind="stable")
        want = np.full(idx.shape, -1)
        want[order[:keep.sum()]] = np.arange(keep.sum())
        np.testing.assert_array_equal(pos.numpy(), want)
        counts = np.bincount(idx[keep], minlength=N)
        np.testing.assert_array_equal(hop.offsets.numpy(),
                                      np.concatenate([[0], np.cumsum(counts)]))
        assert hop.offsets.dtype == pos.dtype == torch.int32
        assert hop.terms.shape == (idx.shape[0], 8)
    assert left_out == {"invalid", "static"}
    for t, p in zip(plan.shards, packs):
        assert torch.equal(t.ab, p.ab_p.to(torch.int32))


def random_segments(dtype, seed, n=37, E=400):
    """Terms [E,8] (some rows zero, magnitudes spread over 12 decades) in
    segments of random length (some bodies without any), a start and x."""
    g = np.random.default_rng(seed)
    deg = g.integers(0, 25, n)
    deg[[3, 11]] = 0
    off = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    E = int(off[-1])
    t = g.standard_normal((E, 8)) * 10.0 ** g.integers(-6, 6, (E, 1))
    t[:, 6:] = 0.0
    t[g.random(E) < 0.2] = 0.0
    t[g.random(E) < 0.05, 2] = -0.0
    mk = lambda a: torch.as_tensor(a, dtype=dtype)
    x = g.standard_normal((n, 8))
    x[:, 6:] = 0.0
    start = g.standard_normal((n, 8))
    start[:, 6:] = 0.0
    start[g.random(n) < 0.3] = 0.0
    return mk(t), torch.as_tensor(off), mk(x), mk(start)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_segment_sum_is_the_card_order_to_the_bit(dtype):
    """x plus each body's live terms summed from zero, in order: equal to
    a Python loop in that order, to the bit, and written into x. Within
    rtol 1e-5 (1e-12 at float64) of ``index_add``, which adds each term to
    x in turn: the same terms in another order of summation."""
    terms, off, x, _ = random_segments(dtype, seed=4)
    target = torch.repeat_interleave(torch.arange(x.shape[0]),
                                     (off[1:] - off[:-1]).long())
    want = card_order_sum(x[:, :6], target, terms[:, :6])
    x0 = x.clone()
    got = sk.segment_sum(terms, off, x=x)
    assert got.data_ptr() == x.data_ptr()
    assert bits_equal(got[:, :6], want)
    assert torch.equal(got[:, 6:], x0[:, 6:])
    near = x0[:, :6].index_add(0, target, terms[:, :6])
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    scale = terms[:, :6].abs().amax() + x0.abs().amax()
    assert float((got[:, :6] - near).abs().max()) <= tol * float(scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_segment_sum_start_is_a_chain_hop(dtype):
    """Without x, with the running sum as start: one hop of
    ``chain_index_sum`` as the card takes it (``index_sum`` into zeros of
    the running sum's rows, then the hop's terms), to the bit; without a
    start, its first hop."""
    terms, off, _, start = random_segments(dtype, seed=5)
    n = start.shape[0]
    target = torch.repeat_interleave(torch.arange(n),
                                     (off[1:] - off[:-1]).long())
    zeros = torch.zeros((n, 6), dtype=dtype)
    hop = tsolver.index_sum(zeros, torch.cat([torch.arange(n), target]),
                            torch.cat([start[:, :6], terms[:, :6]]))
    got = sk.segment_sum(terms, off, start=start)
    assert bits_equal(got[:, :6], hop)
    assert not got[:, 6:].any()
    first = sk.segment_sum(terms, off)
    assert bits_equal(first[:, :6], tsolver.index_sum(zeros, target,
                                                      terms[:, :6]))


def _xla_scatter(x_t, ab, upd):
    return x_t.at[:, ab].add(jnp.concatenate([upd[:6], upd[6:]], axis=1))


def k3b_matches_the_pallas_kernel(dtype):
    """``relvel_fused_plain`` from the [N,8] velocity table against
    ``relvel_pallas`` (interpret mode) on an XLA gather, then the JAX
    pass's glue (``edyn_tpu/dynamics/solver.py:624-628``): the rhs within
    1e-5 (``test_torch_solver.test_relvel_kernel``'s tolerance), the
    activity equal, and the flag raised to the pass's number exactly where
    a row is active; once with the velocities and once with them zero (no
    row active: the flag keeps the last pass's number). At float64 the
    port takes the same float32 inputs widened; the JAX package runs in
    float32."""
    d = static_rows(seed=2)
    jt, ja, jb, _ = ps.pack_rows_t(jax_rows(d))
    (pack,) = packs = shard_packs(port_rows(d), 1)
    plan = scatter.ScatterPlan.build(packs, moves(), Mesh((CPU,)))
    t = plan.shards[0]
    vel = (np.random.RandomState(3).randn(N, 6) * 0.1).astype(np.float32)
    for scale, raised in ((1.0, True), (0.0, False)):
        v = vel * np.float32(scale)
        relv = ps.relvel_pallas(jt, jnp.asarray(v.T)[:, jnp.concatenate(
            [ja, jb])], interpret=True)
        restit = jt[56:57]
        active = (jt[55:56] > 0.5) & (relv < -0.005) & (restit > 0)
        want = np.asarray(jnp.concatenate([-relv * (1.0 + restit),
                                           active.astype(jnp.float32)]))
        gen = plan.next_generation()
        got = sk.relvel_fused(pack.tbl.to(dtype), scatter.body_table(
            torch.from_numpy(v).to(dtype)), t.ab, t.flag, gen)
        assert got.dtype == dtype and got.shape == want.shape
        np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(got[1].numpy(), want[1])
        assert bool(jnp.any(active)) == raised
        assert (int(t.flag) == gen) == raised
        if raised:
            assert 0 < int(want[1].sum()) < int((d["valid"]).sum())
    assert int(t.flag) == gen - 1


@pytest.mark.parametrize("kernel", ["K1", "K1-no-sr", "K3a", "K2", "K3b",
                                    "K3b-f64"])
def test_fused_iterations_match_the_pallas_kernels(kernel):
    """The plan, the fused plain iteration and ``segment_sum_plain`` from
    [N,8] body deltas against the JAX package's Pallas kernel in interpret
    mode between an XLA gather and scatter-add, at 1e-5 (absolute and
    relative): the scatter-add adds the terms to x one by one, the segment
    sum from zero and then to x. K2's soft rows (about a fifth of
    ``random_rows``) keep their planned positions and write zero terms.
    K3b, at float32 and float64: ``k3b_matches_the_pallas_kernel``."""
    if kernel.startswith("K3b"):
        k3b_matches_the_pallas_kernel(torch.float64 if kernel.endswith("f64")
                                      else torch.float32)
        return
    with_sr = kernel == "K1"
    d = static_rows(seed=2, with_sr=with_sr)
    rows = port_rows(d)
    jt, ja, jb, Rp = ps.pack_rows_t(jax_rows(d))
    rng = np.random.RandomState(3)
    dvw = (rng.randn(N, 6) * 0.1).astype(np.float32)
    (pack,) = packs = shard_packs(rows, 1)
    plan = scatter.ScatterPlan.build(packs, moves(), Mesh((CPU,)))
    t = plan.shards[0]
    body = scatter.body_table(torch.from_numpy(dvw))
    jab = jnp.concatenate([ja, jb])
    x_t = jnp.asarray(dvw.T)
    if kernel == "K2":
        jupd, jimp = ps.ngs_iteration_pallas(jt, x_t[:, jab], RATE, MAX_CORR,
                                             interpret=True)
        timp = sk.ngs_iteration_fused(pack.tbl, body, t.ab, t.pos,
                                      t.terms_a, t.terms_b, RATE, MAX_CORR)
        soft = torch.from_numpy(np.pad(d["soft"] & d["valid"],
                                       (0, Rp - len(d["soft"]))))
        soft_pos = torch.cat([t.pos[:Rp][soft], t.pos[Rp:][soft]])
        soft_pos = soft_pos[soft_pos >= 0].long()
        assert soft_pos.numel() > 0
        assert not t.terms_a[soft_pos].any()
        assert float(timp.max()) > 0
    elif kernel == "K3a":
        # active rows are valid ones, as solve_restitution_sharded makes them
        active = (rng.rand(Rp) > 0.3) & (pack.tbl[55].numpy() > 0.5)
        dyn = np.stack([rng.randn(Rp), active]).astype(np.float32)
        imp = rng.rand(3, Rp).astype(np.float32)
        jimp, jupd = ps.restitution_iteration_pallas(
            jt, jnp.asarray(dyn), jnp.asarray(imp), x_t[:, jab],
            interpret=True)
        timp = sk.restitution_iteration_fused(
            pack.tbl, torch.from_numpy(dyn), torch.from_numpy(imp), body,
            t.ab, t.pos, t.terms_a, t.terms_b)
    else:
        imp = rng.rand(6, Rp).astype(np.float32)
        jimp, jupd = ps.solve_iteration_pallas(
            jt, jnp.asarray(imp), x_t[:, jab], with_sr, interpret=True)
        timp = sk.solve_iteration_fused(pack.tbl, torch.from_numpy(imp),
                                        body, t.ab, t.pos, t.terms_a,
                                        t.terms_b, with_sr)
    got = plan.add(body, Mesh((CPU,)))
    want = _xla_scatter(x_t, jab, jupd)
    np.testing.assert_allclose(timp.numpy(), np.asarray(jimp), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got[:, :6].numpy(), np.asarray(want).T,
                               rtol=1e-5, atol=1e-5)
    assert float((got[:, :6] - torch.from_numpy(dvw)).abs().max()) > 1e-3
    # the static bodies' rows keep their deltas (no live term reaches them)
    assert torch.equal(got[list(STATIC), :6],
                       torch.from_numpy(dvw)[list(STATIC)])


def unfused_in_card_order(rows, imp_t, dvw, iterations, with_sr):
    """The unfused velocity iterations (gather, K1's plain version) with
    each scatter-add summed in the card's order."""
    tbl, a_p, b_p, _ = sk.pack_rows_t(rows)
    ab = torch.cat([a_p, b_p])
    for _ in range(iterations):
        imp_t, upd = sk.solve_iteration_plain(tbl, imp_t, dvw[ab].T, with_sr)
        dvw = card_order_sum(dvw, ab, torch.cat([upd[:6], upd[6:]], 1).T)
    return imp_t, dvw


def unfused_positions_in_card_order(rows, iterations):
    """The unfused position iterations (gather, K2's plain version) with
    each scatter-add summed in the card's order and the early exit; returns
    the [N,6] deltas and the iterations run."""
    tbl, a_p, b_p, _ = sk.pack_rows_t(rows)
    ab = torch.cat([a_p, b_p])
    dpq = torch.zeros((N, 6))
    for it in range(1, iterations + 1):
        upd, err = sk.ngs_iteration_plain(tbl, dpq[ab].T, RATE, MAX_CORR)
        dpq = card_order_sum(dpq, ab, torch.cat([upd[:6], upd[6:]], 1).T)
        if not bool(err.max() >= tposition.ERROR_EXIT):
            break
    return dpq, it


# (shards, a hop each, loop): the velocity loop's cases keep their ids
LOOPS = [(1, False, "K1"), (3, False, "K1"), (3, True, "K1"),
         (1, False, "K2"), (3, False, "K2"), (3, True, "K2")]


@pytest.mark.parametrize("k,hops,loop", LOOPS,
                         ids=["k1", "k3", "k3-hops", "K2-k1", "K2-k3",
                              "K2-k3-hops"])
def test_planned_velocity_loop_is_the_unfused_one_in_card_order(k, hops,
                                                                 loop):
    """``solver.solve_velocities`` under a plan, over k shards (merged into
    one hop, or a hop each), equals the unfused iterations summed in the
    card's order, to the bit, impulses and deltas. With ``loop`` K2, the
    same for ``position.solve_positions_sharded``: the corrected positions
    and orientations equal the unfused loop's, to the bit, over three
    iterations and with errors under the exit threshold, where both exit
    after the first; the terms buffers, shared with K1 and K3a and never
    zeroed, start with another loop's terms in them."""
    d = static_rows(seed=6)
    rows = port_rows(d)
    packs = shard_packs(rows, k)
    mesh = Mesh((CPU,) * k, hop_each_shard=hops)
    plan = scatter.ScatterPlan.build(packs, moves(), mesh)
    if loop == "K2":
        start = _bodies(N, 12, "torch")
        d["base_dist"] = np.linspace(-0.004, 0.01, len(d["base_dist"]),
                                     dtype=np.float32)
        for case, ran in ((rows, 3), (port_rows(d), 1)):
            want, it = unfused_positions_in_card_order(case, 3)
            assert it == ran
            want = tposition._apply_correction(start, want.T.contiguous())
            packs = shard_packs(case, k)
            for h in plan.hops:     # what an earlier loop left there
                h.terms.normal_()
            got = tposition.solve_positions_sharded(start, packs, mesh, 3,
                                                    plan)
            assert bits_equal(got.pos, want.pos)
            assert bits_equal(got.orn, want.orn)
            assert float((got.pos - start.pos).abs().max()) > 1e-4
            assert torch.equal(got.pos[list(STATIC)],
                               start.pos[list(STATIC)])
        return
    Rp = sk.pack_rows_t(rows)[3]
    rng = np.random.RandomState(7)
    imp = torch.from_numpy(rng.rand(6, Rp).astype(np.float32))
    dvw = torch.from_numpy((rng.randn(N, 6) * 0.1).astype(np.float32))
    want_imp, want = unfused_in_card_order(rows, imp, dvw, 2, True)
    cuts = ranges(rows.valid.shape[0], k)
    imp_ts = [torch.nn.functional.pad(imp[:, r0:r1], (0, p.Rp - (r1 - r0)))
              for (r0, r1), p in zip(cuts, packs)]
    got_imp, got = tsolver.solve_velocities(packs, imp_ts, dvw.clone(), True,
                                            mesh, 2, plan)
    assert bits_equal(got, want)
    R = rows.valid.shape[0]
    cat = torch.cat([i[:, :r1 - r0] for i, (r0, r1) in zip(got_imp, cuts)],
                    1)
    assert bits_equal(cat, want_imp[:, :R])


def unfused_restitution_in_card_order(rows, vel, passes, inner):
    """The unfused restitution pre-pass (gather, K3b's plain version and
    the pass's glue, the host-read exit, K3a's plain version) with each
    scatter-add summed in the card's order; returns the [N,6] velocities
    and the passes that solved."""
    tbl, a_p, b_p, Rp = sk.pack_rows_t(rows)
    ab = torch.cat([a_p, b_p])
    valid, restit = tbl[55:56] > 0.5, tbl[56:57]
    for ran in range(passes):
        relv = sk.relvel_plain(tbl, vel[ab].T)
        active = valid & (relv < -0.005) & (restit > 0)
        if not bool(active.any()):
            return vel, ran
        dyn = torch.cat([-relv * (1.0 + restit), active.to(tbl.dtype)])
        imp3, dvw = torch.zeros((3, Rp)), torch.zeros_like(vel)
        for _ in range(inner):
            imp3, upd = sk.restitution_iteration_plain(tbl, dyn, imp3,
                                                       dvw[ab].T)
            dvw = card_order_sum(dvw, ab, torch.cat([upd[:6], upd[6:]], 1).T)
        vel = vel + dvw
    return vel, passes


@pytest.mark.parametrize("k,hops,scale", [(1, False, 0.1), (3, False, 0.1),
                                          (3, True, 0.1), (1, False, 0.0)],
                         ids=["k1", "k3", "k3-hops", "k1-none-active"])
def test_planned_restitution_is_the_unfused_one_in_card_order(k, hops,
                                                               scale):
    """``solver.solve_restitution_sharded`` under a plan (the fused K3b a
    pass on the [N,8] velocity table, one read of the shards' flags, the
    fused K3a), over k shards merged into one hop or a hop each, equals the
    unfused pre-pass summed in the card's order, to the bit, and exits
    after the same pass; with no row active it reads the flags once and
    returns the velocities as they were."""
    rows = port_rows(static_rows(seed=6))
    packs = shard_packs(rows, k)
    mesh = Mesh((CPU,) * k, hop_each_shard=hops)
    plan = scatter.ScatterPlan.build(packs, moves(), mesh)
    rng = np.random.RandomState(11)
    vel = torch.from_numpy((rng.randn(N, 6) * scale).astype(np.float32))
    state = SimpleNamespace(capacity=N, linvel=vel[:, :3], angvel=vel[:, 3:])
    passes, inner = 8, 3
    want, ran = unfused_restitution_in_card_order(rows, vel, passes, inner)
    lin, ang = tsolver.solve_restitution_sharded(state, packs, mesh, passes,
                                                 inner, plan)
    got = torch.cat([lin, ang], 1)
    assert bits_equal(got, want)
    # a pass that solves reads the flags once, and so does the one that exits
    assert plan.generation == min(ran + 1, passes)
    if scale:
        assert ran > 1
        assert float((got - vel).abs().max()) > 1e-3
        assert torch.equal(got[list(STATIC)], vel[list(STATIC)])
    else:
        assert ran == 0 and torch.equal(got, vel)


def test_fused_wrappers_take_the_plain_version_only_on_the_cpu():
    """Tensors not on the CPU never reach a plain version: tensors on two
    devices, or on a device without the kernels, raise; the CPU's calls
    count no launch."""
    rows = port_rows(static_rows(seed=8))
    (pack,) = shard_packs(rows, 1)
    plan = scatter.ScatterPlan.build([pack], moves(), Mesh((CPU,)))
    t, Rp = plan.shards[0], pack.Rp
    body = torch.zeros((N, 8))
    imp6, imp3, dyn = torch.zeros((6, Rp)), torch.zeros((3, Rp)), \
        torch.zeros((2, Rp))
    meta = lambda x: x.to("meta")
    with pytest.raises(ValueError):
        sk.ngs_iteration_fused(pack.tbl, meta(body), t.ab, t.pos, t.terms_a,
                               t.terms_b, RATE, MAX_CORR)
    with pytest.raises(ValueError):
        sk.ngs_iteration_fused(*map(meta, (
            pack.tbl, body, t.ab, t.pos, t.terms_a, t.terms_b)), RATE,
            MAX_CORR)
    with pytest.raises(ValueError):
        sk.solve_iteration_fused(pack.tbl, imp6, meta(body), t.ab, t.pos,
                                 t.terms_a, t.terms_b, True)
    with pytest.raises(ValueError):
        sk.restitution_iteration_fused(*map(meta, (
            pack.tbl, dyn, imp3, body, t.ab, t.pos, t.terms_a, t.terms_b)))
    with pytest.raises(ValueError):
        sk.relvel_fused(pack.tbl, meta(body), t.ab, t.flag, 1)
    with pytest.raises(ValueError):
        sk.relvel_fused(*map(meta, (pack.tbl, body, t.ab, t.flag)), 1,
                        out=meta(dyn))
    h = plan.hops[0]
    with pytest.raises(ValueError):
        sk.segment_sum(h.terms, h.offsets, x=meta(body))
    before = dict(sk.LAUNCHES), dict(sk.LAUNCHES_F64)
    sk.solve_iteration_fused(pack.tbl, imp6, body, t.ab, t.pos, t.terms_a,
                             t.terms_b, True)
    sk.restitution_iteration_fused(pack.tbl, dyn, imp3, body, t.ab, t.pos,
                                   t.terms_a, t.terms_b)
    sk.ngs_iteration_fused(pack.tbl, body, t.ab, t.pos, t.terms_a, t.terms_b,
                           RATE, MAX_CORR)
    sk.segment_sum(h.terms, h.offsets, x=body)
    sk.relvel_fused(pack.tbl, body, t.ab, t.flag, 1, out=dyn)
    assert (sk.LAUNCHES, sk.LAUNCHES_F64) == before
    assert scatter.for_step(None, [pack], Mesh((CPU,))) is None


@pytest.fixture(scope="module")
def pile():
    """A 56-body pile stepped into its first contacts, on the CPU."""
    b, _ = mixed_pile(n_bodies=56)
    return et.make_world(b, capacity=64, max_pairs=1024,
                         device="cpu").step(25)


def test_planned_steps(pile, monkeypatch):
    """Whole steps taken through the plan (forced on the CPU): over three
    shards merged and with a hop each equal to the unsharded planned step
    in every leaf for 5 steps; the first step within the suite's
    whole-step tolerances (``test_torch_step.TOL``) of the CPU's own step,
    which sums the same terms in another order (each added to x in turn,
    where the segment sum adds them from zero and then to x). Later steps
    are not compared: while the pile lands, a rounding difference grows
    past those tolerances within a few steps. The planned steps' position
    iterations run the fused K2 (its plain version counted), never the
    unfused one, and so do their restitution outer passes (the fused K3b,
    never ``relvel``)."""
    w = pile
    start = w.state
    calls = {"fused": 0, "unfused": 0, "fused K3b": 0, "unfused K3b": 0}

    def counted(key, fn):
        def call(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return call
    monkeypatch.setattr(sk, "ngs_iteration_fused_plain",
                        counted("fused", sk.ngs_iteration_fused_plain))
    monkeypatch.setattr(sk, "ngs_iteration",
                        counted("unfused", sk.ngs_iteration))
    monkeypatch.setattr(sk, "relvel_fused_plain",
                        counted("fused K3b", sk.relvel_fused_plain))
    monkeypatch.setattr(sk, "relvel", counted("unfused K3b", sk.relvel))
    ref = [start]
    for _ in range(5):
        ref.append(stepper.physics_step(ref[-1], w.settings, w.meta))
    assert calls["fused"] == 0 and calls["unfused"] > 0
    assert calls["fused K3b"] == 0 and calls["unfused K3b"] > 0
    calls["unfused"] = calls["unfused K3b"] = 0
    monkeypatch.setattr(scatter, "for_step", lambda state, packs, mesh:
                        scatter.ScatterPlan.build(
                            packs, scatter.movable(state), mesh))
    planned = [start]
    for _ in range(5):
        planned.append(stepper.physics_step(planned[-1], w.settings, w.meta))
    assert calls["fused"] > 0 and calls["unfused"] == 0
    assert calls["fused K3b"] > 0 and calls["unfused K3b"] == 0
    for hops in (False, True):
        mesh = make_mesh([CPU] * 3, hop_each_shard=hops)
        step, got = make_sharded_step(mesh, start, w.settings, w.meta)
        for i in range(1, 6):
            got = step(got)
            bad = [n for (n, a), (_, b) in zip(leaves(got),
                                                leaves(planned[i]))
                   if not torch.equal(a, b)]
            assert not bad, f"hops={hops}: step {i} differs at {bad[:8]}"
    assert int(planned[-1].contacts.point_valid.sum()) > 0
    for f, (rtol, atol) in STEP_TOL.items():
        a, b = getattr(planned[1], f), getattr(ref[1], f)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol,
                                   atol=atol, err_msg=f)
    assert any(not torch.equal(getattr(planned[1], f), getattr(ref[1], f))
               for f in STEP_TOL)


def test_movable_bodies(pile):
    """The plan's movable bodies: the pile's dynamic bodies, not its
    planes."""
    st = pile.state
    m = scatter.movable(st)
    assert torch.equal(m[st.valid], st.is_dynamic[st.valid])
    assert int(m.sum()) == 56
