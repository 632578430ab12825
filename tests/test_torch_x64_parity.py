"""The port's float64 mode against the JAX package's x64 mode.

x64 is process-global in JAX, so ONE subprocess with ``jax_enable_x64``
computes every reference from inputs this module writes (numpy, float64)
and writes them back as an ``.npz``; the port computes in-process. The
references:
- the jnp solver functions that ``tests/test_pallas_solver.py`` holds the
  Pallas kernels K1-K3b against (``solver.solve_contacts_once``,
  ``solve_restitution``, ``position.solve_positions``), on seeded rows;
- ``support_sat.collide_support`` on the seeded pairs of a pile;
- ``find_pairs`` and ``find_pairs_sweep`` on that pile's state;
- two steps of the 4-box stack run op by op under ``jax.disable_jit()``
  (the jitted x64 step fails, ROADMAP R2) from the port's state after 40
  steps;
- a checkpoint of the JAX x64 stack world, which the port loads as a
  float64 world.

Tolerances (absolute, with the same relative term): one velocity
iteration 1e-12 (the two packages add 3-term sums and scatter-adds in
other orders: ~1e-15 at these magnitudes); the restitution and position
loops 1e-9 (random, non-physical rows amplify rounding over passes, as in
``test_torch_solver.py``'s f32 loops at 1e-3); contact points 1e-9; the
two whole steps 1e-7 m and m/s: the JAX package's x64 step rounds the
inverse masses, the material values and the contact distances through
float32 (``solver.pack_solver_view``, ``pack_manifold_points``,
``manifold.py:224``; ROADMAP R17), which the port does not, so the two
steps differ by up to ~6e-8 of those values (7.4e-9 m/s measured). Keys
and counters are integers: equal."""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import edyn_tpu_torch as et
from edyn_tpu_torch.collision import broadphase as tbp
from edyn_tpu_torch.collision import narrowphase as nph
from edyn_tpu_torch.collision.kernels import support_sat
from edyn_tpu_torch.collision.kernels.support import (Side, pack_side_table,
                                                      side_from_packed)
from edyn_tpu_torch.core.convert import state_to_numpy
from edyn_tpu_torch.dynamics import position as tposition
from edyn_tpu_torch.dynamics import solver as tsolver
from edyn_tpu_torch.dynamics import solver_kernels as sk
from edyn_tpu_torch.serialization.checkpoint import world_from_bytes
from edyn_tpu_torch.simulation import stepper
from edyn_tpu_torch.utils import scenes
from test_torch_solver import SR, Bodies, port_rows, random_rows
from test_torch_step import jax_keys, one_thread  # noqa: F401
from test_torch_x64 import assert_f64, box_stack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOLVER_TOL = 1e-12
LOOP_TOL = 1e-9
POINT_TOL = 1e-9
STEP_TOL = 1e-7
THRESHOLD = 0.01
SIDE_FIELDS = [f.name for f in dataclasses.fields(Side)]

SCENARIO = textwrap.dedent('''
    import dataclasses
    import sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import edyn_tpu as ej
    from edyn_tpu.collision import broadphase as jbp
    from edyn_tpu.collision.kernels.support import Side
    from edyn_tpu.collision.kernels.support_sat import collide_support
    from edyn_tpu.dynamics import position as jp
    from edyn_tpu.dynamics import solver as js
    from edyn_tpu.serialization.checkpoint import world_to_bytes
    from edyn_tpu.simulation.stepper import physics_step_impl
    from edyn_tpu.utils import scenes

    inp = dict(np.load(sys.argv[1]))
    out = {}

    def sub(prefix):
        return {k[len(prefix):]: v for k, v in inp.items()
                if k.startswith(prefix)}

    def nest(flat):
        tree = {}
        for path, v in flat.items():
            head, _, rest = path.partition("/")
            if rest:
                tree.setdefault(head, {})[rest] = v
            else:
                tree[head] = v
        return tree

    DIR = ("JaA", "JaB", "tA", "tB", "eff_mass", "rhs")
    SR = %(SR)r

    def rows(prefix):
        d = nest(sub(prefix))
        kw = {k: (js.RowDir(**{f: jnp.asarray(v[f]) for f in DIR})
                  if isinstance(v, dict) else jnp.asarray(v))
              for k, v in d.items()}
        kw.update({k: None for k in SR if k not in d})
        R = d["valid"].shape[0]
        return js.ContactRows(
            ab=jnp.concatenate([kw["a"], kw["b"]]),
            row_slot=jnp.arange(R, dtype=jnp.int32),
            dropped=jnp.zeros((), jnp.int32), count=jnp.int32(R), **kw)

    @dataclasses.dataclass
    class Bodies:
        linvel: object
        angvel: object
        pos: object
        orn: object

        @property
        def capacity(self):
            return self.linvel.shape[0]

    def bodies(prefix):
        return Bodies(**{k: jnp.asarray(v) for k, v in sub(prefix).items()})

    # K1's counterpart
    imp6, dvw = js.solve_contacts_once(rows("vel/"), jnp.asarray(inp["imp6"]),
                                       jnp.asarray(inp["dvw"]))
    out["vel_imp6"], out["vel_dvw"] = np.asarray(imp6), np.asarray(dvw)
    # K3a and K3b's counterpart: the restitution loop
    lin, ang = js.solve_restitution(bodies("rb/"), rows("rest/"), 2, 2,
                                    1 / 60)
    out["rest_lin"], out["rest_ang"] = np.asarray(lin), np.asarray(ang)
    # K2's counterpart: the position loop
    st = jp.solve_positions(bodies("pb/"), rows("pos/"), 3)
    out["pos_pos"], out["pos_orn"] = np.asarray(st.pos), np.asarray(st.orn)

    # collide_support on the pile's pairs
    A = Side(**{k: jnp.asarray(v) for k, v in sub("A/").items()})
    B = Side(**{k: jnp.asarray(v) for k, v in sub("B/").items()})
    res = collide_support(A, B, %(THRESHOLD)r)
    for f in ("point_valid", "pivot_a", "pivot_b", "normal", "distance"):
        out["cs_" + f] = np.asarray(getattr(res, f))

    def carried(like, tree):
        kw = {}
        for name, val in tree.items():
            cur = getattr(like, name)
            if isinstance(cur, dict):
                kw[name] = {k: jnp.asarray(v) for k, v in val.items()}
            elif isinstance(val, dict):
                kw[name] = dataclasses.replace(cur, **{
                    k: jnp.asarray(v) for k, v in val.items()})
            else:
                kw[name] = jnp.asarray(val)
        return dataclasses.replace(like, **kw)

    # the two broadphases on the pile's state
    pile = ej.make_world(scenes.mixed_pile(n_bodies=40, seed=4)[0])
    pst = carried(pile.state, nest(sub("pile/")))
    P, W = int(inp["max_pairs"]), int(inp["window"])
    k, a, b, v, d = jbp.find_pairs(pst, P, 256, None,
                                   wide_cap=pile.meta.wide_cap)
    out.update(dense_keys=np.asarray(k), dense_valid=np.asarray(v),
               dense_dropped=np.asarray(d))
    k, a, b, v, d, al = jbp.find_pairs_sweep(pst, P, W, pile.meta.wide_cap)
    out.update(sweep_keys=np.asarray(k), sweep_valid=np.asarray(v),
               sweep_dropped=np.asarray(d), sweep_alarms=np.asarray(al))

    # two op-by-op steps of the box stack from the port's state
    b = ej.WorldBuilder()
    b.make_rigidbody(ej.RigidBodyDef(
        kind=ej.KIND_STATIC, shape=ej.PlaneShape((0, 1, 0), 0),
        material=ej.Material(friction=0.8)))
    for k in range(4):
        b.make_rigidbody(ej.RigidBodyDef(
            mass=1.0, shape=ej.BoxShape((0.5, 0.5, 0.5)),
            position=(0.0, 0.55 + 1.08 * k, 0.0),
            material=ej.Material(friction=0.8, restitution=0.0)))
    w = ej.make_world(b)
    out["ckpt"] = np.frombuffer(world_to_bytes(w.state, w.settings),
                                np.uint8)
    out["ckpt_pos"] = np.asarray(w.state.pos)
    st = carried(w.state, nest(sub("stack/")))
    for i in range(2):
        with jax.disable_jit():
            st = physics_step_impl(st, w.settings, w.meta)
        for f in ("pos", "orn", "linvel", "angvel"):
            out[f"step{i}_{f}"] = np.asarray(getattr(st, f))
        out[f"step{i}_points"] = np.asarray(st.contacts.point_valid.sum())
    np.savez(sys.argv[2], **out)
    print("X64_REFS_OK")
''') % dict(SR=SR, THRESHOLD=THRESHOLD)


def flat(prefix, tree, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            flat(f"{prefix}{k}/", v, out)
        else:
            out[prefix + k] = v
    return out


def f64_rows(seed, with_sr):
    d = random_rows(with_sr=with_sr, seed=seed)

    def up(v):
        if isinstance(v, dict):
            return {k: up(x) for k, x in v.items()}
        return v.astype(np.float64) if v.dtype == np.float32 else v
    return up(d)


def f64_bodies(N, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(N, 4)
    return dict(linvel=rng.randn(N, 3), angvel=rng.randn(N, 3),
                pos=rng.randn(N, 3),
                orn=q / np.linalg.norm(q, axis=1, keepdims=True))


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """The inputs, the port's states they came from, and the JAX x64
    references."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        inp = {}
        rows = {"vel": f64_rows(0, True), "rest": f64_rows(3, True),
                "pos": f64_rows(11, False)}
        rows["pos"]["base_dist"] = rows["pos"]["base_dist"] * 3 - 0.02
        for k, d in rows.items():
            flat(f"{k}/", d, inp)
        rng = np.random.RandomState(1)
        inp["imp6"] = rng.rand(96, 6)
        inp["dvw"] = rng.randn(48, 6) * 0.1
        flat("rb/", f64_bodies(48, 2), inp)
        flat("pb/", f64_bodies(48, 12), inp)

        pile = et.make_world(scenes.mixed_pile(n_bodies=40, seed=4)[0],
                             device="cpu")
        pile.step(90)
        st = pile.state
        flat("pile/", state_to_numpy(st), inp)
        inp["max_pairs"] = np.int64(pile.meta.max_pairs)
        inp["window"] = np.int64(pile.meta.sweep_window)
        cls, _, _, _ = nph.live_classes(st, st.contacts)
        live = torch.nonzero(cls == nph.B_UNIFIED).flatten()
        ka = torch.cat([st.contacts.body_a[live].long(),
                        torch.arange(5, 29)])
        kb = torch.cat([st.contacts.body_b[live].long(),
                        torch.arange(21, 45)])
        packed, dims = pack_side_table(st)
        A = side_from_packed(packed[ka], dims)
        B = side_from_packed(packed[kb], dims)
        for name, S in (("A", A), ("B", B)):
            for f in SIDE_FIELDS:
                inp[f"{name}/{f}"] = getattr(S, f).numpy()

        b, _ = box_stack()
        stack = et.make_world(b, device="cpu")
        stack.step(40)
        flat("stack/", state_to_numpy(stack.state), inp)
    finally:
        torch.set_default_dtype(old)
    d = tmp_path_factory.mktemp("x64")
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1")
    env.setdefault("JAX_COMPILATION_CACHE_DIR", "/tmp/jax_test_cache")
    run = subprocess.run([sys.executable, "-c", SCENARIO, str(d / "in.npz"),
                          str(d / "out.npz")], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=900)
    assert run.returncode == 0, run.stdout + "\n" + run.stderr
    assert "X64_REFS_OK" in run.stdout
    return dict(inp=inp, rows=rows, pile=pile, A=A, B=B, stack=stack,
                ref=dict(np.load(d / "out.npz")))


def close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.dtype == np.float64 and want.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_solver_functions(refs):
    """K1's, K3a/K3b's and K2's counterparts: one velocity iteration, the
    restitution loop and the position loop at float64."""
    inp, ref = refs["inp"], refs["ref"]
    r = port_rows(refs["rows"]["vel"])
    tbl, a_p, b_p, Rp = sk.pack_rows_t(r)
    assert tbl.dtype == torch.float64
    imp_t = torch.nn.functional.pad(torch.from_numpy(inp["imp6"]),
                                    (0, 0, 0, Rp - 96)).T.contiguous()
    imp_t, dvw_t = tsolver.solve_contacts_once(
        tbl, imp_t, torch.from_numpy(inp["dvw"]).T.contiguous(),
        torch.cat([a_p, b_p]), True)
    close(imp_t.T[:96], ref["vel_imp6"], SOLVER_TOL)
    close(dvw_t.T, ref["vel_dvw"], SOLVER_TOL)

    def bodies(p):
        return Bodies(**{k: torch.from_numpy(inp[f"{p}/{k}"])
                         for k in ("linvel", "angvel", "pos", "orn")})
    tbl, a_p, b_p, _ = sk.pack_rows_t(port_rows(refs["rows"]["rest"]))
    lin, ang = tsolver.solve_restitution(bodies("rb"), tbl,
                                         torch.cat([a_p, b_p]), 2, 2)
    close(lin, ref["rest_lin"], LOOP_TOL)
    close(ang, ref["rest_ang"], LOOP_TOL)
    tbl, a_p, b_p, _ = sk.pack_rows_t(port_rows(refs["rows"]["pos"]))
    got = tposition.solve_positions(bodies("pb"), tbl, torch.cat([a_p, b_p]),
                                    3)
    close(got.pos, ref["pos_pos"], LOOP_TOL)
    close(got.orn, ref["pos_orn"], LOOP_TOL)


def test_collide_support(refs):
    """The UNIFIED bucket's CPU path on the landed pile's live UNIFIED
    pairs and 24 farther ones."""
    ref = refs["ref"]
    res = support_sat.collide_support(refs["A"], refs["B"], THRESHOLD)
    pv = res.point_valid.numpy()
    np.testing.assert_array_equal(pv, ref["cs_point_valid"])
    assert pv.sum() > 20
    for f in ("pivot_a", "pivot_b", "normal", "distance"):
        close(getattr(res, f).numpy()[pv], ref["cs_" + f][pv], POINT_TOL)


def test_broadphases(refs):
    """find_pairs and find_pairs_sweep on the same float64 state."""
    ref, st, meta = refs["ref"], refs["pile"].state, refs["pile"].meta
    assert st.pos.dtype == torch.float64
    k, _, _, v, d = tbp.find_pairs(st, meta.max_pairs, meta.wide_cap)
    np.testing.assert_array_equal(k.numpy(), jax_keys(ref["dense_keys"]))
    np.testing.assert_array_equal(v.numpy(), ref["dense_valid"])
    assert d == int(ref["dense_dropped"])
    k, _, _, v, d, al = tbp.find_pairs_sweep(st, meta.max_pairs,
                                             meta.sweep_window, meta.wide_cap)
    np.testing.assert_array_equal(k.numpy(), jax_keys(ref["sweep_keys"]))
    np.testing.assert_array_equal(v.numpy(), ref["sweep_valid"])
    assert (d, al) == (int(ref["sweep_dropped"]), int(ref["sweep_alarms"]))
    assert int(v.sum()) > 60


def test_stack_steps_and_checkpoint(refs):
    """Two whole steps of the 4-box stack against the op-by-op JAX x64
    step, every counter int32; and the JAX x64 checkpoint loads as a
    float64 world of the same positions."""
    ref = refs["ref"]
    w = refs["stack"]
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        st = w.state
        for i in range(2):
            st = stepper.physics_step(st, w.settings, w.meta)
            assert_f64(st)
            for f in ("pos", "orn", "linvel", "angvel"):
                close(getattr(st, f), ref[f"step{i}_{f}"], STEP_TOL)
            assert int(st.contacts.point_valid.sum()) == int(
                ref[f"step{i}_points"])
        assert int(ref["step1_points"]) >= 16
        loaded, _ = world_from_bytes(ref["ckpt"].tobytes(), device="cpu")
    finally:
        torch.set_default_dtype(old)
    assert_f64(loaded)
    np.testing.assert_array_equal(loaded.pos.numpy(), ref["ckpt_pos"])
