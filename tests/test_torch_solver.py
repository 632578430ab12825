"""Parity of the port's solver kernels (``edyn_tpu_torch.dynamics.
solver_kernels``) with the JAX package's Pallas kernels, and of the loops
built on them with the JAX package's jnp solver.

On the CPU every kernel wrapper takes its plain PyTorch version; the Pallas
kernels run in interpret mode, as ``tests/test_pallas_solver.py`` runs
them. Inputs are ``_random_rows``-style rows drawn with numpy and handed to
both packages. The CUDA kernels themselves are held against the same plain
versions on the card by ``chip_smoke.py``."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edyn_tpu.dynamics import pallas_solver as ps
from edyn_tpu.dynamics import position as jposition
from edyn_tpu.dynamics import solver as jsolver

from edyn_tpu_torch.config import CONTACT_POSITION_CORRECTION_RATE
from edyn_tpu_torch.dynamics import position as tposition
from edyn_tpu_torch.dynamics import solver as tsolver
from edyn_tpu_torch.dynamics import solver_kernels as sk

from test_torch_step import one_thread  # noqa: F401

DIR = ("JaA", "JaB", "tA", "tB", "eff_mass", "rhs")
SR = ("spin_friction", "roll_friction", "sA_n", "sB_n", "sA_t1", "sB_t1",
      "sA_t2", "sB_t2", "em_spin", "em_roll1", "em_roll2", "rhs_spin",
      "rhs_roll1", "rhs_roll2", "roll_t1", "roll_t2")


def random_rows(R=96, N=48, with_sr=True, seed=0) -> dict:
    """Row constants as numpy (the generator of
    tests/test_pallas_solver.py:_random_rows)."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    u = lambda *s: rng.rand(*s).astype(np.float32)

    def unit():
        v = rng.randn(R, 3)
        return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(
            np.float32)

    a = rng.randint(0, N, R).astype(np.int32)
    b = rng.randint(0, N, R).astype(np.int32)
    d = dict(a=a, b=b, n=unit(), t1=unit(), t2=unit())
    for r in ("rn", "r1", "r2"):
        d[r] = dict(JaA=f(R, 3), JaB=f(R, 3), tA=f(R, 3), tB=f(R, 3),
                    eff_mass=u(R), rhs=f(R))
    d["valid"] = rng.rand(R) > 0.25
    if with_sr:
        d.update(spin_friction=u(R) * 0.1, roll_friction=u(R) * 0.1,
                 sA_n=f(R, 3), sB_n=f(R, 3), sA_t1=f(R, 3), sB_t1=f(R, 3),
                 sA_t2=f(R, 3), sB_t2=f(R, 3), em_spin=u(R), em_roll1=u(R),
                 em_roll2=u(R), rhs_spin=f(R), rhs_roll1=f(R),
                 rhs_roll2=f(R), roll_t1=f(R, 3), roll_t2=f(R, 3))
    d.update(inv_mA=u(R), inv_mB=u(R), friction=u(R), restitution=u(R))
    d["upper_n"] = np.where(rng.rand(R) > 0.5, u(R) * 10,
                            np.float32(ps.BIG)).astype(np.float32)
    d["soft"] = rng.rand(R) > 0.8
    d["base_dist"] = f(R) * 0.01
    d["rA"], d["rB"] = f(R, 3), f(R, 3)
    return d


def jax_rows(d):
    kw = {k: (jsolver.RowDir(**{f: jnp.asarray(v[f]) for f in DIR})
              if isinstance(v, dict) else jnp.asarray(v))
          for k, v in d.items()}
    kw.update({k: None for k in SR if k not in d})
    R = d["valid"].shape[0]
    return jsolver.ContactRows(
        ab=jnp.concatenate([kw["a"], kw["b"]]),
        row_slot=jnp.arange(R, dtype=jnp.int32),
        dropped=jnp.zeros((), jnp.int32), count=jnp.int32(R), **kw)


def port_rows(d):
    kw = {k: (tsolver.RowDir(**{f: torch.from_numpy(v[f]) for f in DIR})
              if isinstance(v, dict) else torch.from_numpy(v))
          for k, v in d.items()}
    kw.update({k: None for k in SR if k not in d})
    kw["a"], kw["b"] = kw["a"].long(), kw["b"].long()
    R = d["valid"].shape[0]
    return tsolver.ContactRows(ab=torch.cat([kw["a"], kw["b"]]),
                               row_slot=torch.arange(R), dropped=0, count=R,
                               **kw)


def tables(with_sr, seed=0):
    d = random_rows(with_sr=with_sr, seed=seed)
    jt, ja, jb, jRp = ps.pack_rows_t(jax_rows(d))
    tt, ta, tb, tRp = sk.pack_rows_t(port_rows(d))
    return d, (jt, ja, jb, jRp), (tt, ta, tb, tRp)


def close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("with_sr", [True, False])
def test_pack_rows_t(with_sr):
    _, (jt, ja, jb, jRp), (tt, ta, tb, tRp) = tables(with_sr)
    assert tRp == jRp == 128
    assert tt.shape == (sk.C_BASE + (sk.C_SR if with_sr else 0), 128)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def _gathered(Rp, seed):
    rng = np.random.RandomState(seed)
    g = (rng.randn(6, 2 * Rp) * 0.1).astype(np.float32)
    return jnp.asarray(g), torch.from_numpy(g)


@pytest.mark.parametrize("with_sr", [True, False])
def test_velocity_kernel(with_sr):
    """K1 (solve_iteration_pallas) against its plain version."""
    _, (jt, *_, Rp), (tt, *_) = tables(with_sr, seed=1)
    imp = np.random.RandomState(2).rand(6, Rp).astype(np.float32)
    jg, tg = _gathered(Rp, 3)
    jimp, jupd = ps.solve_iteration_pallas(jt, jnp.asarray(imp), jg, with_sr,
                                           interpret=True)
    timp, tupd = sk.solve_iteration(tt, torch.from_numpy(imp), tg, with_sr)
    close(timp, jimp)
    close(tupd, jupd)


def test_restitution_kernel():
    """K3a (restitution_iteration_pallas) against its plain version."""
    _, (jt, *_, Rp), (tt, *_) = tables(True, seed=4)
    rng = np.random.RandomState(5)
    dyn = np.stack([rng.randn(Rp), rng.rand(Rp) > 0.3]).astype(np.float32)
    imp3 = rng.rand(3, Rp).astype(np.float32)
    jg, tg = _gathered(Rp, 6)
    jimp, jupd = ps.restitution_iteration_pallas(
        jt, jnp.asarray(dyn), jnp.asarray(imp3), jg, interpret=True)
    timp, tupd = sk.restitution_iteration(tt, torch.from_numpy(dyn),
                                          torch.from_numpy(imp3), tg)
    close(timp, jimp)
    close(tupd, jupd)


def test_relvel_kernel():
    """K3b (relvel_pallas) against its plain version."""
    _, (jt, *_, Rp), (tt, *_) = tables(True, seed=7)
    jg, tg = _gathered(Rp, 8)
    close(sk.relvel(tt, tg), ps.relvel_pallas(jt, jg, interpret=True))


def test_ngs_kernel():
    """K2 (ngs_iteration_pallas) against its plain version."""
    _, (jt, *_, Rp), (tt, *_) = tables(True, seed=9)
    jg, tg = _gathered(Rp, 10)
    rate = float(CONTACT_POSITION_CORRECTION_RATE)
    mc = tposition.MAX_CORRECTION
    jupd, jerr = ps.ngs_iteration_pallas(jt, jg, rate, mc, interpret=True)
    tupd, terr = sk.ngs_iteration(tt, tg, rate, mc)
    close(tupd, jupd)
    close(terr, jerr)
    assert float(terr.max()) > 0


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    """A tensor that is not on the CPU never reaches a plain version: tensors
    on two devices, or on a device without the kernels, raise."""
    _, _, (tt, *_, Rp) = tables(False)
    g = torch.zeros((6, 2 * Rp))
    with pytest.raises(ValueError):
        sk.relvel(tt.to("meta"), g.to("meta"))
    with pytest.raises(ValueError):
        sk.relvel(tt, g.to("meta"))
    before = dict(sk.LAUNCHES)
    sk.relvel(tt, g)
    assert sk.LAUNCHES == before


@dataclasses.dataclass
class Bodies:
    """The body columns the restitution and position loops read."""
    linvel: object
    angvel: object
    pos: object
    orn: object

    @property
    def capacity(self):
        return self.linvel.shape[0]


def _bodies(N, seed, lib):
    rng = np.random.RandomState(seed)
    q = rng.randn(N, 4)
    x = dict(linvel=rng.randn(N, 3), angvel=rng.randn(N, 3),
             pos=rng.randn(N, 3), orn=q / np.linalg.norm(q, axis=1,
                                                         keepdims=True))
    x = {k: v.astype(np.float32) for k, v in x.items()}
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    return Bodies(**{k: conv(v) for k, v in x.items()})


def test_restitution_loop():
    """The restitution pre-pass over K3b and K3a against the jnp loop, at
    the loop tolerance of tests/test_pallas_solver.py:123-126 (random,
    non-physical rows amplify f32 rounding over passes)."""
    d = random_rows(with_sr=True, seed=3)
    jr, tr = jax_rows(d), port_rows(d)
    lin_j, ang_j = jsolver.solve_restitution(_bodies(48, 2, "jax"), jr, 2, 2,
                                             1 / 60)
    tbl, a_p, b_p, _ = sk.pack_rows_t(tr)
    lin_t, ang_t = tsolver.solve_restitution(
        _bodies(48, 2, "torch"), tbl, torch.cat([a_p, b_p]), 2, 2)
    close(lin_t, lin_j, 1e-3)
    close(ang_t, ang_j, 1e-3)
    assert float((lin_t - _bodies(48, 2, "torch").linvel).abs().max()) > 0


def test_position_loop():
    """The NGS position loop over K2 against the jnp loop (3 iterations with
    the early exit)."""
    d = random_rows(with_sr=False, seed=11)
    d["base_dist"] = d["base_dist"] * 3 - 0.02
    jr, tr = jax_rows(d), port_rows(d)
    want = jposition.solve_positions(_bodies(48, 12, "jax"), jr, 3)
    tbl, a_p, b_p, _ = sk.pack_rows_t(tr)
    start = _bodies(48, 12, "torch")
    got = tposition.solve_positions(start, tbl, torch.cat([a_p, b_p]), 3)
    close(got.pos, want.pos, 1e-3)
    close(got.orn, want.orn, 1e-3)
    assert float((got.pos - start.pos).abs().max()) > 1e-3
