"""The port's multi-device sharding (``edyn_tpu_torch.parallel``) against
the JAX package's (``edyn_tpu.parallel.sharding``) on the 8-device virtual
CPU mesh of ``tests/conftest.py``.

One JAX world serves both tests: ``tests/test_sharding.py``'s 56-body
pile, built with that test's arguments so that the persistent compile
cache can serve its sharded executable. The spec tree: every leaf the two
``WorldState``s share gets the same sharded-or-replicated choice. The
step: the port's sharded step on 8 CPU shards, from the JAX state carried
over by ``core/convert.py``, against JAX's ``make_sharded_step`` after 5
steps, at ``tests/test_sharding.py``'s tolerances; a body outside them
passes only within the reference's own 1-ulp sensitivity (P1, as
``tests/test_torch_step.py``'s ``check_step``).
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import edyn_tpu as ej
from edyn_tpu.parallel import sharding as jsh
from edyn_tpu.utils.scenes import mixed_pile as j_mixed_pile

from edyn_tpu_torch.core.convert import state_from_numpy
from edyn_tpu_torch.parallel import (
    BODY_AXIS, make_mesh, make_sharded_step, state_shardings,
)

from test_torch_step import jtree, one_thread  # noqa: F401

N_DEV = 8
STEPS = 5
ATOL = {"pos": 2e-4, "linvel": 2e-3}   # tests/test_sharding.py
# leaves of one package's WorldState only (none: the port keeps the JAX
# package's field names, core/convert.py)
ONLY_JAX = set()
ONLY_PORT = set()

pytestmark = pytest.mark.skipif(len(jax.devices()) < N_DEV,
                                reason="needs 8 virtual devices")


@pytest.fixture(scope="module")
def jax_world():
    builder, _ = j_mixed_pile(n_bodies=56)
    cap = ((len(builder.defs) + N_DEV - 1) // N_DEV) * N_DEV
    return ej.make_world(builder, capacity=cap, max_pairs=1024,
                         max_manifolds=1024, max_joints=N_DEV)


def _named(tree, of_leaf):
    """{dotted path: of_leaf(leaf)} over a JAX pytree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))[0]:
        name = ".".join(str(getattr(k, "name", getattr(k, "key", k)))
                        for k in path)
        out[name] = of_leaf(leaf)
    return out


def _port_named(tree, prefix=""):
    """{dotted path: spec} over the port's spec tree."""
    import dataclasses
    out = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif dataclasses.is_dataclass(tree):
        items = ((f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree))
    else:
        return {prefix: tree}
    for k, v in items:
        out.update(_port_named(v, f"{prefix}.{k}" if prefix else k))
    return out


def test_spec_tree_matches_jax(jax_world):
    mesh = jsh.make_mesh(jax.devices()[:N_DEV])
    want = _named(jsh.state_shardings(mesh, jax_world.state),
                  lambda s: BODY_AXIS if s.spec == P("b") else None)
    pstate = state_from_numpy(jtree(jax_world.state), "cpu")
    got = _port_named(state_shardings(
        make_mesh([torch.device("cpu")] * N_DEV), pstate))
    assert set(want) - set(got) == ONLY_JAX
    assert set(got) - set(want) == ONLY_PORT
    differ = {k: (got[k], want[k]) for k in set(got) & set(want)
              if got[k] != want[k]}
    assert not differ, differ
    assert got["pos"] == got["contacts.key"] == BODY_AXIS
    assert got["step_count"] is None


def _jax_steps(w, pos=None):
    """JAX's sharded step from the world's state (its pos replaced by
    ``pos``), STEPS times."""
    import dataclasses
    start = w.state if pos is None else dataclasses.replace(
        w.state, pos=jax.numpy.asarray(pos))
    mesh = jsh.make_mesh(jax.devices()[:N_DEV])
    step, dev_state = jsh.make_sharded_step(mesh, start, w.settings, w.meta)
    for _ in range(STEPS):
        dev_state = step(dev_state)
    jax.block_until_ready(dev_state.pos)
    return {f: np.asarray(getattr(dev_state, f)) for f in (*ATOL, "asleep")}


def test_sharded_step_matches_jax_sharded_step(jax_world):
    w = jax_world
    want = _jax_steps(w)
    import edyn_tpu_torch as et
    from edyn_tpu_torch.utils.scenes import mixed_pile
    tw = et.make_world(mixed_pile(n_bodies=56)[0],
                       capacity=w.state.capacity, max_pairs=1024,
                       max_joints=N_DEV, device="cpu")
    start = state_from_numpy(jtree(w.state), "cpu")
    step, got = make_sharded_step(
        make_mesh([torch.device("cpu")] * N_DEV), start, tw.settings,
        tw.meta)
    for _ in range(STEPS):
        got = step(got)
    diff = {f: np.abs(getattr(got, f).numpy() - want[f]) for f in ATOL}
    bad = np.zeros(w.state.capacity, bool)
    for f, atol in ATOL.items():
        bad |= (diff[f] > atol).any(-1)
    if bad.any():
        # P1: the bodies outside pass only within twice the reference's
        # own sensitivity to a 1-ulp nudge of their start positions
        pos = np.asarray(w.state.pos)
        sens = {f: np.zeros_like(d) for f, d in diff.items()}
        for to in (np.float32(np.inf), np.float32(-np.inf)):
            nudged = pos.copy()
            nudged[bad] = np.nextafter(pos[bad], to)
            alt = _jax_steps(w, nudged)
            for f in sens:
                sens[f] = np.maximum(sens[f], np.abs(alt[f] - want[f]))
        for f, atol in ATOL.items():
            over = diff[f][bad] > np.maximum(atol, 2 * sens[f][bad])
            assert not over.any(), (
                f"{f} of bodies {np.nonzero(bad)[0]} differs by "
                f"{diff[f][bad].max()}, beyond twice the reference's own "
                f"1-ulp sensitivity {sens[f][bad].max()}")
    np.testing.assert_array_equal(got.asleep.numpy(), want["asleep"])
