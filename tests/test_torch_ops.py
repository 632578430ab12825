"""K5, the dense AABB-overlap count: ``count_overlaps`` and
``suggest_max_pairs`` of the port (its plain version on the CPU) exactly
equal to the JAX package's Pallas kernel in interpret mode, on random AABBs
with N not a multiple of the 256-row tile and some invalid rows, and on the
inputs whose exactness the CUDA kernel must keep (N below one tile, every
box invalid, infinite and 1e30 extents, touching faces, the +-1e6 slabs of
mixed_pile's planes); and the device rule of the numpy bridge, the builder
and the convex table."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import edyn_tpu as ej
from edyn_tpu.ops import overlap_count as jov
from edyn_tpu.utils.scenes import mixed_pile as j_mixed_pile

from edyn_tpu_torch.core.convert import state_from_numpy, state_to_numpy
from edyn_tpu_torch.ops import overlap_count as tov

from test_torch_step import jtree, one_thread  # noqa: F401


def _boxes(seed, n, invalid):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    h = rng.uniform(0.1, 0.8, (n, 3)).astype(np.float32)
    # some boxes share a face exactly: touching counts as overlap
    c[1::7, 0] = c[0::7, 0][:len(c[1::7])] + h[0::7, 0][:len(c[1::7])] \
        + h[1::7, 0]
    return c - h, c + h, rng.uniform(size=n) > invalid


@pytest.mark.parametrize("seed,n,invalid", [(0, 300, 0.1), (1, 517, 0.3),
                                            (2, 77, 0.0)])
def test_count_overlaps_matches_jax(monkeypatch, seed, n, invalid):
    amin, amax, valid = _boxes(seed, n, invalid)
    want = int(jov.count_overlaps(jnp.asarray(amin), jnp.asarray(amax),
                                  jnp.asarray(valid), interpret=True))
    assert want > 0
    args = [torch.from_numpy(x) for x in (amin, amax, valid)]
    tov.reset_launch_counts()
    assert tov.count_overlaps(*args) == want
    monkeypatch.setattr(tov, "ROW_BLOCK", 64)   # row blocks change nothing
    assert tov.count_overlaps_plain(*args) == want
    assert tov.LAUNCHES["count_overlaps"] == 0


def _edge_boxes(case):
    amin, amax, valid = _boxes(10, 200, 0.2)
    if case == "all_invalid":
        valid[:] = False
    elif case == "infinite":
        amin[::3, 1] = -np.inf
        amax[::5, 0] = np.inf
        amin[7::11] = -np.inf
        amax[7::11] = np.inf
    elif case == "huge":
        amin[::4, 2] = -1e30
        amax[1::4] = 1e30
    elif case == "touching":
        # a row of unit boxes whose faces touch exactly, and one corner
        amin[:50] = np.arange(50, dtype=np.float32)[:, None] * [1, 0, 0]
        amax[:50] = amin[:50] + 1.0
        amin[50] = amax[49]
        amax[50] = amin[50] + 1.0
    return amin, amax, valid


@pytest.mark.parametrize("case", ["all_invalid", "infinite", "huge",
                                  "touching"])
def test_count_overlaps_edge_cases_match_jax(case):
    amin, amax, valid = _edge_boxes(case)
    want = int(jov.count_overlaps(jnp.asarray(amin), jnp.asarray(amax),
                                  jnp.asarray(valid), interpret=True))
    if case == "all_invalid":
        assert want == 0
    else:
        assert want > 0
    args = [torch.from_numpy(x) for x in (amin, amax, valid)]
    assert tov.count_overlaps(*args) == want


def test_suggest_max_pairs_matches_jax():
    b, _ = j_mixed_pile(n_bodies=40)
    w = ej.make_world(b)
    st = state_from_numpy(jtree(w.state), "cpu")
    # the static planes' world-sized slabs are in the input
    assert float(st.aabb_max.max()) >= 1e6 and float(st.aabb_min.min()) <= -1e6
    n = tov.count_overlaps(st.aabb_min, st.aabb_max, st.valid)
    assert n == int(jov.count_overlaps(w.state.aabb_min, w.state.aabb_max,
                                       w.state.valid, interpret=True))
    assert tov.suggest_max_pairs(st) == jov.suggest_max_pairs(
        w.state, interpret=True) == max(256, int(n * 1.5))


def test_state_from_numpy_defaults_to_cuda():
    from edyn_tpu_torch.utils.scenes import mixed_pile
    import edyn_tpu_torch as et
    tree = state_to_numpy(et.make_world(mixed_pile(n_bodies=8)[0],
                                        device="cpu").state)
    assert state_from_numpy(tree, "cpu").pos.device.type == "cpu"
    if torch.cuda.is_available():
        assert state_from_numpy(tree).pos.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            state_from_numpy(tree)


def test_builder_and_convex_table_default_to_cuda():
    """WorldBuilder.finalize and build_convex_table place their tensors on
    the card unless the caller names a device, and raise without one."""
    from edyn_tpu_torch.shapes.convex import build_convex_table
    from edyn_tpu_torch.utils.scenes import mixed_pile
    builder = mixed_pile(n_bodies=8)[0]
    assert builder.finalize(device="cpu").pos.device.type == "cpu"
    args = (np.array([1]), np.array([[0.5, 0, 0, 0]], np.float32),
            np.array([0]))
    assert build_convex_table(*args, device="cpu").radius.device.type == \
        "cpu"
    if torch.cuda.is_available():
        assert builder.finalize().pos.device.type == "cuda"
        assert build_convex_table(*args).radius.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            builder.finalize()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_convex_table(*args)
