"""K5, the dense AABB-overlap count: ``count_overlaps`` and
``suggest_max_pairs`` of the port (its plain version on the CPU) exactly
equal to the JAX package's Pallas kernel in interpret mode, on random AABBs
with N not a multiple of the 256-row tile and some invalid rows; and the
numpy bridge's device rule."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import edyn_tpu as ej
from edyn_tpu.ops import overlap_count as jov
from edyn_tpu.utils.scenes import mixed_pile as j_mixed_pile

from edyn_tpu_torch.core.convert import state_from_numpy, state_to_numpy
from edyn_tpu_torch.ops import overlap_count as tov

from test_torch_step import jtree


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


def test_suggest_max_pairs_matches_jax():
    b, _ = j_mixed_pile(n_bodies=40)
    w = ej.make_world(b)
    st = state_from_numpy(jtree(w.state), "cpu")
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
