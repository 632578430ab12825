"""Whole-step parity of the PyTorch port with the JAX package on a pile of
four ragdolls in two layers dropped on the floor (``chip_smoke.ragdoll_pile``
at n_ragdolls=4): point, cone and hinge joints beside contacts in the
UNIFIED, BOXBOX and PLANE buckets. Contact generation is 1-ulp sensitive,
so every fourth step of the first 40 is held under ``check_step``'s rule
(see ``test_torch_step.py``); the last one has floor contacts. The start
states are the port's own CPU trajectory carried into JAX states (no
compile of the JAX package's jitted step)."""
import numpy as np
import pytest

from chip_smoke import ragdoll_pile
from test_torch_step import Trajectory, eager_cache, one_thread  # noqa: F401


def ragdolls4(pkg):
    return ragdoll_pile(pkg, n_ragdolls=4, seed=0, layers=2)[0]


@pytest.fixture(scope="module")
def ragdolls(eager_cache):  # noqa: F811
    return Trajectory(40, ragdolls4, source="port")


def test_scene(ragdolls):
    assert ragdolls.tw.meta.has_joints
    assert int(ragdolls.tw.state.joints.valid.sum()) == 4 * 20
    np.testing.assert_array_equal(
        ragdolls.tw.state.exclusions.numpy(),
        np.asarray(ragdolls.jw.state.exclusions))


@pytest.mark.parametrize("step", [3, 7, 11, 15, 19, 23, 27, 31, 35, 39])
def test_ragdoll_step_parity(ragdolls, step):
    contacts = ragdolls.check_step(step)
    assert step < 39 or contacts > 0
