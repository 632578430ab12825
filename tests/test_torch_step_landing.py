"""Per-step parity of the PyTorch port with the JAX package, steps 20-39 of
the 64-body ``mixed_pile``: the first contacts (see ``test_torch_step.py``
for the method and the tolerances)."""
import pytest

from test_torch_step import Trajectory, eager_cache  # noqa: F401


@pytest.fixture(scope="module")
def trajectory(eager_cache):  # noqa: F811
    return Trajectory(40)


@pytest.mark.parametrize("step", range(20, 40))
def test_step_parity(trajectory, step):
    trajectory.check_step(step)


def test_steps_have_contacts(trajectory):
    assert trajectory.check_step(39) > 50
