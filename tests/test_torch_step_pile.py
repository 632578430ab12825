"""Per-step parity of the PyTorch port with the JAX package, steps 40-59 of
the 64-body ``mixed_pile``: the pile in contact (see ``test_torch_step.py``
for the method and the tolerances)."""
import pytest

from test_torch_step import Trajectory, eager_cache  # noqa: F401


@pytest.fixture(scope="module")
def trajectory(eager_cache):  # noqa: F811
    return Trajectory(60)


@pytest.mark.parametrize("step", range(40, 60))
def test_step_parity(trajectory, step):
    trajectory.check_step(step)


def test_steps_have_contacts(trajectory):
    assert trajectory.check_step(59) > 150
