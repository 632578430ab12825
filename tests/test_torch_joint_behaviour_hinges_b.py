"""The JAX package's joint and ragdoll behaviour tests on the port's CPU
``World``: the cases of ``test_torch_joint_behaviour.HINGE_CASES`` after the
first 3 (the cases and the method are in ``test_torch_joint_behaviour.py``)."""
import pytest

from test_torch_joint_behaviour import HINGE_CASES, one_thread  # noqa: F401


@pytest.mark.parametrize("case", HINGE_CASES[3:], ids=lambda f: f.__name__)
def test_behaviour(case):
    case()
