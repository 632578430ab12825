"""The JAX package's joint behaviour tests on the port's CPU ``World``, the
last three of ``test_torch_joint_behaviour.CASES`` (the cases and the
method are in ``test_torch_joint_behaviour.py``)."""
import pytest

from test_torch_joint_behaviour import CASES, one_thread  # noqa: F401


@pytest.mark.parametrize("case", CASES[4:], ids=lambda f: f.__name__)
def test_behaviour(case):
    case()
