"""The JAX package's joint and ragdoll behaviour tests on the port's CPU
``World``, second part: the hinge chain, the point and hinge pendulums, the
hinge bump stop and limit restitution (the cases and the method are in
``test_torch_joint_behaviour.py``)."""
import pytest

from test_torch_joint_behaviour import HINGE_CASES, one_thread  # noqa: F401


@pytest.mark.parametrize("case", HINGE_CASES[:3], ids=lambda f: f.__name__)
def test_behaviour(case):
    case()
