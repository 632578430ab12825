"""The JAX package's joint and ragdoll behaviour tests on the port's CPU
``World``, third part: the ragdoll, the generic spring and friction, the
cone, the hinge limit and runtime create and destroy (the cases and the
method are in ``test_torch_joint_behaviour.py``)."""
import pytest

from test_torch_joint_behaviour import RAGDOLL_CASES, one_thread  # noqa: F401


@pytest.mark.parametrize("case", RAGDOLL_CASES[:3], ids=lambda f: f.__name__)
def test_behaviour(case):
    case()
