"""The JAX package's networking tests on the port's CPU worlds, and the
port's own: the cases ``test_torch_networking_behaviour.CASES[4:8]``
(the cases and the method are in ``test_torch_networking_behaviour.py``)."""
import pytest

from test_torch_networking_behaviour import CASES, one_thread  # noqa: F401


@pytest.mark.parametrize("case", CASES[4:8], ids=lambda f: f.__name__)
def test_behaviour(case):
    case()
