"""The JAX package's async worker, presentation and profile tests on the
port's CPU worlds: the cases ``test_torch_async_behaviour.CASES[4:]``
(the cases and the method are in ``test_torch_async_behaviour.py``)."""
import pytest

from test_torch_async_behaviour import CASES, one_thread  # noqa: F401


@pytest.mark.parametrize("case", CASES[4:], ids=lambda f: f.__name__)
def test_behaviour(case):
    case()
