"""The JAX package's compound behaviour tests on the port's CPU ``World``:
the cases of ``test_torch_compound_behaviour.CASES`` after the first three
(the cases and the method are in ``test_torch_compound_behaviour.py``)."""
import pytest

from test_torch_compound_behaviour import CASES, one_thread  # noqa: F401


@pytest.mark.parametrize("case", CASES[3:], ids=lambda f: f.__name__)
def test_behaviour(case):
    case()
