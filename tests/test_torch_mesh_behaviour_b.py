"""The JAX package's mesh behaviour tests on the port's CPU ``World``:
the cases of ``test_torch_mesh_behaviour.CASES`` after the first three
(the cases and the method are in ``test_torch_mesh_behaviour.py``)."""
import pytest

from test_torch_mesh_behaviour import CASES, one_thread  # noqa: F401


@pytest.mark.parametrize("case", CASES[3:], ids=lambda f: f.__name__)
def test_behaviour(case):
    case()
