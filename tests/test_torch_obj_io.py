"""OBJ loading of the port (``shapes/obj_io.py``, its own copy of the
JAX package's module, over the port's ``native/loader.py``): the three
OBJ tests of ``tests/test_native_io.py`` on the port, each file also read
by the JAX package's functions, whose arrays the port's must equal."""
import os
import tempfile

import numpy as np
import pytest

from edyn_tpu.shapes import obj_io as jobj
from edyn_tpu_torch.native import loader
from edyn_tpu_torch.shapes import obj_io

OBJ = """\
# test cube + tet
v -1 0 -1 0.5 0.2 0.1
v 1 0 -1 0.5 0.2 0.1
v 1 0 1 0.5 0.2 0.1
v -1 0 1 0.5 0.2 0.1
f 1 2 3 4
"""

# two disjoint tetrahedra (convex pieces) and a triangle too small to be one
PIECES = """\
v 0 0 0
v 1 0 0
v 0 1 0
v 0 0 1
v 3 0 0
v 4 0 0
v 3 1 0
v 3 0 1
v 9 9 9
v 9 8 9
v 8 9 9
f 1 2 3
f 1 2 4
f 1 3 4
f 2 3 4
f 5 6 7
f 5 6 8
f 5 7 8
f 6 7 8
f 9 10 11
"""


@pytest.fixture
def obj_path():
    paths = []

    def write(text):
        fd, path = tempfile.mkstemp(suffix=".obj")
        with os.fdopen(fd, "w") as f:
            f.write(text)
        paths.append(path)
        return path
    yield write
    for p in paths:
        os.unlink(p)


def test_parse_obj_quad_triangulated(obj_path):
    path = obj_path(OBJ)
    verts, colors, faces = obj_io.parse_obj(path)
    assert verts.shape == (4, 3)
    assert faces.shape == (2, 3)  # quad -> 2 tris
    np.testing.assert_allclose(colors[0], [0.5, 0.2, 0.1])
    for a, b in zip((verts, colors, faces), jobj.parse_obj(path)):
        np.testing.assert_array_equal(a, b)


def test_parse_obj_native_matches_python(obj_path):
    path = obj_path(OBJ)
    py = obj_io._parse_obj_python(path)
    for a, b in zip(py, jobj._parse_obj_python(path)):
        np.testing.assert_array_equal(a, b)
    if loader.lib() is not None:
        nat = loader.parse_obj(path)
        for a, b in zip(py, nat):
            np.testing.assert_allclose(a, b)


def test_load_trimesh_with_materials(obj_path):
    path = obj_path(OBJ)
    mesh = obj_io.load_tri_mesh_from_obj(path, friction_from_red=True)
    assert mesh.vertex_friction is not None
    np.testing.assert_allclose(mesh.vertex_friction, 0.5)
    want = jobj.load_tri_mesh_from_obj(path, friction_from_red=True)
    np.testing.assert_array_equal(mesh.vertices, want.vertices)
    np.testing.assert_array_equal(mesh.indices, want.indices)
    assert mesh.vertices.dtype == np.float32


def test_load_convex_polyhedrons(obj_path):
    """Each connected group of at least four vertices is one polyhedron, as
    the JAX package splits them."""
    path = obj_path(PIECES)
    got = obj_io.load_convex_polyhedrons_from_obj(path)
    want = jobj.load_convex_polyhedrons_from_obj(path)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.vertices, w.vertices)
