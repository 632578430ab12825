"""Shape volumes and the mesh centroid of the port
(``shapes/volume.py``, its own copy of the JAX package's module): the
JAX package's ``tests/test_volume.py`` on the port (reference:
test/edyn/shapes/test_shape_volume.cpp and test_centroid.cpp), each with
the same inputs also given to the JAX package's functions, whose results
the port's must equal (both are float64 numpy)."""
import math

import numpy as np

import edyn_tpu as ej
import edyn_tpu_torch as et
from edyn_tpu.shapes import volume as jvol
from edyn_tpu_torch.shapes import volume as tvol
from edyn_tpu_torch.shapes.params import _convex_hull


def _unit_box_cloud(h=0.5):
    return np.array([[sx * h, sy * h, sz * h]
                     for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                    np.float64)


def _rot(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    x, y, z = axis
    c, s = math.cos(angle), math.sin(angle)
    C = 1 - c
    return np.array([[c + x*x*C, x*y*C - z*s, x*z*C + y*s],
                     [y*x*C + z*s, c + y*y*C, y*z*C - x*s],
                     [z*x*C - y*s, z*y*C + x*s, c + z*z*C]])


def _both(name, *args):
    """The port's result, asserted equal to the JAX package's; shapes are
    built in each package from the same arguments."""
    def build(pkg, a):
        if isinstance(a, tuple) and a and isinstance(a[0], str):
            kind, *rest = a
            if kind == "compound":
                return pkg.CompoundShape(children=[
                    (build(pkg, c), p, o) for c, p, o in rest[0]])
            return getattr(pkg, kind)(*rest)
        return a
    got = getattr(tvol, name)(*(build(et, a) for a in args))
    want = getattr(jvol, name)(*(build(ej, a) for a in args))
    np.testing.assert_array_equal(got, want)
    return got


def test_primitive_volumes():
    assert abs(_both("shape_volume", ("SphereShape", 0.7))
               - 4/3 * math.pi * 0.7**3) < 1e-9
    assert abs(_both("shape_volume", ("BoxShape", (0.5, 1.0, 2.0)))
               - 8.0) < 1e-9
    assert abs(_both("shape_volume", ("CylinderShape", 0.5, 1.5))
               - math.pi * 0.25 * 3.0) < 1e-9
    # capsule = cylinder + full sphere
    assert abs(_both("shape_volume", ("CapsuleShape", 0.5, 1.5))
               - (math.pi * 0.25 * 3.0 + 4/3 * math.pi * 0.125)) < 1e-9
    assert et.shape_volume is tvol.shape_volume


def test_polyhedron_volume_invariances():
    """Unit box cloud has volume 1, invariant under rotation and
    translation, scales cubically."""
    v = _unit_box_cloud()
    assert abs(_both("shape_volume", ("PolyhedronShape", v)) - 1.0) < 1e-9
    R = _rot((3, 8, -1), math.pi * 1.34)
    vr = v @ R.T
    assert abs(_both("shape_volume", ("PolyhedronShape", vr)) - 1.0) < 1e-5
    vt = vr + np.array([10.0, -12.0, 20.889])
    assert abs(_both("shape_volume", ("PolyhedronShape", vt)) - 1.0) < 1e-5
    assert abs(_both("shape_volume", ("PolyhedronShape", vt * 2.0))
               - 8.0) < 1e-4


def test_compound_volume_sums_children():
    comp = ("compound", [(("BoxShape", (0.5, 0.5, 0.5)), (0, 0, 0),
                          (0, 0, 0, 1)),
                         (("SphereShape", 1.0), (0, 2, 0), (0, 0, 0, 1))])
    assert abs(_both("shape_volume", comp) - (1.0 + 4/3 * math.pi)) < 1e-9


def test_mesh_centroid():
    """The centroid of a box mesh is its centre, invariant under rotation,
    and follows translation."""
    v = _unit_box_cloud()
    f = _convex_hull(v)
    np.testing.assert_allclose(_both("mesh_centroid", v, f), 0.0,
                               atol=1e-12)
    R = _rot((-2, 0.22, 7), math.pi * 2.71)
    vr = v @ R.T
    fr = _convex_hull(vr)
    np.testing.assert_allclose(_both("mesh_centroid", vr, fr), 0.0,
                               atol=1e-4)
    pos = np.array([-9.8, 1.85, 12.13])
    np.testing.assert_allclose(_both("mesh_centroid", vr + pos, fr), pos,
                               atol=1e-4)
    assert abs(_both("mesh_volume", vr + pos, fr) - 1.0) < 1e-5
    assert et.mesh_centroid is tvol.mesh_centroid
