"""The primitive narrowphase functions of the port
(``collision/kernels/primitives.py``, ``poly_plane.py``): the JAX
package's goldens of ``tests/test_collision.py`` (its primitive, box-box and
cylinder-plane cases) on the port, and seeded random inputs given to every
function of both packages.

No bucket of the step reaches these functions (the JAX package's
``_classes_present`` never returns them); they are library functions.
Parity: point validity and attachment equal; pivots, normals and distances
of the valid points within 1e-5 m, the float32 rounding of the two
packages' different operation orders (3-term sums as ``jnp.sum`` against
``torch.sum``)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edyn_tpu.collision.kernels import poly_plane as jpp
from edyn_tpu.collision.kernels import primitives as jprim
from edyn_tpu.collision.kernels.support import Side as JSide
from edyn_tpu_torch.collision.kernels import box_box, poly_plane, primitives
from edyn_tpu_torch.collision.kernels.support import Side as TSide
from test_torch_step import one_thread  # noqa: F401

THRESH = 0.01
IDENT = torch.tensor([[0.0, 0.0, 0.0, 1.0]])
ZERO = torch.tensor([[0.0, 0.0, 0.0]])


def _params(*vals):
    p = torch.zeros((1, 4))
    p[0, :len(vals)] = torch.tensor(vals)
    return p


def _axis_angle(axis, angle):
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a) * math.sin(angle / 2)
    return torch.tensor([[a[0], a[1], a[2], math.cos(angle / 2)]],
                        dtype=torch.float32)


def _valid_points(res):
    pv = res.point_valid[0].numpy()
    return [i for i in range(4) if pv[i]]


# --- tests/test_collision.py on the port --------------------------------
def test_sphere_sphere_touching():
    res = primitives.collide_sphere_sphere(
        torch.tensor([[0.0, 2.001, 0.0]]), IDENT, _params(1.0),
        ZERO, IDENT, _params(1.0), THRESH)
    assert len(_valid_points(res)) == 1
    assert abs(float(res.distance[0, 0]) - 0.001) < 1e-5
    np.testing.assert_allclose(res.normal[0, 0].numpy(), [0, 1, 0],
                               atol=1e-6)


def test_sphere_sphere_separated_beyond_threshold():
    res = primitives.collide_sphere_sphere(
        torch.tensor([[0.0, 2.5, 0.0]]), IDENT, _params(1.0),
        ZERO, IDENT, _params(1.0), THRESH)
    assert len(_valid_points(res)) == 0


def test_sphere_plane():
    res = primitives.collide_sphere_plane(
        torch.tensor([[0.0, 0.95, 0.0]]), IDENT, _params(1.0),
        ZERO, IDENT, _params(0.0, 1.0, 0.0, 0.0), THRESH)
    assert len(_valid_points(res)) == 1
    assert abs(float(res.distance[0, 0]) + 0.05) < 1e-6
    np.testing.assert_allclose(res.pivot_a[0, 0].numpy(), [0, -1, 0],
                               atol=1e-5)


def test_box_plane_face_contact_four_points():
    res = primitives.collide_box_plane(
        torch.tensor([[0.0, 0.5, 0.0]]), IDENT, _params(0.5, 0.5, 0.5),
        ZERO, IDENT, _params(0.0, 1.0, 0.0, 0.0), THRESH)
    pts = _valid_points(res)
    assert len(pts) == 4
    pivots = res.pivot_a[0].numpy()[pts]
    assert np.allclose(np.abs(pivots), 0.5, atol=1e-5)
    assert np.allclose(pivots[:, 1], -0.5, atol=1e-5)
    assert np.allclose(res.distance[0].numpy()[pts], 0.0, atol=1e-5)


def test_box_plane_edge_tilt():
    orn = _axis_angle((0.0, 0.0, 1.0), np.pi / 4)
    h = np.sqrt(2) * 0.5
    res = primitives.collide_box_plane(
        torch.tensor([[0.0, float(h), 0.0]]), orn, _params(0.5, 0.5, 0.5),
        ZERO, IDENT, _params(0.0, 1.0, 0.0, 0.0), THRESH)
    pts = _valid_points(res)
    assert len(pts) == 2
    world = res.pivot_a[0].numpy()[pts]
    assert set(np.round(world[:, 2], 3)) == {0.5, -0.5}


def test_box_box_face_face():
    res = box_box.collide_box_box(
        torch.tensor([[0.0, 1.0005, 0.0]]), IDENT, _params(0.5, 0.5, 0.5),
        ZERO, IDENT, _params(0.5, 0.5, 0.5), THRESH)
    pts = _valid_points(res)
    assert len(pts) == 4
    np.testing.assert_allclose(res.normal[0].numpy()[pts], [[0, 1, 0]] * 4,
                               atol=1e-5)
    np.testing.assert_allclose(res.distance[0].numpy()[pts], 0.0005,
                               atol=1e-4)
    piv = res.pivot_a[0].numpy()[pts]
    assert np.allclose(np.abs(piv[:, [0, 2]]), 0.5, atol=1e-4)
    assert np.allclose(piv[:, 1], -0.5, atol=1e-4)


def test_box_box_face_face_offset_clip():
    res = box_box.collide_box_box(
        torch.tensor([[0.5, 1.0, 0.0]]), IDENT, _params(0.5, 0.5, 0.5),
        ZERO, IDENT, _params(0.5, 0.5, 0.5), THRESH)
    pts = _valid_points(res)
    assert len(pts) == 4
    pa_world = res.pivot_a[0].numpy()[pts] + [0.5, 1.0, 0.0]
    assert pa_world[:, 0].min() > -0.01 and pa_world[:, 0].max() < 1.01


def test_box_box_edge_edge():
    orn_a = _axis_angle((0.0, 0.0, 1.0), np.pi / 4)
    orn_b = _axis_angle((1.0, 0.0, 0.0), np.pi / 4)
    ha = np.sqrt(2) * 0.5
    res = box_box.collide_box_box(
        torch.tensor([[0.0, float(2 * ha - 0.001), 0.0]]), orn_a,
        _params(0.5, 0.5, 0.5), ZERO, orn_b, _params(0.5, 0.5, 0.5), THRESH)
    pts = _valid_points(res)
    assert len(pts) >= 1
    assert float(res.distance[0, pts[0]]) < 0.0


def test_sphere_box_face():
    res = primitives.collide_sphere_box(
        torch.tensor([[0.0, 1.45, 0.0]]), IDENT, _params(1.0),
        ZERO, IDENT, _params(0.5, 0.5, 0.5), THRESH)
    assert len(_valid_points(res)) == 1
    assert abs(float(res.distance[0, 0]) + 0.05) < 1e-5
    np.testing.assert_allclose(res.normal[0, 0].numpy(), [0, 1, 0],
                               atol=1e-5)


def test_sphere_box_deep_center():
    res = primitives.collide_sphere_box(
        torch.tensor([[0.0, 0.4, 0.0]]), IDENT, _params(0.25),
        ZERO, IDENT, _params(0.5, 0.5, 0.5), THRESH)
    assert len(_valid_points(res)) == 1
    np.testing.assert_allclose(res.normal[0, 0].numpy(), [0, 1, 0],
                               atol=1e-5)
    assert float(res.distance[0, 0]) < -0.3


def test_capsule_plane_lying():
    res = primitives.collide_capsule_plane(
        torch.tensor([[0.0, 0.25, 0.0]]), IDENT, _params(0.3, 0.5, 0.0),
        ZERO, IDENT, _params(0.0, 1.0, 0.0, 0.0), THRESH)
    pts = _valid_points(res)
    assert len(pts) == 2
    np.testing.assert_allclose(res.distance[0].numpy()[pts], -0.05,
                               atol=1e-5)


def test_capsule_capsule_parallel_two_points():
    res = primitives.collide_capsule_capsule(
        torch.tensor([[0.0, 0.59, 0.0]]), IDENT, _params(0.3, 0.5, 0.0),
        ZERO, IDENT, _params(0.3, 0.5, 0.0), THRESH)
    pts = _valid_points(res)
    assert len(pts) == 2
    np.testing.assert_allclose(res.distance[0].numpy()[pts], -0.01,
                               atol=1e-4)


def test_cylinder_plane_flat_cap():
    res = primitives.collide_cylinder_plane(
        torch.tensor([[0.0, 0.495, 0.0]]), IDENT, _params(0.3, 0.5, 1.0),
        ZERO, IDENT, _params(0.0, 1.0, 0.0, 0.0), THRESH)
    pts = _valid_points(res)
    assert len(pts) == 4
    np.testing.assert_allclose(res.distance[0].numpy()[pts], -0.005,
                               atol=1e-4)


def test_cylinder_plane_side_lying():
    res = primitives.collide_cylinder_plane(
        torch.tensor([[0.0, 0.295, 0.0]]), IDENT, _params(0.3, 0.5, 0.0),
        ZERO, IDENT, _params(0.0, 1.0, 0.0, 0.0), THRESH)
    pts = _valid_points(res)
    assert len(pts) == 2
    np.testing.assert_allclose(res.distance[0].numpy()[pts], -0.005,
                               atol=1e-4)


# --- seeded random inputs through both packages --------------------------
K = 256
RES_FIELDS = ("pivot_a", "pivot_b", "normal", "distance")


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _shape_params(rng, kind, n):
    p = np.zeros((n, 4), np.float32)
    if kind == "sphere":
        p[:, 0] = rng.uniform(0.1, 0.6, n)
    elif kind == "box":
        p[:, :3] = rng.uniform(0.1, 0.6, (n, 3))
    elif kind in ("capsule", "cylinder"):
        p[:, 0] = rng.uniform(0.1, 0.4, n)
        p[:, 1] = rng.uniform(0.1, 0.6, n)
        p[:, 2] = rng.integers(0, 3, n)
    elif kind == "plane":
        nrm = rng.normal(size=(n, 3))
        p[:, :3] = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
        p[:, 3] = rng.uniform(-0.3, 0.3, n)
    return p


def _pair_inputs(seed, kind_a, kind_b):
    """Pairs whose shapes are within about their size of touching, so most
    produce points."""
    rng = np.random.default_rng(seed)
    pos_b = rng.uniform(-2, 2, (K, 3)).astype(np.float32)
    off = rng.normal(size=(K, 3))
    off /= np.linalg.norm(off, axis=1, keepdims=True)
    pos_a = (pos_b + off * rng.uniform(0.0, 1.0, (K, 1))).astype(np.float32)
    orn_a, orn_b = _quats(rng, K), _quats(rng, K)
    prm_a = _shape_params(rng, kind_a, K)
    prm_b = _shape_params(rng, kind_b, K)
    if kind_b == "plane":
        # the plane through pos_b, shifted so the body A straddles it
        orn_b = np.tile(np.float32([0, 0, 0, 1]), (K, 1))
        prm_b[:, 3] = (np.sum(prm_b[:, :3] * (pos_a - pos_b), 1)
                       - rng.uniform(-0.4, 0.6, K)).astype(np.float32)
    return pos_a, orn_a, prm_a, pos_b, orn_b, prm_b


def _assert_results_equal(t, j):
    pv = t.point_valid.numpy()
    np.testing.assert_array_equal(pv, np.asarray(j.point_valid))
    np.testing.assert_array_equal(t.attachment.numpy(),
                                  np.asarray(j.attachment))
    for f in RES_FIELDS:
        a = getattr(t, f).numpy()[pv]
        b = np.asarray(getattr(j, f))[pv]
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=f)
    assert pv.any(1).mean() > 0.2


PRIMITIVES = [
    ("collide_sphere_sphere", "sphere", "sphere"),
    ("collide_sphere_plane", "sphere", "plane"),
    ("collide_box_plane", "box", "plane"),
    ("collide_capsule_plane", "capsule", "plane"),
    ("collide_cylinder_plane", "cylinder", "plane"),
    ("collide_sphere_box", "sphere", "box"),
    ("collide_sphere_capsule", "sphere", "capsule"),
    ("collide_capsule_capsule", "capsule", "capsule"),
]


@pytest.mark.parametrize("name,kind_a,kind_b", PRIMITIVES,
                         ids=[p[0] for p in PRIMITIVES])
def test_primitive_parity(name, kind_a, kind_b):
    args = _pair_inputs(len(name), kind_a, kind_b)
    t = getattr(primitives, name)(*(torch.from_numpy(x) for x in args),
                                  THRESH)
    j = getattr(jprim, name)(*(jnp.asarray(x) for x in args), THRESH)
    _assert_results_equal(t, j)


def _side(pkg_side, conv, pos, orn, params, verts, vmask):
    Kn, V = vmask.shape
    z = np.zeros
    return pkg_side(
        pos=conv(pos), orn=conv(orn), params=conv(params), verts=conv(verts),
        vert_mask=conv(vmask), radius=conv(z((Kn,), np.float32)),
        face_normals=conv(z((Kn, 1, 3), np.float32)),
        face_mask=conv(z((Kn, 1), bool)),
        edge_dirs=conv(z((Kn, 1, 3), np.float32)),
        edge_mask=conv(z((Kn, 1), bool)),
        disc_r=conv(z((Kn,), np.float32)),
        disc_axis=conv(np.tile(np.float32([0, 0, 1]), (Kn, 1))))


def test_polyhedron_plane_parity():
    """Random 8-vertex clouds (some vertices masked) against random
    planes."""
    pos_a, orn_a, _, pos_b, orn_b, prm_b = _pair_inputs(7, "box", "plane")
    rng = np.random.default_rng(8)
    verts = rng.uniform(-0.5, 0.5, (K, 8, 3)).astype(np.float32)
    vmask = rng.random((K, 8)) > 0.2
    vmask[:, 0] = True
    prm_a = np.zeros((K, 4), np.float32)
    A_t = _side(TSide, torch.from_numpy, pos_a, orn_a, prm_a, verts, vmask)
    B_t = _side(TSide, torch.from_numpy, pos_b, orn_b, prm_b, verts[:, :1],
                vmask[:, :1])
    A_j = _side(JSide, jnp.asarray, pos_a, orn_a, prm_a, verts, vmask)
    B_j = _side(JSide, jnp.asarray, pos_b, orn_b, prm_b, verts[:, :1],
                vmask[:, :1])
    _assert_results_equal(poly_plane.collide_polyhedron_plane(A_t, B_t,
                                                              THRESH),
                          jpp.collide_polyhedron_plane(A_j, B_j, THRESH))


def test_primitives_follow_the_input_dtype():
    """At float64 every float output is float64 (the f64 mode)."""
    args = _pair_inputs(3, "capsule", "plane")
    res = primitives.collide_capsule_plane(
        *(torch.from_numpy(x).double() for x in args), THRESH)
    for f in RES_FIELDS + ("friction_scale", "restitution_scale"):
        assert getattr(res, f).dtype == torch.float64, f
