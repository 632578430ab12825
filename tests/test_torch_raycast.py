"""The port's raycast: against the jitted JAX raycast on one state, and the
JAX package's raycast tests (``tests/test_raycast.py``) on the port's CPU
world.

The parity case casts rays made from a numpy seed over
``test_torch_world_api.live_scene`` (every convex shape, a plane, a trimesh
and compounds), settled by the port and carried into a JAX state, through
the jitted JAX raycast and through the same function op by op
(``jax.disable_jit``): the hit entity, feature, sub index and compound
child must equal both, the fraction and the normal must be within ``TOL``
of both. The one exception: at grazing hits on curved sides, XLA's fused
code moves the jitted normal by up to ~4e-4 from the op-by-op one (ROADMAP
P1); there the normal is held to the op-by-op reference only, and such
rays must stay under ``GRAZING_SHARE`` of the hits. The other cases are
the JAX tests, each a static world stepped once (well under a second each
on the CPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import edyn_tpu_torch as et
from edyn_tpu.collision.raycast import raycast as jax_raycast
from edyn_tpu_torch.collision.raycast import (
    FEAT_FACE, FEAT_HEMISPHERE, FEAT_SIDE, FEAT_TRIANGLE, raycast,
)
from test_torch_step import eager_cache  # noqa: F401
from test_torch_world_api import Live, one_thread  # noqa: F401

TOL = 1e-5
GRAZING_SHARE = 0.1
N_RAYS = 384


@pytest.fixture(scope="module")
def live():
    return Live()


def seeded_rays(seed: int = 11):
    """Vertical rays over the scene's footprint, tilted rays, horizontal
    rays through the pile, and rays from inside the bodies' region in
    random directions: [Q, 3] start and end points."""
    rng = np.random.default_rng(seed)
    q = N_RAYS // 4
    lo, hi = np.array([-4.0, -2.5]), np.array([12.5, 2.5])
    xz = rng.uniform(lo, hi, (q, 2))
    down0 = np.stack([xz[:, 0], np.full(q, 4.0), xz[:, 1]], 1)
    down1 = down0 * [1, 0, 1] + [0, -1.0, 0]
    tilt1 = down1 + rng.normal(0, 1.0, (q, 3)) * [1, 0, 1]
    yz = rng.uniform([0.0, -2.5], [1.2, 2.5], (q, 2))
    side0 = np.stack([np.full(q, -6.0), yz[:, 0], yz[:, 1]], 1)
    side1 = side0 + [20.0, 0.0, 0.0]
    mid = rng.uniform([-4, 0, -2.5], [12.5, 1.5, 2.5], (q, 3))
    far = mid + rng.normal(0, 3.0, (q, 3))
    p0 = np.concatenate([down0, down0, side0, mid]).astype(np.float32)
    p1 = np.concatenate([down1, tilt1, side1, far]).astype(np.float32)
    return p0, p1


def test_raycast_parity(live, eager_cache):  # noqa: F811
    jw, tw = live.worlds()
    p0, p1 = seeded_rays()
    args = (jw.state, jnp.asarray(p0), jnp.asarray(p1))
    want = {k: np.asarray(v) for k, v in jax_raycast(*args).items()}
    with jax.disable_jit():
        eager = {k: np.asarray(v) for k, v in jax_raycast(*args).items()}
    got = {k: v.numpy() for k, v in raycast(
        tw.state, torch.as_tensor(p0), torch.as_tensor(p1)).items()}
    hit = want["entity"] >= 0
    assert hit.sum() > N_RAYS // 2
    kinds = set(np.asarray(tw.state.shape_type)[want["entity"][hit]])
    assert len(kinds) >= 7, kinds   # every shape type but NONE and paged
    for ref in (want, eager):
        for k in ("entity", "feature", "sub_index", "child_index"):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        np.testing.assert_allclose(got["fraction"], ref["fraction"], rtol=0,
                                   atol=TOL)
    np.testing.assert_allclose(got["normal"], eager["normal"], rtol=0,
                               atol=TOL)
    grazing = np.abs(want["normal"] - eager["normal"]).max(1) > TOL
    assert grazing.sum() <= GRAZING_SHARE * hit.sum(), grazing.sum()
    np.testing.assert_allclose(got["normal"][~grazing],
                               want["normal"][~grazing], rtol=0, atol=TOL)
    # the World entry point and a small block size give the same answers
    out = tw.raycast(p0, p1)
    blocks = raycast(tw.state, torch.as_tensor(p0), torch.as_tensor(p1),
                     block=7)
    for k in got:
        np.testing.assert_array_equal(out[k], got[k])
        np.testing.assert_array_equal(blocks[k].numpy(), got[k])


# --- tests/test_raycast.py on the port ----------------------------------
def _world_with(shapes_positions):
    b = et.WorldBuilder()
    ids = []
    for shape, pos in shapes_positions:
        ids.append(b.make_rigidbody(et.RigidBodyDef(
            kind=et.KIND_STATIC, shape=shape, position=pos)))
    w = et.make_world(b, device="cpu")
    w.step(1)  # compute AABBs
    return w, ids


def ray_sphere():
    w, ids = _world_with([(et.SphereShape(1.0), (0, 0, 0))])
    hit = w.raycast((0, 5, 0), (0, -5, 0))
    assert hit["entity"] == ids[0]
    np.testing.assert_allclose(hit["fraction"], 0.4, atol=1e-4)
    np.testing.assert_allclose(hit["normal"], [0, 1, 0], atol=1e-4)


def ray_box():
    w, ids = _world_with([(et.BoxShape((0.5, 0.5, 0.5)), (2, 0, 0))])
    hit = w.raycast((-5, 0, 0), (5, 0, 0))
    assert hit["entity"] == ids[0]
    np.testing.assert_allclose(hit["fraction"], (1.5 + 5) / 10, atol=1e-4)
    np.testing.assert_allclose(hit["normal"], [-1, 0, 0], atol=1e-4)


def ray_plane_miss_parallel():
    w, ids = _world_with([(et.PlaneShape((0, 1, 0), 0.0), (0, 0, 0))])
    hit = w.raycast((0, 1, 0), (10, 1, 0))
    assert hit["entity"] == -1
    hit = w.raycast((0, 1, 0), (0, -1, 0))
    assert hit["entity"] == ids[0]
    np.testing.assert_allclose(hit["fraction"], 0.5, atol=1e-4)


def ray_capsule_and_cylinder():
    w, ids = _world_with([
        (et.CapsuleShape(0.5, 1.0), (0, 0, 0)),       # axis X
        (et.CylinderShape(0.5, 1.0, 1), (5, 0, 0)),   # axis Y
    ])
    hit = w.raycast((0, 3, 0), (0, -3, 0))            # capsule side
    assert hit["entity"] == ids[0]
    np.testing.assert_allclose(hit["fraction"], 2.5 / 6, atol=1e-3)
    hit = w.raycast((3, 0, 0), (-3, 0, 0))            # capsule cap
    assert hit["entity"] == ids[0]
    np.testing.assert_allclose(hit["fraction"], 1.5 / 6, atol=1e-3)
    hit = w.raycast((5, 3, 0), (5, -3, 0))            # cylinder cap disc
    assert hit["entity"] == ids[1]
    np.testing.assert_allclose(hit["fraction"], 2.0 / 6, atol=1e-3)
    np.testing.assert_allclose(hit["normal"], [0, 1, 0], atol=1e-3)


def ray_polyhedron():
    verts = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                      [0, 0, 1], [0, 0, -1]], np.float32)  # octahedron
    w, ids = _world_with([(et.PolyhedronShape(verts), (0, 0, 0))])
    hit = w.raycast((0, 5, 0), (0, -5, 0))
    assert hit["entity"] == ids[0]
    np.testing.assert_allclose(hit["fraction"], 0.4, atol=1e-3)


def ray_feature_info():
    w, ids = _world_with([
        (et.BoxShape((0.5, 0.5, 0.5)), (0, 0, 0)),
        (et.CapsuleShape(0.5, 1.0), (5, 0, 0)),       # axis X
        (et.CylinderShape(0.5, 1.0, 1), (10, 0, 0)),  # axis Y
    ])
    hit = w.raycast((-3, 0, 0), (0, 0, 0))    # box -x face: index 1
    assert hit["feature"] == FEAT_FACE and hit["sub_index"] == 1
    hit = w.raycast((0, 3, 0), (0, -3, 0))    # box +y face: index 2
    assert hit["feature"] == FEAT_FACE and hit["sub_index"] == 2
    hit = w.raycast((5, 3, 0), (5, -3, 0))    # capsule side
    assert hit["feature"] == FEAT_SIDE
    hit = w.raycast((2, 0, 0), (8, 0, 0))     # capsule -x hemisphere
    assert hit["feature"] == FEAT_HEMISPHERE and hit["sub_index"] == 1
    hit = w.raycast((10, 3, 0), (10, -3, 0))  # cylinder +axis cap disc
    assert hit["feature"] == FEAT_FACE and hit["sub_index"] == 0
    hit = w.raycast((7, 0, 0), (13, 0, 0))    # cylinder side
    assert hit["feature"] == FEAT_SIDE
    assert hit["child_index"] == -1


def ray_mesh_triangle_and_compound_child():
    tri_v = np.array([[0, 0, 0], [4, 0, 0], [0, 0, 4],
                      [4, 0, 4]], np.float32)
    tris = np.array([[0, 2, 1], [1, 2, 3]], np.int32)  # +y winding
    b = et.WorldBuilder()
    mesh_id = b.make_rigidbody(et.RigidBodyDef(
        kind=et.KIND_STATIC, shape=et.MeshShape(tri_v, tris)))
    comp = et.CompoundShape(children=[
        (et.SphereShape(0.5), (0, 0, 0), (0, 0, 0, 1)),
        (et.BoxShape((0.3, 0.3, 0.3)), (2.0, 0, 0), (0, 0, 0, 1)),
    ])
    comp_id = b.make_rigidbody(et.RigidBodyDef(
        kind=et.KIND_STATIC, shape=comp, position=(10, 2, 0)))
    w = et.make_world(b, device="cpu")
    w.step(1)
    hit = w.raycast((3, 2, 3), (3, -2, 3))   # triangle 1 (x + z > 4)
    assert hit["entity"] == mesh_id
    assert hit["feature"] == FEAT_TRIANGLE and hit["sub_index"] == 1
    hit = w.raycast((12, 5, 0), (12, -1, 0))  # the compound's box child
    assert hit["entity"] == comp_id
    assert hit["child_index"] == 1


def ray_nearest_of_many():
    w, ids = _world_with([
        (et.SphereShape(0.5), (0, 0, 0)),
        (et.SphereShape(0.5), (2, 0, 0)),
        (et.SphereShape(0.5), (4, 0, 0)),
    ])
    hit = w.raycast((-5, 0, 0), (10, 0, 0))
    assert hit["entity"] == ids[0]
    out = w.raycast([(-5, 0, 0), (10, 0, 0)], [(10, 0, 0), (-5, 0, 0)])
    assert out["entity"][0] == ids[0]
    assert out["entity"][1] == ids[2]


CASES = [ray_sphere, ray_box, ray_plane_miss_parallel,
         ray_capsule_and_cylinder, ray_polyhedron, ray_feature_info,
         ray_mesh_triangle_and_compound_child, ray_nearest_of_many]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
def test_raycast_behaviour(case):
    case()
