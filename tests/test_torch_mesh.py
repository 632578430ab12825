"""Parity of the port's static triangle meshes with the JAX package: the
baked tables, the candidate grid lookup, mesh AABBs, the MESH bucket's
``collide_convex_mesh`` and the chunking of the bucket.

- Tables (``preprocess_trimesh``, ``build_grid``, ``pack_meshes``) and
  ``candidate_tris``: equal, for ``rich_scene``'s ``grid_mesh`` terrain and
  a random-height mesh with per-vertex materials.
- AABBs of a tilted, offset mesh body beside convex bodies: equal.
- ``collide_convex_mesh`` on fixed inputs: random spheres, boxes, capsules,
  cylinders and tetrahedra near the random mesh, with and without rim
  axes, against the JAX function evaluated op by op (``jax.disable_jit``,
  see ``test_torch_step.py``): point validity equal, every point's fields
  within atol 1e-5 (as ``test_torch_unified.py`` holds K4), the material
  scales equal.
- The bucket in ``update_contacts``: chunks of 1 and 3 (body, mesh) pairs
  give what one chunk gives, bit for bit, with the same drop count.
- ROADMAP R10 from both packages: on the port's state at step 58 of
  ``tests/test_mesh.py::test_polyhedron_on_terrain``, the two
  ``collide_convex_mesh`` agree (atol 1e-5) and both give points at
  triangle corners beside the tetrahedron, with a depth.

The port runs on the CPU, one thread (the suite runs several workers).
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import edyn_tpu as ej
from edyn_tpu.collision.kernels import mesh as jmk
from edyn_tpu.collision.kernels import support as jsup
from edyn_tpu.shapes import mesh as jmesh
from edyn_tpu.shapes.aabb import compute_aabbs as j_aabbs

import edyn_tpu_torch as et
from edyn_tpu_torch.collision import narrowphase as tnph
from edyn_tpu_torch.collision.kernels import mesh as tmk
from edyn_tpu_torch.collision.kernels import support as tsup
from edyn_tpu_torch.core.convert import state_from_numpy, state_to_numpy
from edyn_tpu_torch.shapes import mesh as tmesh
from edyn_tpu_torch.shapes.aabb import compute_aabbs as t_aabbs

from test_torch_mesh_behaviour import make_grid_mesh
from test_torch_step import eager_cache, jtree, one_thread, to_jax  # noqa: F401

THRESHOLD = 0.01
TET = np.array([[0.15, 0.15, 0.15], [-0.15, -0.15, 0.15],
                [-0.15, 0.15, -0.15], [0.15, -0.15, -0.15]], np.float32)



def terrain(pkg):
    """``rich_scene``'s terrain at n_bodies=48."""
    scenes = importlib.import_module(pkg.__name__ + ".utils.scenes")
    extent = 8.0
    return scenes.grid_mesh(24, 24, 2 * extent / 23, height_fn=lambda x, z:
                            0.15 * np.sin(0.4 * x) * np.cos(0.4 * z))


def bumpy(pkg):
    """A 7 x 7 random-height mesh with per-vertex friction and
    restitution."""
    scenes = importlib.import_module(pkg.__name__ + ".utils.scenes")
    rng = np.random.default_rng(3)
    h = rng.uniform(-0.3, 0.3, (7, 7))
    verts, tris = scenes.grid_mesh(7, 7, 0.8)
    verts[:, 1] = h.reshape(-1)
    fr = rng.uniform(0.3, 1.2, len(verts))
    re = rng.uniform(0.0, 1.0, len(verts))
    return verts, tris, fr, re


def mesh_world(pkg, seed: int = 0, n: int = 40):
    """The bumpy mesh, tilted and offset, with random convex bodies of five
    kinds near its surface; a plane far below."""
    verts, tris, fr, re = bumpy(pkg)
    rng = np.random.default_rng(seed)
    b = pkg.WorldBuilder()
    q = np.array([0.05, 0.0, 0.03, 1.0])
    b.make_rigidbody(pkg.RigidBodyDef(
        kind=pkg.KIND_STATIC, position=(0.2, 0.1, -0.1),
        orientation=tuple(q / np.linalg.norm(q)),
        shape=pkg.MeshShape(verts, tris, vertex_friction=fr,
                            vertex_restitution=re),
        material=pkg.Material(friction=0.7)))
    b.make_rigidbody(pkg.RigidBodyDef(
        kind=pkg.KIND_STATIC, shape=pkg.PlaneShape((0, 1, 0), -5.0)))
    kinds = [lambda: pkg.SphereShape(0.15 + 0.1 * rng.random()),
             lambda: pkg.BoxShape(tuple(0.1 + 0.15 * rng.random(3))),
             lambda: pkg.CapsuleShape(0.08 + 0.07 * rng.random(),
                                      0.1 + 0.1 * rng.random()),
             lambda: pkg.CylinderShape(0.1 + 0.08 * rng.random(),
                                       0.1 + 0.1 * rng.random()),
             lambda: pkg.PolyhedronShape(TET)]
    for i in range(n):
        shape = kinds[i % 5]()
        x, z = rng.uniform(-2.2, 2.2, 2)
        y = rng.uniform(-0.35, 0.45)
        qb = rng.normal(size=4)
        b.make_rigidbody(pkg.RigidBodyDef(
            mass=1.0, shape=shape, position=(x, y, z),
            orientation=tuple(qb / np.linalg.norm(qb))))
    return b


@pytest.fixture(scope="module")
def worlds():
    jw = ej.make_world(mesh_world(ej))
    tw = et.make_world(mesh_world(et), device="cpu")
    return jw, tw


@pytest.mark.parametrize("mesh", ["terrain", "bumpy"])
def test_baked_tables_equal(mesh):
    make = terrain if mesh == "terrain" else bumpy
    jargs, targs = make(ej), make(et)
    for x, y in zip(jmesh.preprocess_trimesh(*jargs),
                    tmesh.preprocess_trimesh(*targs)):
        np.testing.assert_array_equal(y, x)
    tv = jmesh.preprocess_trimesh(*jargs)[0]
    want = jmesh.build_grid(tv, cap=64)
    got = tmesh.build_grid(tmesh.preprocess_trimesh(*targs)[0], cap=64)
    for i in (0, 1, 2, 3):
        np.testing.assert_array_equal(got[i], want[i])
    np.testing.assert_array_equal(got[4][0], want[4][0])
    np.testing.assert_array_equal(got[4][1], want[4][1])
    assert (got[0] >= 0).sum() > len(tv)
    jshape, tshape = ej.MeshShape(*jargs), et.MeshShape(*targs)
    jt_ = jmesh.pack_meshes([jshape, jshape])
    tt_ = tmesh.pack_meshes([tshape, tshape], "cpu")
    for f in dataclasses.fields(jt_):
        np.testing.assert_array_equal(getattr(tt_, f.name).numpy(),
                                      np.asarray(getattr(jt_, f.name)),
                                      err_msg=f.name)


def test_candidate_tris_equal(worlds):
    jw, tw = worlds
    rng = np.random.default_rng(1)
    pts = rng.uniform(-4.0, 4.0, (500, 3)).astype(np.float32)
    idx = np.zeros(500, np.int32)
    want = jmesh.candidate_tris(jw.state.mesh, jnp.asarray(idx),
                                jnp.asarray(pts))
    got = tmesh.candidate_tris(tw.state.mesh, torch.from_numpy(idx),
                               torch.from_numpy(pts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (np.asarray(want) >= 0).any(1).mean() > 0.5


def test_mesh_aabbs_equal(worlds):
    jw, tw = worlds
    js, ts = jw.state, tw.state
    jmin, jmax = j_aabbs(js.shape_type, js.shape_params, js.origin_pos(),
                         js.orn, js.poly, js.shape_index, js.mesh, js.convex)
    tmin, tmax = t_aabbs(ts.shape_type, ts.origin_pos(), ts.orn, ts.convex,
                         ts.shape_index, ts.mesh)
    np.testing.assert_allclose(tmin.numpy(), np.asarray(jmin), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tmax.numpy(), np.asarray(jmax), rtol=0,
                               atol=1e-6)
    # the mesh body's box is the tilted mesh's, not a point
    assert float(tmax[0, 0] - tmin[0, 0]) > 4.0


def _mesh_pairs(n):
    return np.arange(2, 2 + n), np.zeros(n, np.int64)


@pytest.mark.parametrize("rim", [True, False])
def test_collide_convex_mesh_equal(worlds, eager_cache, rim):  # noqa: F811
    jw, tw = worlds
    ka, kb = _mesh_pairs(tw.state.capacity - 2)
    js = jw.state
    with jax.disable_jit():
        packed, dims = jsup.pack_side_table(js)
        want = jmk.collide_convex_mesh(
            jsup.side_from_packed(packed[ka], dims),
            jsup.side_from_packed(packed[kb], dims), THRESHOLD,
            mesh_table=js.mesh, mesh_index=js.shape_index[kb], rim_axes=rim)
    ts = state_from_numpy(jtree(js), "cpu")
    tp, td = tsup.pack_side_table(ts)
    tka, tkb = torch.from_numpy(ka), torch.from_numpy(kb)
    got = tmk.collide_convex_mesh(
        tsup.side_from_packed(tp[tka], td), tsup.side_from_packed(tp[tkb], td),
        THRESHOLD, ts.mesh, ts.shape_index[tkb], rim_axes=rim)
    pv = np.asarray(want.point_valid)
    np.testing.assert_array_equal(got.point_valid.numpy(), pv)
    assert pv.any(1).sum() >= 10, pv.any(1).sum()
    for f in ("pivot_a", "pivot_b", "normal", "distance"):
        np.testing.assert_allclose(getattr(got, f).numpy()[pv],
                                   np.asarray(getattr(want, f))[pv], rtol=0,
                                   atol=1e-5, err_msg=f)
    for f in ("friction_scale", "restitution_scale", "attachment"):
        np.testing.assert_array_equal(getattr(got, f).numpy()[pv],
                                      np.asarray(getattr(want, f))[pv],
                                      err_msg=f)
    assert len(np.unique(got.friction_scale.numpy()[pv])) > 3


def _mesh_table_state(tw, ts):
    """``ts`` with a contact table holding every (body, mesh) pair."""
    N = ts.capacity
    ka, kb = _mesh_pairs(N - 2)
    man = ts.contacts
    M = man.key.shape[0]
    n = len(ka)
    valid = torch.zeros(M, dtype=torch.bool)
    valid[:n] = True
    a = torch.zeros(M, dtype=torch.int32)
    b = torch.zeros(M, dtype=torch.int32)
    a[:n] = torch.from_numpy(kb).to(torch.int32)   # mesh first: swapped
    b[:n] = torch.from_numpy(ka).to(torch.int32)
    key = torch.where(valid, a.long() * N + b.long(),
                      torch.full((M,), torch.iinfo(torch.int64).max))
    return dataclasses.replace(ts, contacts=dataclasses.replace(
        man, valid=valid, body_a=a, body_b=b, key=key))


@pytest.mark.parametrize("chunk", [64, 192])
def test_mesh_bucket_chunked_equal(worlds, monkeypatch, chunk):
    """The MESH bucket's live pairs in chunks of CHUNK // 64 (body, mesh)
    pairs, one and three, against one chunk: bit for bit."""
    jw, tw = worlds
    ts = _mesh_table_state(tw, tw.state)
    args = (THRESHOLD, tw.meta.types_present, 8, 1 / 60)
    one, drop1 = tnph.update_contacts(ts, ts.contacts, *args)
    monkeypatch.setattr(tnph, "CHUNK", chunk)
    got, drop = tnph.update_contacts(ts, ts.contacts, *args)
    assert drop == drop1 == 0
    ntree, gtree = state_to_numpy(dataclasses.replace(ts, contacts=one)), \
        state_to_numpy(dataclasses.replace(ts, contacts=got))
    for k, v in ntree["contacts"].items():
        np.testing.assert_array_equal(gtree["contacts"][k], v, err_msg=k)
    assert ntree["contacts"]["point_valid"].any(1).sum() >= 10


def polyhedron_on_terrain(pkg):
    """``tests/test_mesh.py::test_polyhedron_on_terrain``'s scene: a
    tetrahedron of 0.35 m over a flat 10 x 10 terrain of 1 m cells."""
    verts, tris = make_grid_mesh(10, 10, 1.0)
    b = pkg.WorldBuilder()
    b.make_rigidbody(pkg.RigidBodyDef(
        kind=pkg.KIND_STATIC, shape=pkg.MeshShape(verts, tris),
        material=pkg.Material(friction=0.7)))
    b.make_rigidbody(pkg.RigidBodyDef(
        mass=1.0, shape=pkg.PolyhedronShape(np.array(
            [[0.2, 0.2, 0.2], [0.2, -0.2, -0.2],
             [-0.2, 0.2, -0.2], [-0.2, -0.2, 0.2]], np.float32)),
        position=(0.1, 1.5, -0.1), material=pkg.Material(friction=0.6)))
    return b


def test_points_beside_the_body_in_both_packages(eager_cache):  # noqa: F811
    """ROADMAP R10, why the port's copy of test_polyhedron_on_terrain
    fails: from the port's state at step 58 of that scene, where the
    tetrahedron rests on the flat terrain, the JAX package's
    ``collide_convex_mesh`` (op by op) gives the port's points within 1e-5,
    and in both, points on triangles at least 1 m from the tetrahedron's
    centre (laterally) have a depth."""
    tw = et.make_world(polyhedron_on_terrain(et), device="cpu")
    tw.step(58)
    jw = ej.make_world(polyhedron_on_terrain(ej))
    js = to_jax(state_to_numpy(tw.state), jw.state)
    ka, kb = np.array([1]), np.array([0])
    with jax.disable_jit():
        packed, dims = jsup.pack_side_table(js)
        want = jmk.collide_convex_mesh(
            jsup.side_from_packed(packed[ka], dims),
            jsup.side_from_packed(packed[kb], dims), THRESHOLD,
            mesh_table=js.mesh, mesh_index=js.shape_index[kb])
    ts = tw.state
    tp, td = tsup.pack_side_table(ts)
    tka, tkb = torch.from_numpy(ka), torch.from_numpy(kb)
    got = tmk.collide_convex_mesh(
        tsup.side_from_packed(tp[tka], td), tsup.side_from_packed(tp[tkb], td),
        THRESHOLD, ts.mesh, ts.shape_index[tkb])
    pv = np.asarray(want.point_valid)
    np.testing.assert_array_equal(got.point_valid.numpy(), pv)
    for f in ("pivot_a", "pivot_b", "normal", "distance"):
        np.testing.assert_allclose(getattr(got, f).numpy()[pv],
                                   np.asarray(getattr(want, f))[pv], rtol=0,
                                   atol=1e-5, err_msg=f)
    centre = ts.pos[1].numpy()
    for res in (got, want):
        on_mesh = np.asarray(res.pivot_b)[pv]     # the mesh is at the origin
        beside = np.linalg.norm((on_mesh - centre)[:, [0, 2]], axis=-1)
        depth = np.asarray(res.distance)[pv]
        assert ((beside > 1.0) & (depth < 0.0)).any(), (beside, depth)
