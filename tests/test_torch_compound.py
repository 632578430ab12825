"""Parity of the port's compound shapes with the JAX package: mass
properties, the builder's tables (the compound table, the children's
convex-table rows past the N bodies, ``center_of_mass``), the four compound
narrowphase functions, and K4's side table and plain pre-pass on a table
with child rows.

- ``compound_mass_properties``: inertia and centre of mass within 1e-6 of
  the element plus 1e-9 (both packages compose in float64 around a float32
  rotation matrix).
- Tables: equal, bit for bit.
- ``collide_compound_convex``, ``_plane``, ``_mesh`` and ``_compound`` on
  fixed inputs (every compound against every convex body, the wall plane,
  the terrain mesh and every other compound of a random scene), against
  the JAX functions evaluated op by op (``jax.disable_jit``, see
  ``test_torch_step.py``): point validity equal, every point's fields
  within atol 1e-5 (as ``test_torch_unified.py`` holds K4).
- K4's tables: ``pack_side_table_t`` equal to the JAX package's and
  N columns wide; the plain pre-pass and the plain K4 on the scene's
  UNIFIED pairs bit-equal with and without the child rows.

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
from edyn_tpu.collision.kernels import compound as jck
from edyn_tpu.collision.kernels import pallas_unified as pu
from edyn_tpu.collision.kernels import support as jsup
from edyn_tpu.shapes import compound as jcomp

import edyn_tpu_torch as et
from edyn_tpu_torch.collision.kernels import compound as tck
from edyn_tpu_torch.collision.kernels import support as tsup
from edyn_tpu_torch.collision.kernels import unified_kernel as uk
from edyn_tpu_torch.core.convert import state_from_numpy
from edyn_tpu_torch.shapes import compound as tcomp

from test_torch_step import eager_cache, jtree, one_thread  # noqa: F401

THRESHOLD = 0.01
TET = np.array([[0.15, 0.15, 0.15], [-0.15, -0.15, 0.15],
                [-0.15, 0.15, -0.15], [0.15, -0.15, -0.15]], np.float32)



def chassis(pkg):
    """``examples/vehicle.py``'s chassis shape."""
    return pkg.CompoundShape(children=[
        (pkg.BoxShape((0.9, 0.18, 0.5)), (0, 0, 0), (0, 0, 0, 1)),
        (pkg.BoxShape((0.4, 0.14, 0.45)), (-0.1, 0.3, 0), (0, 0, 0, 1)),
    ])


def dumbbell(pkg):
    """``tests/test_compound.py``'s dumbbell."""
    return pkg.CompoundShape(children=[
        (pkg.SphereShape(0.25), (-0.5, 0, 0), (0, 0, 0, 1)),
        (pkg.SphereShape(0.25), (0.5, 0, 0), (0, 0, 0, 1)),
        (pkg.BoxShape((0.5, 0.08, 0.08)), (0, 0, 0), (0, 0, 0, 1)),
    ])


def mixed(pkg):
    """Rotated children of every convex kind, a polyhedron among them."""
    s = np.sin(0.3)
    return pkg.CompoundShape(children=[
        (pkg.CapsuleShape(0.1, 0.3), (0.2, 0.1, 0), (0, 0, s, np.cos(0.3))),
        (pkg.CylinderShape(0.15, 0.1), (-0.3, 0, 0.1), (s, 0, 0,
                                                       np.cos(0.3))),
        (pkg.PolyhedronShape(TET), (0, -0.2, -0.2), (0, 0, 0, 1)),
        (pkg.SphereShape(0.12), (0, 0.25, 0.2), (0, 0, 0, 1)),
    ])


SHAPES = {"chassis": chassis, "dumbbell": dumbbell, "mixed": mixed}


def compound_world(pkg, seed: int = 0):
    """A bumpy terrain mesh, a wall plane, six compounds (two of each kind,
    one with a ``center_of_mass``) and ten convex bodies, packed close."""
    scenes = importlib.import_module(pkg.__name__ + ".utils.scenes")
    rng = np.random.default_rng(seed)
    verts, tris = scenes.grid_mesh(8, 8, 0.6)
    verts[:, 1] = rng.uniform(-0.08, 0.08, len(verts))
    b = pkg.WorldBuilder()
    b.make_rigidbody(pkg.RigidBodyDef(
        kind=pkg.KIND_STATIC, shape=pkg.MeshShape(verts, tris)))
    b.make_rigidbody(pkg.RigidBodyDef(
        kind=pkg.KIND_STATIC, shape=pkg.PlaneShape((1, 0, 0), -0.2)))
    shapes = {k: f(pkg) for k, f in SHAPES.items()}
    for i, k in enumerate(("chassis", "dumbbell", "mixed") * 2):
        q = rng.normal(size=4)
        b.make_rigidbody(pkg.RigidBodyDef(
            mass=3.0, shape=shapes[k],
            position=(rng.uniform(-1.2, 1.2), rng.uniform(0.0, 0.5),
                      rng.uniform(-1.2, 1.2)),
            orientation=tuple(q / np.linalg.norm(q)),
            center_of_mass=(0.05, -0.1, 0.02) if i == 0 else None))
    kinds = [lambda: pkg.SphereShape(0.2), lambda: pkg.BoxShape((0.2, 0.15,
                                                                 0.1)),
             lambda: pkg.CapsuleShape(0.1, 0.2),
             lambda: pkg.CylinderShape(0.15, 0.12),
             lambda: pkg.PolyhedronShape(TET)]
    for i in range(10):
        q = rng.normal(size=4)
        b.make_rigidbody(pkg.RigidBodyDef(
            mass=1.0, shape=kinds[i % 5](),
            position=(rng.uniform(-1.2, 1.2), rng.uniform(0.0, 0.6),
                      rng.uniform(-1.2, 1.2)),
            orientation=tuple(q / np.linalg.norm(q))))
    return b


COMPOUNDS = np.arange(2, 8)
CONVEX = np.arange(8, 18)


@pytest.fixture(scope="module")
def worlds():
    jw = ej.make_world(compound_world(ej))
    tw = et.make_world(compound_world(et), device="cpu")
    return jw, tw


@pytest.mark.parametrize("shape", list(SHAPES))
def test_compound_mass_properties(shape):
    jI, jc = jcomp.compound_mass_properties(SHAPES[shape](ej), 3.0)
    tI, tc = tcomp.compound_mass_properties(SHAPES[shape](et), 3.0)
    np.testing.assert_allclose(tI, jI, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(tc, jc, rtol=1e-6, atol=1e-9)
    assert jcomp.compound_aabb_extent(SHAPES[shape](ej)) == \
        tcomp.compound_aabb_extent(SHAPES[shape](et))


def test_builder_tables_equal(worlds):
    """The compound table, the convex table with the children's rows past
    the N bodies (a compound body's own row its bounding sphere), the mesh
    table, and the bodies' centres, COM offsets and inverse inertias (the
    first compound has a ``center_of_mass``)."""
    jw, tw = worlds
    want, got = jtree(jw.state), tw.state
    N = got.capacity
    assert got.convex.verts.shape[0] == N + 2 + 3 + 4
    for table in ("compound", "convex", "mesh"):
        for f, w in want[table].items():
            np.testing.assert_array_equal(
                getattr(getattr(got, table), f).numpy(), w,
                err_msg=f"{table}.{f}")
    for f in ("shape_type", "shape_params", "shape_index", "pos", "com",
              "inertia_inv", "aabb_min", "aabb_max"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), want[f],
                                      err_msg=f)
    assert float(got.com[2].abs().sum()) > 0.1


def _sides(js, ts, ka, kb):
    packed, dims = jsup.pack_side_table(js)
    tp, td = tsup.pack_side_table(ts)
    tka, tkb = torch.from_numpy(ka), torch.from_numpy(kb)
    return ((jsup.side_from_packed(packed[ka], dims),
             jsup.side_from_packed(packed[kb], dims)),
            (tsup.side_from_packed(tp[tka], td),
             tsup.side_from_packed(tp[tkb], td)), tka, tkb)


def _pairs(kind):
    if kind == "convex":
        return np.repeat(COMPOUNDS, len(CONVEX)), np.tile(CONVEX,
                                                          len(COMPOUNDS))
    if kind == "plane":
        return COMPOUNDS, np.full(len(COMPOUNDS), 1)
    if kind == "mesh":
        return COMPOUNDS, np.zeros(len(COMPOUNDS), np.int64)
    a, b = np.triu_indices(len(COMPOUNDS), 1)
    return COMPOUNDS[a], COMPOUNDS[b]


@pytest.mark.parametrize("kind", ["convex", "plane", "mesh", "compound"])
def test_compound_kernels_equal(worlds, eager_cache, kind):  # noqa: F811
    jw, tw = worlds
    js = jw.state
    ts = state_from_numpy(jtree(js), "cpu")
    ka, kb = _pairs(kind)
    fn = {"convex": "collide_compound_convex",
          "plane": "collide_compound_plane", "mesh": "collide_compound_mesh",
          "compound": "collide_compound_compound"}[kind]
    kw = {"rim_axes": True} if kind == "mesh" else {}
    with jax.disable_jit():
        (jA, jB), (tA, tB), tka, tkb = _sides(js, ts, ka, kb)
        want = getattr(jck, fn)(js, jnp.asarray(ka), jnp.asarray(kb), jA, jB,
                                THRESHOLD, **kw)
    got = getattr(tck, fn)(ts, tka, tkb, tA, tB, THRESHOLD, **kw)
    pv = np.asarray(want.point_valid)
    np.testing.assert_array_equal(got.point_valid.numpy(), pv)
    assert pv.any(1).sum() >= 2, pv.any(1).sum()
    for f in ("pivot_a", "pivot_b", "normal", "distance"):
        np.testing.assert_allclose(getattr(got, f).numpy()[pv],
                                   np.asarray(getattr(want, f))[pv], rtol=0,
                                   atol=1e-5, err_msg=f)
    for f in ("friction_scale", "restitution_scale", "attachment"):
        np.testing.assert_array_equal(getattr(got, f).numpy()[pv],
                                      np.asarray(getattr(want, f))[pv],
                                      err_msg=f)


def _bits(x):
    return x.contiguous().view(torch.int32)


def test_k4_tables_with_child_rows(worlds):
    """K4 reads body columns only: its side table is the JAX package's and
    N columns wide, and its plain pre-pass and plain per-pair version on
    the scene's UNIFIED pairs give the same bits with the child rows cut
    from the convex table."""
    jw, tw = worlds
    js = jw.state
    ts = state_from_numpy(jtree(js), "cpu")
    N = ts.capacity
    jt, jd = pu.pack_side_table_t(js)
    tbl, dims = uk.pack_side_table_t(ts)
    assert dims == jd and tbl.shape[1] == N
    np.testing.assert_array_equal(tbl.numpy(), np.asarray(jt))
    cut = dataclasses.replace(ts, convex=type(ts.convex)(
        **{f.name: getattr(ts.convex, f.name)[:N]
           for f in dataclasses.fields(ts.convex)}))
    tbl_cut, dims_cut = uk.pack_side_table_t(cut)
    assert dims_cut == dims and torch.equal(tbl_cut, tbl)
    feat = uk.world_features_plain(tbl, dims)
    assert feat[0].shape[0] == N
    ka = torch.from_numpy(np.repeat(CONVEX, len(CONVEX)))
    kb = torch.from_numpy(np.tile(CONVEX, len(CONVEX)))
    keep = ka != kb
    ka, kb = ka[keep], kb[keep]
    got = uk.collide_support_unified(tbl, ka, kb, dims, THRESHOLD, True)
    want = uk.collide_support_plain(tbl_cut[:, ka], tbl_cut[:, kb], dims,
                                    THRESHOLD, True)
    assert torch.equal(_bits(got), _bits(want))
    assert bool((got[..., 11] > 0.5).any())
