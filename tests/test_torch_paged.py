"""The port's PagedTerrain: both tiers against the JAX package's, and the
JAX package's paged terrain tests (``tests/test_paged.py``) on the port's
CPU world.

The parity cases build one terrain in both packages and move a body along
a scripted path with ``set_position`` (no step runs), calling ``update()``
after each move: the pages loaded and unloaded, the callbacks, the slot
maps and the world's validity, shape types and shape indices must be
equal, and in the streaming tier the pool table must be bit-equal to the
JAX package's after every update and after a scripted series of direct
tile writes.
"""
import tempfile

import numpy as np
import pytest

import edyn_tpu as ej
import edyn_tpu_torch as et
from edyn_tpu.shapes.paged import PagedTerrain as JaxPaged
from edyn_tpu_torch.shapes.paged import PagedTerrain
from test_torch_mesh_behaviour import make_grid_mesh, one_thread  # noqa: F401

# a diagonal crossing, a jump back, a stop off the terrain
PATH = ([(-10.0 + 1.5 * k, 1.0, -10.0 + 1.5 * k) for k in range(14)]
        + [(-6.0, 1.0, 8.0), (30.0, 1.0, 30.0), (0.0, 1.0, 0.0)])


def terrain_mesh():
    verts, tris = make_grid_mesh(24, 24, 1.0)
    return verts, tris


def paired(tmp, **kw):
    """The terrain in both packages (JAX first), each with a ball, and
    their callback logs."""
    verts, tris = terrain_mesh()
    out = []
    for pkg, cls in ((ej, JaxPaged), (et, PagedTerrain)):
        log = []
        b = pkg.WorldBuilder()
        extra = {}
        if kw.get("pool_slots"):
            extra["cache_dir"] = f"{tmp}/{pkg.__name__}"
        t = cls(b, verts, tris, tile_size=4.0, prefetch=False,
                on_page_load=lambda k, e, log=log: log.append(("+", k, e)),
                on_page_unload=lambda k, e, log=log: log.append(("-", k, e)),
                **kw, **extra)
        ball = b.make_rigidbody(pkg.RigidBodyDef(
            mass=1.0, shape=pkg.SphereShape(0.3), position=PATH[0]))
        w = (pkg.make_world(b) if pkg is ej
             else pkg.make_world(b, device="cpu"))
        t.attach(w)
        out.append((t, w, ball, log))
    return out


def same_world(jw, tw):
    for f in ("valid", "shape_type", "shape_index"):
        np.testing.assert_array_equal(getattr(tw.state, f).numpy(),
                                      np.asarray(getattr(jw.state, f)),
                                      err_msg=f)


def same_pool(jw, tw):
    for f in ("tri_verts", "tri_normal", "adj_normal", "tri_mask",
              "tri_friction", "tri_restitution", "aabb", "grid",
              "grid_origin", "grid_cell", "grid_axes"):
        np.testing.assert_array_equal(getattr(tw.state.mesh, f).numpy(),
                                      np.asarray(getattr(jw.state.mesh, f)),
                                      err_msg=f)


@pytest.mark.parametrize("pool_slots", [None, 6], ids=["resident",
                                                       "streaming"])
def test_paged_parity(pool_slots):
    with tempfile.TemporaryDirectory() as tmp:
        (jt, jw, jball, jlog), (tt, tw, tball, tlog) = paired(
            tmp, pool_slots=pool_slots)
        assert jt.bodies == tt.bodies and jball == tball
        np.testing.assert_array_equal(np.asarray(tt.centers),
                                      np.asarray(jt.centers))
        same_world(jw, tw)
        counts = []
        for p in PATH:
            jw.set_position(jball, p)
            tw.set_position(tball, p)
            r = jt.update()
            assert tt.update() == r
            counts.append(r)
            assert tt.loaded == jt.loaded and tlog == jlog
            same_world(jw, tw)
            if pool_slots:
                assert tt.slot_tile == jt.slot_tile
                assert tt.tile_slot == jt.tile_slot
                assert tt.prefetch_misses == jt.prefetch_misses
                same_pool(jw, tw)
        assert sum(c[0] for c in counts) > 10 and sum(
            c[1] for c in counts) > 10
        if pool_slots:
            assert tt.refused_loads > 0   # the path overfills the pool
            # a scripted series of tile writes into the pool
            n = len(tt.bodies)
            for slot, k in [(0, 3), (5, n - 1), (2, 7), (0, n // 2)]:
                jt._write_tile(slot, k)
                tt._write_tile(slot, k)
                same_pool(jw, tw)


# --- tests/test_paged.py on the port -------------------------------------
def paged_terrain_streams_and_collides():
    verts, tris = terrain_mesh()
    b = et.WorldBuilder()
    loads, unloads = [], []
    terrain = PagedTerrain(b, verts, tris, tile_size=6.0,
                           on_page_load=lambda k, e: loads.append(k),
                           on_page_unload=lambda k, e: unloads.append(k))
    ball = b.make_rigidbody(et.RigidBodyDef(
        mass=1.0, shape=et.SphereShape(0.3), position=(-8.0, 1.0, -8.0),
        linvel=(8.0, 0, 8.0),
        material=et.Material(friction=0.02, roll_friction=0.0),
        sleeping_disabled=True))
    w = et.make_world(b, device="cpu")
    terrain.attach(w)
    assert terrain.num_loaded == 0
    terrain.update()
    assert terrain.num_loaded >= 1, "page under the ball should load"
    first_loaded = terrain.num_loaded
    ys = []
    for _ in range(150):
        w.step()
        terrain.update()
        ys.append(float(w.position(ball)[1]))
    assert min(ys) > 0.1, min(ys)
    assert len(loads) > first_loaded, "no additional pages streamed in"
    assert len(unloads) >= 1, "left-behind pages never unloaded"
    assert w.position(ball)[0] > -2.0, "ball didn't travel"


def streaming_pool_bounded_memory():
    import os
    verts, tris = terrain_mesh()
    with tempfile.TemporaryDirectory() as cache:
        b = et.WorldBuilder()
        terrain = PagedTerrain(b, verts, tris, tile_size=6.0,
                               pool_slots=4, cache_dir=cache)
        n_tiles = len(terrain.bodies)
        assert n_tiles > 4, "scene must have more tiles than pool slots"
        ball = b.make_rigidbody(et.RigidBodyDef(
            mass=1.0, shape=et.SphereShape(0.3), position=(-8.0, 1.0, -8.0),
            linvel=(8.0, 0, 8.0),
            material=et.Material(friction=0.02, roll_friction=0.0),
            sleeping_disabled=True))
        w = et.make_world(b, device="cpu")
        terrain.attach(w)
        assert w.state.mesh.tri_verts.shape[0] == 4
        assert len(os.listdir(cache)) == n_tiles  # page caches baked
        terrain.update()
        assert terrain.resident_slots_used >= 1
        ys = []
        for _ in range(150):
            w.step()
            terrain.update()
            assert terrain.resident_slots_used <= 4
            ys.append(float(w.position(ball)[1]))
        terrain.stop()
        assert min(ys) > 0.1, min(ys)
        assert float(w.position(ball)[0]) > -2.0
        # a second terrain from the same cache directory skips baking
        b2 = et.WorldBuilder()
        t2 = PagedTerrain(b2, verts, tris, tile_size=6.0, pool_slots=4,
                          cache_dir=cache, prefetch=False)
        assert len(t2._host_tiles) == n_tiles


def prefetch_thread_keeps_loads_off_the_step():
    import time
    verts, tris = terrain_mesh()
    with tempfile.TemporaryDirectory() as cache:
        b = et.WorldBuilder()
        terrain = PagedTerrain(b, verts, tris, tile_size=2.0,
                               pool_slots=24, cache_dir=cache,
                               load_distance=2.0, prefetch_distance=8.0)
        assert len(terrain.bodies) >= 100, len(terrain.bodies)
        assert all(r is None for r in terrain._host_tiles)  # disk only
        ball = b.make_rigidbody(et.RigidBodyDef(
            mass=1.0, shape=et.SphereShape(0.3),
            position=(-10.0, 0.8, -10.0), linvel=(10.0, 0, 10.0),
            material=et.Material(friction=0.02, roll_friction=0.0),
            sleeping_disabled=True))
        w = et.make_world(b, device="cpu")
        terrain.attach(w)
        assert terrain._prefetch_thread is not None
        time.sleep(0.5)  # the prefetcher decodes the starting pages
        terrain.update()
        ys = []
        for _ in range(130):
            w.step()
            w.block_until_ready()
            time.sleep(0.005)  # frame pacing the prefetcher rides on
            terrain.update()
            ys.append(float(w.position(ball)[1]))
        terrain.stop()
        assert min(ys) > 0.1, min(ys)
        assert float(w.position(ball)[0]) > -4.0
        assert terrain.prefetch_misses == 0, \
            f"{terrain.prefetch_misses} loads waited on a disk decode"


CASES = [paged_terrain_streams_and_collides, streaming_pool_bounded_memory,
         prefetch_thread_keeps_loads_off_the_step]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
def test_paged_behaviour(case):
    case()
