"""Paged terrain: a tiled trimesh whose pages stream in and out by
proximity (counterpart of ``edyn_tpu/shapes/paged.py``; reference:
paged_triangle_mesh, include/edyn/shapes/paged_triangle_mesh.hpp, its page
cache serialization/paged_triangle_mesh_s11n and the load hooks of
util/paged_mesh_load_reporting).

Two tiers:

1. resident (``pool_slots=None``): every tile is a mesh-table entry with a
   static body slot baked at build; loading a page sets its body's valid
   flag.
2. streaming (``pool_slots=K``): the world's mesh table is a pool of K tile
   slots. Tile geometry lives on the host (numpy rows, optionally in
   ``.npz`` page caches on disk) and is written into a free pool slot when
   its page loads; an unloaded page frees its slot. The device holds K
   tiles however large the terrain is.

A background thread prefetches (decodes) the rows of pages near the awake
bodies. It reads only the host copy of their positions and velocities
that ``update()`` publishes, never a device tensor; every device write
(tile rows, validity, shape index) happens in ``update()``, on the thread
that steps the world.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..core.builder import Material, RigidBodyDef, WorldBuilder
from ..core.state import KIND_STATIC
from .params import MeshShape, ShapeType


class PagedTerrain:
    """Builds the tile bodies at scene-build time and streams their pages.

    usage:
        terrain = PagedTerrain(builder, vertices, indices, tile_size=8.0)
        world = et.make_world(builder)
        terrain.attach(world)
        ... each frame: terrain.update()  # pages near awake bodies load
    """

    def __init__(self, builder: WorldBuilder, vertices, indices,
                 tile_size: float = 8.0, material: Optional[Material] = None,
                 load_distance: float = 4.0,
                 on_page_load: Optional[Callable] = None,
                 on_page_unload: Optional[Callable] = None,
                 start_loaded: bool = False,
                 pool_slots: Optional[int] = None,
                 cache_dir: Optional[str] = None,
                 prefetch_distance: Optional[float] = None,
                 prefetch: bool = True):
        vertices = np.asarray(vertices, np.float64)
        indices = np.asarray(indices, np.int64)
        material = material or Material(friction=0.7)
        self.tile_size = float(tile_size)
        self.load_distance = float(load_distance)
        # rows decode on the prefetch thread before a body comes close
        # enough to need them (reference: background page-load jobs,
        # triangle_mesh_page_loader.hpp:10)
        self.prefetch_distance = (float(prefetch_distance)
                                  if prefetch_distance is not None
                                  else 3.0 * float(load_distance))
        self.prefetch_enabled = prefetch
        self.prefetch_misses = 0  # loads that found no decoded row
        self.on_page_load = on_page_load
        self.on_page_unload = on_page_unload
        self.world = None
        self.pool_slots = pool_slots
        self.cache_dir = cache_dir
        # every (slot, tile) written, in order (streaming tier)
        self.writes: list[tuple[int, int]] = []
        self.refused_loads = 0  # wanted pages left out for want of a slot
        self._prefetch_thread = None
        self._prefetch_stop = False
        self._ready_lock = threading.Lock()
        self._ready: dict = {}  # tile -> decoded row (prefetch cache)
        # (positions, velocities) of the awake dynamic bodies, host copies
        # published by update() for the prefetch thread
        self._bodies_host = (np.zeros((0, 3), np.float32),
                             np.zeros((0, 3), np.float32))

        # tiles over the dominant plane
        tv = vertices[indices]
        lo = tv.reshape(-1, 3).min(axis=0)
        hi = tv.reshape(-1, 3).max(axis=0)
        up = int(np.argmin(hi - lo))
        axes = [a for a in range(3) if a != up]
        cent = tv.mean(axis=1)
        cx = ((cent[:, axes[0]] - lo[axes[0]]) // tile_size).astype(int)
        cy = ((cent[:, axes[1]] - lo[axes[1]]) // tile_size).astype(int)

        self.bodies: list[int] = []
        self.centers: list[np.ndarray] = []
        self.loaded: list[bool] = []
        tiles: list[MeshShape] = []
        for key in sorted(set(zip(cx.tolist(), cy.tolist()))):
            tri_ids = np.nonzero((cx == key[0]) & (cy == key[1]))[0]
            sub_tris = indices[tri_ids]
            used = np.unique(sub_tris)
            remap = np.full(len(vertices), -1, np.int64)
            remap[used] = np.arange(len(used))
            tile = MeshShape(vertices=vertices[used].astype(np.float32),
                             indices=remap[sub_tris])
            tiles.append(tile)
            # streaming: the body is amorphous until a page load gives it
            # the MESH type and a pool slot
            body = builder.make_rigidbody(RigidBodyDef(
                kind=KIND_STATIC, shape=tile if pool_slots is None else None,
                material=material))
            self.bodies.append(body)
            self.centers.append(tv[tri_ids].reshape(-1, 3).mean(axis=0))
            self.loaded.append(start_loaded if pool_slots is None else False)
        self._centers = np.asarray(self.centers)
        if pool_slots is None:
            self._pending_deactivate = ([] if start_loaded
                                        else list(self.bodies))
        else:
            self._bake_host_tiles(tiles)
            self.tile_slot = [-1] * len(self.bodies)
            self.slot_tile = [-1] * pool_slots

    # -- streaming tier ---------------------------------------------------
    def _bake_host_tiles(self, tiles):
        """Bake every tile to a mesh-table row (numpy), with ``.npz`` page
        caches when ``cache_dir`` is set (reference:
        paged_triangle_mesh_s11n). With a cache directory the rows live on
        disk only: host memory holds each tile's sizes and the prefetch
        cache, so the terrain's size is bounded by the disk."""
        from .mesh import build_grid, preprocess_trimesh
        rows = []
        sizes = []
        for k, tile in enumerate(tiles):
            cache = (os.path.join(self.cache_dir, f"tile_{k}.npz")
                     if self.cache_dir else None)
            if cache and os.path.exists(cache):
                d = np.load(cache)
                row = {n: d[n] for n in d.files}
            else:
                tv, n, adj, fr, re = preprocess_trimesh(tile.vertices,
                                                        tile.indices)
                grid, origin, cell, gaxes, bounds, _ = build_grid(tv)
                row = dict(tv=tv.astype(np.float32), n=n.astype(np.float32),
                           adj=adj.astype(np.float32),
                           fr=fr.astype(np.float32),
                           re=re.astype(np.float32), grid=grid,
                           origin=origin.astype(np.float32),
                           cell=np.float32(cell), axes=gaxes,
                           lo=np.asarray(bounds[0], np.float32),
                           hi=np.asarray(bounds[1], np.float32))
                if cache:
                    os.makedirs(self.cache_dir, exist_ok=True)
                    np.savez_compressed(cache, **row)
            sizes.append((len(row["tv"]),) + row["grid"].shape)
            rows.append(None if self.cache_dir else row)
        self._host_tiles = rows
        self._maxt = max(s[0] for s in sizes)
        self._gx = max(s[1] for s in sizes)
        self._gy = max(s[2] for s in sizes)
        self._gcap = max(s[3] for s in sizes)

    def _get_row(self, k: int):
        """Tile k's decoded row: prefetch cache, then memory, then disk."""
        with self._ready_lock:
            r = self._ready.get(k)
        if r is not None:
            return r
        if self._host_tiles[k] is not None:
            return self._host_tiles[k]
        d = np.load(os.path.join(self.cache_dir, f"tile_{k}.npz"))
        return {n: d[n] for n in d.files}

    def make_pool_table(self, device, dtype=None):
        """An empty pool: ``pool_slots`` mesh-table rows sized to the
        largest tile (``shapes.mesh.MeshTable`` layout), floats at
        ``dtype`` (default the scalar dtype); tiles are staged in float32,
        as the JAX package stages them."""
        from ..config import scalar_dtype
        from .mesh import MeshTable
        K, T = self.pool_slots, self._maxt
        fdt = dtype or scalar_dtype()
        z = lambda *s, dtype=fdt: torch.zeros(s, dtype=dtype, device=device)
        one = lambda *s: torch.ones(s, dtype=fdt, device=device)
        return MeshTable(
            tri_verts=z(K, T, 3, 3), tri_normal=z(K, T, 3),
            adj_normal=z(K, T, 3, 3), tri_mask=z(K, T, dtype=torch.bool),
            tri_friction=one(K, T), tri_restitution=one(K, T),
            aabb=z(K, 2, 3),
            grid=torch.full((K, self._gx, self._gy, self._gcap), -1,
                            dtype=torch.int32, device=device),
            grid_origin=z(K, 2), grid_cell=one(K),
            grid_axes=z(K, 2, dtype=torch.int32))

    def tile_rows(self, k: int) -> dict:
        """Tile k as one pool row of each ``MeshTable`` field (numpy,
        padded to the pool's widths)."""
        r = self._get_row(k)
        T = len(r["tv"])
        pad = lambda x: np.pad(x, [(0, self._maxt - x.shape[0])]
                               + [(0, 0)] * (x.ndim - 1))
        g = np.full((self._gx, self._gy, self._gcap), -1, np.int32)
        g[:r["grid"].shape[0], :r["grid"].shape[1], :r["grid"].shape[2]] = \
            r["grid"]
        mask = np.zeros((self._maxt,), bool)
        mask[:T] = True
        fr = np.ones((self._maxt,), np.float32)
        fr[:T] = r["fr"]
        re = np.ones((self._maxt,), np.float32)
        re[:T] = r["re"]
        return dict(
            tri_verts=pad(r["tv"]), tri_normal=pad(r["n"]),
            adj_normal=pad(r["adj"]), tri_mask=mask, tri_friction=fr,
            tri_restitution=re, aabb=np.stack([r["lo"], r["hi"]]), grid=g,
            grid_origin=np.asarray(r["origin"]),
            grid_cell=np.float32(r["cell"]),
            grid_axes=np.asarray(r["axes"]).astype(np.int32))

    @staticmethod
    def write_rows(table, slot: int, rows: dict):
        """``table`` with pool slot ``slot`` overwritten by ``rows``
        (``tile_rows``): each field a new tensor (an earlier state keeps
        its table), the slot written by slice assignment on the table's
        device."""
        out = {}
        for name, val in rows.items():
            col = getattr(table, name).clone()
            col[slot] = torch.as_tensor(val, dtype=col.dtype,
                                        device=col.device)
            out[name] = col
        return dataclasses.replace(table, **out)

    def _write_tile(self, slot: int, k: int):
        """Write tile k into pool slot ``slot`` of the world's table."""
        st = self.world.state
        self.world.state = dataclasses.replace(
            st, mesh=self.write_rows(st.mesh, slot, self.tile_rows(k)))
        self.writes.append((slot, k))

    # -- background prefetch ---------------------------------------------
    def _near(self, pts, radius: float):
        """[tiles] bool: tile centres within ``radius`` (plus half a tile,
        per axis) of any of ``pts``."""
        if not len(pts):
            return np.zeros(len(self.centers), bool)
        dist = np.abs(pts[None, :, :] - self._centers[:, None, :]).max(-1)
        return (dist < self.tile_size / 2 + radius).any(-1)

    def _near_tiles(self, pos, vel, radius: float, horizon: float = 0.25):
        """Tile ids whose centre is within ``radius`` of a position or of
        its velocity-predicted position ``horizon`` seconds ahead."""
        if not len(pos):
            return []
        pts = np.concatenate([pos, pos + vel * horizon])
        return np.nonzero(self._near(pts, radius))[0].tolist()

    def _prefetch_loop(self):
        while not self._prefetch_stop:
            pos, vel = self._bodies_host
            want = self._near_tiles(pos, vel, self.prefetch_distance)
            with self._ready_lock:
                have = set(self._ready)
            for k in want:
                if self._prefetch_stop:
                    return
                if k in have or self.loaded[k]:
                    continue
                try:
                    row = self._get_row(k)  # disk decode off the sim thread
                except FileNotFoundError:
                    # only while the cache directory is being torn down
                    if self._prefetch_stop:
                        return
                    raise
                with self._ready_lock:
                    self._ready[k] = row
            # drop rows that fell out of range (bounds host memory)
            keep = set(want)
            with self._ready_lock:
                for k in list(self._ready):
                    if k not in keep:
                        del self._ready[k]
            time.sleep(0.01)

    def stop(self):
        """Stop the prefetch thread (streaming tier)."""
        self._prefetch_stop = True
        if self._prefetch_thread is not None:
            self._prefetch_thread.join(timeout=2.0)
            self._prefetch_thread = None

    def attach(self, world):
        self.world = world
        if self.pool_slots is None:
            if self._pending_deactivate:
                self._set_valid(self._pending_deactivate, False)
                self._pending_deactivate = []
            return self
        st = world.state
        idx = torch.as_tensor(self.bodies, dtype=torch.long,
                              device=st.device)
        valid = st.valid.clone()
        valid[idx] = False
        stype = st.shape_type.clone()
        stype[idx] = int(ShapeType.MESH)
        world.state = dataclasses.replace(
            st, mesh=self.make_pool_table(st.device, st.dtype), valid=valid,
            shape_type=stype)
        world.meta = dataclasses.replace(
            world.meta,
            types_present=world.meta.types_present | {int(ShapeType.MESH)})
        if self.prefetch_enabled:
            self._publish_bodies(world.state)
            self._prefetch_thread = threading.Thread(
                target=self._prefetch_loop, daemon=True,
                name="edyn-terrain-prefetch")
            self._prefetch_thread.start()
        return self

    def _set_valid(self, bodies, value: bool):
        st = self.world.state
        valid = st.valid.clone()
        valid[torch.as_tensor(bodies, dtype=torch.long,
                              device=st.device)] = value
        self.world.state = dataclasses.replace(st, valid=valid)

    def _publish_bodies(self, st):
        """Host copies of the awake dynamic bodies' positions and
        velocities, for the prefetch thread; returns the positions."""
        # host read: the JAX package reads these as numpy
        awake = (st.is_dynamic & ~st.asleep).cpu().numpy()
        pos = st.pos.cpu().numpy()[awake]
        self._bodies_host = (pos, st.linvel.cpu().numpy()[awake])
        return pos

    def update(self):
        """Load the pages near awake dynamic bodies and unload the rest
        (the reference's proximity-driven page loader); in the streaming
        tier a load writes the tile into a free pool slot. Returns (pages
        loaded, pages unloaded)."""
        if self.world is None:
            raise RuntimeError("call attach(world) first")
        pos = self._publish_bodies(self.world.state)
        # the nearest body's distance per tile (max-norm), nearest first:
        # when the pool cannot hold every page in range, the pages under
        # bodies win the slots
        if len(pos):
            dist = np.abs(pos[None, :, :]
                          - self._centers[:, None, :]).max(-1).min(-1)
        else:
            dist = np.full(len(self.centers), np.inf)
        near = dist < self.tile_size / 2 + self.load_distance
        loaded = np.asarray(self.loaded, bool)
        load_k = np.nonzero(near & ~loaded)[0]
        want_load = load_k[np.lexsort((load_k, dist[load_k]))].tolist()
        want_unload = np.nonzero(~near & loaded)[0].tolist()

        if self.pool_slots is None:
            for k in want_load:
                self.loaded[k] = True
                if self.on_page_load:
                    self.on_page_load(k, self.bodies[k])
            for k in want_unload:
                self.loaded[k] = False
                if self.on_page_unload:
                    self.on_page_unload(k, self.bodies[k])
            if want_load:
                self._set_valid([self.bodies[k] for k in want_load], True)
            if want_unload:
                self._set_valid([self.bodies[k] for k in want_unload], False)
            return len(want_load), len(want_unload)

        # streaming: free the unloaded pages' slots, then fill
        for k in want_unload:
            self.loaded[k] = False
            slot = self.tile_slot[k]
            self.tile_slot[k] = -1
            if slot >= 0:
                self.slot_tile[slot] = -1
        if want_unload:
            self._set_valid([self.bodies[k] for k in want_unload], False)
        if self.on_page_unload:
            for k in want_unload:
                self.on_page_unload(k, self.bodies[k])
        placed = []
        for n, k in enumerate(want_load):
            try:
                slot = self.slot_tile.index(-1)
            except ValueError:
                # pool exhausted: the farther pages stay unloaded
                self.refused_loads += len(want_load) - n
                break
            self.slot_tile[slot] = k
            self.tile_slot[k] = slot
            with self._ready_lock:
                was_ready = (k in self._ready
                             or self._host_tiles[k] is not None)
            if not was_ready:
                self.prefetch_misses += 1
            self._write_tile(slot, k)
            placed.append((k, self.bodies[k], slot))
            self.loaded[k] = True
        if placed:
            st = self.world.state
            body = torch.as_tensor([b for _, b, _ in placed],
                                   dtype=torch.long, device=st.device)
            sindex = st.shape_index.clone()
            sindex[body] = torch.as_tensor(
                [s for _, _, s in placed], dtype=sindex.dtype,
                device=st.device)
            valid = st.valid.clone()
            valid[body] = True
            self.world.state = dataclasses.replace(st, shape_index=sindex,
                                                   valid=valid)
        if self.on_page_load:
            for k, body, _ in placed:
                self.on_page_load(k, body)
        return len(placed), len(want_unload)

    @property
    def resident_slots_used(self) -> int:
        if self.pool_slots is None:
            return sum(self.loaded)
        return sum(1 for t in self.slot_tile if t >= 0)

    @property
    def num_loaded(self) -> int:
        return sum(self.loaded)
