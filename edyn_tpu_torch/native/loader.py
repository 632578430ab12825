"""ctypes loader for the native C++ runtime helpers (``csrc/edyn_native.cpp``),
the port's own copy of ``edyn_tpu/native/loader.py``.

The library speeds up host-side work: trimesh preprocessing (edge
adjacency), candidate-grid baking, OBJ parsing and the snapshot varint
framing of ``networking/wire.py``. Every entry point has a Python
fallback, so the library is an accelerator, not a dependency. Build it
with ``make -C csrc``; ``lib()`` is None when it is not built.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

_lib = None
_tried = False


def lib():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    here = os.path.dirname(os.path.abspath(__file__))
    for cand in (os.path.join(here, "libedyn_native.so"),
                 os.path.join(here, "..", "..", "csrc", "libedyn_native.so")):
        if os.path.exists(cand):
            try:
                _lib = ctypes.CDLL(cand)
                _configure(_lib)
                break
            except OSError:
                _lib = None
    return _lib


def _configure(L):
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    c = ctypes

    L.edyn_adjacent_normals.argtypes = [i64p, c.c_long, f64p, f64p]
    L.edyn_adjacent_normals.restype = None

    L.edyn_bake_grid.argtypes = [f64p, c.c_long, c.c_int, c.c_int,
                                 c.c_double, c.c_double, c.c_double,
                                 c.c_double, c.c_int, c.c_int, c.c_int,
                                 i32p, i32p]
    L.edyn_bake_grid.restype = c.c_long

    L.edyn_parse_obj.argtypes = [c.c_char_p, c.POINTER(c.c_long),
                                 c.POINTER(c.c_long),
                                 c.c_void_p, c.c_void_p, c.c_void_p]
    L.edyn_parse_obj.restype = c.c_int

    L.edyn_varint_encode_deltas.argtypes = [i32p, c.c_long, c.c_void_p]
    L.edyn_varint_encode_deltas.restype = c.c_long
    L.edyn_varint_decode_deltas.argtypes = [u8p, c.c_long, i32p, c.c_long]
    L.edyn_varint_decode_deltas.restype = c.c_long


def adjacent_normals(indices: np.ndarray, normals: np.ndarray) -> np.ndarray:
    """Edge-adjacent normals per triangle edge via the native hash map."""
    L = lib()
    T = len(indices)
    out = np.repeat(np.ascontiguousarray(normals, np.float64)[:, None, :], 3, 1)
    out = np.ascontiguousarray(out)
    L.edyn_adjacent_normals(
        np.ascontiguousarray(indices, np.int64), T,
        np.ascontiguousarray(normals, np.float64), out.reshape(-1))
    return out


def bake_grid(tv: np.ndarray, ax0: int, ax1: int, origin, cell_size: float,
              margin: float, gx: int, gy: int, cap: int):
    """Returns (grid [gx,gy,cap] int32, overflow)."""
    L = lib()
    grid = np.full((gx, gy, cap), -1, np.int32)
    counts = np.zeros((gx, gy), np.int32)
    overflow = L.edyn_bake_grid(
        np.ascontiguousarray(tv, np.float64).reshape(-1), len(tv),
        ax0, ax1, float(origin[0]), float(origin[1]), float(cell_size),
        float(margin), gx, gy, cap, grid.reshape(-1), counts.reshape(-1))
    return grid, int(overflow)


def parse_obj(path: str):
    """Returns (verts [V,3], colors [V,3], faces [F,3]) or None if the native
    lib is unavailable."""
    import ctypes as c
    L = lib()
    if L is None:
        return None
    nv = c.c_long(0)
    nf = c.c_long(0)
    rc = L.edyn_parse_obj(path.encode(), c.byref(nv), c.byref(nf),
                          None, None, None)
    if rc != 0:
        raise FileNotFoundError(path)
    verts = np.zeros((nv.value, 3), np.float64)
    colors = np.ones((nv.value, 3), np.float64)
    faces = np.zeros((nf.value, 3), np.int64)
    L.edyn_parse_obj(path.encode(), c.byref(nv), c.byref(nf),
                     verts.ctypes.data_as(c.c_void_p),
                     colors.ctypes.data_as(c.c_void_p),
                     faces.ctypes.data_as(c.c_void_p))
    return verts, colors, faces


def varint_encode(values: np.ndarray) -> bytes:
    L = lib()
    vals = np.ascontiguousarray(values, np.int32)
    n = L.edyn_varint_encode_deltas(vals, len(vals), None)
    out = np.zeros(n, np.uint8)
    L.edyn_varint_encode_deltas(vals, len(vals),
                                out.ctypes.data_as(ctypes.c_void_p))
    return out.tobytes()


def varint_decode(blob: bytes, max_out: int) -> np.ndarray:
    L = lib()
    data = np.frombuffer(blob, np.uint8)
    out = np.zeros(max_out, np.int32)
    n = L.edyn_varint_decode_deltas(np.ascontiguousarray(data), len(data),
                                    out, max_out)
    return out[:n]
