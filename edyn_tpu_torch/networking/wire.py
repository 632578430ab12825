"""Wire codec: every packet type <-> bytes, with zero pickling (counterpart
of ``edyn_tpu/networking/wire.py``, byte for byte the same frames).

Reference: the packet layer serializes through byte archives
(include/edyn/serialization/memory_archive.hpp) and classifies reliability
per type (include/edyn/networking/packet/edyn_packet.hpp:29-88). Each
packet encodes to a self-describing frame:

    [type: u8][timestamp: f64 LE][payload ...]

Payload primitives:
  - varint          unsigned LEB128 (counts, lengths, small ids)
  - svarint         zigzag signed varint
  - entity arrays   delta + zigzag varint (csrc/edyn_native.cpp:166
                    ``edyn_varint_encode_deltas`` when the native library is
                    built; otherwise the bit-identical numpy code below)
  - ndarray         [dtype u8][ndim u8][dims varint...][raw LE bytes]
  - str             varint length + UTF-8
  - json blob       str of canonical JSON (rigidbody defs only: rare,
                    structure-heavy creation packets)

The codec runs on the host: snapshots reach it as numpy pools
(``replication.snapshot``), in the JAX package's dtypes. A decoded packet
compares equal field by field with the original; nothing in the stream is
executable. Malformed or truncated frames raise ``WireError`` (reference
analogue: packet validation, Design.md:381-383).
"""
from __future__ import annotations

import json
import struct
from typing import List, Tuple

import numpy as np

from ..replication.snapshot import RegistrySnapshot
from . import packets as pk
from .input_history import InputRecord


class WireError(ValueError):
    pass


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def _w_varint(out: bytearray, v: int):
    if v < 0:
        raise WireError(f"varint must be >= 0, got {v}")
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _r_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    v = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise WireError("truncated varint")
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        shift += 7
        if not (b & 0x80):
            return v, pos
        if shift > 63:
            raise WireError("varint overflow")


def _w_svarint(out: bytearray, v: int):
    _w_varint(out, (v << 1) ^ (v >> 63) if v < 0 else (v << 1))


def _r_svarint(buf, pos):
    u, pos = _r_varint(buf, pos)
    return (u >> 1) ^ -(u & 1), pos


def _w_str(out: bytearray, s: str):
    raw = s.encode("utf-8")
    _w_varint(out, len(raw))
    out.extend(raw)


def _r_str(buf, pos):
    n, pos = _r_varint(buf, pos)
    if pos + n > len(buf):
        raise WireError("truncated string")
    return bytes(buf[pos:pos + n]).decode("utf-8"), pos + n


def _w_f64(out: bytearray, v: float):
    out.extend(struct.pack("<d", float(v)))


def _r_f64(buf, pos):
    if pos + 8 > len(buf):
        raise WireError("truncated f64")
    return struct.unpack_from("<d", buf, pos)[0], pos + 8


# numpy dtype codes (stable on the wire)
_DTYPES = [np.dtype(np.float32), np.dtype(np.float64), np.dtype(np.int32),
           np.dtype(np.int64), np.dtype(np.uint32), np.dtype(np.uint8),
           np.dtype(np.bool_), np.dtype(np.float16), np.dtype(np.int8),
           np.dtype(np.uint64), np.dtype(np.int16), np.dtype(np.uint16)]
_DTYPE_CODE = {dt: i for i, dt in enumerate(_DTYPES)}


def _w_ndarray(out: bytearray, a: np.ndarray):
    a = np.ascontiguousarray(a)
    if a.dtype not in _DTYPE_CODE:
        raise WireError(f"unsupported wire dtype {a.dtype}")
    out.append(_DTYPE_CODE[a.dtype])
    out.append(a.ndim)
    for d in a.shape:
        _w_varint(out, d)
    out.extend(a.astype(a.dtype.newbyteorder("<"), copy=False).tobytes())


def _r_ndarray(buf, pos):
    if pos + 2 > len(buf):
        raise WireError("truncated ndarray header")
    code = buf[pos]
    ndim = buf[pos + 1]
    pos += 2
    if code >= len(_DTYPES) or ndim > 8:
        raise WireError("bad ndarray header")
    shape = []
    for _ in range(ndim):
        d, pos = _r_varint(buf, pos)
        shape.append(d)
    dt = _DTYPES[code].newbyteorder("<")
    count = int(np.prod(shape, dtype=np.int64)) if shape else 1
    nbytes = count * dt.itemsize
    if pos + nbytes > len(buf):
        raise WireError("truncated ndarray data")
    a = np.frombuffer(buf, dtype=dt, count=count, offset=pos)
    return a.reshape(shape).astype(_DTYPES[code]), pos + nbytes


def _encode_deltas_py(values: np.ndarray) -> bytes:
    """Delta + zigzag LEB128 of an id array, without the native library:
    every value's bytes at once (numpy), the same bytes as the native
    encoder and the JAX package's per-value loop."""
    v = np.asarray(values).astype(np.int64)
    if not len(v):
        return b""
    d = np.diff(v, prepend=np.int64(0))
    zz = ((d << 1) ^ (d >> 63)).view(np.uint64)
    nb = np.ones(len(zz), np.int64)
    for k in range(1, 10):
        nb += zz >= np.uint64(1) << np.uint64(7 * k)
    start = np.cumsum(nb) - nb
    out = np.empty(int(nb.sum()), np.uint8)
    for k in range(int(nb.max())):
        m = nb > k
        byte = (zz[m] >> np.uint64(7 * k)) & np.uint64(0x7F)
        byte |= np.where(nb[m] - 1 > k, np.uint64(0x80), np.uint64(0))
        out[start[m] + k] = byte.astype(np.uint8)
    return out.tobytes()


def _decode_deltas_py(data: bytes, n: int) -> np.ndarray:
    """Inverse of ``_encode_deltas_py``: the first ``n`` ids of ``data``
    (later bytes are ignored, as the per-value loop ignores them)."""
    if n == 0:
        return np.empty(0, np.int32)
    raw = np.frombuffer(data, np.uint8)
    ends = np.flatnonzero((raw & 0x80) == 0)
    if len(ends) < n:
        raise WireError("truncated entity deltas")
    ends = ends[:n]
    raw = raw[:ends[-1] + 1]
    starts = np.concatenate([[0], ends[:-1] + 1])
    if (ends - starts).max() >= 10:
        raise WireError("entity delta overflow")
    group = np.repeat(np.arange(n), ends - starts + 1)
    shift = (7 * (np.arange(len(raw)) - starts[group])).astype(np.uint64)
    parts = (raw & 0x7F).astype(np.uint64) << shift
    zz = np.bitwise_or.reduceat(parts, starts)
    d = (zz >> np.uint64(1)).view(np.int64) ^ -(zz & np.uint64(1)).view(
        np.int64)
    return np.cumsum(d).astype(np.int32)


def varint_encoder() -> str:
    """Which entity-array encoder this process uses: "native" (the built
    ``csrc`` library) or "numpy"."""
    from ..native.loader import lib
    return "native" if lib() is not None else "numpy"


def _w_entities(out: bytearray, ent: np.ndarray):
    """Sorted-ish int32 id arrays: delta varint via the native encoder
    (csrc/edyn_native.cpp:166) or the numpy fallback."""
    ent = np.ascontiguousarray(ent, np.int32)
    _w_varint(out, len(ent))
    from ..native.loader import lib
    L = lib()
    if L is not None and len(ent):
        need = L.edyn_varint_encode_deltas(ent, len(ent), None)
        raw = np.empty(need, np.uint8)
        L.edyn_varint_encode_deltas(ent, len(ent), raw.ctypes.data)
        payload = raw.tobytes()
    else:
        payload = _encode_deltas_py(ent)
    _w_varint(out, len(payload))
    out.extend(payload)


def _r_entities(buf, pos) -> Tuple[np.ndarray, int]:
    n, pos = _r_varint(buf, pos)
    nb, pos = _r_varint(buf, pos)
    if pos + nb > len(buf):
        raise WireError("truncated entity array")
    raw = bytes(buf[pos:pos + nb])
    pos += nb
    from ..native.loader import lib
    L = lib()
    if L is not None and n:
        out = np.empty(n, np.int32)
        raw_a = np.frombuffer(raw, np.uint8)
        got = L.edyn_varint_decode_deltas(raw_a, len(raw_a), out, n)
        if got != n:
            raise WireError("entity delta count mismatch")
        return out, pos
    return _decode_deltas_py(raw, n), pos


# ---------------------------------------------------------------------------
# composites
# ---------------------------------------------------------------------------

def _w_snapshot(out: bytearray, snap: RegistrySnapshot):
    _w_f64(out, snap.timestamp)
    _w_entities(out, snap.entities)
    _w_varint(out, len(snap.pools))
    for name, pool in snap.pools.items():
        _w_str(out, name)
        _w_ndarray(out, np.asarray(pool))


def _r_snapshot(buf, pos) -> Tuple[RegistrySnapshot, int]:
    ts, pos = _r_f64(buf, pos)
    ent, pos = _r_entities(buf, pos)
    np_pools, pos = _r_varint(buf, pos)
    pools = {}
    for _ in range(np_pools):
        name, pos = _r_str(buf, pos)
        arr, pos = _r_ndarray(buf, pos)
        pools[name] = arr
    return RegistrySnapshot(entities=ent, pools=pools, timestamp=ts), pos


def _w_json(out: bytearray, obj):
    _w_str(out, json.dumps(obj, separators=(",", ":"), sort_keys=True))


def _r_json(buf, pos):
    s, pos = _r_str(buf, pos)
    return json.loads(s), pos


def _w_records(out: bytearray, records: List[InputRecord]):
    _w_varint(out, len(records))
    for r in records:
        _w_f64(out, r.timestamp)
        _w_str(out, r.component)
        _w_entities(out, np.asarray(r.entities, np.int32))
        _w_ndarray(out, np.asarray(r.values))


def _r_records(buf, pos) -> Tuple[List[InputRecord], int]:
    n, pos = _r_varint(buf, pos)
    recs = []
    for _ in range(n):
        ts, pos = _r_f64(buf, pos)
        name, pos = _r_str(buf, pos)
        ent, pos = _r_entities(buf, pos)
        vals, pos = _r_ndarray(buf, pos)
        recs.append(InputRecord(timestamp=ts, component=name,
                                entities=ent, values=vals))
    return recs, pos


# ---------------------------------------------------------------------------
# packet table
# ---------------------------------------------------------------------------

# stable wire ids (reference: edyn_packet variant order, edyn_packet.hpp:29-47)
_PACKET_TYPES = [
    pk.ClientCreatedEntity,   # 0
    pk.ClientDestroyedEntity,  # 1
    pk.EntityEntered,          # 2
    pk.EntityExited,           # 3
    pk.UpdateEntityMap,        # 4
    pk.TransientSnapshot,      # 5
    pk.GeneralSnapshot,        # 6
    pk.TimeRequest,            # 7
    pk.TimeResponse,           # 8
    pk.ServerSettings,         # 9
    pk.SetPlayoutDelay,        # 10
    pk.ActionPacket,           # 11
    pk.InputSnapshot,          # 12
    pk.AssetRequest,           # 13
    pk.AssetResponse,          # 14
    pk.SetAabbOfInterest,      # 15
    pk.QueryEntity,            # 16
    pk.EntityResponse,         # 17
]
_TYPE_ID = {t: i for i, t in enumerate(_PACKET_TYPES)}


def encode_packet(p: pk.Packet) -> bytes:
    tid = _TYPE_ID.get(type(p))
    if tid is None:
        raise WireError(f"unregistered packet type {type(p).__name__}")
    out = bytearray()
    out.append(tid)
    _w_f64(out, p.timestamp)

    if isinstance(p, pk.ClientCreatedEntity):
        _w_entities(out, np.asarray(p.entities, np.int32))
        _w_json(out, p.defs)
    elif isinstance(p, (pk.ClientDestroyedEntity, pk.EntityExited)):
        _w_entities(out, np.asarray(p.entities, np.int32))
    elif isinstance(p, pk.EntityEntered):
        _w_snapshot(out, p.snapshot)
        items = sorted(p.owners.items())
        _w_entities(out, np.asarray([e for e, _ in items], np.int32))
        _w_entities(out, np.asarray([o for _, o in items], np.int32))
        aitems = sorted(p.assets.items())
        _w_entities(out, np.asarray([e for e, _ in aitems], np.int32))
        _w_entities(out, np.asarray([a for _, a in aitems], np.int32))
    elif isinstance(p, pk.AssetRequest):
        _w_entities(out, np.asarray(p.ids, np.int32))
    elif isinstance(p, pk.AssetResponse):
        _w_entities(out, np.asarray(sorted(p.assets), np.int32))
        _w_json(out, [p.assets[k] for k in sorted(p.assets)])
    elif isinstance(p, pk.UpdateEntityMap):
        _w_entities(out, np.asarray([a for a, _ in p.pairs], np.int32))
        _w_entities(out, np.asarray([b for _, b in p.pairs], np.int32))
    elif isinstance(p, pk.InputSnapshot):
        _w_entities(out, np.asarray([p.entity], np.int32))
        _w_records(out, p.records)
    elif isinstance(p, (pk.TransientSnapshot, pk.GeneralSnapshot)):
        _w_snapshot(out, p.snapshot)
    elif isinstance(p, pk.TimeRequest):
        _w_varint(out, p.id)
    elif isinstance(p, pk.TimeResponse):
        _w_varint(out, p.id)
        _w_f64(out, p.origin_time)
    elif isinstance(p, pk.ServerSettings):
        _w_f64(out, p.fixed_dt)
        for g in p.gravity:
            _w_f64(out, g)
        _w_f64(out, p.playout_delay_multiplier)
        _w_varint(out, 1 if p.allow_full_ownership else 0)
    elif isinstance(p, pk.SetPlayoutDelay):
        _w_f64(out, p.delay)
    elif isinstance(p, pk.SetAabbOfInterest):
        for v in (*p.lo, *p.hi):
            _w_f64(out, v)
    elif isinstance(p, pk.QueryEntity):
        _w_varint(out, p.id)
        _w_varint(out, len(p.queries))
        for ent, comps in p.queries:
            _w_svarint(out, int(ent))
            _w_varint(out, len(comps))
            for cname in comps:
                _w_str(out, cname)
    elif isinstance(p, pk.EntityResponse):
        _w_varint(out, p.id)
        _w_snapshot(out, p.snapshot)
    elif isinstance(p, pk.ActionPacket):
        _w_svarint(out, p.entity)
        _w_varint(out, len(p.actions))
        for t, payload in p.actions:
            _w_f64(out, t)
            _w_ndarray(out, np.asarray(payload))
    return bytes(out)


def decode_packet(data: bytes) -> pk.Packet:
    buf = memoryview(data)
    if len(buf) < 9:
        raise WireError("frame too short")
    tid = buf[0]
    if tid >= len(_PACKET_TYPES):
        raise WireError(f"unknown packet type id {tid}")
    cls = _PACKET_TYPES[tid]
    ts, pos = _r_f64(buf, 1)

    if cls is pk.ClientCreatedEntity:
        ent, pos = _r_entities(buf, pos)
        defs, pos = _r_json(buf, pos)
        return pk.ClientCreatedEntity(timestamp=ts, entities=ent.tolist(),
                                      defs=defs)
    if cls in (pk.ClientDestroyedEntity, pk.EntityExited):
        ent, pos = _r_entities(buf, pos)
        return cls(timestamp=ts, entities=ent.tolist())
    if cls is pk.EntityEntered:
        snap, pos = _r_snapshot(buf, pos)
        ents, pos = _r_entities(buf, pos)
        owners, pos = _r_entities(buf, pos)
        aents, pos = _r_entities(buf, pos)
        aids, pos = _r_entities(buf, pos)
        return pk.EntityEntered(timestamp=ts, snapshot=snap,
                                owners=dict(zip(ents.tolist(),
                                                owners.tolist())),
                                assets=dict(zip(aents.tolist(),
                                                aids.tolist())))
    if cls is pk.AssetRequest:
        ids, pos = _r_entities(buf, pos)
        return pk.AssetRequest(timestamp=ts, ids=ids.tolist())
    if cls is pk.AssetResponse:
        ids, pos = _r_entities(buf, pos)
        defs, pos = _r_json(buf, pos)
        return pk.AssetResponse(timestamp=ts,
                                assets=dict(zip(ids.tolist(), defs)))
    if cls is pk.UpdateEntityMap:
        a, pos = _r_entities(buf, pos)
        b, pos = _r_entities(buf, pos)
        return pk.UpdateEntityMap(timestamp=ts,
                                  pairs=list(zip(a.tolist(), b.tolist())))
    if cls is pk.InputSnapshot:
        ent, pos = _r_entities(buf, pos)
        recs, pos = _r_records(buf, pos)
        return pk.InputSnapshot(timestamp=ts, entity=int(ent[0]),
                                records=recs)
    if cls in (pk.TransientSnapshot, pk.GeneralSnapshot):
        snap, pos = _r_snapshot(buf, pos)
        return cls(timestamp=ts, snapshot=snap)
    if cls is pk.TimeRequest:
        i, pos = _r_varint(buf, pos)
        return pk.TimeRequest(timestamp=ts, id=i)
    if cls is pk.TimeResponse:
        i, pos = _r_varint(buf, pos)
        ot, pos = _r_f64(buf, pos)
        return pk.TimeResponse(timestamp=ts, id=i, origin_time=ot)
    if cls is pk.ServerSettings:
        dt, pos = _r_f64(buf, pos)
        g = []
        for _ in range(3):
            gi, pos = _r_f64(buf, pos)
            g.append(gi)
        pm, pos = _r_f64(buf, pos)
        afo, pos = _r_varint(buf, pos)
        return pk.ServerSettings(timestamp=ts, fixed_dt=dt, gravity=tuple(g),
                                 playout_delay_multiplier=pm,
                                 allow_full_ownership=bool(afo))
    if cls is pk.SetPlayoutDelay:
        d, pos = _r_f64(buf, pos)
        return pk.SetPlayoutDelay(timestamp=ts, delay=d)
    if cls is pk.SetAabbOfInterest:
        vs = []
        for _ in range(6):
            v, pos = _r_f64(buf, pos)
            vs.append(v)
        return pk.SetAabbOfInterest(timestamp=ts, lo=tuple(vs[:3]),
                                    hi=tuple(vs[3:]))
    if cls is pk.QueryEntity:
        qid, pos = _r_varint(buf, pos)
        n, pos = _r_varint(buf, pos)
        queries = []
        for _ in range(n):
            e, pos = _r_svarint(buf, pos)
            m, pos = _r_varint(buf, pos)
            comps = []
            for _ in range(m):
                cname, pos = _r_str(buf, pos)
                comps.append(cname)
            queries.append((e, comps))
        return pk.QueryEntity(timestamp=ts, id=qid, queries=queries)
    if cls is pk.EntityResponse:
        qid, pos = _r_varint(buf, pos)
        snap, pos = _r_snapshot(buf, pos)
        return pk.EntityResponse(timestamp=ts, id=qid, snapshot=snap)
    if cls is pk.ActionPacket:
        e, pos = _r_svarint(buf, pos)
        n, pos = _r_varint(buf, pos)
        actions = []
        for _ in range(n):
            t, pos = _r_f64(buf, pos)
            a, pos = _r_ndarray(buf, pos)
            actions.append((t, a))
        return pk.ActionPacket(timestamp=ts, entity=e, actions=actions)
    raise WireError(f"no decoder for {cls.__name__}")
