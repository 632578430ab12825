"""The port's wire codec against the JAX package's, byte for byte.

Every packet of ``tests/test_wire.py``'s ``ROUNDTRIP_CASES`` is built in
both packages (the port's from the JAX one, field by field) and must
encode to identical bytes; each package decodes the other's bytes to the
packet it started from. Snapshots the port extracts from a state encode to
the bytes of the JAX package's snapshot of the same state (the state of
``test_torch_checkpoint``). Truncated and garbage frames raise
``WireError``, and the port's numpy varint code gives the JAX package's
per-value loop's bytes on random id arrays. All exact.
"""
import dataclasses

import numpy as np
import pytest

from edyn_tpu.networking import wire as jwire
from edyn_tpu.replication import snapshot as jsn
from edyn_tpu_torch.networking import input_history as tih
from edyn_tpu_torch.networking import packets as tpk
from edyn_tpu_torch.networking import wire as twire
from edyn_tpu_torch.replication import snapshot as tsn
from test_torch_checkpoint import worlds  # noqa: F401
from test_torch_step import one_thread  # noqa: F401
from test_wire import ROUNDTRIP_CASES

_PORT_TYPES = {c.__name__: c for c in (
    *[getattr(tpk, n) for n in dir(tpk)], tsn.RegistrySnapshot,
    tih.InputRecord) if isinstance(c, type)}


def to_port(x):
    """A JAX package packet (or snapshot, record) as the port's."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        cls = _PORT_TYPES[type(x).__name__]
        return cls(**{f.name: to_port(getattr(x, f.name))
                      for f in dataclasses.fields(x)})
    if isinstance(x, list):
        return [to_port(v) for v in x]
    if isinstance(x, tuple):
        return tuple(to_port(v) for v in x)
    if isinstance(x, dict):
        return {k: to_port(v) for k, v in x.items()}
    return x


def assert_same(a, b, path="packet"):
    """Field-by-field equality across packages (arrays with their dtypes)."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{path}.{f.name}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for k, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{k}]")
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    else:
        assert a == b and type(a) is type(b), (path, a, b)


@pytest.mark.parametrize("packet", ROUNDTRIP_CASES,
                         ids=[type(p).__name__ for p in ROUNDTRIP_CASES])
def test_same_bytes_both_ways(packet):
    port = to_port(packet)
    raw = jwire.encode_packet(packet)
    assert twire.encode_packet(port) == raw
    assert_same(twire.decode_packet(raw), jwire.decode_packet(raw))
    assert tpk.should_send_reliably(port) == \
        jwire.pk.should_send_reliably(packet)


@pytest.mark.parametrize("kind", ["TransientSnapshot", "EntityEntered",
                                  "GeneralSnapshot"])
def test_extracted_snapshots_encode_alike(worlds, kind):
    jw, tw = worlds
    ent = [0, 2, 3, 9, 17, 21, 35]
    comps = (jsn.TRANSIENT_COMPONENTS if kind == "TransientSnapshot"
             else jsn.CREATION_COMPONENTS)
    js = jsn.extract_snapshot(jw.state, ent, comps, timestamp=4.25)
    ts = tsn.extract_snapshot(tw.state, ent, comps, timestamp=4.25)
    jcls = getattr(jwire.pk, kind)
    extra = {"owners": {2: 1, 9: 2}} if kind == "EntityEntered" else {}
    raw = jwire.encode_packet(jcls(timestamp=4.5, snapshot=js, **extra))
    assert twire.encode_packet(getattr(tpk, kind)(
        timestamp=4.5, snapshot=ts, **extra)) == raw
    assert_same(twire.decode_packet(raw).snapshot, ts)


def test_truncated_and_garbage_frames_rejected(worlds):
    jw, tw = worlds
    snap = tsn.extract_snapshot(tw.state, [1, 2, 3])
    raw = twire.encode_packet(tpk.TransientSnapshot(timestamp=6.0,
                                                    snapshot=snap))
    for bad in (raw[: len(raw) // 2], b"\xff" + raw[1:], b"", raw[:8],
                raw[:-1]):
        with pytest.raises(twire.WireError):
            twire.decode_packet(bad)
        with pytest.raises(jwire.WireError):
            jwire.decode_packet(bad)
    with pytest.raises(twire.WireError):
        twire._decode_deltas_py(b"\x80\x80", 1)
    with pytest.raises(twire.WireError):
        twire._w_ndarray(bytearray(), np.zeros(2, np.complex64))


@pytest.mark.parametrize("seed", range(4))
def test_numpy_varints_equal_the_jax_loop(seed):
    rng = np.random.default_rng(seed)
    cases = [rng.integers(-2**31, 2**31, 500), np.sort(rng.integers(
        0, 20_000, 2_000)), rng.integers(-3, 3, 64),
        np.array([0, 2**31 - 1, -2**31, 2**31 - 1, -2**31]),
        np.zeros(0, np.int64)]
    for a in cases:
        a = a.astype(np.int32)
        raw = jwire._encode_deltas_py(a)
        assert twire._encode_deltas_py(a) == raw
        np.testing.assert_array_equal(twire._decode_deltas_py(raw, len(a)),
                                      a)
        # trailing bytes after the n-th id are ignored, as the loop does
        np.testing.assert_array_equal(
            twire._decode_deltas_py(raw + b"\x05", len(a)), a)
    assert twire.varint_encoder() in ("native", "numpy")
