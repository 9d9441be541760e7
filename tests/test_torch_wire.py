"""The port's columnar exchange codec (engine/wire.py) — counterparts of
the JAX package's tests/test_exchange_codec.py: decode(encode(x)) == x over
randomized payloads (every scalar type, mixed-type columns, nullable
columns, empty lists, dict-nested payloads, the wm/bcast side-channels),
row accounting, the typed fast paths, lookalike types, the ragged and
pickle fallbacks, big diffs and keys, the whole-frame fallback, the
gather and tick payload shapes, bad frames and empty lists.

And against the JAX package's codec: a kind-1 frame with no pickle column
is byte for byte the JAX package's ``encode_frame`` of the same payload
(the fuzz payloads that take no pickle path, and bench.py's
``bench_exchange`` payload), and each package decodes the other's frame.
No wall-clock gate: the codec's time is measured on the chip
(chip_smoke.py ``phase_etl_sharded``), not here.
"""

from __future__ import annotations

import math
import random
import string

import numpy as np
import pytest

from pathway_tpu.engine import wire as jwire
from pathway_tpu.internals import json as jjson
from pathway_tpu.internals import keys as jkeys
from pathway_tpu_torch.engine import wire
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.keys import Pointer, hash_values


def _eq(a, b) -> bool:
    """Structural equality tolerant of NaN and ndarray cells."""
    if type(a) is not type(b):
        # bool/int/float cross-type equality must NOT pass (1 != True on
        # the wire: the codec is type-preserving)
        return False
    if isinstance(a, float):
        return (math.isnan(a) and math.isnan(b)) or a == b
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_eq(v, b[k])
                                            for k, v in a.items())
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_eq, a, b))
    return a == b


def _roundtrip(tag, payload):
    chunks, total, n_enc = wire.encode_frame(tag, payload)
    blob = b"".join(chunks)
    assert total == len(blob)
    rtag, out, n_dec = wire.decode_frame(blob)
    assert _eq(rtag, tag)
    assert n_enc == n_dec
    assert _eq(out, payload), (payload, out)
    return out, n_enc


_SCALAR_POOLS = [
    lambda rng: rng.randrange(-2**40, 2**40),
    lambda rng: rng.randrange(-2**80, 2**80),          # past int64
    lambda rng: rng.random() * 1e6 - 5e5,
    lambda rng: rng.choice([float("nan"), float("inf"), -0.0, 1e-300]),
    lambda rng: "".join(rng.choices(string.printable, k=rng.randrange(12))),
    lambda rng: rng.choice(["", "héllo wörld", "日本語", "a" * 100]),
    lambda rng: rng.choice([True, False]),
    lambda rng: None,
    lambda rng: Pointer(rng.randrange(2**128)),
    lambda rng: bytes(rng.randrange(256) for _ in range(rng.randrange(8))),
    lambda rng: tuple(rng.randrange(9) for _ in range(rng.randrange(3))),
    lambda rng: np.arange(rng.randrange(1, 5), dtype=np.float32),
    lambda rng: Json({"k": rng.randrange(9)}),
]


def _rand_value(rng):
    return rng.choice(_SCALAR_POOLS)(rng)


def _rand_entries(rng, uniform_prob=0.5):
    n = rng.choice([1, 2, 3, 17, 100])
    width = rng.randrange(5)
    if rng.random() < uniform_prob:
        # homogeneous columns — the typed fast paths (incl. nullable)
        makers = [rng.choice(_SCALAR_POOLS) for _ in range(width)]
        nullable = [rng.random() < 0.3 for _ in range(width)]
        rows = [tuple(None if nullable[c] and rng.random() < 0.4
                      else makers[c](rng) for c in range(width))
                for _ in range(n)]
    else:
        # mixed-type columns — per-column pickle fallback
        rows = [tuple(_rand_value(rng) for _ in range(width))
                for _ in range(n)]
    return [(hash_values("fz", rng.randrange(10**9)), row,
             rng.choice([1, -1, 3, -2**40]))
            for row in rows]


def _rand_payload(rng, depth=0):
    shape = rng.randrange(6 if depth < 2 else 4)
    if shape == 0:
        return _rand_entries(rng)
    if shape == 1:
        return rng.choice([None, True, False, 7, "x", 3.5, [],
                           [1, 2, 3], ["not", "entries"]])
    if shape == 2:
        return {"rows": {rng.randrange(4): {rng.randrange(64):
                                            _rand_entries(rng)}},
                "wm": rng.choice([None, 17, 3.25, "2026-01-01"]),
                "bcast": rng.choice([None,
                                     {0: _rand_entries(rng)}])}
    if shape == 3:
        return _rand_value(rng)
    if shape == 4:
        return {rng.choice(["a", 5, True, None]): _rand_payload(rng,
                                                                depth + 1)
                for _ in range(rng.randrange(4))}
    return {i: _rand_payload(rng, depth + 1) for i in range(2)}


@pytest.mark.parametrize("seed", range(40))
def test_fuzz_roundtrip(seed):
    rng = random.Random(seed)
    payload = _rand_payload(rng)
    tag = rng.choice([("x", 3, 0), ("g", 1, 7), ("tick", 12), "s"])
    _roundtrip(tag, payload)


def test_row_accounting_counts_entries_not_side_channels():
    rng = random.Random(1234)
    ents = _rand_entries(rng)
    payload = {"rows": {0: {0: ents}}, "wm": 3, "bcast": {1: ents}}
    _out, n = _roundtrip(("x", 0, 0), payload)
    assert n == len(ents)  # bcast copies and wm excluded
    assert wire.payload_rows(payload) == len(ents)


def test_typed_column_fast_paths_take_columnar_kind(monkeypatch):
    ents = [(Pointer(i), (i, float(i), f"s{i}", i % 2 == 0, None,
                          Pointer(i * 3),
                          i if i % 2 else None,        # Optional[int]
                          float(i) if i % 3 else None,  # Optional[float]
                          f"t{i}" if i % 2 else None),  # Optional[str]
             1) for i in range(64)]
    payload = {"rows": {0: {0: ents}}, "wm": None, "bcast": None}
    # every column above has a typed fast path: the per-column pickle
    # fallback must never fire for this payload
    monkeypatch.setattr(
        wire, "_enc_col_pkl",
        lambda col, out: (_ for _ in ()).throw(
            AssertionError(f"pickle fallback hit for column {col[:3]}...")))
    chunks, _t, _n = wire.encode_frame(("x", 1, 0), payload)
    blob = b"".join(chunks)
    assert blob[3] == wire.KIND_COLUMNAR
    monkeypatch.undo()
    _roundtrip(("x", 1, 0), payload)


def test_type_preservation_across_lookalike_columns():
    """bool vs int, int vs float, -0.0, and Pointer vs int must come back
    as the exact types that went in (they compare equal but hash/route
    differently downstream)."""
    ents = [(Pointer(1), (True, 1, 1.0, -0.0, Pointer(5)), 1),
            (Pointer(2), (False, 0, 0.0, 0.25, Pointer(6)), 1)]
    out, _ = _roundtrip(("x", 0, 0), {"rows": {0: {0: ents}}})
    row0 = out["rows"][0][0][0][1]
    assert row0[0] is True and type(row0[1]) is int
    assert type(row0[2]) is float and row0[2] == 1.0
    assert math.copysign(1.0, row0[3]) == -1.0
    assert type(row0[4]) is Pointer


def test_ragged_and_non_tuple_rows_fall_back_losslessly():
    ents = [(Pointer(1), ("a", 1), 1),
            (Pointer(2), ("b", 2, "extra"), -1),     # ragged width
            (Pointer(3), "not-a-tuple", 1)]          # non-tuple row
    _roundtrip(("x", 0, 0), {"rows": {0: {0: ents}}})


def test_overlong_entry_tuples_are_not_truncated():
    """A list whose FIRST element looks like an entry but whose tail
    carries 4-tuples (or non-tuples) must ship via pickle, not silently
    drop the extra elements — the codec never loses data it does not
    understand."""
    mixed = [(Pointer(5), ("a", 1), 1),
             (Pointer(6), ("b", 2), 1, "EXTRA")]     # 4-tuple tail
    out, n = _roundtrip(("x", 0, 0), {"rows": {0: {0: mixed}}})
    assert out["rows"][0][0][1] == (Pointer(6), ("b", 2), 1, "EXTRA")
    mixed2 = [(Pointer(5), ("a", 1), 1), "stray"]    # non-tuple tail
    _roundtrip(("x", 0, 0), {"rows": {0: {0: mixed2}}})


def test_big_diffs_and_big_keys():
    ents = [(Pointer(2**128 - 1), ("x",), 2**50),
            (Pointer(0), ("y",), -2**50)]
    out, _ = _roundtrip(("x", 0, 0), {"rows": {0: {0: ents}}})
    got = out["rows"][0][0]
    assert got[0][2] == 2**50 and got[1][2] == -2**50
    assert int(got[0][0]) == 2**128 - 1


def test_surrogate_strings_fall_back_to_pickle_column():
    # lone surrogates cannot encode to utf-8; the column must ride pickle
    ents = [(Pointer(i), ("\ud800bad" if i else "fine",), 1)
            for i in range(3)]
    _roundtrip(("x", 0, 0), {"rows": {0: {0: ents}}})


def test_whole_frame_pickle_fallback(monkeypatch):
    """A columnar-encoder failure (future codec bug, exotic structure)
    must degrade to the kind-0 whole-frame pickle, not a send error —
    and the kind-0 path must still decode with correct row accounting."""
    def boom(*_a, **_k):
        raise RuntimeError("seeded codec failure")

    monkeypatch.setattr(wire, "_enc_node", boom)
    ents = [(Pointer(i), (i,), 1) for i in range(5)]
    payload = {"rows": {0: {0: ents}}, "wm": None, "bcast": None}
    chunks, _t, n = wire.encode_frame(("x", 0, 0), payload)
    blob = b"".join(chunks)
    assert blob[3] == wire.KIND_PICKLE
    tag, out, n_dec = wire.decode_frame(blob)
    assert tag == ("x", 0, 0)
    assert out == payload
    assert n == n_dec == 5


def test_gather_payload_shape():
    # the ("g", time, node) exchange ships {input_j: entries} or None
    ents = [(hash_values("g", i), (i, f"v{i}"), 1) for i in range(20)]
    _out, n = _roundtrip(("g", 4, 9), {0: ents, 2: ents[:3]})
    assert n == 23
    _roundtrip(("g", 4, 9), None)


def test_streaming_tick_payload_shape():
    ents = [(hash_values("t", i), (f"w{i}", i), 1) for i in range(10)]
    payload = {"rows": {0: ents}, "any": True, "closed": False}
    _out, n = _roundtrip(("tick", 31), payload)
    assert n == 10


def test_bad_frames_raise_named_errors():
    with pytest.raises(ValueError, match="magic"):
        wire.decode_frame(b"XX\x01\x01garbage")
    with pytest.raises(ValueError, match="version"):
        wire.decode_frame(wire.MAGIC + bytes([99, 0]) + b"x")


def test_empty_and_single_entry_lists():
    for ents in ([], [(Pointer(3), (), 1)]):
        payload = {"rows": {0: {0: ents}}, "wm": None, "bcast": None}
        _out, n = _roundtrip(("x", 0, 0), payload)
        assert n == len(ents)


# -- against the JAX package's codec ---------------------------------------

def _to_jax(obj):
    """The same payload built from the JAX package's classes."""
    if isinstance(obj, Pointer):
        return jkeys.Pointer(int(obj))
    if isinstance(obj, Json):
        return jjson.Json(obj.value)
    if isinstance(obj, dict):
        return {_to_jax(k): _to_jax(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_jax(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_to_jax(v) for v in obj)
    return obj


def _frame(codec, tag, payload) -> bytes:
    chunks, total, _n = codec.encode_frame(tag, payload)
    blob = b"".join(chunks)
    assert total == len(blob)
    return blob


def _pickle_free(monkeypatch, tag, payload) -> bool:
    """Whether the port encodes ``payload`` without any pickle path."""
    hits = []
    col, node = wire._enc_col_pkl, wire._enc_pickle_node
    with monkeypatch.context() as m:
        m.setattr(wire, "_enc_col_pkl",
                  lambda c, out: (hits.append(1), col(c, out))[1])
        m.setattr(wire, "_enc_pickle_node",
                  lambda o, out: (hits.append(1), node(o, out))[1])
        blob = _frame(wire, tag, payload)
    return not hits and blob[3] == wire.KIND_COLUMNAR


@pytest.mark.parametrize("seed", range(40))
def test_fuzz_frames_equal_jax_bytes_when_pickle_free(seed, monkeypatch):
    rng = random.Random(seed)
    payload = _rand_payload(rng)
    tag = rng.choice([("x", 3, 0), ("g", 1, 7), ("tick", 12), "s"])
    mine = _frame(wire, tag, payload)
    theirs = _frame(jwire, tag, _to_jax(payload))
    if _pickle_free(monkeypatch, tag, payload):
        assert mine == theirs
        # the port decodes the JAX package's frame to the payload
        assert _eq(wire.decode_frame(theirs)[1], payload)
    # a pickled cell decodes to its own package's class; the rows moved
    # are counted alike either way
    assert jwire.decode_frame(mine)[2] == wire.decode_frame(mine)[2]


def test_typed_columns_equal_jax_bytes(monkeypatch):
    ents = [(Pointer(i * 7919), (i, float(i) / 3, f"s{i}", i % 2 == 0, None,
                                 Pointer(i * 3),
                                 i if i % 2 else None,
                                 float(i) if i % 3 else None,
                                 f"t{i}" if i % 2 else None),
             1 - 2 * (i % 3 == 0)) for i in range(200)]
    payload = {"rows": {1: {3: ents}}, "wm": 7, "bcast": {0: ents[:5]},
               "any": True}
    assert _pickle_free(monkeypatch, ("x", 2, 0), payload)
    mine = _frame(wire, ("x", 2, 0), payload)
    assert mine == _frame(jwire, ("x", 2, 0), _to_jax(payload))
    tag, out, n = wire.decode_frame(mine)
    assert tag == ("x", 2, 0) and n == 200
    assert all(type(e[0]) is Pointer for e in out["rows"][1][3])


def test_bench_exchange_payload_equals_jax_bytes(monkeypatch):
    """bench.py's ``bench_exchange`` payload (bench.py:1863-1896): 20,000
    rows of (word, quantity) under ``hash_values("row", i)`` keys, from
    bench_etl's draws."""
    rng = np.random.default_rng(0)
    words = rng.integers(0, 5000, size=100_000)
    qtys = rng.integers(1, 10, size=100_000)
    n = 20_000
    ents = [(hash_values("row", i), (f"w{words[i]}", int(qtys[i])), 1)
            for i in range(n)]
    payload = {"rows": {0: {0: ents}}, "wm": None, "bcast": None}
    assert _pickle_free(monkeypatch, ("x", 1, 0), payload)
    mine = _frame(wire, ("x", 1, 0), payload)
    assert mine == _frame(jwire, ("x", 1, 0), _to_jax(payload))
    tag, out, rows = wire.decode_frame(mine)
    assert rows == n and out == payload
