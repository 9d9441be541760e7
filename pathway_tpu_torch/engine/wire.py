"""Self-describing columnar wire format for the exchange plane — port of
pathway_tpu/engine/wire.py, whole.

The dominant payload of a cluster exchange, lists of ``(Pointer, row,
diff)`` entries, serializes column-wise into contiguous buffers, the shape
timely's ``communication/`` crate ships (length-prefixed byte slabs, no
per-row object graph):

* the 16-byte key slab (one contiguous blob, not one pickle a key),
* one typed buffer per row column — int64 / float64 / bool / str / None
  fast paths plus nullable (``Optional``) variants — encoded with
  ``array``/``str.join`` C loops,
* an int32 diff array (widened to int64 only when a diff overflows).

Pickle is demoted to a per-column fallback for exotic value types (numpy
arrays, Json, mixed-type columns, ragged rows) and to a whole-frame
fallback (frame kind 0) if columnar encoding fails outright, so the codec
never loses data it does not understand — it just stops being fast there.
A kind-1 frame with no pickle column is byte for byte the JAX package's
frame for the same payload.

Frame layout (the transport adds its own length prefix)::

    0: 2 bytes magic  b"PW"
    2: 1 byte  version (1)
    3: 1 byte  kind    (0 = whole-frame pickle fallback, 1 = columnar)
    4: kind 0 → pickle((tag, payload))
       kind 1 → u32 tag_len | pickle(tag) | NODE(payload)

``NODE`` is a one-byte-tagged recursive encoding (dict / entry-list /
scalar fast paths / per-node pickle fallback); see the ``_N_*`` / ``_C_*``
tag tables below.

Row accounting: ``encode_frame``/``decode_frame`` return the number of
entries they moved, counting only genuine ``(key, row, diff)`` entry lists
and excluding the ``wm``/``bcast`` side-channels (watermark scalars and
broadcast duplicates are not exchange rows).

bench.py's ``bench_exchange`` measures this codec; the multi-process
cluster that ships it is not ported (ROADMAP queue 1, item 6f).
"""

from __future__ import annotations

import pickle
import struct
from array import array
from itertools import accumulate
from operator import methodcaller
from typing import Any

from pathway_tpu_torch.internals.keys import Pointer

MAGIC = b"PW"
VERSION = 1
KIND_PICKLE = 0
KIND_COLUMNAR = 1

# node tags
_N_NONE = 0x00
_N_DICT = 0x01
_N_ENTRIES = 0x02
_N_PICKLE = 0x03
_N_INT = 0x04
_N_STR = 0x05
_N_TRUE = 0x06
_N_FALSE = 0x07
_N_FLOAT = 0x08

# column tags
_C_I64 = 0x10
_C_F64 = 0x11
_C_BOOL = 0x12
_C_STR = 0x13
_C_NONE = 0x14
_C_PKL = 0x15
_C_PTR = 0x16
_C_OPT_I64 = 0x17
_C_OPT_F64 = 0x18
_C_OPT_STR = 0x19

# row-mode byte inside an ENTRIES node
_ROWS_COLUMNAR = 0
_ROWS_PICKLE = 1

# side-channels excluded from the per-row gauge denominators: watermark
# candidates are scalars, and broadcast entries are duplicated to every
# peer — counting either would flatter encode_us_per_row
SIDE_CHANNEL_KEYS = frozenset({"wm", "bcast"})

_u32 = struct.Struct("<I")
_i64 = struct.Struct("<q")
_f64 = struct.Struct("<d")

_key_bytes = methodcaller("to_bytes", 16, "little")
_PICKLE_PROTO = pickle.HIGHEST_PROTOCOL


def _is_entry_list(obj) -> bool:
    """Same shape test the old ``_pack_payload`` used: a non-empty list
    whose first element is a 3-tuple keyed by a non-bool int."""
    if type(obj) is not list or not obj:
        return False
    e = obj[0]
    return (type(e) is tuple and len(e) == 3 and isinstance(e[0], int)
            and not isinstance(e[0], bool))


# -- column encoders ---------------------------------------------------------

def _enc_col_i64(col, out):
    out.append(bytes([_C_I64]))
    out.append(array("q", col).tobytes())


def _enc_col_f64(col, out):
    out.append(bytes([_C_F64]))
    out.append(array("d", col).tobytes())


def _enc_col_bool(col, out):
    out.append(bytes([_C_BOOL]))
    out.append(bytes(col))


def _enc_col_str(col, out):
    # char lengths (not byte offsets): the blob decodes to ONE str with a
    # single C-speed .decode(), then rows slice it by char offset
    lens = array("I", map(len, col)).tobytes()
    blob = "".join(col).encode()
    out.append(bytes([_C_STR]))
    out.append(lens)
    out.append(_u32.pack(len(blob)))
    out.append(blob)


def _enc_col_none(col, out):
    out.append(bytes([_C_NONE]))


def _enc_col_ptr(col, out):
    out.append(bytes([_C_PTR]))
    out.append(b"".join(map(_key_bytes, col)))


def _enc_col_pkl(col, out):
    blob = pickle.dumps(list(col), protocol=_PICKLE_PROTO)
    out.append(bytes([_C_PKL]))
    out.append(_u32.pack(len(blob)))
    out.append(blob)


def _mask_of(col) -> bytes:
    return bytes(v is not None for v in col)


def _enc_col_opt_i64(col, out):
    out.append(bytes([_C_OPT_I64]))
    out.append(_mask_of(col))
    out.append(array("q", [v for v in col if v is not None]).tobytes())


def _enc_col_opt_f64(col, out):
    out.append(bytes([_C_OPT_F64]))
    out.append(_mask_of(col))
    out.append(array("d", [v for v in col if v is not None]).tobytes())


def _enc_col_opt_str(col, out):
    present = [v for v in col if v is not None]
    blob = "".join(present).encode()
    out.append(bytes([_C_OPT_STR]))
    out.append(_mask_of(col))
    out.append(array("I", map(len, present)).tobytes())
    out.append(_u32.pack(len(blob)))
    out.append(blob)


_NONE_T = type(None)
_COL_ENCODERS = {
    frozenset((int,)): _enc_col_i64,
    frozenset((float,)): _enc_col_f64,
    frozenset((bool,)): _enc_col_bool,
    frozenset((str,)): _enc_col_str,
    frozenset((_NONE_T,)): _enc_col_none,
    frozenset((Pointer,)): _enc_col_ptr,
    frozenset((int, _NONE_T)): _enc_col_opt_i64,
    frozenset((float, _NONE_T)): _enc_col_opt_f64,
    frozenset((str, _NONE_T)): _enc_col_opt_str,
}


def _enc_column(col, out) -> None:
    enc = _COL_ENCODERS.get(frozenset(map(type, col)), _enc_col_pkl)
    if enc is _enc_col_pkl:
        enc(col, out)
        return
    mark = len(out)
    try:
        enc(col, out)
    except (OverflowError, ValueError, UnicodeEncodeError):
        # ints past int64, pathological lengths, lone surrogates: the
        # typed path refuses, pickle carries the column instead
        del out[mark:]
        _enc_col_pkl(col, out)


def _enc_entries(ents: list, out: list) -> bool:
    """Columnar entry-list encoding. Returns False (with ``out``
    untouched) when the list does not actually have uniform
    ``(key, row, diff)`` shape — caller falls back to pickle."""
    mark = len(out)
    n = len(ents)
    try:
        # every element must be a genuine 3-tuple — _is_entry_list only
        # probed the first one, and encoding e[0..2] of a longer tuple
        # would silently drop its tail (lossy, violates the module
        # contract); non-tuples raise TypeError into the fallback
        if set(map(len, ents)) != {3} \
                or set(map(type, ents)) != {tuple}:
            return False
        keys = b"".join(_key_bytes(e[0]) for e in ents)
        diffs = [e[2] for e in ents]
    except (TypeError, ValueError, OverflowError, IndexError):
        return False
    try:
        dfmt, dblob = b"i", array("i", diffs).tobytes()
    except (OverflowError, TypeError):
        try:
            dfmt, dblob = b"q", array("q", diffs).tobytes()
        except (OverflowError, TypeError):
            del out[mark:]
            return False
    rows = [e[1] for e in ents]
    out.append(bytes([_N_ENTRIES]))
    out.append(_u32.pack(n))
    out.append(dfmt)
    out.append(dblob)
    out.append(keys)
    if set(map(type, rows)) == {tuple} and len(set(map(len, rows))) == 1:
        cols = list(zip(*rows))
        out.append(bytes([_ROWS_COLUMNAR]))
        out.append(_u32.pack(len(cols)))
        for col in cols:
            _enc_column(col, out)
    else:
        # ragged or non-tuple rows: keys/diffs still ship columnar, rows
        # ride one pickle blob
        blob = pickle.dumps(rows, protocol=_PICKLE_PROTO)
        out.append(bytes([_ROWS_PICKLE]))
        out.append(_u32.pack(len(blob)))
        out.append(blob)
    return True


def _enc_pickle_node(obj, out) -> None:
    blob = pickle.dumps(obj, protocol=_PICKLE_PROTO)
    out.append(bytes([_N_PICKLE]))
    out.append(_u32.pack(len(blob)))
    out.append(blob)


def _enc_node(obj, out: list, ctr: list, count: bool) -> None:
    if obj is None:
        out.append(bytes([_N_NONE]))
        return
    t = type(obj)
    if t is dict:
        out.append(bytes([_N_DICT]))
        out.append(_u32.pack(len(obj)))
        for k, v in obj.items():
            _enc_node(k, out, ctr, count)
            _enc_node(v, out, ctr,
                      count and k not in SIDE_CHANNEL_KEYS)
        return
    if _is_entry_list(obj):
        if _enc_entries(obj, out):
            if count:
                ctr[0] += len(obj)
            return
        _enc_pickle_node(obj, out)
        return
    if t is bool:
        out.append(bytes([_N_TRUE if obj else _N_FALSE]))
        return
    if t is int:
        try:
            out.append(bytes([_N_INT]) + _i64.pack(obj))
        except struct.error:
            _enc_pickle_node(obj, out)
        return
    if t is float:
        out.append(bytes([_N_FLOAT]) + _f64.pack(obj))
        return
    if t is str:
        b = obj.encode()
        out.append(bytes([_N_STR]))
        out.append(_u32.pack(len(b)))
        out.append(b)
        return
    _enc_pickle_node(obj, out)


def encode_frame(tag: Any, payload: Any) -> tuple[list[bytes], int, int]:
    """Encode ``(tag, payload)`` into wire chunks.

    Returns ``(chunks, total_bytes, n_rows)``; the transport either joins
    the chunks behind a length prefix (TCP) or writes them sequentially
    into a shared-memory slot (no join, no intermediate copy). Any
    columnar-encode failure falls back to a whole-frame pickle (kind 0) —
    the wire never refuses a payload pickle could carry.
    """
    ctr = [0]
    out: list[bytes] = [MAGIC + bytes([VERSION, KIND_COLUMNAR])]
    try:
        tag_blob = pickle.dumps(tag, protocol=_PICKLE_PROTO)
        out.append(_u32.pack(len(tag_blob)))
        out.append(tag_blob)
        _enc_node(payload, out, ctr, True)
    except Exception:
        blob = pickle.dumps((tag, payload), protocol=_PICKLE_PROTO)
        out = [MAGIC + bytes([VERSION, KIND_PICKLE]), blob]
        ctr[0] = payload_rows(payload)
    return out, sum(map(len, out)), ctr[0]


# -- decoding ----------------------------------------------------------------

class _Cursor:
    __slots__ = ("buf", "pos")

    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def take(self, n: int):
        p = self.pos
        self.pos = p + n
        return self.buf[p:p + n]

    def u8(self) -> int:
        p = self.pos
        self.pos = p + 1
        return self.buf[p]

    def u32(self) -> int:
        return _u32.unpack(self.take(4))[0]


def _dec_keys(cur: _Cursor, n: int) -> list:
    kv = cur.take(16 * n)
    ifb = int.from_bytes
    P = Pointer
    return [P(ifb(kv[i:i + 16], "little")) for i in range(0, 16 * n, 16)]


def _dec_str_block(cur: _Cursor, m: int) -> list:
    lens = array("I")
    lens.frombytes(bytes(cur.take(4 * m)))
    blob_len = cur.u32()
    s = bytes(cur.take(blob_len)).decode()
    offs = [0, *accumulate(lens)]
    return [s[offs[i]:offs[i + 1]] for i in range(m)]


def _fill_optional(mask, present: list) -> list:
    it = iter(present)
    return [next(it) if flag else None for flag in mask]


def _dec_column(cur: _Cursor, n: int) -> list:
    ct = cur.u8()
    if ct == _C_I64:
        a = array("q")
        a.frombytes(bytes(cur.take(8 * n)))
        return a.tolist()
    if ct == _C_F64:
        a = array("d")
        a.frombytes(bytes(cur.take(8 * n)))
        return a.tolist()
    if ct == _C_BOOL:
        return list(map(bool, cur.take(n)))
    if ct == _C_STR:
        return _dec_str_block(cur, n)
    if ct == _C_NONE:
        return [None] * n
    if ct == _C_PTR:
        return _dec_keys(cur, n)
    if ct == _C_PKL:
        blob_len = cur.u32()
        # pwt-ok: PWT306 — intra-fleet exchange frames from peers the
        # same supervisor spawned (HMAC-authenticated transport), not a
        # snapshot restore path; cell payloads carry arbitrary UDF types
        # a name whitelist cannot enumerate
        return pickle.loads(bytes(cur.take(blob_len)))
    if ct == _C_OPT_I64:
        mask = bytes(cur.take(n))
        a = array("q")
        a.frombytes(bytes(cur.take(8 * sum(mask))))
        return _fill_optional(mask, a.tolist())
    if ct == _C_OPT_F64:
        mask = bytes(cur.take(n))
        a = array("d")
        a.frombytes(bytes(cur.take(8 * sum(mask))))
        return _fill_optional(mask, a.tolist())
    if ct == _C_OPT_STR:
        mask = bytes(cur.take(n))
        return _fill_optional(mask, _dec_str_block(cur, sum(mask)))
    raise ValueError(f"unknown wire column tag 0x{ct:02x}")


def _dec_entries(cur: _Cursor, ctr: list, count: bool) -> list:
    n = cur.u32()
    dfmt = chr(cur.u8())
    diffs = array(dfmt)
    diffs.frombytes(bytes(cur.take(n * diffs.itemsize)))
    keys = _dec_keys(cur, n)
    rowmode = cur.u8()
    if rowmode == _ROWS_COLUMNAR:
        ncols = cur.u32()
        cols = [_dec_column(cur, n) for _ in range(ncols)]
        rows = list(zip(*cols)) if cols else [()] * n
    else:
        blob_len = cur.u32()
        # pwt-ok: PWT306 — trusted intra-fleet wire protocol (see
        # _dec_column); not a restore path
        rows = pickle.loads(bytes(cur.take(blob_len)))
    if count:
        ctr[0] += n
    return list(zip(keys, rows, diffs.tolist()))


def _dec_node(cur: _Cursor, ctr: list, count: bool):
    nt = cur.u8()
    if nt == _N_NONE:
        return None
    if nt == _N_DICT:
        n = cur.u32()
        out = {}
        for _ in range(n):
            k = _dec_node(cur, ctr, count)
            out[k] = _dec_node(cur, ctr,
                               count and k not in SIDE_CHANNEL_KEYS)
        return out
    if nt == _N_ENTRIES:
        return _dec_entries(cur, ctr, count)
    if nt == _N_PICKLE:
        blob_len = cur.u32()
        # pwt-ok: PWT306 — trusted intra-fleet wire protocol (see
        # _dec_column); not a restore path
        return pickle.loads(bytes(cur.take(blob_len)))
    if nt == _N_INT:
        return _i64.unpack(cur.take(8))[0]
    if nt == _N_STR:
        n = cur.u32()
        return bytes(cur.take(n)).decode()
    if nt == _N_TRUE:
        return True
    if nt == _N_FALSE:
        return False
    if nt == _N_FLOAT:
        return _f64.unpack(cur.take(8))[0]
    raise ValueError(f"unknown wire node tag 0x{nt:02x}")


def decode_frame(buf) -> tuple[Any, Any, int]:
    """Decode one wire frame (bytes or memoryview — shared-memory slots
    decode in place, no intermediate copy). Returns
    ``(tag, payload, n_rows)``."""
    view = memoryview(buf)
    if bytes(view[:2]) != MAGIC:
        raise ValueError("bad exchange frame magic (protocol skew?)")
    version, kind = view[2], view[3]
    if version != VERSION:
        raise ValueError(f"unsupported exchange wire version {version}")
    if kind == KIND_PICKLE:
        # pwt-ok: PWT306 — trusted intra-fleet wire protocol (see
        # _dec_column); not a restore path
        tag, payload = pickle.loads(view[4:])
        return tag, payload, payload_rows(payload)
    cur = _Cursor(view)
    cur.pos = 4
    tag_len = cur.u32()
    # pwt-ok: PWT306 — trusted intra-fleet wire protocol (see
    # _dec_column); not a restore path
    tag = pickle.loads(bytes(cur.take(tag_len)))
    ctr = [0]
    payload = _dec_node(cur, ctr, True)
    return tag, payload, ctr[0]


def payload_rows(obj, count: bool = True) -> int:
    """Entry count of a raw (unencoded) exchange payload — genuine entry
    lists only; ``wm``/``bcast`` side-channels, scalars, and plain lists
    count zero (the per-row gauges divide by *rows moved*, nothing else).
    """
    if _is_entry_list(obj):
        return len(obj) if count else 0
    if isinstance(obj, dict):
        return sum(
            payload_rows(v, count and k not in SIDE_CHANNEL_KEYS)
            for k, v in obj.items())
    return 0
