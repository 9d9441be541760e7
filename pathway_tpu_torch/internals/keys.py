"""128-bit row keys (Pointers) and deterministic hashing — the part of
pathway_tpu/internals/keys.py the index, the engine and their tests use,
copied so that a key made here equals the key the JAX package makes from
the same values.
"""

from __future__ import annotations

import hashlib
import math
import struct
from typing import Any

import numpy as np

_SALT = b"pathway-tpu-key-v1"


class Pointer(int):
    """An opaque 128-bit row id. Subclasses int for cheap hashing/dict keys."""

    __slots__ = ()

    def __repr__(self) -> str:
        return f"^{self:032X}"[:12] + "..."

    def __str__(self) -> str:
        return f"^{_b64ish(self)}"

    @property
    def lo(self) -> int:
        return int(self) & 0xFFFFFFFFFFFFFFFF

    @property
    def hi(self) -> int:
        return int(self) >> 64


_ALPHABET = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"


def _b64ish(v: int) -> str:
    # short readable digest for debug printing (like reference's base32 keys)
    out = []
    v = int(v) & ((1 << 128) - 1)
    for _ in range(14):
        out.append(_ALPHABET[v % 36])
        v //= 36
    return "".join(reversed(out))


def _encode_value(value: Any, out: list) -> None:
    """Canonical byte encoding of an engine value for hashing.

    Hot path: one exact-type dict dispatch (``_ENCODERS``) instead of an
    isinstance chain — this runs once per value per key derivation
    (~millions of calls per 100k-row tick). Subclasses and numpy scalar
    types miss the dict and take the full chain below, which stays the
    single source of encoding truth for them."""
    enc = _ENCODERS.get(type(value))
    if enc is not None:
        enc(value, out)
        return
    _encode_value_slow(value, out)


def _enc_none(value, out):
    out.append(b"\x00")


def _enc_bool(value, out):
    out.append(b"\x01\x01" if value else b"\x01\x00")


def _enc_pointer(value, out):
    out.append(b"\x02" + int(value).to_bytes(16, "little"))


def _enc_int(value, out):
    v = int(value)
    if -(2**63) <= v < 2**63:
        out.append(b"\x03" + struct.pack("<q", v))
    else:
        # arbitrary-precision ints (e.g. raw 128-bit pointer values)
        b = v.to_bytes((v.bit_length() + 8) // 8, "little", signed=True)
        out.append(b"\x0b" + struct.pack("<q", len(b)) + b)


def _enc_float(value, out):
    f = float(value)
    if math.isfinite(f) and f == int(f) and abs(f) < 2**62:
        # ints and equal floats hash identically (reference: HashInto for Value)
        out.append(b"\x03" + struct.pack("<q", int(f)))
    else:
        out.append(b"\x04" + struct.pack("<d", f))


def _enc_str(value, out):
    b = value.encode()
    out.append(b"\x05" + struct.pack("<q", len(b)) + b)


def _enc_bytes(value, out):
    out.append(b"\x06" + struct.pack("<q", len(value)) + value)


def _enc_tuple(value, out):
    out.append(b"\x07" + struct.pack("<q", len(value)))
    for v in value:
        _encode_value(v, out)


def _enc_ndarray(value, out):
    out.append(b"\x08" + str(value.dtype).encode() + struct.pack(
        "<q", value.ndim) + value.shape.__repr__().encode() + value.tobytes())


_ENCODERS = {
    type(None): _enc_none,
    bool: _enc_bool,
    Pointer: _enc_pointer,
    int: _enc_int,
    float: _enc_float,
    str: _enc_str,
    bytes: _enc_bytes,
    tuple: _enc_tuple,
    np.ndarray: _enc_ndarray,
}


def _encode_value_slow(value: Any, out: list) -> None:
    """Full chain for types outside _ENCODERS (numpy scalars, subclasses,
    Json, arbitrary objects). MUST encode identically to the fast
    encoders for any value both can see."""
    if value is None:
        out.append(b"\x00")
    elif value is True:
        out.append(b"\x01\x01")
    elif value is False:
        out.append(b"\x01\x00")
    elif isinstance(value, Pointer):
        _enc_pointer(value, out)
    elif isinstance(value, (int, np.integer)):
        _enc_int(value, out)
    elif isinstance(value, (float, np.floating)):
        _enc_float(value, out)
    elif isinstance(value, str):
        _enc_str(value, out)
    elif isinstance(value, bytes):
        _enc_bytes(value, out)
    elif isinstance(value, tuple):
        _enc_tuple(value, out)
    elif isinstance(value, np.ndarray):
        _enc_ndarray(value, out)
    else:
        from pathway_tpu_torch.internals.json import Json

        if isinstance(value, Json):
            b = value.dumps().encode()
            out.append(b"\x09" + struct.pack("<q", len(b)) + b)
        else:
            b = repr(value).encode()
            out.append(b"\x0a" + struct.pack("<q", len(b)) + b)


_HASH_CACHE: dict = {}
_HASH_CACHE_MAX = 1 << 20


def hash_values(*values: Any) -> Pointer:
    """Deterministic 128-bit key from a tuple of values (ref_scalar analogue).

    Memoized: dataflow key spaces repeat heavily (every join/group output
    key and exchange route hashes the same few thousand values tick after
    tick), and encode+blake2b is ~16 µs while a dict hit is ~0.2 µs. The
    cache key is type-qualified because ``True == 1 == 1.0`` as dict keys
    but bool encodes differently (int vs equal float intentionally encode
    the SAME, so their sharing a cache slot is correct)."""
    try:
        ck = (values, tuple(map(type, values)))
        cached = _HASH_CACHE.get(ck)
        if cached is not None:
            return cached
    except TypeError:  # unhashable member (ndarray, Json, ...)
        ck = None
    out: list = []
    for v in values:
        _encode_value(v, out)
    digest = hashlib.blake2b(b"".join(out), digest_size=16, key=_SALT).digest()
    result = Pointer(int.from_bytes(digest, "little"))
    if ck is not None and len(_HASH_CACHE) < _HASH_CACHE_MAX:
        _HASH_CACHE[ck] = result
    return result


def hash_values_uncached(*values: Any) -> Pointer:
    """hash_values minus the memo cache, for callers whose keys are
    unique by construction (e.g. per-row source ids that embed a row
    index): the cache tuple build + miss + insert is pure overhead there
    and evicts genuinely-repeating dataflow keys. Identical bytes →
    identical Pointer as hash_values."""
    out: list = []
    for v in values:
        _encode_value(v, out)
    digest = hashlib.blake2b(b"".join(out), digest_size=16, key=_SALT).digest()
    return Pointer(int.from_bytes(digest, "little"))


def ref_scalar(*args: Any, optional: bool = False) -> Pointer:
    """Public ``pw.this.pointer_from`` scalar variant."""
    return hash_values(*args)


_MASK128 = (1 << 128) - 1
_MIX_A = 0x9E3779B97F4A7C15F39CC0605CEDC835
_MIX_B = 0xC2B2AE3D27D4EB4F165667B19E3779F9
_MIX_NONE = 0x6C62272E07BB014262B821756295C58D  # stands in for a missing side


def mix_pointers(a: int | None, b: int | None) -> Pointer:
    """Deterministic 128-bit combine of two (blake2b-uniform) pointers:
    the key of a flattened row (its parent key mixed with its position)
    and of a join's output row (its left and right ids; the native join
    pass, native/fastjoin.cpp, computes the same mix). Pointers are
    already uniform 128-bit digests, so a multiply-xor mix preserves
    uniformity at far less cost than re-encoding + blake2b."""
    x = _MIX_NONE if a is None else int(a)
    y = _MIX_NONE + 1 if b is None else int(b)
    x = (x * _MIX_A) & _MASK128
    y = (y * _MIX_B) & _MASK128
    z = (x ^ (y >> 63) ^ (y << 65)) & _MASK128
    z = (z * _MIX_A) & _MASK128
    return Pointer(z ^ (z >> 64))


_INT_RANGE = 1 << 62


def canonical_shard_value(v: Any):
    """Canonical raw form of a value used as a join-state key.

    ``hash_values`` encodes equal ints and floats (and their numpy scalar
    forms) identically, so keying by the raw value must collapse the same
    equivalence classes: integral floats and numpy scalars map to the
    python int/float, NaN (!= itself, so useless as a dict key) maps to
    its hash, and anything exotic maps to its hash. Bools stay raw — they
    equal their int twins as dict keys, so join key functions hash bools
    before calling this."""
    if v is None:
        return v
    cls = v.__class__
    if cls is str or cls is int or cls is Pointer or cls is bool:
        return v
    if cls is float:
        if v != v:
            return hash_values(v)
        if v.is_integer() and -_INT_RANGE < v < _INT_RANGE:
            return int(v)
        return v
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        f = float(v)
        if f != f:
            return hash_values(f)
        if f.is_integer() and -_INT_RANGE < f < _INT_RANGE:
            return int(f)
        return f
    # subclasses of the raw-pass classes (np.str_, IntEnum, Pointer
    # subtypes) canonicalize to the base so they key identically to their
    # plain twins — hash_values encodes them identically too
    if isinstance(v, Pointer):
        return v
    if isinstance(v, str):
        return str(v)
    if isinstance(v, int):  # bool was exact-checked above; can't subclass
        return int(v)
    return hash_values(v)
