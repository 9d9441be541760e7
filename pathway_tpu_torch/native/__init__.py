"""ctypes bindings to the port's native C++ engines (``native/*.cpp``) —
port of pathway_tpu/native/__init__.py, trimmed to the WordPiece engine.

The library is built on first use (``native/build.py``). When the build
fails, ``wordpiece_available()`` is False and ``NativeWordPiece`` raises
``NativeBuildError`` naming the failure; the tokenizer then runs its
pure-Python engine and records why (``WordPieceTokenizer.native_error``).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from pathway_tpu_torch.native.build import NativeBuildError, ensure_built

_load_lock = threading.Lock()
_wordpiece_lib = None
_wordpiece_err: Exception | None = None


def _load_wordpiece():
    global _wordpiece_lib, _wordpiece_err
    if _wordpiece_lib is not None or _wordpiece_err is not None:
        return _wordpiece_lib
    with _load_lock:
        if _wordpiece_lib is not None or _wordpiece_err is not None:
            return _wordpiece_lib
        try:
            lib = ctypes.CDLL(ensure_built("wordpiece"))
        except Exception as e:  # no toolchain, read-only checkout, ...
            _wordpiece_err = e
            return None
        lib.wp_new.restype = ctypes.c_void_p
        lib.wp_new.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                               ctypes.c_int32]
        lib.wp_free.argtypes = [ctypes.c_void_p]
        lib.wp_encode_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
        _wordpiece_lib = lib
        return lib


def wordpiece_available() -> bool:
    return _load_wordpiece() is not None


class NativeWordPiece:
    """Batch WordPiece tokenizer over the C++ engine
    (``native/wordpiece.cpp``): one C call a batch, during which ctypes
    releases the GIL. Ids match the pure-Python engine of
    ``models/tokenizer.py``."""

    def __init__(self, vocab: list[str], do_lower: bool = True):
        lib = _load_wordpiece()
        if lib is None:
            raise NativeBuildError(
                f"native wordpiece unavailable: {_wordpiece_err}")
        self._lib = lib
        blob = "\n".join(vocab).encode("utf-8")
        self._h = lib.wp_new(blob, len(blob), 1 if do_lower else 0)

    def __del__(self):
        lib = getattr(self, "_lib", None)
        h = getattr(self, "_h", None)
        if lib is not None and h:
            lib.wp_free(h)
            self._h = None

    def encode_batch(self, texts: list[bytes], max_len: int, cls_id: int,
                     sep_id: int, unk_id: int, pad_id: int):
        n = len(texts)
        offsets = np.zeros(n + 1, dtype=np.int64)
        offsets[1:] = np.cumsum(np.fromiter(map(len, texts), np.int64, n))
        blob = b"".join(texts)
        out_ids = np.empty((n, max_len), dtype=np.int32)
        out_lens = np.empty(n, dtype=np.int32)
        self._lib.wp_encode_batch(
            self._h, blob, offsets.ctypes.data_as(
                ctypes.POINTER(ctypes.c_int64)), n, max_len,
            cls_id, sep_id, unk_id, pad_id,
            out_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out_ids, out_lens
