"""ctypes bindings for the C++ append-log KV backend
(`csrc/host/kvlog.cc`).

The shared library is built by g++ on first use into
`build/cometbft_tpu_torch/`, named by a digest of the source and flags
(`ops/_build.host_lib`); a failed build raises with the compiler's
output. The file format is identical to db.kv.FileDB, so the two
backends, and the JAX package's, open each other's files.

Port of `cometbft_tpu/db/native/wrapper.py`, which builds beside its
source and loads a committed library; the port does neither, and has no
`native_available` probe: there is no fallback to ask about.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Iterator, List, Optional, Tuple

from ...ops import _build

_lib = None
_lib_lock = threading.Lock()

_U8P = ctypes.POINTER(ctypes.c_uint8)


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = _build.host_lib("kvlog")
        lib.nkv_open.restype = ctypes.c_void_p
        lib.nkv_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.nkv_close.argtypes = [ctypes.c_void_p]
        lib.nkv_set.restype = ctypes.c_int
        lib.nkv_set.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_size_t, ctypes.c_char_p,
                                ctypes.c_size_t]
        lib.nkv_del.restype = ctypes.c_int
        lib.nkv_del.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_size_t]
        lib.nkv_get.restype = ctypes.c_int64
        lib.nkv_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_size_t, ctypes.POINTER(_U8P)]
        lib.nkv_free.argtypes = [_U8P]
        lib.nkv_size.restype = ctypes.c_int64
        lib.nkv_size.argtypes = [ctypes.c_void_p]
        lib.nkv_iter.restype = ctypes.c_void_p
        lib.nkv_iter.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_size_t, ctypes.c_char_p,
                                 ctypes.c_size_t]
        lib.nkv_iter_next.restype = ctypes.c_int
        lib.nkv_iter_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(_U8P),
            ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(_U8P),
            ctypes.POINTER(ctypes.c_size_t)]
        lib.nkv_iter_close.argtypes = [ctypes.c_void_p]
        lib.nkv_compact.restype = ctypes.c_int
        lib.nkv_compact.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class NativeDB:
    """KVStore over the C++ backend (same seam as MemDB/FileDB)."""

    def __init__(self, path: str, fsync: bool = False):
        self._lib = _load()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._h = self._lib.nkv_open(path.encode(), 1 if fsync else 0)
        if not self._h:
            raise OSError(f"nkv_open failed for {path}")

    def get(self, key: bytes) -> Optional[bytes]:
        out = _U8P()
        n = self._lib.nkv_get(self._h, key, len(key), ctypes.byref(out))
        if n < 0:
            return None
        try:
            return ctypes.string_at(out, n)
        finally:
            self._lib.nkv_free(out)

    def set(self, key: bytes, value: bytes) -> None:
        if self._lib.nkv_set(self._h, key, len(key), value,
                             len(value)) != 0:
            raise OSError("nkv_set failed")

    def delete(self, key: bytes) -> None:
        if self._lib.nkv_del(self._h, key, len(key)) != 0:
            raise OSError("nkv_del failed")

    def iterate(self, start: bytes = b"",
                end: Optional[bytes] = None
                ) -> Iterator[Tuple[bytes, bytes]]:
        it = self._lib.nkv_iter(self._h, start, len(start),
                                end or b"", len(end or b""))
        try:
            k, v = _U8P(), _U8P()
            klen, vlen = ctypes.c_size_t(), ctypes.c_size_t()
            while self._lib.nkv_iter_next(
                    it, ctypes.byref(k), ctypes.byref(klen),
                    ctypes.byref(v), ctypes.byref(vlen)):
                yield (ctypes.string_at(k, klen.value),
                       ctypes.string_at(v, vlen.value))
        finally:
            self._lib.nkv_iter_close(it)

    def write_batch(self, sets: List[Tuple[bytes, bytes]],
                    deletes: List[bytes] = ()) -> None:
        for k, v in sets:
            self.set(k, v)
        for k in deletes:
            self.delete(k)

    def compact(self) -> None:
        if self._lib.nkv_compact(self._h) != 0:
            raise OSError("nkv_compact failed")

    def __len__(self) -> int:
        return int(self._lib.nkv_size(self._h))

    def close(self) -> None:
        if self._h:
            self._lib.nkv_close(self._h)
            self._h = None
