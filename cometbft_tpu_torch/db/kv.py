"""Key-value storage backends (the cometbft-db seam, reference go.mod:42,
node/node.go:284).

Three built-in backends:
- MemDB: ordered in-memory map (the memdb analog used across tests),
- FileDB: append-only log + in-memory index with compaction — a simple
  durable store in pure Python,
- NativeDB (db/native): the same record format implemented in C++
  (csrc/host/kvlog.cc, built by g++ into build/, ctypes-bound) — the
  production storage path, file-compatible with FileDB.

Iteration is ordered by raw bytes, matching goleveldb semantics the
reference relies on for height-ordered scans.

On-disk log format (docs/STORAGE.md):
  v1 record (legacy, self-committing — still replayed, still written by
  NativeDB):        u8 op(0|1) | u32 klen | u32 vlen | key | value
  v2 record:        u8 op(2|3) | u32 klen | u32 vlen | u32 crc |
                    key | value
  v2 commit marker: u8 4 | u32 0 | u32 4 | u32 crc | u32 count
where crc = crc32(header-sans-crc | key | value). v2 records between
commit markers form one BATCH, replayed all-or-nothing: a torn,
CRC-bad, or uncommitted tail truncates the log back to the last commit
boundary, so a crash at ANY byte offset inside a `write_batch` leaves
the store at the exact pre-batch state — never a prefix (the old v1
`write_batch` was a bare append loop; a mid-batch crash durably applied
meta-without-parts and friends, cometbft_tpu/store/blockstore.py).
`set`/`delete` are single-record batches. v1 logs replay transparently
(each v1 record is its own commit point) and upgrade wholesale to v2 on
the next `compact()`.

Copy of `cometbft_tpu/db/kv.py` (the port keeps its own): a log written
by either package opens in the other, byte for byte.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from bisect import bisect_left, insort
from typing import Dict, Iterator, List, Optional, Protocol, Tuple

from ..libs import faultio
from ..libs.fail import fail_point


class KVStore(Protocol):
    def get(self, key: bytes) -> Optional[bytes]: ...
    def set(self, key: bytes, value: bytes) -> None: ...
    def delete(self, key: bytes) -> None: ...
    def iterate(self, start: bytes = b"", end: Optional[bytes] = None
                ) -> Iterator[Tuple[bytes, bytes]]: ...
    def write_batch(self, sets: List[Tuple[bytes, bytes]],
                    deletes: List[bytes] = ()) -> None: ...
    def close(self) -> None: ...


class MemDB:
    def __init__(self):
        self._data: Dict[bytes, bytes] = {}
        self._keys: List[bytes] = []
        self._lock = threading.RLock()

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            return self._data.get(key)

    def set(self, key: bytes, value: bytes) -> None:
        with self._lock:
            if key not in self._data:
                insort(self._keys, key)
            self._data[key] = value

    def delete(self, key: bytes) -> None:
        with self._lock:
            if key in self._data:
                del self._data[key]
                i = bisect_left(self._keys, key)
                self._keys.pop(i)

    def iterate(self, start: bytes = b"", end: Optional[bytes] = None
                ) -> Iterator[Tuple[bytes, bytes]]:
        with self._lock:
            i = bisect_left(self._keys, start)
            keys = self._keys[i:]
            snapshot = [(k, self._data[k]) for k in keys
                        if end is None or k < end]
        yield from snapshot

    def write_batch(self, sets, deletes=()):
        with self._lock:
            for k, v in sets:
                self.set(k, v)
            for k in deletes:
                self.delete(k)

    def close(self):
        pass


_REC_SET = 0      # v1, self-committing
_REC_DEL = 1      # v1, self-committing
_REC_SET2 = 2     # v2, pending until a commit marker
_REC_DEL2 = 3     # v2, pending until a commit marker
_REC_COMMIT = 4   # v2 batch commit marker; value = u32 record count

_V1_HDR = struct.Struct("<BII")
_V2_HDR = struct.Struct("<BIII")
_U32 = struct.Struct("<I")


def _enc2(op: int, key: bytes, value: bytes = b"") -> bytes:
    crc = zlib.crc32(_V1_HDR.pack(op, len(key), len(value)) + key + value)
    return _V2_HDR.pack(op, len(key), len(value), crc) + key + value


def _storage_metrics():
    """Lazy: store/ imports db/ at module level (blockstore), so the
    reverse edge must resolve at call time, and only on the cold
    corruption/repair paths."""
    from ..store import recovery
    return recovery.metrics()


class FileDB:
    """Append-only log with full in-memory index.

    Reopen replays the log (module docstring has the v1/v2 framing);
    `compact()` rewrites live records as one committed v2 batch.
    Durability knob `fsync` mirrors the role of the WAL's sync flag
    (reference internal/autofile). All file I/O rides the
    libs/faultio seam under labels db:log / db:replay / db:compact."""

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self._fsync = fsync
        self._mem = MemDB()
        self._lock = threading.RLock()
        # True once replay sees any v1 record: the one-time v2 upgrade
        # happens wholesale at the next compact() (store/recovery's
        # doctor reports it; nothing forces an eager rewrite of a
        # large, healthy log at boot).
        self.needs_upgrade = False
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # crash hygiene: a crash before compact()'s os.replace leaves a
        # stale temp beside the log — stale state, never the live copy
        stale = path + ".compact"
        if os.path.exists(stale):
            os.remove(stale)
            m = _storage_metrics()
            if m is not None:
                m.doctor_repairs.inc(kind="stale-compact")
        if os.path.exists(path):
            good = self._replay()
            if good != os.path.getsize(path):
                # torn/uncommitted/corrupt tail from a crash: truncate
                # back to the last commit boundary, else new appends
                # land after garbage and are lost on next replay
                with faultio.open_file(path, "r+b", label="db:log") as f:
                    f.truncate(good)
        self._f = faultio.open_file(path, "ab", label="db:log")

    def _replay(self) -> int:
        """Replay the log; returns the offset of the last COMMITTED
        byte: the end of the last complete v1 record or v2 commit
        marker. v2 records buffer in `pending` and apply only when
        their commit marker lands with a matching count — a tail of
        pending records without one is a crashed `write_batch` and is
        discarded wholesale (all-or-nothing)."""
        good = 0
        pos = 0
        pending: List[Tuple[int, bytes, bytes]] = []
        crc_bad = torn_batch = False
        with faultio.open_file(self.path, "rb", label="db:replay") as f:
            while True:
                b0 = f.read(1)
                if not b0:
                    break
                op = b0[0]
                if op in (_REC_SET, _REC_DEL):
                    rest = f.read(_V1_HDR.size - 1)
                    if len(rest) < _V1_HDR.size - 1:
                        break
                    _, klen, vlen = _V1_HDR.unpack(b0 + rest)
                    kv = f.read(klen + vlen)
                    if len(kv) < klen + vlen:
                        break  # torn tail write (crash recovery)
                    if pending:
                        # a v1 record can never land inside an open v2
                        # batch — this is corruption, not framing
                        torn_batch = True
                        break
                    key, value = kv[:klen], kv[klen:]
                    if op == _REC_SET:
                        self._mem.set(key, value)
                    else:
                        self._mem.delete(key)
                    self.needs_upgrade = True
                    pos += _V1_HDR.size + klen + vlen
                    good = pos
                elif op in (_REC_SET2, _REC_DEL2, _REC_COMMIT):
                    rest = f.read(_V2_HDR.size - 1)
                    if len(rest) < _V2_HDR.size - 1:
                        break
                    _, klen, vlen, crc = _V2_HDR.unpack(b0 + rest)
                    kv = f.read(klen + vlen)
                    if len(kv) < klen + vlen:
                        break
                    if zlib.crc32(_V1_HDR.pack(op, klen, vlen) + kv) != crc:
                        crc_bad = True
                        break
                    pos += _V2_HDR.size + klen + vlen
                    if op == _REC_COMMIT:
                        if klen != 0 or vlen != _U32.size or \
                                _U32.unpack(kv)[0] != len(pending):
                            torn_batch = True
                            break
                        for p_op, k, v in pending:
                            if p_op == _REC_SET2:
                                self._mem.set(k, v)
                            else:
                                self._mem.delete(k)
                        pending = []
                        good = pos
                    else:
                        pending.append((op, kv[:klen], kv[klen:]))
                else:
                    break  # unknown op: corrupt tail
        m = _storage_metrics()
        if m is not None:
            if crc_bad:
                m.crc_failures.inc()
            if pending or torn_batch:
                m.torn_batches.inc()
        return good

    def get(self, key: bytes) -> Optional[bytes]:
        return self._mem.get(key)

    def set(self, key: bytes, value: bytes) -> None:
        self.write_batch([(key, value)])

    def delete(self, key: bytes) -> None:
        self.write_batch([], [key])

    def iterate(self, start: bytes = b"", end: Optional[bytes] = None):
        return self._mem.iterate(start, end)

    def write_batch(self, sets, deletes=()):
        """Crash-atomic: records + commit marker go down in ONE write
        through the faultio seam, and the in-memory index is touched
        only after the disk image is past its commit point — a tear at
        any byte offset replays to the exact pre-batch state."""
        with self._lock:
            buf = bytearray()
            n = 0
            for k, v in sets:
                buf += _enc2(_REC_SET2, k, v)
                n += 1
            for k in deletes:
                buf += _enc2(_REC_DEL2, k)
                n += 1
            if n == 0:
                return
            buf += _enc2(_REC_COMMIT, b"", _U32.pack(n))
            self._f.write(bytes(buf))
            self._f.flush()
            if self._fsync:
                faultio.fsync(self._f)
            for k, v in sets:
                self._mem.set(k, v)
            for k in deletes:
                self._mem.delete(k)

    def compact(self):
        """Rewrite live records as one committed v2 batch into a temp
        file, then atomically swap it in — also the one-time v1→v2
        upgrade. The two fail points bracket the os.replace so the
        crash matrix pins both halves: pre = old log intact + stale
        temp (removed at next open), post = new log already live."""
        with self._lock:
            tmp = self.path + ".compact"
            live = list(self._mem.iterate())
            f = faultio.open_file(tmp, "wb", label="db:compact")
            try:
                buf = bytearray()
                for k, v in live:
                    buf += _enc2(_REC_SET2, k, v)
                buf += _enc2(_REC_COMMIT, b"", _U32.pack(len(live)))
                f.write(bytes(buf))
                f.flush()
                faultio.fsync(f)
            finally:
                f.close()
            self._f.close()
            fail_point("db:pre-compact-replace")
            os.replace(tmp, self.path)
            fail_point("db:post-compact-replace")
            self._f = faultio.open_file(self.path, "ab", label="db:log")
            self.needs_upgrade = False

    def close(self):
        self._f.close()


def open_db(backend: str, name: str, directory: str) -> KVStore:
    if backend == "memdb":
        return MemDB()
    if backend == "filedb":
        return FileDB(os.path.join(directory, f"{name}.db"))
    if backend == "native":
        from .native import NativeDB
        return NativeDB(os.path.join(directory, f"{name}.db"))
    raise ValueError(f"unknown db backend {backend!r}")
