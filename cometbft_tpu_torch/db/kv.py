"""Key-value storage (the cometbft-db seam, reference go.mod:42,
node/node.go:284; port of `cometbft_tpu/db/kv.py`).

The port carries the `KVStore` protocol and MemDB, an ordered in-memory
map. Iteration is ordered by raw bytes, matching goleveldb semantics the
reference relies on for height-ordered scans. FileDB (the append-only
log with CRC'd batches) and NativeDB, with libs/faultio and
store/recovery behind them, and `open_db`, which picks a backend from
the node config, are not ported yet (ROADMAP.md Queue 1: FileDB).
"""

from __future__ import annotations

import threading
from bisect import bisect_left, insort
from typing import Dict, Iterator, List, Optional, Protocol, Tuple


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

