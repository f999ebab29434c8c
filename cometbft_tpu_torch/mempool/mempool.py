"""Mempool: CheckTx admission, FIFO ordering, reap, recheck
(reference mempool/mempool.go:25-118 interface,
mempool/clist_mempool.go:48-52,251-370, mempool/cache.go).

The reference's CList (concurrent linked list) exists so per-peer gossip
goroutines can hold stable cursors while the list mutates; here an
OrderedDict gives the same FIFO-with-O(1)-removal shape, and gossip
cursors are height-stamped iteration (see p2p reactor) — the
single-writer engine loop serializes mutations (SURVEY §2.3).

Copy of `cometbft_tpu/mempool/mempool.py` (the port keeps its own; the
standard library only). `mempool/reactor.py` (p2p gossip) is not ported
yet (ROADMAP.md Queue 1: the host-only layers).
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Protocol, Tuple

CODE_TYPE_OK = 0


def tx_key(tx: bytes) -> bytes:
    """sha256 identity of a tx (reference types/tx.go Tx.Key)."""
    return hashlib.sha256(tx).digest()


class Mempool(Protocol):
    """reference mempool/mempool.go:25-118 (subset that consensus and
    the block executor consume)."""

    def check_tx(self, tx: bytes) -> int: ...
    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int
                               ) -> List[bytes]: ...
    def reap_max_txs(self, n: int) -> List[bytes]: ...
    def lock(self) -> None: ...
    def unlock(self) -> None: ...
    def update(self, height: int, txs: List[bytes], results) -> None: ...
    def flush(self) -> None: ...
    def size(self) -> int: ...
    def size_bytes(self) -> int: ...


class TxCache:
    """LRU seen-tx cache (reference mempool/cache.go LRUTxCache):
    spam/duplicate filter in front of CheckTx."""

    def __init__(self, size: int = 10000):
        self._size = size
        self._map: "OrderedDict[bytes, None]" = OrderedDict()

    def push(self, key: bytes) -> bool:
        """Returns False if already present (and refreshes recency)."""
        if key in self._map:
            self._map.move_to_end(key)
            return False
        self._map[key] = None
        if len(self._map) > self._size:
            self._map.popitem(last=False)
        return True

    def remove(self, key: bytes) -> None:
        self._map.pop(key, None)

    def reset(self) -> None:
        self._map.clear()

    def __contains__(self, key: bytes) -> bool:
        return key in self._map

    def __len__(self) -> int:
        return len(self._map)


@dataclass
class _MempoolTx:
    """reference mempool/clist_mempool.go mempoolTx."""
    tx: bytes
    height: int        # height at which the tx was admitted
    gas_wanted: int = 0


class TxRemovedError(Exception):
    pass


class CListMempool:
    """FIFO mempool over an app CheckTx callback
    (reference mempool/clist_mempool.go:48-118).

    check_fn(tx) -> (code, gas_wanted); code 0 admits. `keep_in_cache`
    mirrors the reference's config.CacheSize + KeepInvalidTxsInCache
    semantics: invalid txs are evicted from the cache so a later valid
    variant can re-enter, unless keep_invalid is set.
    """

    def __init__(self, check_fn: Callable[[bytes], Tuple[int, int]],
                 max_tx_bytes: int = 1024 * 1024,
                 max_txs_bytes: int = 64 * 1024 * 1024,
                 size: int = 5000, cache_size: int = 10000,
                 keep_invalid_in_cache: bool = False,
                 recheck: bool = True):
        self._check_fn = check_fn
        self._max_tx_bytes = max_tx_bytes
        self._max_txs_bytes = max_txs_bytes
        self._max_size = size
        self._recheck = recheck
        self._keep_invalid = keep_invalid_in_cache
        self.cache = TxCache(cache_size)
        self._txs: "OrderedDict[bytes, _MempoolTx]" = OrderedDict()
        self._bytes = 0
        self._height = 0
        self._update_lock = threading.RLock()
        self._notify: List[Callable[[], None]] = []
        # cache-eviction observers (ingest/admission.TxFilter mirrors
        # this cache: a tx the mempool forgets must be resubmittable
        # through the front door too). cb(key) per eviction; cb(None)
        # on a wholesale reset (flush)
        self._evict_cbs: List[Callable[[Optional[bytes]], None]] = []
        # optional generated metrics struct
        # (libs/metrics_gen.MempoolMetrics — reference
        # mempool/metrics.go); None until the node wires it
        self.metrics = None

    # --- admission -----------------------------------------------------------

    def check_tx(self, tx: bytes) -> int:
        """Admit a tx (reference clist_mempool.go:251-313 CheckTx).
        Returns the app code (0 = admitted). Raises ValueError on
        structural rejection (too large / full / duplicate)."""
        with self._update_lock:
            if len(tx) > self._max_tx_bytes:
                raise ValueError(
                    f"tx too large: {len(tx)} > {self._max_tx_bytes}")
            if (len(self._txs) >= self._max_size
                    or self._bytes + len(tx) > self._max_txs_bytes):
                raise ValueError("mempool is full")
            key = tx_key(tx)
            if not self.cache.push(key):
                raise ValueError("tx already in cache")
            code, gas = self._check_fn(tx)
            if code != CODE_TYPE_OK:
                if not self._keep_invalid:
                    self.cache.remove(key)
                    self._fire_evict(key)
                if self.metrics is not None:
                    self.metrics.failed_txs.inc()
                return code
            self._txs[key] = _MempoolTx(tx, self._height, gas)
            self._bytes += len(tx)
            self._set_gauges()
            for cb in self._notify:
                cb(tx)
            return CODE_TYPE_OK

    def _set_gauges(self) -> None:
        if self.metrics is not None:
            self.metrics.size.set(len(self._txs))
            self.metrics.size_bytes.set(self._bytes)

    def on_new_tx(self, cb: Callable[[bytes], None]) -> None:
        """Subscribe to tx arrival with the admitted tx (gossip relay /
        consensus wake-up)."""
        self._notify.append(cb)

    def on_tx_evicted(self, cb: Callable[[Optional[bytes]], None]) -> None:
        """Subscribe to seen-cache evictions: cb(tx_key) whenever an
        invalid/rechecked tx is dropped from the cache, cb(None) when
        the cache resets wholesale."""
        self._evict_cbs.append(cb)

    def _fire_evict(self, key: Optional[bytes]) -> None:
        for cb in self._evict_cbs:
            cb(key)

    # --- reaping -------------------------------------------------------------

    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int
                               ) -> List[bytes]:
        """FIFO reap under byte/gas budgets (reference
        clist_mempool.go:519-552)."""
        with self._update_lock:
            out, total_b, total_g = [], 0, 0
            for mt in self._txs.values():
                nb = total_b + len(mt.tx)
                ng = total_g + mt.gas_wanted
                if max_bytes >= 0 and nb > max_bytes:
                    break
                if max_gas >= 0 and ng > max_gas:
                    break
                out.append(mt.tx)
                total_b, total_g = nb, ng
            return out

    def reap_max_txs(self, n: int) -> List[bytes]:
        with self._update_lock:
            if n < 0:
                return [mt.tx for mt in self._txs.values()]
            return [mt.tx for mt in list(self._txs.values())[:n]]

    def txs_after(self, start: int) -> List[bytes]:
        """Gossip helper: all txs, FIFO (cursor management is the
        caller's; reference mempool/reactor.go:217 broadcastTxRoutine)."""
        return self.reap_max_txs(-1)[start:]

    # --- post-commit update --------------------------------------------------

    def lock(self) -> None:
        # staticcheck: allow(resource-lifecycle)  ## exported lock()/unlock() pair — the caller brackets app.commit()+update() across statements (reference clist_mempool.go Lock/Unlock); pairing is the caller's contract, pinned by test_mempool
        self._update_lock.acquire()

    def unlock(self) -> None:
        self._update_lock.release()

    def update(self, height: int, txs: List[bytes], results=None) -> None:
        """Remove committed txs and recheck survivors against the
        post-commit app state (reference clist_mempool.go:577-649).
        Caller holds lock() around app.commit()+update()."""
        self._height = height
        for i, tx in enumerate(txs):
            key = tx_key(tx)
            # committed txs stay in the cache to block replays; invalid
            # ones are evicted (reference clist_mempool.go:600-612)
            code = (results[i].code if results is not None
                    and i < len(results) else CODE_TYPE_OK)
            if code == CODE_TYPE_OK:
                self.cache.push(key)
            elif not self._keep_invalid:
                self.cache.remove(key)
                self._fire_evict(key)
            mt = self._txs.pop(key, None)
            if mt is not None:
                self._bytes -= len(mt.tx)
        if self._recheck and self._txs:
            self._recheck_txs()
        self._set_gauges()

    def _recheck_txs(self) -> None:
        """Re-run CheckTx on every pending tx (reference
        clist_mempool.go:655-687 recheckTxs)."""
        if self.metrics is not None:
            self.metrics.recheck_times.inc()
        for key in list(self._txs.keys()):
            mt = self._txs[key]
            code, gas = self._check_fn(mt.tx)
            if code != CODE_TYPE_OK:
                del self._txs[key]
                self._bytes -= len(mt.tx)
                if not self._keep_invalid:
                    self.cache.remove(key)
                    self._fire_evict(key)
                if self.metrics is not None:
                    self.metrics.evicted_txs.inc()
            else:
                mt.gas_wanted = gas

    def flush(self) -> None:
        with self._update_lock:
            self._txs.clear()
            self._bytes = 0
            self.cache.reset()
            self._fire_evict(None)
            self._set_gauges()

    # --- introspection -------------------------------------------------------

    def size(self) -> int:
        return len(self._txs)

    def size_bytes(self) -> int:
        return self._bytes

    def contains(self, key: bytes) -> bool:
        return key in self._txs

    def is_empty(self) -> bool:
        return not self._txs


class NopMempool:
    """reference mempool/nop_mempool.go — for apps that disseminate txs
    themselves."""

    def check_tx(self, tx: bytes) -> int:
        raise ValueError("tx rejected: nop mempool")

    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int):
        return []

    def reap_max_txs(self, n: int):
        return []

    def lock(self) -> None:
        pass

    def unlock(self) -> None:
        pass

    def update(self, height: int, txs, results=None) -> None:
        pass

    def flush(self) -> None:
        pass

    def size(self) -> int:
        return 0

    def size_bytes(self) -> int:
        return 0
