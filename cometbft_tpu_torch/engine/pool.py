"""Block pool: pipelined block fetching ahead of the verify/apply loop
(reference internal/blocksync/pool.go:71-96,616,776).

Per-height requesters run as a small thread pool pulling from a height
queue; fetched blocks land in an ordered buffer the sync loop pops from.
This overlaps network fetch with TPU verify + apply — the reference's
bpRequester goroutines, bounded like its `maxPendingRequests`
(pool.go:31). The fetch function is pluggable: LocalChainSource for
tests, a p2p requester for real peers (engine/reactor.py).

Copy of `cometbft_tpu/engine/pool.py` (the port keeps its own).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Optional, Tuple

from ..types.block import Block, BlockID


class BlockPool:
    """Prefetching adapter around a PeerSource-shaped fetch function."""

    def __init__(self, fetch: Callable[[int], Optional[Tuple[Block, BlockID]]],
                 max_height: Callable[[], int],
                 start_height: int, lookahead: int = 64,
                 n_workers: int = 8, pop_timeout: float = 30.0):
        self._fetch = fetch
        self._max_height = max_height
        self._lookahead = lookahead
        self._pop_timeout = pop_timeout
        self._next_wanted = start_height
        self._next_to_schedule = start_height
        self._buffer: Dict[int, Optional[Tuple[Block, BlockID]]] = {}
        self._pending = 0  # scheduled fetches not yet landed (under lock)
        self._lock = threading.Lock()
        self._available = threading.Condition(self._lock)
        self._work: "queue.Queue[int]" = queue.Queue()
        self._stop = threading.Event()
        self._workers = [
            threading.Thread(target=self._worker, name=f"bp-req-{i}",
                             daemon=True)
            for i in range(n_workers)]
        for w in self._workers:
            w.start()
        with self._lock:
            self._schedule()

    def _schedule(self) -> None:
        """Keep up to `lookahead` heights in flight (pool.go:616
        makeRequestersRoutine). Caller holds the lock."""
        # +1: the tile engine fetches max_height+1 for the synthetic
        # successor that seals the tip (engine/blocksync._sync_tile)
        top = min(self._next_wanted + self._lookahead - 1,
                  self._max_height() + 1)
        while self._next_to_schedule <= top:
            self._pending += 1
            self._work.put(self._next_to_schedule)
            self._next_to_schedule += 1

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                h = self._work.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                got = self._fetch(h)
            except Exception:  # noqa: BLE001 — a raising fetch lands as
                # a miss (peer error ≙ no block) instead of killing the
                # worker and leaving _pending overcounted forever
                got = None
            with self._available:
                self._buffer[h] = got
                self._pending -= 1
                self._available.notify_all()

    def pending_count(self) -> int:
        """Scheduled fetches that have not landed in the buffer yet —
        reported in SyncStalled diagnostics."""
        with self._lock:
            return self._pending

    def pop(self, height: int, timeout: Optional[float] = None
            ) -> Optional[Tuple[Block, BlockID]]:
        """Blocking ordered read; also advances the scheduling window.

        Entries are retained (not removed) until the window moves past
        them: the tile engine reads boundary heights twice — once as the
        next tile's seal provider, once as a member — so a destructive
        pop would hang the second read (reference pool.go PeekTwoBlocks
        keeps blocks until PopRequest for the same reason)."""
        if timeout is None:
            timeout = self._pop_timeout
        with self._available:
            if height > self._next_wanted:
                self._next_wanted = height
            self._schedule()
            ok = self._available.wait_for(
                lambda: height in self._buffer or self._stop.is_set(),
                timeout=timeout)
            if not ok or height not in self._buffer:
                return None
            got = self._buffer[height]
            # evict everything below the seal-overlap lookback
            for h in [h for h in self._buffer if h < height - 1]:
                del self._buffer[h]
            return got

    def invalidate(self, height: int) -> None:
        """A bad block came back: refetch (the reference redo()s the
        requester after banning the peer, pool.go:776)."""
        with self._available:
            self._buffer.pop(height, None)
            self._pending += 1
        self._work.put(height)

    def stop(self) -> None:
        """Ends the workers and wakes a waiting `pop` (it returns None)."""
        with self._available:
            self._stop.set()
            self._available.notify_all()


class PooledSource:
    """PeerSource adapter: BlocksyncReactor's fetch() hits the prefetch
    buffer instead of the network directly."""

    def __init__(self, inner, start_height: int, lookahead: int = 64,
                 n_workers: int = 8, pop_timeout: float = 30.0):
        self._inner = inner
        self._pool = BlockPool(inner.fetch, inner.max_height,
                               start_height, lookahead, n_workers,
                               pop_timeout=pop_timeout)

    def max_height(self) -> int:
        return self._inner.max_height()

    def fetch(self, height: int):
        return self._pool.pop(height)

    def pending_fetches(self) -> int:
        """Surfaced by BlocksyncReactor in SyncStalled messages."""
        return self._pool.pending_count()

    def ban(self, height: int) -> None:
        self._inner.ban(height)
        self._pool.invalidate(height)

    def stop(self) -> None:
        self._pool.stop()
