"""Bounded verified-signature cache shared across verification paths.

Consensus gossip re-delivers the same precommit many times, blocksync
re-fetches tile-boundary blocks, and the light client re-verifies
commits blocksync already checked — each re-verification is a wasted
device lane (or a ~400µs host verify). The cache records signatures
that VERIFIED TRUE, keyed by (pubkey, sign_bytes, sig): the sign bytes
embed chain id, height, round, and type, so a hit is exactly "this key
already verified these bytes under this chain" — never a cross-context
confusion. Failed signatures are never cached (attribution paths handle
them), so a hit can only skip work, never flip a verdict.

Intake paths attribute hits/misses per label ("blocksync", "vote",
"commit") — the raw material of the pipeline_sigcache_{hits,misses}
Prometheus counters (libs/metrics_defs.PipelineMetrics). Capacity is
LRU-bounded; COMETBFT_TPU_SIGCACHE_CAPACITY overrides the default
(0 disables the process-wide shared cache entirely).

Copy of `cometbft_tpu/pipeline/cache.py` (the port keeps its own).
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Dict, Optional

from ..libs.env import env_int

DEFAULT_CAPACITY = 65536
ENV_CAPACITY = "COMETBFT_TPU_SIGCACHE_CAPACITY"


def _key(pub: bytes, sign_bytes: bytes, sig: bytes) -> bytes:
    # length-prefixed concat: no ambiguity between field boundaries
    h = hashlib.sha256()
    for part in (pub, sign_bytes, sig):
        h.update(len(part).to_bytes(4, "big"))
        h.update(part)
    return h.digest()


class SigCache:
    """Thread-safe LRU of verified-true signatures."""

    # guarded-by: _lock: _entries, hits, misses, evictions
    # (enforced by tools/staticcheck's guarded-by rule: any access to
    # the attributes above outside `with self._lock` is a lint error)

    def __init__(self, capacity: int = DEFAULT_CAPACITY, metrics=None):
        self.capacity = capacity
        self.metrics = metrics  # libs/metrics_gen.PipelineMetrics or None
        self._lock = threading.Lock()
        self._entries: "OrderedDict[bytes, None]" = OrderedDict()
        self.evictions = 0
        self.hits: Dict[str, int] = {}
        self.misses: Dict[str, int] = {}

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @staticmethod
    def key(pub: bytes, sign_bytes: bytes, sig: bytes) -> bytes:
        """Stable digest of one signature triple — the cache's own
        entry key, exposed so the farm batcher's intra-batch dedup
        collapses identical lanes under the same identity."""
        return _key(pub, sign_bytes, sig)

    def seen(self, pub: bytes, sign_bytes: bytes, sig: bytes,
             path: str = "unknown") -> bool:
        """True iff this exact signature previously verified TRUE.
        Counts a hit or miss against `path`."""
        if self.capacity <= 0:
            return False
        k = _key(pub, sign_bytes, sig)
        with self._lock:
            hit = k in self._entries
            if hit:
                self._entries.move_to_end(k)
                self.hits[path] = self.hits.get(path, 0) + 1
            else:
                self.misses[path] = self.misses.get(path, 0) + 1
        m = self.metrics
        if m is not None:
            (m.cache_hits if hit else m.cache_misses).inc(path=path)
        return hit

    def add(self, pub: bytes, sign_bytes: bytes, sig: bytes) -> None:
        """Record a signature that verified TRUE. Never call for a
        failed verification."""
        if self.capacity <= 0:
            return
        evicted = 0
        k = _key(pub, sign_bytes, sig)
        with self._lock:
            self._entries[k] = None
            self._entries.move_to_end(k)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                evicted += 1
            self.evictions += evicted
        if evicted and self.metrics is not None:
            self.metrics.cache_evictions.inc(evicted)

    def hit_rate(self, path: Optional[str] = None) -> float:
        """Hits / (hits + misses), overall or for one intake path."""
        with self._lock:
            if path is None:
                h, m = sum(self.hits.values()), sum(self.misses.values())
            else:
                h, m = self.hits.get(path, 0), self.misses.get(path, 0)
        return h / (h + m) if h + m else 0.0

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.hits.clear()
            self.misses.clear()
            self.evictions = 0


_shared: Optional[SigCache] = None
_shared_lock = threading.Lock()


def shared_cache() -> SigCache:
    """Process-wide cache instance (consensus vote intake, light client,
    and any blocksync engine not given its own). Capacity from
    COMETBFT_TPU_SIGCACHE_CAPACITY at first use; 0 yields a disabled
    (always-miss, never-store) instance."""
    global _shared
    with _shared_lock:
        if _shared is None:
            _shared = SigCache(env_int(ENV_CAPACITY, DEFAULT_CAPACITY))
        return _shared


def reset_shared_cache() -> None:
    """Drop the shared instance (tests; also re-reads the env knob)."""
    global _shared
    with _shared_lock:
        _shared = None
