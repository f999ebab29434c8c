"""Seal provider: serve `(height, header, AggregatedCommit)` tuples out
of the blockstore so laggards can adopt decided heights without block
bodies. Bounded + shed like farm/ingest: a provider under pressure
refuses loudly (SealsyncOverloaded) instead of queueing unboundedly.

Serving rules:
- interior heights serve the CANONICAL commit (block h+1's LastCommit,
  the one `header_{h+1}.last_commit_hash` binds); only the tip serves
  its seen commit (nothing binds the tip — it is always a pivot and
  pays its own pairing on the adopter)
- heights adopted locally via sealsync (body not yet backfilled) are
  served from the adopted-seal record — a freshly-adopted node is
  immediately a useful provider
- an epoch boundary (validators_hash differs from the predecessor
  header's) attaches the new set's bytes from the state store plus
  registered PoPs for its BLS keys; a height whose commit is not
  aggregated ends the sealable run (per-sig chains deep-sync as
  before)

Copy of `cometbft_tpu/sealsync/provider.py` (the port keeps its own).
Its p2p transport is engine/reactor (the seal messages of
BlocksyncNetReactor, NetSealSource); the RPC routes /seal_range and
/seal_status come with the RPC server (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

from ..aggsig.aggregate import registered_pop
from ..types.agg_commit import AggregatedCommit
from .chain import SealTuple

DEFAULT_MAX_BATCH = 128
DEFAULT_MAX_INFLIGHT = 4


class SealsyncOverloaded(RuntimeError):
    """Provider at its inflight bound — caller sheds/retries, never
    queues."""


class SealProvider:
    def __init__(self, block_store, state_store=None, *,
                 max_batch: int = DEFAULT_MAX_BATCH,
                 max_inflight: int = DEFAULT_MAX_INFLIGHT,
                 metrics=None, log=None):
        self._store = block_store
        self._state_store = state_store
        self.max_batch = max_batch
        self.max_inflight = max_inflight
        self._metrics = metrics
        self._log = log
        # guarded-by: _lock: _inflight
        self._lock = threading.Lock()
        self._inflight = 0

    def status(self) -> Tuple[int, int]:
        """(base, sealable tip): the tip counts locally-adopted
        heights, so adoption propagates peer-to-peer ahead of body
        backfill."""
        return (self._store.base(),
                max(self._store.height(), self._store.adopted_tip()))

    def serve(self, start: int, count: int) -> List[SealTuple]:
        """Seal tuples for [start, start+count), clamped to max_batch,
        stopping at the first unsealable height (prefix semantics —
        an empty list means "nothing sealable here")."""
        with self._lock:
            if self._inflight >= self.max_inflight:
                if self._metrics is not None:
                    self._metrics.serve_sheds.inc()
                raise SealsyncOverloaded(
                    f"{self._inflight} serves in flight "
                    f"(bound {self.max_inflight})")
            self._inflight += 1
        try:
            return self._serve(start, max(0, min(count, self.max_batch)))
        finally:
            with self._lock:
                self._inflight -= 1

    def _serve(self, start: int, count: int) -> List[SealTuple]:
        out: List[SealTuple] = []
        prev_vh: Optional[bytes] = None
        for h in range(start, start + count):
            t = self._tuple(h, prev_vh)
            if t is None:
                break
            out.append(t)
            prev_vh = t.header.validators_hash
        if out and self._metrics is not None:
            self._metrics.seals_served.inc(len(out))
        return out

    def _tuple(self, height: int,
               prev_vh: Optional[bytes]) -> Optional[SealTuple]:
        store = self._store
        adopted = store.load_adopted_seal(height)
        if adopted is not None:
            _bid, header, commit = adopted
        else:
            meta = store.load_block_meta(height)
            if meta is None:
                return None
            _bid, header = meta
            if height < store.height():
                commit = store.load_block_commit(height)
            else:
                commit = store.load_seen_commit(height)
        if not isinstance(commit, AggregatedCommit):
            return None
        valset = None
        pops = {}
        if prev_vh is None:
            prev_vh = self._validators_hash(height - 1)
        if prev_vh is not None and header.validators_hash != prev_vh:
            valset, pops = self._epoch_payload(height)
            if valset is None:
                # boundary we cannot attest (no state store / set
                # pruned): end the run rather than serve an
                # unverifiable span
                return None
        return SealTuple(height, header, commit, valset, pops)

    def _validators_hash(self, height: int) -> Optional[bytes]:
        adopted = self._store.load_adopted_seal(height)
        if adopted is not None:
            return adopted[1].validators_hash
        meta = self._store.load_block_meta(height)
        return meta[1].validators_hash if meta is not None else None

    def _epoch_payload(self, height: int):
        if self._state_store is None:
            return None, {}
        vals = self._state_store.load_validators(height)
        if vals is None:
            return None, {}
        pops = {}
        for v in vals.validators:
            pub = v.pub_key.bytes_()
            pop = registered_pop(pub)
            if pop is not None:
                pops[pub] = pop
        return vals, pops
