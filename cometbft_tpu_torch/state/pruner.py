"""Background pruning service honoring the app's retain height
(reference state/pruner.go — the Commit response's retain_height,
state/execution.go:315) and the data companion's retain heights set
through the privileged gRPC PruningService (reference
rpc/grpc/server/privileged, proto/cometbft/services/pruning/v1).

Block data is pruned to the LOWER of the app's and the companion's
retain heights (each treated as "no opinion" while 0, matching the
reference pruner's findMinRetainHeight). Block results, tx-index and
block-index retain heights are companion-only.

Copy of `cometbft_tpu/state/pruner.py` in the port.
"""

from __future__ import annotations

import threading
from typing import Optional


def _effective(*heights: int) -> int:
    """min of the set (>0) opinions; 0 = nobody asked to prune."""
    set_ = [h for h in heights if h > 0]
    return min(set_) if set_ else 0


class Pruner:
    """Prunes block data below the app-requested retain height."""

    def __init__(self, block_store, state_store=None,
                 interval_s: float = 10.0, tx_indexer=None,
                 block_indexer=None):
        self.block_store = block_store
        self.state_store = state_store
        self.tx_indexer = tx_indexer
        self.block_indexer = block_indexer
        self.interval_s = interval_s
        self._retain = 0                 # app (ResponseCommit)
        self._companion_retain = 0       # PruningService block retain
        self._results_retain = 0         # PruningService block results
        self._tx_index_retain = 0        # PruningService tx indexer
        self._block_index_retain = 0     # PruningService block indexer
        self._tx_index_applied = 0       # last retain actually scanned
        self._block_index_applied = 0
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # companion opinions survive restarts (reference pruner reads
        # them back from the state store)
        if state_store is not None and \
                hasattr(state_store, "load_companion_retain_heights"):
            d = state_store.load_companion_retain_heights()
            self._companion_retain = d.get("block", 0)
            self._results_retain = d.get("results", 0)
            self._tx_index_retain = d.get("tx_index", 0)
            self._block_index_retain = d.get("block_index", 0)

    def set_retain_height(self, height: int) -> None:
        """Called with ResponseCommit.retain_height (0 = keep all)."""
        if height > self._retain:
            self._retain = height
            self._wake.set()

    # --- companion (privileged PruningService) setters ---------------------

    def _persist_companion(self) -> None:
        if self.state_store is not None and \
                hasattr(self.state_store, "save_companion_retain_heights"):
            self.state_store.save_companion_retain_heights({
                "block": self._companion_retain,
                "results": self._results_retain,
                "tx_index": self._tx_index_retain,
                "block_index": self._block_index_retain})

    def set_companion_block_retain_height(self, height: int) -> None:
        self._companion_retain = height
        self._persist_companion()
        self._wake.set()

    def set_block_results_retain_height(self, height: int) -> None:
        self._results_retain = height
        self._persist_companion()
        self._wake.set()

    def set_tx_indexer_retain_height(self, height: int) -> None:
        self._tx_index_retain = height
        self._persist_companion()
        self._wake.set()

    def set_block_indexer_retain_height(self, height: int) -> None:
        self._block_index_retain = height
        self._persist_companion()
        self._wake.set()

    def retain_heights(self) -> dict:
        """Snapshot for the Get* pruning APIs."""
        return {
            "app_retain_height": self._retain,
            "pruning_service_block_retain_height": self._companion_retain,
            "pruning_service_block_results_retain_height":
                self._results_retain,
            "pruning_service_tx_indexer_retain_height":
                self._tx_index_retain,
            "pruning_service_block_indexer_retain_height":
                self._block_index_retain,
        }

    def prune_now(self) -> int:
        retain = _effective(self._retain, self._companion_retain)
        pruned = 0
        if retain > 0:
            pruned = self.block_store.prune_blocks(
                min(retain, self.block_store.height()))
            if self.state_store is not None:
                self.state_store.prune(retain)
        if self._results_retain > 0 and self.state_store is not None:
            # never drop the latest response: crash recovery replays
            # from it (reference pruner.go keeps the tip)
            self.state_store.prune_abci_responses(
                min(self._results_retain, self.block_store.height()))
        # the indexer prunes are FULL SCANS of their stores — run them
        # only when the retain height actually moved, not every wake
        if self.tx_indexer is not None and \
                self._tx_index_retain > self._tx_index_applied:
            self.tx_indexer.prune(self._tx_index_retain)
            self._tx_index_applied = self._tx_index_retain
        if self.block_indexer is not None and \
                self._block_index_retain > self._block_index_applied:
            self.block_indexer.prune(self._block_index_retain)
            self._block_index_applied = self._block_index_retain
        return pruned

    def start(self) -> None:
        def loop():
            while not self._stop.is_set():
                if self._wake.wait(timeout=self.interval_s):
                    self._wake.clear()
                if not self._stop.is_set():
                    self.prune_now()
        self._thread = threading.Thread(target=loop, name="pruner",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
