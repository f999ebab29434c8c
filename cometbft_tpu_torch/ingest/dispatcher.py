"""In-order verdict application: batch admission must be a
verdict-equivalent drop-in for sequential `check_tx`.

The dispatcher turns a resolved signature verdict plus the ticket's tx
into exactly the sequence of mempool/app effects the sequential path
produces: tickets are applied strictly in submission (FIFO) order, a
bad-signature tx never reaches the app, and every rejection releases
the admission duplicate filter the same way `CListMempool` releases
its own cache for invalid txs (keep_invalid=False semantics) — so a
corrected or retried tx re-enters instead of bouncing off a stale
filter entry. App-CheckTx call order, mempool contents, FIFO reap
order, and recheck behavior are byte-for-byte those of the sequential
path (tests/test_ingest.py pins the equivalence at depth 1 and N).

Copy of `cometbft_tpu/ingest/dispatcher.py` (the port keeps its own).
"""

from __future__ import annotations

from ..mempool.mempool import CODE_TYPE_OK

# admission-layer rejection code for an envelope whose ed25519
# signature failed (or whose frame was malformed): outside the app's
# code space on purpose — the app never saw the tx
CODE_BAD_SIGNATURE = 101


class VerdictDispatcher:
    """Applies one ticket's verdict into the mempool. Callers (the
    pipeline's flush, or sequential submit) already serialize
    application in FIFO order; the mempool's own lock makes the
    app-CheckTx call sequence identical either way."""

    def __init__(self, mempool, tx_filter, metrics=None):
        self.mempool = mempool
        self.filter = tx_filter
        self.metrics = metrics  # libs/metrics_gen.IngestMetrics or None
        self.admitted = 0
        self.rejected = 0

    def apply(self, ticket, sig_ok: bool) -> None:
        """Resolve `ticket` with the mempool outcome of its tx. Always
        sets the ticket's event, even on an unexpected mempool error."""
        try:
            if not sig_ok:
                ticket.code = CODE_BAD_SIGNATURE
                self.filter.remove(ticket.key)
                self._reject("sig")
                return
            try:
                code = self.mempool.check_tx(ticket.tx)
            except ValueError as e:
                # structural rejection (full / too large / duplicate in
                # the mempool's own cache): release the filter entry so
                # a later retry reaches the mempool again, exactly as
                # the sequential path would
                ticket.error = e
                self.filter.remove(ticket.key)
                self._reject("mempool")
                return
            ticket.code = code
            if code != CODE_TYPE_OK:
                # the mempool evicted the invalid tx from its cache
                # (keep_invalid=False); mirror that in the front filter
                self.filter.remove(ticket.key)
                self._reject("app")
            else:
                self.admitted += 1
                if self.metrics is not None:
                    self.metrics.admitted.inc()
        finally:
            ticket._ev.set()

    def _reject(self, reason: str) -> None:
        self.rejected += 1
        if self.metrics is not None:
            self.metrics.rejected.inc(reason=reason)
