"""Mempool gossip reactor (reference mempool/reactor.go:217).

Channel 0x30 carries raw txs. The reference runs a per-peer
broadcastTxRoutine walking the CList; here admission triggers a
broadcast to current peers, and new peers get the current pool replayed
once on add_peer — same delivery guarantee (every peer eventually sees
every pending tx) without per-peer cursors.

Copy of `cometbft_tpu/mempool/reactor.py` in the port.
"""

from __future__ import annotations

from typing import List

from ..p2p.mconn import ChannelDescriptor

MEMPOOL_CHANNEL = 0x30


class MempoolReactor:
    def __init__(self, mempool, ingest=None):
        self.mempool = mempool
        # ingest/admission.IngestPipeline when [mempool] ingest_batch
        # is on: relayed txs then coalesce into the same shared
        # signature batches as RPC traffic instead of walking a
        # synchronous check_tx on the p2p read thread
        self.ingest = ingest
        self._switch = None
        mempool.on_new_tx(self._on_local_admit)
        self._relaying: List[bytes] = []

    def attach(self, switch) -> None:
        self._switch = switch

    def get_channels(self) -> List[ChannelDescriptor]:
        return [ChannelDescriptor(id=MEMPOOL_CHANNEL, priority=3,
                                  send_queue_capacity=1000)]

    def add_peer(self, peer) -> None:
        for tx in self.mempool.reap_max_txs(-1):
            peer.try_send(MEMPOOL_CHANNEL, tx)

    def remove_peer(self, peer, reason: str) -> None:
        pass

    def receive(self, channel_id: int, peer, tx: bytes) -> None:
        if self.ingest is not None:
            # fire-and-forget: duplicates/sheds drop silently and the
            # background flusher settles the ticket off-thread
            self.ingest.submit_nowait(tx)
            return
        try:
            self.mempool.check_tx(tx)
        except ValueError:
            pass  # duplicate/full/invalid: drop (reference logs only)

    def _on_local_admit(self, tx: bytes) -> None:
        if self._switch is not None:
            self._switch.broadcast(MEMPOOL_CHANNEL, tx)
