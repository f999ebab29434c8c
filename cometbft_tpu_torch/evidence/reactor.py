"""Evidence gossip reactor (reference internal/evidence/reactor.go:1-252).

Channel 0x38 carries wire-encoded evidence. The reference runs a
per-peer broadcastEvidenceRoutine walking the pool's clist; here — like
the mempool reactor — local admission triggers a broadcast to current
peers, and a newly-added peer gets the pending pool replayed once. Same
delivery guarantee: every peer eventually holds every pending piece, so
any FUTURE proposer can commit it. Without this reactor a double-sign
witnessed only by non-proposers would never land in a block.

Copy of `cometbft_tpu/evidence/reactor.py` in the port.
"""

from __future__ import annotations

from typing import Callable, List

from ..p2p.mconn import ChannelDescriptor
from ..types.evidence import EvidenceError, decode_evidence

EVIDENCE_CHANNEL = 0x38  # reference internal/evidence/reactor.go:24


class EvidenceReactor:
    def __init__(self, pool, state_getter: Callable):
        self.pool = pool
        self.state_getter = state_getter
        self._switch = None
        pool.on_new_evidence(self._on_admit)

    def attach(self, switch) -> None:
        self._switch = switch

    def get_channels(self) -> List[ChannelDescriptor]:
        # priority 6, small queue: evidence is rare but urgent
        # (reference reactor.go:45-52)
        return [ChannelDescriptor(id=EVIDENCE_CHANNEL, priority=6,
                                  send_queue_capacity=100)]

    def add_peer(self, peer) -> None:
        for ev in self.pool.pending_evidence():
            peer.try_send(EVIDENCE_CHANNEL, ev.encode())

    def remove_peer(self, peer, reason: str) -> None:
        pass

    def receive(self, channel_id: int, peer, raw: bytes) -> None:
        try:
            ev = decode_evidence(raw)
        except (ValueError, KeyError, IndexError):
            return  # malformed: drop (the reference stops the peer)
        try:
            # admission re-broadcasts via _on_admit; dedup in the pool
            # (seen/committed sets) keeps the flood finite
            self.pool.add_evidence(ev, self.state_getter())
        except EvidenceError:
            pass  # invalid/expired: drop (reference logs only)

    def _on_admit(self, ev) -> None:
        if self._switch is not None:
            self._switch.broadcast(EVIDENCE_CHANNEL, ev.encode())
