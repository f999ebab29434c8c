"""Event bus: typed consensus events over pubsub
(reference types/event_bus.go, types/events.go).

Standard event tags: tm.event ∈ {NewBlock, NewBlockHeader, Tx,
NewRound, CompleteProposal, Vote, ValidatorSetUpdates}; tx events add
tx.hash and tx.height plus app-emitted ABCI event attributes
(composite key "type.attr_key", reference types/events.go:180-210).

Copy of `cometbft_tpu/pubsub/events.py` in the port.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List

from .pubsub import PubSubServer, Subscription
from .query import Query

EVENT_NEW_BLOCK = "NewBlock"
EVENT_NEW_BLOCK_HEADER = "NewBlockHeader"
EVENT_TX = "Tx"
EVENT_VOTE = "Vote"
EVENT_NEW_ROUND = "NewRound"
EVENT_COMPLETE_PROPOSAL = "CompleteProposal"
EVENT_VALIDATOR_SET_UPDATES = "ValidatorSetUpdates"

QUERY_NEW_BLOCK = Query("tm.event = 'NewBlock'")
QUERY_TX = Query("tm.event = 'Tx'")


def tx_event_attrs(height: int, tx: bytes, result) -> Dict[str, List[str]]:
    """The tx event's composite-key attributes (events.go:180): the ONE
    definition shared by the live bus path (publish_tx) and offline
    reindexing (indexer.kv.reindex_block) — the two must never diverge
    or a reindex breaks tx_search parity."""
    from ..types.block import tx_hash
    attrs: Dict[str, List[str]] = {
        "tx.hash": [tx_hash(tx).hex().upper()],
        "tx.height": [str(height)],
    }
    for ev_type, kvs in getattr(result, "events", []) or []:
        for k, v in kvs:
            attrs.setdefault(f"{ev_type}.{k}", []).append(str(v))
    return attrs


@dataclass
class Event:
    kind: str
    data: Any
    attributes: Dict[str, List[str]] = dc_field(default_factory=dict)


class EventBus:
    """reference types/event_bus.go EventBus — the pubsub facade the
    node wires consensus/state into, and RPC subscribes out of."""

    def __init__(self):
        self.server = PubSubServer()

    def subscribe(self, subscriber: str, query: Query,
                  buffer: int = None) -> Subscription:
        """Bounded, non-blocking subscription: a subscriber that falls
        behind `buffer` pending events loses the oldest (drop-oldest,
        counted on the subscription) rather than stalling the
        publisher."""
        from .pubsub import DEFAULT_SUB_BUFFER
        return self.server.subscribe(
            subscriber, query,
            buffer if buffer is not None else DEFAULT_SUB_BUFFER)

    def unsubscribe_all(self, subscriber: str) -> None:
        self.server.unsubscribe_all(subscriber)

    def _publish(self, kind: str, data: Any,
                 extra: Dict[str, List[str]]) -> None:
        events = {"tm.event": [kind]}
        events.update(extra)
        self.server.publish(Event(kind, data, events), events)

    # --- typed publishers (event_bus.go:70-200) ------------------------------

    def publish_new_block(self, block, result) -> None:
        self._publish(EVENT_NEW_BLOCK, (block, result), {
            "block.height": [str(block.header.height)]})

    def publish_new_block_header(self, header) -> None:
        self._publish(EVENT_NEW_BLOCK_HEADER, header, {
            "block.height": [str(header.height)]})

    def publish_tx(self, height: int, index: int, tx: bytes,
                   result) -> None:
        """Tx event with app-emitted attributes flattened to composite
        keys (events.go:180 composite key rule)."""
        self._publish(EVENT_TX, (height, index, tx, result),
                      tx_event_attrs(height, tx, result))

    def publish_vote(self, vote) -> None:
        self._publish(EVENT_VOTE, vote, {})

    def publish_validator_set_updates(self, updates) -> None:
        self._publish(EVENT_VALIDATOR_SET_UPDATES, updates, {})
