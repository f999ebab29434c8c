"""Pubsub server: query-filtered subscriptions with bounded buffers
(reference internal/pubsub/pubsub.go).

Copy of `cometbft_tpu/pubsub/pubsub.py` in the port.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional, Tuple

from .query import Query


class SubscriptionError(Exception):
    pass


DEFAULT_SUB_BUFFER = 100


@dataclass
class Subscription:
    subscriber: str
    query: Query
    out: "queue.Queue" = dc_field(
        default_factory=lambda: queue.Queue(DEFAULT_SUB_BUFFER))
    cancelled: bool = False
    # events discarded by the drop-oldest policy because this
    # subscriber fell behind its bounded buffer — the fan-out is
    # non-blocking by contract, so lag is visible here, never as a
    # stalled publisher
    dropped: int = 0

    def next(self, timeout: Optional[float] = None):
        """Blocking read of the next published message; None on cancel."""
        try:
            return self.out.get(timeout=timeout)
        except queue.Empty:
            return None


class PubSubServer:
    """reference pubsub.go Server: subscribe/unsubscribe/publish."""

    def __init__(self):
        self._subs: Dict[Tuple[str, str], Subscription] = {}
        self._lock = threading.RLock()

    def subscribe(self, subscriber: str, query: Query,
                  buffer: int = DEFAULT_SUB_BUFFER) -> Subscription:
        key = (subscriber, query.raw)
        with self._lock:
            if key in self._subs:
                raise SubscriptionError(
                    f"{subscriber} already subscribed to {query.raw!r}")
            sub = Subscription(subscriber, query,
                               queue.Queue(buffer))
            self._subs[key] = sub
            return sub

    def unsubscribe(self, subscriber: str, query: Query) -> None:
        with self._lock:
            sub = self._subs.pop((subscriber, query.raw), None)
        if sub is not None:
            sub.cancelled = True

    def unsubscribe_all(self, subscriber: str) -> None:
        with self._lock:
            keys = [k for k in self._subs if k[0] == subscriber]
            for k in keys:
                self._subs.pop(k).cancelled = True

    def publish(self, msg: Any, events: Dict[str, List[str]]) -> None:
        """Deliver to every matching subscription — NEVER blocking the
        publisher (the consensus/executor thread): a full buffer drops
        the oldest entry and counts it on the subscription (the
        reference cancels slow subscribers — for an embedded bus,
        sliding is friendlier, still bounded, and the lag is
        observable via `Subscription.dropped`)."""
        with self._lock:
            subs = list(self._subs.values())
        for sub in subs:
            if sub.query.matches(events):
                try:
                    sub.out.put_nowait((msg, events))
                except queue.Full:
                    try:
                        sub.out.get_nowait()
                        sub.dropped += 1
                    except queue.Empty:
                        pass
                    try:
                        sub.out.put_nowait((msg, events))
                    except queue.Full:
                        sub.dropped += 1

    def num_subscriptions(self) -> int:
        with self._lock:
            return len(self._subs)
