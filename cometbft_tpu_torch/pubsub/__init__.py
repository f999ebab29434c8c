"""Copy of `cometbft_tpu/pubsub/__init__.py` in the port."""

from .query import Query, QueryError
from .pubsub import PubSubServer, Subscription
from .events import EventBus, Event

__all__ = ["Query", "QueryError", "PubSubServer", "Subscription",
           "EventBus", "Event"]
