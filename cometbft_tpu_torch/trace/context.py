"""Explicit trace-context propagation — the carrier that rides the
data plane's own handles instead of thread-locals.

A `TraceContext` is the (trace_id, span_id) pair of the span a unit of
work descends from. It is carried EXPLICITLY: `TxTicket.ctx`,
`CheckTicket.ctx`, the pipeline `_Tile.ctx`, `MeshFuture.ctx`, and the
`ctx=` keyword on `DeviceClient.submit()` / `MeshExecutor.submit()`.
Thread-locals are deliberately not used — the batchers coalesce work
from many submitter threads into one flush thread, so ambient context
would attribute every span to whichever thread happened to flush
(docs/TRACE.md "propagation rules").

On the device wire the context travels as a backward-compatible
request trailer (device/protocol.encode_request `trace=`), exactly
like the mesh's per-lane shard-attribution response trailer: v1 decoders
that predate it reject nothing, because the trailer is only appended
when tracing is enabled and the v2 decoder accepts both forms.

Copy of `cometbft_tpu/trace/context.py` (the port keeps its own).
"""

from __future__ import annotations

import struct
from typing import Optional

# the wire form is two u64le ids — see device/protocol.py
WIRE_LEN = 16


class TraceContext:
    """Immutable (trace_id, span_id) pair linking child work to the
    span that caused it."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: int, span_id: int):
        object.__setattr__(self, "trace_id", int(trace_id))
        object.__setattr__(self, "span_id", int(span_id))

    def __setattr__(self, name, value):  # pragma: no cover - guard
        raise AttributeError("TraceContext is immutable")

    def __eq__(self, other) -> bool:
        return (isinstance(other, TraceContext)
                and other.trace_id == self.trace_id
                and other.span_id == self.span_id)

    def __hash__(self) -> int:
        return hash((self.trace_id, self.span_id))

    def __repr__(self) -> str:
        return f"TraceContext({self.trace_id}, {self.span_id})"

    # --- wire form (device protocol trailer) ------------------------------

    def to_wire(self) -> bytes:
        return struct.pack("<QQ", self.trace_id, self.span_id)

    @classmethod
    def from_wire(cls, raw: bytes) -> "TraceContext":
        if len(raw) != WIRE_LEN:
            raise ValueError(f"trace trailer must be {WIRE_LEN} bytes")
        trace_id, span_id = struct.unpack("<QQ", raw)
        return cls(trace_id, span_id)


def ctx_of(parent) -> Optional[TraceContext]:
    """Normalize a propagation argument: accepts a Span (live or
    no-op), a TraceContext, or None; returns a TraceContext or None.
    The single place the `parent=` / `ctx=` keywords are interpreted,
    so every seam accepts the same shapes."""
    if parent is None:
        return None
    if isinstance(parent, TraceContext):
        return parent
    return parent.ctx  # Span.ctx (NoopSpan.ctx is None)
