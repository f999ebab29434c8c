"""Span runtime: the deterministic, low-overhead core of the flight
recorder.

Determinism contract (what lets simnet runs emit byte-identical trace
JSONL per seed):

  * span/trace ids come from a SEEDED COUNTER (`Tracer.reseed`), never
    from `id()`, wall time, or an RNG — two runs with the same seed
    and the same call order allocate the same ids;
  * timestamps flow EXCLUSIVELY through `libs/timesource`, so under
    simnet's virtual clock every t0/t1/event stamp is a pure function
    of the event queue;
  * `Span.to_dict()` emits a stable key set and the JSON encoder
    downstream (recorder/export) sorts keys — same spans, same bytes.

Overhead contract: with tracing disabled, `Tracer.start()` is one
attribute lookup (`self.enabled`) and returns the process-wide
`NOOP_SPAN` singleton — no allocation at all (the no-op-mode test pins
this by object identity). Hot loops that would otherwise build kwargs
for attributes should additionally gate on `tracer.enabled`.

Copy of `cometbft_tpu/trace/span.py` (the port keeps its own).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ..libs import timesource
from .context import TraceContext, ctx_of

# reseed(seed) spaces id ranges per seed so a seed's ids never collide
# with another seed's in a merged view; 2**20 spans per run is far
# above any ring capacity in use
SEED_ID_STRIDE = 1 << 20


class NoopSpan:
    """The disabled-mode span: every method is a no-op, `ctx` is None
    so child work propagates nothing. A single module-level instance
    (`NOOP_SPAN`) is returned for every disabled start() — zero
    allocations per call, verified by object identity in the tests."""

    __slots__ = ()

    ctx: Optional[TraceContext] = None

    def set_attr(self, key: str, value) -> None:
        pass

    def event(self, name: str, **attrs) -> None:
        pass

    def link(self, ctx) -> None:
        pass

    def end(self) -> None:
        pass

    def __enter__(self) -> "NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NOOP_SPAN = NoopSpan()


class Span:
    """One unit of attributed work: name, parent link, start/end
    timestamps, attributes, point events, and links to causally
    related spans that are not ancestors (a coalesced flush links the
    tickets it serves)."""

    __slots__ = ("_tracer", "name", "trace_id", "span_id", "parent_id",
                 "t_start", "t_end", "attrs", "events", "links",
                 "_ended")

    def __init__(self, tracer: "Tracer", name: str, trace_id: int,
                 span_id: int, parent_id: int,
                 attrs: Optional[Dict] = None):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id  # 0 = root
        self.t_start = timesource.time_ns()
        self.t_end = 0
        self.attrs: Dict = dict(attrs) if attrs else {}
        self.events: List = []
        self.links: List = []
        self._ended = False

    @property
    def ctx(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id)

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value

    def event(self, name: str, **attrs) -> None:
        """Point-in-time annotation inside this span."""
        self.events.append((timesource.time_ns(), name,
                            attrs if attrs else {}))

    def link(self, ctx) -> None:
        """Record a causal link to a span that is NOT an ancestor
        (e.g. a flush span linking each ticket's admit span). Accepts
        a Span/TraceContext/None; None links are dropped."""
        c = ctx_of(ctx)
        if c is not None:
            self.links.append((c.trace_id, c.span_id))

    def end(self) -> None:
        """Close the span and hand it to the recorder. Idempotent —
        a `finally: sp.end()` after an explicit end records once."""
        if self._ended:
            return
        self._ended = True
        self.t_end = timesource.time_ns()
        self._tracer._record(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.end()

    def to_dict(self) -> Dict:
        """Stable JSONL shape (sorted at encode time): sid/tid/pid are
        the span/trace/parent ids; ev entries are [t, name, attrs];
        lk entries are [trace_id, span_id]."""
        d = {"name": self.name, "sid": self.span_id,
             "tid": self.trace_id, "pid": self.parent_id,
             "t0": self.t_start, "t1": self.t_end}
        if self.attrs:
            d["attrs"] = self.attrs
        if self.events:
            d["ev"] = [[t, n, a] for t, n, a in self.events]
        if self.links:
            d["lk"] = [[t, s] for t, s in self.links]
        return d


class Tracer:
    """Span factory with a seeded id counter. One per process
    (trace.shared_tracer()); `enabled` is the single dispatch flag
    every instrumentation site checks."""

    # guarded-by: _lock: _next_id

    def __init__(self, recorder=None, enabled: bool = False,
                 seed: int = 0):
        self.enabled = enabled
        self.recorder = recorder  # trace.recorder.FlightRecorder
        self._lock = threading.Lock()
        self._next_id = seed * SEED_ID_STRIDE + 1

    def reseed(self, seed: int) -> None:
        """Restart the id counter at the seed's range — simnet calls
        this per run so ids (and therefore the JSONL bytes) are a pure
        function of (scenario, seed)."""
        with self._lock:
            self._next_id = seed * SEED_ID_STRIDE + 1

    def start(self, name: str, parent=None, **attrs):
        """New span (or NOOP_SPAN when disabled). `parent` may be a
        Span, a TraceContext, or None; a None parent starts a new
        trace whose trace_id is the root's span_id."""
        if not self.enabled:
            return NOOP_SPAN
        with self._lock:
            span_id = self._next_id
            self._next_id += 1
        pctx = ctx_of(parent)
        if pctx is None:
            return Span(self, name, span_id, span_id, 0, attrs)
        return Span(self, name, pctx.trace_id, span_id, pctx.span_id,
                    attrs)

    def _record(self, span: Span) -> None:
        rec = self.recorder
        if rec is not None:
            rec.record(span)
