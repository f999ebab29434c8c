"""trace/ — deterministic flight-recorder tracing across the
verification data plane (docs/TRACE.md).

Every failure this tree survives is a CAUSAL CHAIN — a watchdog trip
demotes a tile, a canary mismatch masks a shard, a shed releases a
filter entry — and until now the only observability was metricsgen
aggregates and log archaeology. This package records the chain itself:

  span.py      Tracer/Span/NoopSpan — seeded-counter ids, timestamps
               exclusively via libs/timesource (byte-identical simnet
               runs per seed), one-attribute-lookup disabled mode
  recorder.py  FlightRecorder — lock-guarded bounded ring, drop-oldest
               with counted evictions, dump-on-trigger (exactly once
               per event) through fail_point("trace:dump")
  context.py   TraceContext — EXPLICIT propagation through tickets,
               tiles, and futures (never thread-locals), plus the
               device-protocol trailer wire form
  export.py    JSONL -> Chrome trace-event conversion + causal-chain
               reconstruction (tools/trace_view.py is the CLI)

Dump triggers are the existing verdict-safety events: pipeline
watchdog trip, device canary failure (terminal quarantine), mesh
shard quarantine, and admission shed bursts.

Process posture matches the device supervisor / mesh executor: ONE
tracer + ONE recorder per process (`shared_tracer()` /
`shared_recorder()`), configured first-wins from node boot
(`configure(config.instrumentation, metrics=...)`); simnet scenarios
and tests drive `enable(seed=...)` / `disable()` explicitly around a
run. Knobs: `[instrumentation] trace / trace_ring / trace_dump_dir`,
overridable via COMETBFT_TPU_TRACE / _TRACE_RING / _TRACE_DUMP_DIR.

Copy of `cometbft_tpu/trace/__init__.py` (the port keeps its own).
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Tuple

from ..libs.env import env_bool, env_int
from .context import TraceContext, ctx_of
from .export import causal_chain, chrome_trace, convert, load_jsonl
from .recorder import DEFAULT_RING_SPANS, FlightRecorder
from .span import NOOP_SPAN, NoopSpan, Span, Tracer

__all__ = [
    "TraceContext", "ctx_of", "causal_chain", "chrome_trace",
    "convert", "load_jsonl", "FlightRecorder", "DEFAULT_RING_SPANS",
    "NOOP_SPAN", "NoopSpan", "Span", "Tracer", "shared_tracer",
    "shared_recorder", "configure", "enable", "disable",
    "trigger_dump", "reset_shared",
]

ENV_TRACE = "COMETBFT_TPU_TRACE"                  # bool
ENV_TRACE_RING = "COMETBFT_TPU_TRACE_RING"        # int (spans)
ENV_TRACE_DUMP_DIR = "COMETBFT_TPU_TRACE_DUMP_DIR"  # str

_lock = threading.Lock()
_recorder = FlightRecorder()
_tracer = Tracer(recorder=_recorder, enabled=False)
_configured = False


def shared_tracer() -> Tracer:
    """The process-wide tracer. Stable for the life of the process —
    modules may hold the reference at import time; enable/disable
    flip its `enabled` flag in place."""
    return _tracer


def shared_recorder() -> FlightRecorder:
    return _recorder


def configure(instr_config=None, metrics=None, log=None) -> None:
    """Latch [instrumentation] trace settings for this process (node
    boot; first caller wins, matching device/health.configure — with
    several in-process nodes, one recorder serves all and re-pointing
    metrics would misfile earlier nodes' counts)."""
    global _configured
    with _lock:
        if _configured:
            return
        _configured = True
        cfg_trace = bool(getattr(instr_config, "trace", False))
        cfg_ring = int(getattr(instr_config, "trace_ring",
                               DEFAULT_RING_SPANS) or DEFAULT_RING_SPANS)
        cfg_dir = getattr(instr_config, "trace_dump_dir", "") or ""
        _recorder.capacity = max(1, env_int(ENV_TRACE_RING, cfg_ring,
                                            minimum=1))
        _recorder.dump_dir = (os.environ.get(ENV_TRACE_DUMP_DIR, "")
                              or cfg_dir or None)
        if metrics is not None:
            _recorder.metrics = metrics
        if log is not None:
            _recorder.log = log
        _tracer.enabled = env_bool(ENV_TRACE, cfg_trace)


def enable(seed: int = 0, ring: Optional[int] = None,
           dump_dir: Optional[str] = None
           ) -> Tuple[Tracer, FlightRecorder]:
    """Explicitly turn tracing on (simnet scenarios, tests, benches):
    resets the ring + dump dedup state and reseeds the id counter so
    the run's trace is a pure function of `seed`. Pair with
    `disable()` in a finally block — tracing state is process-wide."""
    with _lock:
        _recorder.reset()
        if ring is not None:
            _recorder.capacity = max(1, int(ring))
        _recorder.dump_dir = dump_dir or None
        _tracer.reseed(seed)
        _tracer.enabled = True
    return _tracer, _recorder


def disable() -> None:
    """Turn tracing off and drop recorded state (the enable() pair)."""
    with _lock:
        _tracer.enabled = False
        _recorder.reset()


def reset_shared() -> None:
    """Back to boot state, configuration latch included (tests)."""
    global _configured
    with _lock:
        _configured = False
        _tracer.enabled = False
        _tracer.reseed(0)
        _recorder.reset()
        _recorder.capacity = DEFAULT_RING_SPANS
        _recorder.dump_dir = None
        _recorder.metrics = None
        _recorder.log = None


def trigger_dump(kind: str, key: str, detail: str = "") -> bool:
    """Fire a flight-recorder dump for verdict-safety event
    (kind, key) — the one call the watchdog / supervisor / shard
    health / shed paths make. No-op (False) while tracing is disabled:
    an empty ring has nothing to explain, and the disabled mode must
    stay one attribute lookup on these hot error paths too."""
    if not _tracer.enabled:
        return False
    return _recorder.trigger(kind, key, detail)
