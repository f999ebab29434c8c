"""Flight recorder: a lock-guarded bounded ring of finished spans,
dumped to JSONL when a verdict-safety event fires.

The ring is drop-oldest with COUNTED evictions (`spans_dropped` — a
silent ring overflow would read as "nothing happened before the
trigger" exactly when the prefix matters most). Dumps are triggered by
the existing causal-chain events — watchdog trip, device canary
failure, mesh shard quarantine, admission shed burst — and each
(kind, key) event dumps EXACTLY ONCE: triggers are deduplicated so a
watchdog that trips the same tile N times, or a shed storm calling in
from every RPC worker, produces one snapshot per underlying event, not
one per call site invocation.

Every dump crosses `fail_point("trace:dump")` (registered in
docs/SIMNET.md), so simnet crash schedules can kill a node mid-dump
and the recovery tests can prove a torn dump never corrupts node
state (dumping is observability, never load-bearing).

JSONL shape: line 1 is a `{"meta": ...}` header (trigger kind/key/
detail, ring accounting), every following line is one span dict
(span.Span.to_dict), oldest first, encoded with sorted keys and
compact separators — byte-identical for identical span streams.

Copy of `cometbft_tpu/trace/recorder.py` (the port keeps its own).
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..libs.fail import fail_point

DEFAULT_RING_SPANS = 4096


def _encode(obj: Dict) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


class FlightRecorder:
    """Bounded ring of finished spans + dump-on-trigger."""

    # guarded-by: _lock: _ring, evicted, recorded, _fired, dumps

    def __init__(self, capacity: int = DEFAULT_RING_SPANS,
                 dump_dir: Optional[str] = None, metrics=None,
                 log=None):
        self.capacity = max(1, int(capacity))
        self.dump_dir = dump_dir or None
        self.metrics = metrics  # libs/metrics_gen.TraceMetrics or None
        self.log = log
        self._lock = threading.Lock()
        self._ring: "deque[Dict]" = deque()
        self.recorded = 0
        self.evicted = 0
        self._fired: set = set()  # (kind, key) events already dumped
        # [(kind, key, detail, jsonl_text, path-or-None)] in trigger
        # order — simnet and the tests read dumps from here without a
        # filesystem round trip
        self.dumps: List[Tuple[str, str, str, str, Optional[str]]] = []

    # --- the ring ---------------------------------------------------------

    def record(self, span) -> None:
        d = span.to_dict()
        with self._lock:
            self._ring.append(d)
            self.recorded += 1
            dropped = len(self._ring) > self.capacity
            if dropped:
                self._ring.popleft()
                self.evicted += 1
            occupancy = len(self._ring)
        if self.metrics is not None:
            self.metrics.spans.inc()
            if dropped:
                self.metrics.dropped.inc()
            self.metrics.ring_occupancy.set(occupancy)

    def snapshot(self) -> List[Dict]:
        """The ring's current contents, oldest first."""
        with self._lock:
            return list(self._ring)

    def snapshot_jsonl(self) -> str:
        """The ring as JSONL text (no meta header) — what the simnet
        scenarios hash into their event logs to pin byte-identity."""
        return "".join(_encode(d) + "\n" for d in self.snapshot())

    # --- dump-on-trigger --------------------------------------------------

    def trigger(self, kind: str, key: str, detail: str = "") -> bool:
        """Dump the ring for event (kind, key); returns True when this
        call performed the dump, False when the event already fired
        (exactly-once per event) or the ring is empty of context AND
        nothing was ever recorded (nothing to say)."""
        with self._lock:
            if (kind, key) in self._fired:
                return False
            self._fired.add((kind, key))
            spans = list(self._ring)
            evicted, recorded = self.evicted, self.recorded
            seq = len(self.dumps)
        fail_point("trace:dump")
        meta = {"meta": {"kind": kind, "key": key, "detail": detail,
                         "seq": seq, "spans": len(spans),
                         "evicted": evicted, "recorded": recorded}}
        text = _encode(meta) + "\n" + "".join(
            _encode(d) + "\n" for d in spans)
        path = None
        if self.dump_dir:
            safe = "".join(c if c.isalnum() or c in "-_" else "-"
                           for c in f"{kind}-{key}")
            path = os.path.join(self.dump_dir,
                                f"trace_dump_{seq:03d}_{safe}.jsonl")
            try:
                os.makedirs(self.dump_dir, exist_ok=True)
                with open(path, "w", encoding="utf-8") as fh:
                    fh.write(text)
            except OSError:
                # dumping is best-effort observability: a read-only
                # dump dir must not take down the verdict-safety path
                # that triggered it
                path = None
        with self._lock:
            self.dumps.append((kind, key, detail, text, path))
        if self.metrics is not None:
            self.metrics.dumps.inc(kind=kind)
        if self.log is not None:
            self.log(f"trace: flight-recorder dump #{seq} "
                     f"({kind}/{key}): {len(spans)} spans"
                     + (f" -> {path}" if path else ""))
        return True

    # --- accounting -------------------------------------------------------

    def stats(self) -> Dict:
        with self._lock:
            return {"capacity": self.capacity,
                    "occupancy": len(self._ring),
                    "recorded": self.recorded,
                    "evicted": self.evicted,
                    "dumps": len(self.dumps)}

    def reset(self) -> None:
        """Drop all spans, dump dedup state, and accounting (tests and
        per-run simnet isolation)."""
        with self._lock:
            self._ring.clear()
            self.recorded = 0
            self.evicted = 0
            self._fired.clear()
            self.dumps = []
