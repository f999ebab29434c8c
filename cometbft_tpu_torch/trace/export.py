"""Trace export: flight-recorder JSONL -> Chrome trace-event JSON
(chrome://tracing / Perfetto "traceEvents" format), plus the
causal-chain reconstruction the containment tests and trace_view's
`--chain` mode share.

Mapping: every span becomes one complete ("X") event — `ts`/`dur` in
microseconds from the span's timesource nanoseconds, `pid` 1, `tid`
the span's trace id (so each causal chain renders as its own row) —
and every span event becomes an instant ("i") event on the same row.
Parent and link ids ride in `args` so nothing is lost round-tripping.

Copy of `cometbft_tpu/trace/export.py` (the port keeps its own).
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Tuple


def load_jsonl(text: str) -> Tuple[Optional[Dict], List[Dict]]:
    """Parse dump JSONL into (meta, spans). The meta header line is
    optional — ring snapshots (recorder.snapshot_jsonl) have none."""
    meta = None
    spans: List[Dict] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        d = json.loads(line)
        if "meta" in d:
            meta = d["meta"]
        else:
            spans.append(d)
    return meta, spans


def span_events(span: Dict) -> List[Dict]:
    """Chrome trace events for ONE span dict (span.Span.to_dict)."""
    args = dict(span.get("attrs", {}))
    args["sid"] = span["sid"]
    if span.get("pid"):
        args["parent_sid"] = span["pid"]
    if span.get("lk"):
        args["links"] = [s for _t, s in span["lk"]]
    t0, t1 = span["t0"], span["t1"]
    out = [{"name": span["name"], "ph": "X", "pid": 1,
            "tid": span["tid"], "ts": t0 / 1000.0,
            "dur": max(0.0, (t1 - t0) / 1000.0), "args": args}]
    for t, name, attrs in span.get("ev", ()):
        out.append({"name": f"{span['name']}:{name}", "ph": "i",
                    "pid": 1, "tid": span["tid"], "ts": t / 1000.0,
                    "s": "t", "args": dict(attrs)})
    return out


def chrome_trace(spans: Iterable[Dict],
                 meta: Optional[Dict] = None) -> Dict:
    """The full traceEvents document for a span stream."""
    events: List[Dict] = []
    for span in spans:
        events.extend(span_events(span))
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    if meta:
        doc["otherData"] = dict(meta)
    return doc


def convert(text: str) -> str:
    """JSONL dump text -> Chrome trace JSON text (stable encoding)."""
    meta, spans = load_jsonl(text)
    return json.dumps(chrome_trace(spans, meta), sort_keys=True,
                      separators=(",", ":"))


# --- causal-chain reconstruction ----------------------------------------------


def causal_chain(spans: List[Dict], leaf_sid: int) -> List[Dict]:
    """The span path from `leaf_sid` back to its ultimate cause,
    following parent links first and, at each trace root, hopping
    across the root's FIRST link (the coalescing seams — a flush span
    has no parent but links every ticket span it served). Returns the
    spans cause-first. Used by the containment tests to prove a dump
    explains rpc -> ingest ticket -> batch flush -> shard dispatch ->
    CPU re-verify end to end."""
    by_sid = {s["sid"]: s for s in spans}
    chain: List[Dict] = []
    seen = set()
    sid: Optional[int] = leaf_sid
    while sid is not None and sid in by_sid and sid not in seen:
        seen.add(sid)
        span = by_sid[sid]
        chain.append(span)
        if span.get("pid"):
            sid = span["pid"]
        elif span.get("lk"):
            sid = span["lk"][0][1]
        else:
            sid = None
    chain.reverse()
    return chain
