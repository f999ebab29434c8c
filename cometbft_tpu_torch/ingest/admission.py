"""Batched CheckTx admission pipeline: the mempool's front door.

Every other verifier in the tree (vote intake, blocksync tiles, the
light-client farm) already rides the SigCache + DeviceClient batch
path; mempool admission was the last one doing one-at-a-time work — a
synchronous `check_tx` per RPC call, which pinned the round-5
saturation knee near 100 tx/s on one core (ROADMAP item 3). This
pipeline coalesces concurrent `broadcast_tx_*` and p2p-relayed txs
into shared signature-verification batches with explicit backpressure:

  submit()  — two-layer dedup (tx-hash duplicate filter in FRONT of
              the mempool's own LRU cache, then SigCache at plan time
              with path "ingest"), then either park the tx on the
              bounded FIFO (batch mode) or verify+apply inline
              (sequential mode — the degenerate baseline the A/B and
              the equivalence tests compare against). A full queue
              SHEDS (IngestShed, the farm's QueueFull discipline):
              explicit retryable rejection, never unbounded memory.
  wait()    — cooperative coalescing: callers block on their ticket
              for one (adaptively shortened) window, and whichever
              waiter wakes first flushes everything pending.
  flush()   — ONE coalesced batch through IngestBatcher (canary/
              supervisor-gated device dispatch, CPU fallback), then
              verdicts applied strictly in submission order through
              VerdictDispatcher — FIFO ordering, recheck, and the
              app-CheckTx call sequence are byte-for-byte the
              sequential path's.

Time flows through libs/timesource so admission latency observation
works under a virtual clock; a deterministic caller (the chip smoke's
ingest phase, the tests) runs the pipeline single-threaded through
explicit flush waves.

Port of `cometbft_tpu/ingest/admission.py`: `IngestPipeline(device=)`
(default cuda) hands its device to the IngestBatcher, whose wide
batches run the RLC kernels there. The RPC front door
(`broadcast_tx_*`, `/check_tx`) and the p2p relay wait for the port's
RPC server and mempool reactor (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..farm.batcher import FLUSH_WAIT_S, coalesce_wait
from ..libs import timesource
from ..libs.env import env_bool, env_float, env_int
from ..libs.fail import fail_point
from ..mempool.mempool import tx_key
from ..pipeline.cache import SigCache
from ..trace import shared_tracer, trigger_dump
from .batcher import IngestBatcher, SigLane
from .dispatcher import VerdictDispatcher
from .tx import MalformedTx, parse_signed_tx, sign_bytes

ENV_MAX_PENDING = "COMETBFT_TPU_INGEST_MAX_PENDING"
ENV_COALESCE_WINDOW = "COMETBFT_TPU_INGEST_COALESCE_WINDOW"
ENV_ADAPTIVE_WINDOW = "COMETBFT_TPU_INGEST_ADAPTIVE_WINDOW"
ENV_FILTER_SIZE = "COMETBFT_TPU_INGEST_FILTER_SIZE"
DEFAULT_MAX_PENDING = 8192
DEFAULT_COALESCE_WINDOW_S = 0.002
DEFAULT_FILTER_SIZE = 65536
CACHE_PATH = "ingest"  # SigCache attribution label for tx lanes

# bounded sample of recent submit→verdict latencies; p50/p90 accessors
# feed the stats() introspection without a histogram walk
LATENCY_SAMPLES = 4096


class IngestShed(Exception):
    """The admission queue is at capacity — this tx is shed (retryable:
    the RPC layer maps it to the same -32005 overload code the farm
    uses)."""


class TxFilter:
    """Thread-safe LRU of recently seen tx keys: the duplicate filter
    in FRONT of the mempool cache. A flood of copies of one tx costs
    one hash lookup each instead of a queue slot + mempool lock."""

    # guarded-by: _lock: _map

    def __init__(self, size: int = DEFAULT_FILTER_SIZE):
        self._size = max(1, size)
        self._lock = threading.Lock()
        self._map: "OrderedDict[bytes, None]" = OrderedDict()

    def push(self, key: bytes) -> bool:
        """False if already present (refreshes recency), True if newly
        recorded."""
        with self._lock:
            if key in self._map:
                self._map.move_to_end(key)
                return False
            self._map[key] = None
            if len(self._map) > self._size:
                self._map.popitem(last=False)
            return True

    def remove(self, key: bytes) -> None:
        with self._lock:
            self._map.pop(key, None)

    def reset(self) -> None:
        with self._lock:
            self._map.clear()

    def __contains__(self, key: bytes) -> bool:
        with self._lock:
            return key in self._map

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)


class TxTicket:
    """Handle for one submitted tx; resolved when its batch settles.
    Exactly one of `code` (admission verdict, 0 = admitted) or `error`
    (structural ValueError — full/too-large/duplicate) is set. `ctx`
    is the tx's admit-span trace context (None with tracing off) —
    the EXPLICIT propagation handle the coalesced flush span links."""

    __slots__ = ("tx", "key", "lane", "code", "error", "_ev", "t_submit",
                 "ctx")

    def __init__(self, tx: bytes, key: bytes,
                 lane: Optional[SigLane], t_submit: float, ctx=None):
        self.tx = tx
        self.key = key
        self.lane = lane
        self.code: Optional[int] = None
        self.error: Optional[Exception] = None
        self._ev = threading.Event()
        self.t_submit = t_submit
        self.ctx = ctx  # trace.TraceContext or None

    def done(self) -> bool:
        return self._ev.is_set()

    def ok(self) -> bool:
        return self.done() and self.error is None and self.code == 0


class IngestPipeline:
    """Bounded, coalescing, deduplicating tx admission front door."""

    # guarded-by: _lock: _tickets, _latencies, shed, dup_hits
    # guarded-by: _lock: _shed_burst_open
    # (flow-aware: _shed_locked is only ever reached from submit()
    # under `with self._lock`, so its shed/filter bookkeeping needs no
    # pragma — the lock rides in from the caller)

    def __init__(self, mempool, cache: Optional[SigCache] = None,
                 batch: bool = True,
                 max_pending: Optional[int] = None,
                 coalesce_window_s: Optional[float] = None,
                 adaptive: Optional[bool] = None,
                 filter_size: Optional[int] = None,
                 verify_backend: Optional[Callable] = None,
                 metrics=None,
                 clock: Callable[[], float] = timesource.monotonic,
                 device=None):
        if max_pending is None:
            max_pending = env_int(ENV_MAX_PENDING, DEFAULT_MAX_PENDING,
                                  minimum=1)
        if coalesce_window_s is None:
            coalesce_window_s = env_float(ENV_COALESCE_WINDOW,
                                          DEFAULT_COALESCE_WINDOW_S,
                                          minimum=0.0)
        if adaptive is None:
            adaptive = env_bool(ENV_ADAPTIVE_WINDOW, True)
        if filter_size is None:
            filter_size = env_int(ENV_FILTER_SIZE, DEFAULT_FILTER_SIZE,
                                  minimum=1)
        self.mempool = mempool
        self.batch = batch
        self.max_pending = max_pending
        self.coalesce_window_s = coalesce_window_s
        self.adaptive = adaptive
        self.cache = cache if cache is not None else SigCache(0)
        self.metrics = metrics  # libs/metrics_gen.IngestMetrics or None
        self.filter = TxFilter(filter_size)
        self.batcher = IngestBatcher(self.cache, verify_backend, metrics,
                                     device=device)
        self.dispatcher = VerdictDispatcher(mempool, self.filter, metrics)
        self._clock = clock
        self._lock = threading.Lock()
        self._flush_lock = threading.Lock()
        self._tickets: List[TxTicket] = []
        self._latencies: "deque[float]" = deque(maxlen=LATENCY_SAMPLES)
        self.shed = 0
        self.dup_hits = 0
        # a shed STORM is one event, not one per bounced tx: the burst
        # opens at the first shed (one flight-recorder dump, keyed by
        # the shed count at open) and closes when a flush drains the
        # queue — the next storm is a new event
        self._shed_burst_open = False
        self._flusher: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # post-commit recheck / update / flush evictions must release
        # the front filter, or a legitimately-evicted tx could never
        # be resubmitted (mempool's cache forgets it; ours must too)
        register = getattr(mempool, "on_tx_evicted", None)
        if register is not None:
            register(self._on_mempool_evict)

    # --- intake -----------------------------------------------------------

    def submit(self, tx: bytes, ctx=None) -> TxTicket:
        """Queue one tx (or, in sequential mode, admit it inline).
        Raises IngestShed when the queue is full, ValueError on a
        duplicate or malformed envelope — the same exception surface
        the sequential mempool path presents to RPC. `ctx` is the
        caller's trace context (the RPC root span); the tx's admit
        span becomes its child and rides the ticket into the flush."""
        t0 = self._clock()
        span = shared_tracer().start("ingest.admit", parent=ctx)
        try:
            key = tx_key(tx)
            if not self.filter.push(key):
                # under the lock: concurrent RPC workers flooding the
                # same tx would lose read-modify-write increments
                # otherwise
                with self._lock:
                    self.dup_hits += 1
                if self.metrics is not None:
                    self.metrics.dedup_hits.inc(kind="txhash")
                span.set_attr("outcome", "duplicate")
                raise ValueError("tx already in cache")
            try:
                parsed = parse_signed_tx(tx)
            except MalformedTx:
                # structurally invalid forever, but mirror the
                # mempool's invalid-tx cache eviction so the filter
                # cannot pin state for garbage bytes
                self.filter.remove(key)
                span.set_attr("outcome", "malformed")
                raise
            lane = None
            if parsed is not None:
                msg = sign_bytes(parsed.payload)
                if not self.cache.seen(parsed.pub, msg, parsed.sig,
                                       path=CACHE_PATH):
                    lane = SigLane(parsed.pub, msg, parsed.sig,
                                   self.cache.key(parsed.pub, msg,
                                                  parsed.sig))
            ticket = TxTicket(tx, key, lane, t0, ctx=span.ctx)
            if not self.batch:
                # sequential baseline: verify this tx's lane natively
                # and apply immediately — the depth-1 degenerate case
                sig_ok = True
                if lane is not None:
                    sig_ok = lane.pk.verify_signature(lane.msg, lane.sig)
                    if sig_ok:
                        self.cache.add(lane.pub, lane.msg, lane.sig)
                self.dispatcher.apply(ticket, sig_ok)
                self._observe(ticket)
                return ticket
            with self._lock:
                if len(self._tickets) >= self.max_pending:
                    depth = len(self._tickets)
                    self._shed_locked(key)
                    span.set_attr("outcome", "shed")
                    raise IngestShed(
                        f"admission queue full ({depth} txs pending)")
                self._tickets.append(ticket)
                depth = len(self._tickets)
            if self.metrics is not None:
                self.metrics.queue_depth.set(depth)
            span.set_attr("depth", depth)
            return ticket
        finally:
            span.end()

    def _shed_locked(self, key: bytes) -> None:
        # caller holds _lock; release the filter entry — a shed is
        # retryable, the retry must not bounce off as a duplicate
        self.shed += 1
        self.filter.remove(key)
        if self.metrics is not None:
            self.metrics.shed.inc()
        if not self._shed_burst_open:
            self._shed_burst_open = True
            trigger_dump("shed-burst", f"ingest:{self.shed}",
                         f"admission queue full at {self.max_pending}")

    def submit_nowait(self, tx: bytes,
                      ctx=None) -> Optional[TxTicket]:
        """Fire-and-forget intake for p2p-relayed txs: duplicates,
        sheds, and malformed envelopes are dropped silently (the
        reference reactor only logs), and nobody blocks the p2p read
        loop waiting for the batch — the background flusher (or the
        next RPC waiter) settles the ticket."""
        try:
            return self.submit(tx, ctx=ctx)
        except (IngestShed, ValueError):
            return None

    # --- coalescing -------------------------------------------------------

    def wait(self, tickets: Sequence[TxTicket]) -> None:
        """Block until every ticket resolves, coalescing with other
        submitters (farm discipline: wait one adaptively-shortened
        window for someone else's flush, then flush ourselves)."""
        for ticket in tickets:
            if coalesce_wait(ticket._ev, self.coalesce_window_s,
                             self._queue_depth, self.adaptive):
                continue
            self.flush()
            if not ticket._ev.wait(FLUSH_WAIT_S):
                raise RuntimeError(
                    "ingest flush did not resolve ticket")

    def _queue_depth(self) -> int:
        with self._lock:
            return len(self._tickets)

    def flush(self) -> int:
        """Verify + apply everything pending in ONE coalesced batch;
        returns the unique-lane width dispatched. Serialized: a
        concurrent flush waits, then sees an empty queue and returns
        0. Verdicts apply in submission order — the FIFO snapshot IS
        the arrival order."""
        with self._flush_lock:
            with self._lock:
                tickets, self._tickets = self._tickets, []
                # the storm (if any) is over once a flush drains the
                # queue; the next shed opens a fresh burst event
                self._shed_burst_open = False
            if self.metrics is not None:
                self.metrics.queue_depth.set(0)
            if not tickets:
                return 0
            fail_point("ingest:flush")
            # the flush is a coalescing seam: many admit spans (one
            # per RPC root) feed ONE flush — so the flush span is a
            # new root that LINKS every ticket's admit span, and
            # causal_chain hops the link back to the rpc root
            tracer = shared_tracer()
            span = tracer.start("ingest.flush", tickets=len(tickets))
            if tracer.enabled:
                for ticket in tickets:
                    span.link(ticket.ctx)
            try:
                lanes = [t.lane for t in tickets if t.lane is not None]
                verdicts = self.batcher.verify(lanes, ctx=span)
                span.set_attr("lanes", len(lanes))
                for ticket in tickets:
                    sig_ok = (verdicts[ticket.lane.key]
                              if ticket.lane is not None else True)
                    self.dispatcher.apply(ticket, sig_ok)
                    self._observe(ticket)
                return self.batcher.last_batch_width if lanes else 0
            except Exception as e:  # noqa: BLE001 — a backend bug must
                # fail the waiting RPC threads, never strand them
                for ticket in tickets:
                    if not ticket.done():
                        ticket.error = e
                        ticket._ev.set()
                raise
            finally:
                span.end()

    # --- background flusher (node runtime; deterministic callers flush
    # explicitly and never start it) --------------------------------------

    def start(self) -> None:
        """Run the background flusher: settles fire-and-forget intake
        (p2p relay, broadcast_tx_async) when no RPC waiter is around
        to perform the cooperative flush."""
        if self._flusher is not None:
            return
        self._stop.clear()
        self._flusher = threading.Thread(
            target=self._flush_loop, name="ingest-flush", daemon=True)
        self._flusher.start()

    def stop(self) -> None:
        self._stop.set()
        if self._flusher is not None:
            self._flusher.join(timeout=2.0)
            self._flusher = None

    def _flush_loop(self) -> None:
        interval = max(self.coalesce_window_s, 0.001)
        while not self._stop.wait(interval):
            if self._queue_depth() == 0:
                continue
            try:
                self.flush()
            except Exception:  # noqa: BLE001 — flush already failed the
                # affected tickets; the loop must survive to serve the
                # next batch
                continue

    # --- query-path cache consultation (/check_tx route) -------------------

    def query_cached(self, tx: bytes
                     ) -> Tuple[bool, Optional[bool], bool]:
        """(known, sig_ok, sig_cached) for the RPC /check_tx query
        route: `known` = the tx-hash duplicate filter already holds
        this tx (previously admitted or in flight); `sig_ok` = the
        envelope signature verdict (None for a bare tx), consulting
        the SigCache before verifying; `sig_cached` = that verdict
        came from the cache. Read-only: mutates no admission state
        beyond recording a verified-TRUE signature."""
        key = tx_key(tx)
        if key in self.filter:
            return True, None, True
        try:
            parsed = parse_signed_tx(tx)
        except MalformedTx:
            return False, False, False
        if parsed is None:
            return False, None, False
        msg = sign_bytes(parsed.payload)
        if self.cache.seen(parsed.pub, msg, parsed.sig, path=CACHE_PATH):
            return False, True, True
        lane = SigLane(parsed.pub, msg, parsed.sig, b"")
        ok = lane.pk.verify_signature(msg, parsed.sig)
        if ok:
            self.cache.add(parsed.pub, msg, parsed.sig)
        return False, ok, False

    # --- introspection ------------------------------------------------------

    def _observe(self, ticket: TxTicket) -> None:
        dt = max(0.0, self._clock() - ticket.t_submit)
        with self._lock:
            self._latencies.append(dt)
        if self.metrics is not None:
            self.metrics.admission_latency.observe(dt)

    def latency_quantiles(self) -> Dict[str, float]:
        """p50/p90 over the recent-latency sample window (seconds)."""
        with self._lock:
            sample = sorted(self._latencies)
        if not sample:
            return {"p50": 0.0, "p90": 0.0}
        return {"p50": sample[len(sample) // 2],
                "p90": sample[min(len(sample) - 1,
                                  int(len(sample) * 0.9))]}

    def stats(self) -> Dict:
        q = self.latency_quantiles()
        with self._lock:
            shed, dup_hits = self.shed, self.dup_hits
        return {
            "queued": self._queue_depth(),
            "admitted": self.dispatcher.admitted,
            "rejected": self.dispatcher.rejected,
            "shed": shed,
            "dup_hits": dup_hits,
            "batches": self.batcher.batches,
            "last_batch_width": self.batcher.last_batch_width,
            "max_batch_width": self.batcher.max_batch_width,
            "dedup_batch_hits": self.batcher.dedup_batch_hits,
            "lanes_by_backend": dict(self.batcher.lanes_by_backend),
            "fallbacks": self.batcher.fallbacks,
            "cache_hit_rate": round(self.cache.hit_rate(CACHE_PATH), 4),
            "latency_p50_s": q["p50"],
            "latency_p90_s": q["p90"],
        }

    # --- mempool eviction mirror --------------------------------------------

    def _on_mempool_evict(self, key: Optional[bytes]) -> None:
        """The mempool evicted `key` from its cache (recheck/update
        invalidation), or reset entirely (None, on flush)."""
        if key is None:
            self.filter.reset()
        else:
            self.filter.remove(key)
