"""Cross-session lane coalescing: many clients' pending checks become
one shared device batch.

The batcher owns a bounded pending queue of PlannedChecks. A flush
snapshots everything pending, dedups identical (pub, msg, sig) lanes
ACROSS checks — two clients verifying the same header pay for each
signature once — and dispatches the unique lanes through the default
backend, `device_or_cpu_backend`, or an injected one. Verified-TRUE
lanes land in the SigCache, so the NEXT client at a nearby trusted
height hits cache instead of lanes. The chosen backend per batch
(device / kernel / cpu) lands in `lanes_by_backend` and
`FarmMetrics.lanes_verified{backend}`.

Backpressure is explicit: `submit()` raises QueueFull once the pending
queue holds `max_pending_lanes` — the caller turns that into a
retryable shed error instead of letting an open-ended client crowd
queue unbounded work.

Flushing is cooperative (no background thread): callers block on their
ticket with a small coalescing window, and whichever caller wakes
first flushes everything pending — concurrent worker threads coalesce,
while single-threaded callers (the chip smoke's farm phase, the tests)
submit a whole wave and flush once, deterministically.

Port of `cometbft_tpu/farm/batcher.py`. The routes of the default
backend, and where they differ from the JAX package's:
- in process (no COMETBFT_TPU_DEVICE_SERVER): routed by width on the
  batcher's device (`device=`, default cuda). An all-ed25519 batch of
  at least FARM_KERNEL_MIN_LANES goes through `ops.ed25519.verify_batch`
  at the next power of two (the RLC kernels on cuda, their plain
  versions on the CPU) and is labelled "kernel"; a narrower batch, or
  one with another key type, takes the per-signature host verify
  ("cpu"). The JAX package sends a wide batch to its kernel only when
  its compile ledger says the bucket is warm, and only for messages of
  at most 128 bytes: both guards exist for XLA's compile time, and the
  port has no jit (its `prepare_batch` sizes the message capacity to
  the chunk, uncapped). A build or launch error, or a
  `KernelCanaryError`, propagates out of `flush()` and fails the
  tickets: the in-process route never degrades to the host;
- through the device server: a transport error (TimeoutError,
  ConnectionError, OSError) from `shared_client()`'s link, or a canary
  mismatch in the server's answer, re-verifies the batch on the host,
  as the JAX package does: the port's permitted drain for a remote
  link. Each drain is counted in the batcher's `fallbacks` and traced
  as `farm.cpu_drain`. `DeviceUnprocessable` and `DeviceFlushFailed`
  raise (the JAX package verifies natively), as in a pipelined sync;
- the mesh switch follows `engine/blocksync.mesh_available`: on, the
  backend raises NotImplementedError (ROADMAP.md Queue 1 item 5).
"""

from __future__ import annotations

import functools
import inspect
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..device import resolve_device
from ..libs.env import env_bool, env_float, env_int
from ..libs.fail import fail_point
from ..pipeline.cache import SigCache
from ..trace import shared_tracer, trigger_dump
from ..types.validation import ErrWrongSignature
from .planner import Lane, PlannedCheck

ENV_MAX_PENDING_LANES = "COMETBFT_TPU_FARM_MAX_PENDING_LANES"
ENV_COALESCE_WINDOW = "COMETBFT_TPU_FARM_COALESCE_WINDOW"
ENV_ADAPTIVE_WINDOW = "COMETBFT_TPU_FARM_ADAPTIVE_WINDOW"
DEFAULT_MAX_PENDING_LANES = 16_384
DEFAULT_COALESCE_WINDOW_S = 0.002
# a wedged flush must surface, not hang an RPC worker forever; the
# device seam's own deadline (device/client.deadline_for) is far below
FLUSH_WAIT_S = 120.0

# adaptive coalescing: the fixed window splits into this many sub-polls,
# and once PLATEAU_POLLS consecutive polls observe the same pending
# width the waiter flushes early — at low load a lone submitter pays
# window/ADAPTIVE_POLLS*2 instead of the full window, while a still-
# growing batch keeps coalescing up to the fixed ceiling (ROADMAP
# item 4 headroom: the fixed knob stays the ceiling).
ADAPTIVE_POLLS = 4
PLATEAU_POLLS = 2

ED25519 = "ed25519"


def coalesce_wait(ev: threading.Event, window_s: float,
                  width_fn: Callable[[], int], adaptive: bool) -> bool:
    """Wait for `ev` up to the coalescing window; returns True iff the
    event fired (someone else's flush resolved the ticket). With
    `adaptive`, the window is sampled in ADAPTIVE_POLLS sub-polls of
    `width_fn` (the pending queue width): when PLATEAU_POLLS
    consecutive polls see no growth the batch has stopped widening and
    waiting longer only adds tail latency — return early so the caller
    flushes now. Shared by the farm and ingest batchers."""
    if window_s <= 0:
        return ev.is_set()
    if not adaptive:
        return ev.wait(window_s)
    poll = window_s / ADAPTIVE_POLLS
    last, flat = -1, 0
    for _ in range(ADAPTIVE_POLLS):
        if ev.wait(poll):
            return True
        width = width_fn()
        if width == last:
            flat += 1
            if flat >= PLATEAU_POLLS - 1:
                return False  # width plateaued: flush early
        else:
            last, flat = width, 0
    return False


class QueueFull(Exception):
    """The pending queue is at capacity — this request is shed."""


class CheckTicket:
    """Handle for one submitted PlannedCheck; resolved by a flush.
    `ctx` is the submitter's trace context — the explicit propagation
    handle the coalesced flush span links (never a thread-local)."""

    def __init__(self, planned: PlannedCheck, ctx=None):
        self.planned = planned
        self.error: Optional[Exception] = None
        self._ev = threading.Event()
        self.ctx = ctx  # trace.TraceContext or None

    def done(self) -> bool:
        return self._ev.is_set()

    def ok(self) -> bool:
        return self.done() and self.error is None


def _native_verify(lanes: Sequence[Lane]) -> Tuple[List[bool], str]:
    """Per-signature host verify (the port's native single-signature
    verify, `csrc/host/ed25519.cc`, for ed25519 lanes)."""
    return [lane.pk.verify_signature(lane.msg, lane.sig)
            for lane in lanes], "cpu"


# a farm flush narrower than this stays per-signature on the host: a
# batch's dispatch, padding and canary cost more than they save until
# the batch is wide
FARM_KERNEL_MIN_LANES = 128


def _in_process_verify(lanes: Sequence[Lane],
                       device) -> Tuple[List[bool], str]:
    """The no-device-server route for ed25519 lanes, by width on
    `device`: a wide batch through the RLC kernels ("kernel"), a narrow
    one per signature on the host ("cpu"). Nothing here catches: a
    kernel error or a canary trip propagates."""
    n = len(lanes)
    if n >= FARM_KERNEL_MIN_LANES:
        from ..ops.ed25519 import verify_batch
        out = verify_batch([lane.pub for lane in lanes],
                           [lane.msg for lane in lanes],
                           [lane.sig for lane in lanes],
                           batch_size=1 << (n - 1).bit_length(),
                           device=device)
        return [bool(v) for v in out], "kernel"
    return _native_verify(lanes)


def _mesh_verify(lanes: Sequence[Lane],
                 ctx=None) -> Optional[Tuple[List[bool], str]]:
    """None while the mesh is off (`engine/blocksync.mesh_available`, as
    on one card): the caller takes the in-process route. With the mesh
    on, the JAX package routes the batch through its shared mesh
    executor, which the port does not have yet."""
    from ..engine.blocksync import mesh_available
    if mesh_available():
        raise NotImplementedError(
            "mesh verification is not ported yet (ROADMAP.md Queue 1 "
            "item 5: mesh and multi-GPU)")
    return None


def _drain(lanes: Sequence[Lane], reason: str, ctx,
           on_drain) -> Tuple[List[bool], str]:
    """Re-verify a device-server batch on the host: counted through
    `on_drain` (the batcher's `fallbacks`) and traced."""
    if on_drain is not None:
        on_drain()
    with shared_tracer().start("farm.cpu_drain", parent=ctx,
                               reason=reason, lanes=len(lanes)):
        return _native_verify(lanes)


def device_or_cpu_backend(lanes: Sequence[Lane], ctx=None, device=None,
                          on_drain: Optional[Callable[[], None]] = None
                          ) -> Tuple[List[bool], str]:
    """Default verify backend: the DeviceClient.submit() seam with
    canary lanes + supervisor gating when COMETBFT_TPU_DEVICE_SERVER
    names a server; otherwise the in-process route on `device` (default
    cuda), by width. `ctx` is the flush span's trace context, forwarded
    through the submit seam; `on_drain()` hears of every host re-verify
    of a device-server batch."""
    from ..device import health
    from ..device.client import shared_client
    dev = resolve_device(device)
    if any(lane.pk.type_() != ED25519 for lane in lanes):
        return _native_verify(lanes)  # kernels are ed25519-only
    client = shared_client()
    if client is None:
        _mesh_verify(lanes, ctx=ctx)  # None while the mesh is off
        return _in_process_verify(lanes, dev)
    sup = health.shared_supervisor()
    if not sup.allow_connect():
        return _in_process_verify(lanes, dev)
    pubs = [lane.pub for lane in lanes]
    msgs = [lane.msg for lane in lanes]
    sigs = [lane.sig for lane in lanes]
    canaried = sup.canary
    if canaried:
        pubs, msgs, sigs = health.splice_canaries(pubs, msgs, sigs)
    try:
        # DeviceUnprocessable and DeviceFlushFailed propagate
        _ok, oks = client.submit(pubs, msgs, sigs, ctx=ctx).result()
    except (TimeoutError, ConnectionError, OSError) as e:
        sup.report_trip(e)
        return _drain(lanes, type(e).__name__, ctx, on_drain)
    if canaried:
        ok, oks = health.check_canaries(oks, len(lanes))
        if not ok:
            sup.report_corruption("farm batch canary mismatch")
            return _drain(lanes, "canary-mismatch", ctx, on_drain)
        sup.report_success()
        return [bool(v) for v in oks], "device"
    sup.report_success()
    # the operator turned canary splicing OFF (COMETBFT_TPU_DEVICE_CANARY=0
    # / [device] canary=false): verdicts are deliberately trusted un-gated
    # in that configuration — the explicit, reviewed opt-out
    # staticcheck: allow(verdict-taint)
    return [bool(v) for v in oks], "device"


class FarmBatcher:
    """Bounded, coalescing, deduplicating verify queue."""

    # guarded-by: _lock: _tickets, _pending_lanes, shed
    # guarded-by: _lock: _shed_burst_open
    # guarded-by: _flush_lock: batches, dedup_batch_hits, lanes_by_backend
    # guarded-by: _flush_lock: last_batch_width, max_batch_width
    # guarded-by: _flush_lock: fallbacks
    # (flow-aware: _run_batch only runs from flush() under _flush_lock,
    # so the batch stats it mutates are serialized by that lock)

    def __init__(self, cache: Optional[SigCache] = None,
                 max_pending_lanes: Optional[int] = None,
                 coalesce_window_s: Optional[float] = None,
                 verify_backend: Optional[Callable] = None,
                 metrics=None, adaptive: Optional[bool] = None,
                 device=None):
        self.device = resolve_device(device)
        if max_pending_lanes is None:
            max_pending_lanes = env_int(ENV_MAX_PENDING_LANES,
                                        DEFAULT_MAX_PENDING_LANES,
                                        minimum=1)
        if coalesce_window_s is None:
            coalesce_window_s = env_float(ENV_COALESCE_WINDOW,
                                          DEFAULT_COALESCE_WINDOW_S,
                                          minimum=0.0)
        if adaptive is None:
            adaptive = env_bool(ENV_ADAPTIVE_WINDOW, True)
        self.max_pending_lanes = max_pending_lanes
        self.coalesce_window_s = coalesce_window_s
        self.adaptive = adaptive
        self.cache = cache if cache is not None else SigCache(0)
        self.metrics = metrics  # libs/metrics_gen.FarmMetrics or None
        self._backend = verify_backend or functools.partial(
            device_or_cpu_backend, device=self.device,
            on_drain=self._drained)
        # ctx propagation is opt-in per backend (injected test/sim
        # backends keep the plain (lanes) signature) — decided once
        self._backend_takes_ctx = (
            "ctx" in inspect.signature(self._backend).parameters)
        self._lock = threading.Lock()
        self._flush_lock = threading.Lock()
        self._tickets: List[CheckTicket] = []
        self._pending_lanes = 0
        # stats (monotonic counters; light_status surfaces them)
        self.batches = 0
        self.lanes_by_backend: Dict[str, int] = {}
        self.dedup_batch_hits = 0
        self.shed = 0
        self.last_batch_width = 0
        self.max_batch_width = 0
        # device-server batches re-verified on the host (farm.cpu_drain)
        self.fallbacks = 0
        # shed storms dump the flight recorder once per burst (ingest
        # discipline): opens at the first shed, closes on a flush
        self._shed_burst_open = False

    # --- intake -----------------------------------------------------------

    def submit(self, planned: PlannedCheck, ctx=None) -> CheckTicket:
        """Queue one check; QueueFull once the lane budget is spent.
        A check with no pending lanes (all cache hits) resolves
        immediately — the dedup fast path costs no queue space. `ctx`
        is the submitter's trace context; it rides the ticket so the
        coalesced flush span can link back to the request."""
        ticket = CheckTicket(planned, ctx=ctx)
        if not planned.lanes:
            ticket._ev.set()
            return ticket
        with self._lock:
            if self._pending_lanes + len(planned.lanes) \
                    > self.max_pending_lanes:
                self.shed += 1
                if self.metrics is not None:
                    self.metrics.shed.inc()
                if not self._shed_burst_open:
                    self._shed_burst_open = True
                    trigger_dump(
                        "shed-burst", f"farm:{self.shed}",
                        f"lane budget {self.max_pending_lanes} spent")
                raise QueueFull(
                    f"farm verify queue full "
                    f"({self._pending_lanes} lanes pending)")
            self._tickets.append(ticket)
            self._pending_lanes += len(planned.lanes)
        return ticket

    def cancel(self, tickets: Sequence[CheckTicket]) -> None:
        """Withdraw not-yet-flushed tickets. A request that sheds
        mid-plan MUST release the lane budget its earlier checks
        claimed: nothing on the RPC path flushes a shed request's
        orphans, so without this the bounded queue fills with dead
        lanes and the farm sheds every later request while idle."""
        with self._lock:
            for ticket in tickets:
                try:
                    self._tickets.remove(ticket)
                except ValueError:
                    continue  # already snapshotted by a flush
                self._pending_lanes -= len(ticket.planned.lanes)

    def wait(self, tickets: Sequence[CheckTicket]) -> None:
        """Block until every ticket resolves, coalescing with other
        submitters: wait up to one window for someone else's flush
        (adaptively cut short once the pending width plateaus —
        coalesce_wait), then flush whatever is pending ourselves."""
        for ticket in tickets:
            if coalesce_wait(ticket._ev, self.coalesce_window_s,
                             self._pending_width, self.adaptive):
                continue
            self.flush()
            if not ticket._ev.wait(FLUSH_WAIT_S):
                raise RuntimeError("farm flush did not resolve ticket")

    def _drained(self) -> None:
        # called from the backend, inside flush() under _flush_lock
        self.fallbacks += 1

    def _pending_width(self) -> int:
        with self._lock:
            return self._pending_lanes

    # --- the shared batch -------------------------------------------------

    def flush(self) -> int:
        """Verify everything pending in ONE coalesced batch; returns
        the unique-lane width dispatched. Serialized: a concurrent
        flush waits, then sees an empty queue and returns 0."""
        with self._flush_lock:
            with self._lock:
                tickets, self._tickets = self._tickets, []
                self._pending_lanes = 0
                self._shed_burst_open = False  # storm (if any) is over
            if not tickets:
                return 0
            fail_point("farm:flush")
            try:
                return self._run_batch(tickets)
            except Exception as e:  # noqa: BLE001 — a backend bug must
                # fail the waiting RPC threads, never strand them
                for ticket in tickets:
                    ticket.error = e
                    ticket._ev.set()
                raise

    def _run_batch(self, tickets: List[CheckTicket]) -> int:
        # intra-batch dedup: one device lane per unique signature, with
        # every (ticket, lane) that needs its verdict fanned back out
        unique: List[Lane] = []
        index: Dict[bytes, int] = {}
        owners: List[List[Tuple[CheckTicket, Lane]]] = []
        for ticket in tickets:
            for lane in ticket.planned.lanes:
                key = self.cache.key(lane.pub, lane.msg, lane.sig)
                at = index.get(key)
                if at is None:
                    index[key] = len(unique)
                    unique.append(lane)
                    owners.append([(ticket, lane)])
                else:
                    self.dedup_batch_hits += 1
                    if self.metrics is not None:
                        self.metrics.dedup_hits.inc(kind="batch")
                    owners[at].append((ticket, lane))
        # coalescing seam: one flush serves many submitters — a root
        # span linking each ticket's submit-side context
        tracer = shared_tracer()
        with tracer.start("farm.flush", tickets=len(tickets),
                          lanes=len(unique)) as span:
            if tracer.enabled:
                for ticket in tickets:
                    span.link(ticket.ctx)
            if self._backend_takes_ctx:
                oks, backend = self._backend(unique, ctx=span)
            else:
                oks, backend = self._backend(unique)
            span.set_attr("backend", backend)
        if len(oks) != len(unique):
            raise RuntimeError(
                f"verify backend answered {len(oks)} lanes "
                f"for {len(unique)}")
        self.batches += 1
        self.last_batch_width = len(unique)
        self.max_batch_width = max(self.max_batch_width, len(unique))
        self.lanes_by_backend[backend] = (
            self.lanes_by_backend.get(backend, 0) + len(unique))
        if self.metrics is not None:
            self.metrics.batches.inc()
            self.metrics.batch_width.set(len(unique))
            self.metrics.lanes.inc(len(unique), backend=backend)
        failures: Dict[int, int] = {}  # ticket id -> first bad sig idx
        for at, ok in enumerate(oks):
            lane = unique[at]
            if ok:
                self.cache.add(lane.pub, lane.msg, lane.sig)
                continue
            for ticket, owner_lane in owners[at]:
                failures.setdefault(id(ticket), owner_lane.sig_index)
        for ticket in tickets:
            bad = failures.get(id(ticket))
            if bad is not None:
                ticket.error = ErrWrongSignature(
                    bad, ticket.planned.commit.signatures[bad].signature)
            ticket._ev.set()
        return len(unique)
