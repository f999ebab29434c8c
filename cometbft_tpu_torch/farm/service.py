"""VerificationFarm: the service object behind the light_* RPC routes
(the routes themselves wait for the port's RPC server).

Lifecycle per client:

  subscribe(height, hash, period)  pin a trust root exactly like
                                   light/client.py _initialize (hash
                                   match + the root commit verified
                                   through the shared batch)
  verify(session, height)          plan the bisection schedule from
                                   the session's latest trusted header
                                   (planner.py), coalesce its lanes
                                   with every other in-flight request
                                   (batcher.py), then commit verified
                                   steps to the session store IN ORDER
                                   — a failed step rejects the request
                                   and nothing past it is trusted
  status([session])                farm-wide counters or one session's
                                   trust state

Two-phase verify (`begin_verify` / `finish_verify`) is the coalescing
seam: a blocking caller uses `verify()` (concurrent worker threads
coalesce through the batcher's window), while deterministic callers —
`chip_smoke.py`'s farm phase, the tests — begin a whole wave of
clients, flush once, and finish each.

Every accepted header appends a decision record
(tools/check_light_spec.check_decisions re-judges them against the
spec/LightClient.tla acceptance rules); `decision_log` is bounded so a
long-lived farm does not grow without bound.

Port of `cometbft_tpu/farm/service.py`. The farm takes `device=`
(default cuda) and hands it to its default batcher, which resolves it
(`device.resolve_device`) and runs its wide batches' RLC kernels there
(batcher.py).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..libs.env import env_int
from ..libs.fail import fail_point
from ..light import verifier
from ..light.provider import ProviderError
from ..light.types import LightBlock, LightBlockError
from ..pipeline.cache import SigCache, shared_cache
from ..types.proto import Timestamp
from ..types.validation import (CommitVerificationError,
                                DEFAULT_TRUST_LEVEL, Fraction)
from . import planner
from .batcher import CheckTicket, FarmBatcher, QueueFull
from .session import FarmSession, SessionError, SessionLimitExceeded, \
    SessionManager

ENV_MAX_FETCHES = "COMETBFT_TPU_FARM_MAX_FETCHES"
DEFAULT_MAX_FETCHES = 128
ENV_DECISION_LOG = "COMETBFT_TPU_FARM_DECISION_LOG"
DEFAULT_DECISION_LOG = 4096


class FarmError(Exception):
    pass


class FarmOverloaded(FarmError):
    """Shed: session limit or verify queue full — retryable."""


class UnknownSession(FarmError):
    pass


class VerifyRejected(FarmError):
    """The request failed the acceptance rules (or a provider could
    not serve the needed headers). Carries the reason; the session
    stays usable at its previous trust state."""


@dataclass
class PendingVerify:
    """An in-flight verify between begin and finish."""
    session: FarmSession
    target_height: int
    steps: List[planner.VerifyStep]
    tickets: List[List[CheckTicket]]  # per step, aligned with checks
    cached: Optional[LightBlock] = None  # already-trusted fast path


@dataclass
class PendingSubscribe:
    session: FarmSession
    root: LightBlock
    tickets: List[CheckTicket] = field(default_factory=list)


class VerificationFarm:
    """One farm per served chain; thread-safe."""

    def __init__(self, chain_id: str, provider,
                 cache: Optional[SigCache] = None,
                 sessions: Optional[SessionManager] = None,
                 batcher: Optional[FarmBatcher] = None,
                 metrics=None,
                 now_fn: Callable[[], Timestamp] = Timestamp.now,
                 max_fetches: Optional[int] = None, device=None):
        self.chain_id = chain_id
        self.provider = provider
        self.metrics = metrics  # libs/metrics_gen.FarmMetrics or None
        self.cache = cache if cache is not None else shared_cache()
        # `is not None`, not `or`: an EMPTY SessionManager is falsy
        # (it defines __len__), and a caller's bounded instance must
        # never be silently swapped for the unbounded default
        self.sessions = (sessions if sessions is not None
                         else SessionManager(metrics=metrics))
        self.batcher = (batcher if batcher is not None
                        else FarmBatcher(cache=self.cache,
                                         metrics=metrics,
                                         device=device))
        self._now = now_fn
        if max_fetches is None:
            max_fetches = env_int(ENV_MAX_FETCHES, DEFAULT_MAX_FETCHES,
                                  minimum=1)
        self.max_fetches = max_fetches
        self._lock = threading.Lock()
        # guarded-by: _lock: decision_log, headers_accepted, headers_rejected
        self.decision_log: List[Dict] = []
        self._decision_cap = env_int(ENV_DECISION_LOG,
                                     DEFAULT_DECISION_LOG, minimum=0)
        self.headers_accepted = 0
        self.headers_rejected = 0

    # --- subscribe --------------------------------------------------------

    def begin_subscribe(self, trusted_height: int, trusted_hash: bytes,
                        trusting_period_s: int,
                        trust_level: Fraction = DEFAULT_TRUST_LEVEL
                        ) -> PendingSubscribe:
        """Pin a trust root (light/client.py _initialize): fetch the
        client's chosen header, demand its hash, and queue the root
        commit's lanes. Sheds when the farm is at session capacity."""
        if trusting_period_s <= 0:
            raise VerifyRejected("trusting period must be positive")
        if trusted_height <= 0:
            raise VerifyRejected("trusted height must be positive")
        if len(trusted_hash) != 32:
            raise VerifyRejected("trusted hash must be 32 bytes")
        try:
            lb = self.provider.light_block(trusted_height)
        except ProviderError as e:
            raise VerifyRejected(f"provider: {e}") from e
        try:
            lb.validate_basic(self.chain_id)
        except LightBlockError as e:
            raise VerifyRejected(f"invalid root light block: {e}") from e
        if lb.header.hash() != trusted_hash:
            raise VerifyRejected(
                f"provider header hash {lb.header.hash().hex()[:16]} != "
                f"trusted {trusted_hash.hex()[:16]}")
        try:
            root_check = planner.plan_commit_light(
                self.chain_id, lb.validator_set,
                lb.signed_header.commit.block_id, lb.height,
                lb.signed_header.commit, self.cache)
        except CommitVerificationError as e:
            raise VerifyRejected(f"root commit: {e}") from e
        try:
            session = self.sessions.create(self.chain_id,
                                           trusting_period_s, trust_level)
        except SessionLimitExceeded as e:
            raise FarmOverloaded(str(e)) from e
        pending = PendingSubscribe(session, lb)
        try:
            pending.tickets = [self.batcher.submit(root_check)]
        except QueueFull as e:
            self.sessions.drop(session.session_id)
            raise FarmOverloaded(str(e)) from e
        return pending

    def finish_subscribe(self, pending: PendingSubscribe) -> FarmSession:
        self.batcher.wait(pending.tickets)
        bad = next((t.error for t in pending.tickets
                    if t.error is not None), None)
        if bad is not None:
            self.sessions.drop(pending.session.session_id)
            raise VerifyRejected(f"root commit: {bad}")
        pending.session.store.save_light_block(pending.root)
        return pending.session

    def subscribe(self, trusted_height: int, trusted_hash: bytes,
                  trusting_period_s: int,
                  trust_level: Fraction = DEFAULT_TRUST_LEVEL
                  ) -> FarmSession:
        return self.finish_subscribe(self.begin_subscribe(
            trusted_height, trusted_hash, trusting_period_s, trust_level))

    def unsubscribe(self, session_id: str) -> bool:
        return self.sessions.drop(session_id)

    # --- verify -----------------------------------------------------------

    def begin_verify(self, session_id: str, height: int = 0,
                     now: Optional[Timestamp] = None) -> PendingVerify:
        """Plan + enqueue one client's update. height 0 = provider
        tip. Raises UnknownSession / FarmOverloaded / VerifyRejected
        (host-side rules: expiry, ordering, power, bisection budget)."""
        try:
            session = self.sessions.get(session_id)
        except SessionError as e:
            raise UnknownSession(str(e)) from e
        now = now or self._now()
        try:
            target = self.provider.light_block(height)
        except ProviderError as e:
            self._reject(session)
            raise VerifyRejected(f"provider: {e}") from e
        latest = session.latest()
        if latest is None:
            self._reject(session)
            raise VerifyRejected("session has no trust root")
        got = session.store.light_block(target.height)
        if got is not None:
            return PendingVerify(session, target.height, [], [],
                                 cached=got)
        if target.height <= latest.height:
            # the farm serves FORWARD verification; a backwards walk
            # is a per-client hash-link chase with no batchable work —
            # the client keeps its own verified headers for that
            self._reject(session)
            raise VerifyRejected(
                f"height {target.height} <= trusted {latest.height} "
                f"(farm verifies forward only)")
        try:
            target.validate_basic(self.chain_id)
            steps = planner.plan_update(
                self.chain_id, latest, target, self.provider, now,
                session.trusting_period_s, session.trust_level,
                self.cache, max_fetches=self.max_fetches)
        except (verifier.VerificationError, CommitVerificationError,
                LightBlockError, ProviderError) as e:
            self._reject(session)
            raise VerifyRejected(str(e)) from e
        tickets: List[List[CheckTicket]] = []
        queued: List[CheckTicket] = []
        try:
            for step in steps:
                row: List[CheckTicket] = []
                for check in step.checks:
                    # one at a time, recording each ticket BEFORE the
                    # next submit can raise — cancel() below must see
                    # every check this request actually queued
                    row.append(self.batcher.submit(check))
                    queued.append(row[-1])
                tickets.append(row)
        except QueueFull as e:
            # shed the WHOLE request — and WITHDRAW the checks already
            # queued for it: a shed request never reaches wait(), so
            # its orphaned lanes would otherwise hold the bounded
            # queue's budget forever (every later request then sheds
            # against dead weight nothing will ever flush)
            self.batcher.cancel(queued)
            raise FarmOverloaded(str(e)) from e
        return PendingVerify(session, target.height, steps, tickets)

    def finish_verify(self, pending: PendingVerify) -> Dict:
        """Wait for the coalesced verdicts, then commit verified steps
        in order. Returns the accepted-tip summary dict."""
        if pending.cached is not None:
            return self._accept_summary(pending.session, pending.cached,
                                        steps=0)
        flat = [t for row in pending.tickets for t in row]
        self.batcher.wait(flat)
        session = pending.session
        accepted = 0
        for step, row in zip(pending.steps, pending.tickets):
            bad = next((t.error for t in row if t.error is not None),
                       None)
            if bad is not None:
                self._reject(session)
                raise VerifyRejected(
                    f"height {step.lb.height}: {bad}") from bad
            fail_point("farm:commit-session")
            session.store.save_light_block(step.lb)
            session.headers_accepted += 1
            accepted += 1
            self._log_decision(session, step)
        return self._accept_summary(
            session, session.store.light_block(pending.target_height),
            steps=accepted)

    def verify(self, session_id: str, height: int = 0,
               now: Optional[Timestamp] = None) -> Dict:
        return self.finish_verify(self.begin_verify(session_id, height,
                                                    now))

    # --- status -----------------------------------------------------------

    def status(self, session_id: Optional[str] = None) -> Dict:
        if session_id is not None:
            try:
                return self.sessions.get(session_id).status()
            except SessionError as e:
                raise UnknownSession(str(e)) from e
        b = self.batcher
        with self._lock:
            accepted, rejected = self.headers_accepted, \
                self.headers_rejected
        return {
            "sessions": len(self.sessions),
            "max_sessions": self.sessions.max_sessions,
            "headers_accepted": accepted,
            "requests_rejected": rejected,
            "batches": b.batches,
            "last_batch_width": b.last_batch_width,
            "max_batch_width": b.max_batch_width,
            "lanes_by_backend": dict(b.lanes_by_backend),
            "dedup_batch_hits": b.dedup_batch_hits,
            "cache_hit_rate": round(
                self.cache.hit_rate(planner.CACHE_PATH), 4),
            "shed": b.shed,
            "fallbacks": b.fallbacks,
        }

    # --- internals --------------------------------------------------------

    def _accept_summary(self, session: FarmSession, lb: LightBlock,
                        steps: int) -> Dict:
        return {"session": session.session_id, "height": lb.height,
                "hash": lb.header.hash().hex(),
                "validators_hash": lb.header.validators_hash.hex(),
                "steps": steps}

    def _reject(self, session: FarmSession) -> None:
        session.requests_rejected += 1
        with self._lock:
            self.headers_rejected += 1
        if self.metrics is not None:
            self.metrics.headers_rejected.inc()

    def _log_decision(self, session: FarmSession,
                      step: planner.VerifyStep) -> None:
        record = dict(step.record)
        record["session"] = session.session_id
        with self._lock:
            self.headers_accepted += 1
            self.decision_log.append(record)
            if len(self.decision_log) > self._decision_cap:
                del self.decision_log[:-self._decision_cap or None]
        if self.metrics is not None:
            self.metrics.headers_accepted.inc()

    def drain_decisions(self) -> List[Dict]:
        """Pop the accumulated decision records (the simnet scenario's
        spec-oracle feed)."""
        with self._lock:
            out, self.decision_log = self.decision_log, []
        return out
