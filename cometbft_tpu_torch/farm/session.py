"""Per-client trust state for the verification farm.

A session is what a light client would keep locally if it verified for
itself: a trust root pinned by (height, hash) at subscribe time, a
trusting period, and the store of headers verified so far. The farm
holds one per subscribed client so repeat `light_verify` calls resume
from the client's own latest trusted header, exactly like
light/client.py resumes from its LightStore.

Sessions are bounded: `max_sessions` is the farm's first backpressure
surface (the second is the batcher's pending-lane queue). A subscribe
over the limit is SHED — rejected immediately with FarmOverloaded —
rather than queued, so an open-ended crowd of clients degrades into
explicit rejections instead of unbounded memory growth.

Copy of `cometbft_tpu/farm/session.py` (the port keeps its own).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Optional

from ..db.kv import MemDB
from ..libs.env import env_int
from ..light.store import LightStore
from ..light.types import LightBlock
from ..types.validation import DEFAULT_TRUST_LEVEL, Fraction

ENV_MAX_SESSIONS = "COMETBFT_TPU_FARM_MAX_SESSIONS"
DEFAULT_MAX_SESSIONS = 10_000


class SessionError(Exception):
    pass


class SessionLimitExceeded(SessionError):
    """max_sessions reached — the subscribe was shed."""


@dataclass
class FarmSession:
    """One client's trust state (the farm-side LightClient residue)."""
    session_id: str
    chain_id: str
    trusting_period_s: int
    trust_level: Fraction = DEFAULT_TRUST_LEVEL
    store: LightStore = field(default_factory=lambda: LightStore(MemDB()))
    headers_accepted: int = 0
    requests_rejected: int = 0

    def latest(self) -> Optional[LightBlock]:
        return self.store.latest()

    def status(self) -> Dict:
        latest = self.latest()
        return {
            "session": self.session_id,
            "trusting_period": self.trusting_period_s,
            "latest_height": latest.height if latest else 0,
            "latest_hash": (latest.header.hash().hex()
                            if latest else ""),
            "headers_accepted": self.headers_accepted,
            "requests_rejected": self.requests_rejected,
        }


class SessionManager:
    """Bounded registry of live sessions. Thread-safe: RPC worker
    threads subscribe/drop concurrently while verify calls read."""

    # guarded-by: _lock: _sessions, _next_id
    # (tools/staticcheck guarded-by rule enforces the annotation)

    def __init__(self, max_sessions: Optional[int] = None, metrics=None):
        if max_sessions is None:
            max_sessions = env_int(ENV_MAX_SESSIONS,
                                   DEFAULT_MAX_SESSIONS, minimum=1)
        self.max_sessions = max_sessions
        self.metrics = metrics  # libs/metrics_gen.FarmMetrics or None
        self._lock = threading.Lock()
        self._sessions: Dict[str, FarmSession] = {}
        self._next_id = 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._sessions)

    def create(self, chain_id: str, trusting_period_s: int,
               trust_level: Fraction = DEFAULT_TRUST_LEVEL) -> FarmSession:
        """New session, or SessionLimitExceeded when the farm is full.
        Ids are a plain process-local counter — deterministic for the
        simnet scenario and meaningless to forge (a session holds no
        authority; it only names a trust root the CLIENT chose)."""
        with self._lock:
            if len(self._sessions) >= self.max_sessions:
                if self.metrics is not None:
                    self.metrics.shed.inc()
                raise SessionLimitExceeded(
                    f"farm at capacity ({self.max_sessions} sessions)")
            sid = f"s{self._next_id}"
            self._next_id += 1
            session = FarmSession(sid, chain_id, trusting_period_s,
                                  trust_level)
            self._sessions[sid] = session
        self._emit_gauge()
        return session

    def get(self, session_id: str) -> FarmSession:
        with self._lock:
            session = self._sessions.get(session_id)
        if session is None:
            raise SessionError(f"unknown session {session_id!r}")
        return session

    def drop(self, session_id: str) -> bool:
        with self._lock:
            gone = self._sessions.pop(session_id, None)
        self._emit_gauge()
        return gone is not None

    def all_sessions(self) -> Dict[str, FarmSession]:
        with self._lock:
            return dict(self._sessions)

    def _emit_gauge(self) -> None:
        if self.metrics is not None:
            self.metrics.sessions.set(len(self))
