"""Timeout scheduling for the consensus state machine
(reference internal/consensus/ticker.go:29-91).

One pending timeout at a time: scheduling a newer (height, round, step)
replaces any older pending one (the reference drains and stops the timer,
ticker.go:105-126). Fired timeouts are delivered into the state machine's
inbox like any other message — the single-writer loop stays the only
mutator.

The supersede/fire logic lives in `BaseTicker`; HOW a timeout is armed is
a seam (`_arm`/`_disarm`):

  * `TimeoutTicker`  — wall clock, threading.Timer (live nodes);
  * `ManualTicker`   — never armed; tests pop timeouts synchronously;
  * `simnet.clock.SimTicker` (JAX package only; simnet comes with node
    boot) — armed on the virtual event queue, so a whole multi-node
    simulation's timeouts fire in deterministic simulated time.

Copy of `cometbft_tpu/consensus/ticker.py`.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Optional


@dataclass(frozen=True, order=True)
class TimeoutInfo:
    """reference ticker.go timeoutInfo (duration first so ordering is by
    deadline-irrelevant fields only via explicit compare below)."""
    duration_ms: int
    height: int
    round: int
    step: int

    def newer_than(self, other: "TimeoutInfo") -> bool:
        return ((self.height, self.round, self.step)
                > (other.height, other.round, other.step))


class BaseTicker:
    """Pending-timeout bookkeeping shared by every ticker flavor
    (reference ticker.go:100-126 timeoutRoutine). Subclasses supply the
    arming mechanism only."""

    def __init__(self, deliver: Callable[[TimeoutInfo], None]):
        self._deliver = deliver
        self._pending: Optional[TimeoutInfo] = None
        self._lock = threading.Lock()

    def schedule(self, ti: TimeoutInfo) -> None:
        """Replace the pending timeout iff ti is for a >= (h,r,s)."""
        with self._lock:
            if self._pending is not None and self._pending.newer_than(ti):
                return
            self._disarm()
            self._pending = ti
            self._arm(ti)

    def fire(self, ti: TimeoutInfo) -> None:
        """Deliver `ti` if it is still the pending timeout (an armed
        trigger can race a superseding schedule)."""
        with self._lock:
            if self._pending is not ti:
                return  # superseded
            self._pending = None
            self._cleared()
        self._deliver(ti)

    def stop(self) -> None:
        with self._lock:
            self._disarm()
            self._pending = None

    # --- arming seam (called with the lock held) ------------------------------

    def _arm(self, ti: TimeoutInfo) -> None:
        """Arrange for self.fire(ti) after ti.duration_ms."""

    def _disarm(self) -> None:
        """Cancel whatever _arm set up (pending is being replaced)."""

    def _cleared(self) -> None:
        """The armed trigger just fired and won (drop stale handles)."""


class TimeoutTicker(BaseTicker):
    """Real-time ticker backed by threading.Timer."""

    def __init__(self, deliver: Callable[[TimeoutInfo], None]):
        super().__init__(deliver)
        self._timer: Optional[threading.Timer] = None

    def _arm(self, ti: TimeoutInfo) -> None:
        self._timer = threading.Timer(
            ti.duration_ms / 1000.0, self.fire, args=(ti,))
        self._timer.daemon = True
        self._timer.start()

    def _disarm(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def _cleared(self) -> None:
        self._timer = None


class ManualTicker(BaseTicker):
    """Virtual-clock ticker for deterministic tests: nothing is armed;
    the test pops the pending timeout itself."""

    def has_pending(self) -> bool:
        return self._pending is not None

    def fire_pending(self) -> bool:
        """Deliver the pending timeout now; returns False if none."""
        with self._lock:
            ti = self._pending
            self._pending = None
        if ti is None:
            return False
        self._deliver(ti)
        return True
