"""Process-wide time seam — the virtual-clock contract for simnet.

Production code that (a) stamps protocol data (`types/proto.Timestamp.now`)
or (b) makes rate/timeout decisions outside the consensus ticker
(consensus/reactor catch-up budgets, blocksync status deadlines) reads
time through this module instead of `time` directly. By default both
functions are the stdlib clocks, so live nodes behave identically to
before the seam existed.

`cometbft_tpu/simnet` installs a virtual source for the duration of a
simulation run: all N in-process nodes then observe one deterministic
clock that only advances when the event queue says so, which is what
makes two runs with the same seed produce byte-identical event logs
(docs/SIMNET.md "virtual-clock seam contract").

The seam is deliberately tiny:

  install(now_ns_fn)  — now_ns_fn() -> int nanoseconds since the Unix
                        epoch (virtual). monotonic() is derived from it,
                        so one function drives both clock families.
  reset()             — back to wall clocks.

Code holding a long-lived reference to `time.monotonic` (thread loops
that must keep running during a sim, e.g. mconn ping routines) is
intentionally NOT routed through here — the seam covers only paths the
simulator executes on its own thread.

Copy of `cometbft_tpu/libs/timesource.py` (the port keeps its own).
"""

from __future__ import annotations

import time as _time
from typing import Callable, Optional

_virtual_now_ns: Optional[Callable[[], int]] = None


def install(now_ns_fn: Callable[[], int]) -> None:
    """Route monotonic()/time_ns() through `now_ns_fn` (simnet only)."""
    global _virtual_now_ns
    _virtual_now_ns = now_ns_fn


def reset() -> None:
    global _virtual_now_ns
    _virtual_now_ns = None


def installed() -> bool:
    return _virtual_now_ns is not None


def time_ns() -> int:
    """Wall (or virtual) nanoseconds since the epoch — feeds
    types/proto.Timestamp.now and therefore every vote/block time."""
    if _virtual_now_ns is not None:
        return _virtual_now_ns()
    return _time.time_ns()


def monotonic() -> float:
    """Monotonic seconds for elapsed-time decisions (token buckets,
    reconcile budgets, status deadlines). Under a virtual source this is
    simply virtual-epoch seconds — virtual time never goes backwards."""
    if _virtual_now_ns is not None:
        return _virtual_now_ns() / 1e9
    return _time.monotonic()


def sleep(seconds: float) -> None:
    """Polling-loop pause. Real sleep on wall clocks; under a virtual
    source a short REAL yield instead — the loop's deadline math reads
    the virtual clock, so blocking this thread for virtual seconds
    would deadlock the simulator that owns clock advancement."""
    if _virtual_now_ns is not None:
        _time.sleep(0.001)
        return
    _time.sleep(seconds)
