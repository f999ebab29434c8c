"""Device-wedge watchdog: per-dispatch deadlines for the verification
pipeline.

A dispatch that will never answer (a wedged device, a device server
that stopped reading) must not hang blocksync forever. Each tile
dispatch gets a deadline scaled by its lane count; a miss (or a
transport error of the device-server link) trips the watchdog: the
current tile and every in-flight tile drain to the CPU fallback
(per-signature verify in the scheduler) instead of waiting out a dead
device, and each drained tile increments the pipeline_wedge_fallbacks
Prometheus counter.

Recovery is owned by the device health supervisor (device/health.py):
with a supervisor attached, a trip reports SUSPECT and `wedged` tracks
the supervisor's state — the scheduler probes the device with cheap
known-answer batches on a jittered exponential backoff and resumes
device dispatch when the supervisor returns to HEALTHY. Without a
supervisor the original STICKY semantics remain (a wedge latches for
the watchdog's lifetime): probing a dead device once per tile would pay
the full deadline every time, so standalone watchdogs never re-arm.

Port of `cometbft_tpu/pipeline/watchdog.py`. What differs: the JAX
package's `result` drains on ANY exception from the backend. Here only
`LINK_ERRORS` drain, a deadline miss (TimeoutError) and a dead link
(ConnectionError); anything else (the device server's
`DeviceFlushFailed`, a kernel build or launch error, `KernelCanaryError`,
a bug) propagates to the caller. The scheduler consults `result` only
for a backend that declares the drain (`drain_on`: the device-server
link and the stubs that model one); for any other backend, its
in-process one included, a deadline miss raises
`scheduler.DispatchDeadlineExceeded`. The drain is the liveness path for
a wedged or unreachable device server, never a fallback that hides a
kernel fault.
"""

from __future__ import annotations

from typing import Optional

from ..libs.env import env_float

DEADLINE_BASE_ENV = "COMETBFT_TPU_PIPELINE_DEADLINE_BASE"
DEADLINE_PER_SIG_ENV = "COMETBFT_TPU_PIPELINE_DEADLINE_PER_SIG"
DEFAULT_BASE_S = 30.0      # covers a cold kernel compile on a live device
DEFAULT_PER_SIG_S = 0.005  # generous: a healthy flush is ms for thousands

# what a dispatch may fail with and still be drained to the CPU: a
# deadline miss, or the device-server link going down
LINK_ERRORS = (TimeoutError, ConnectionError)


class DeviceWatchdog:
    """Bounds every pipeline dispatch; wedge detection latches sticky
    unless a DeviceSupervisor owns recovery."""

    def __init__(self, base_deadline_s: Optional[float] = None,
                 per_sig_s: Optional[float] = None, metrics=None,
                 log=None, supervisor=None):
        if base_deadline_s is None:
            base_deadline_s = env_float(DEADLINE_BASE_ENV,
                                        DEFAULT_BASE_S)
        if per_sig_s is None:
            per_sig_s = env_float(DEADLINE_PER_SIG_ENV,
                                  DEFAULT_PER_SIG_S)
        self.base_deadline_s = base_deadline_s
        self.per_sig_s = per_sig_s
        self.metrics = metrics  # libs/metrics_gen.PipelineMetrics or None
        self.log = log
        self.supervisor = supervisor  # device/health.DeviceSupervisor
        self._sticky_wedged = False
        self.trips = 0       # distinct wedge detections
        self.fallbacks = 0   # tiles drained to the CPU fallback
        self.last_error: Optional[BaseException] = None

    @property
    def wedged(self) -> bool:
        """Is the device currently unusable for dispatch? Supervisor-
        backed watchdogs recover when it returns HEALTHY; standalone
        ones stay sticky."""
        if self.supervisor is not None:
            return not self.supervisor.can_dispatch()
        return self._sticky_wedged

    def deadline_for(self, n_lanes: int) -> float:
        return self.base_deadline_s + self.per_sig_s * max(0, n_lanes)

    def result(self, future, n_lanes: int):
        """The per-lane verdicts from `future`, or None when the caller
        must CPU-verify the tile itself (deadline missed, the link went
        down, or the device is currently wedged/suspect). Any other
        exception propagates."""
        if self.wedged:
            self._fallback()
            return None
        try:
            return future.result(self.deadline_for(n_lanes))
        except LINK_ERRORS as e:
            self._trip(e)
            self._fallback()
            return None

    def _trip(self, exc: BaseException) -> None:
        self.trips += 1
        self.last_error = exc
        # flight-recorder dump keyed per distinct trip: the ring at
        # this moment holds the dispatch/settle spans leading into the
        # wedge (trace/ is a no-op while tracing is disabled)
        from ..trace import trigger_dump
        trigger_dump("watchdog-trip", str(self.trips),
                     f"{type(exc).__name__}: {exc}")
        if self.supervisor is not None:
            self.supervisor.report_trip(exc)
        else:
            self._sticky_wedged = True
        if self.log is not None:
            self.log(f"pipeline watchdog: device wedged "
                     f"({type(exc).__name__}: {exc}); draining to CPU")

    def _fallback(self) -> None:
        self.fallbacks += 1
        if self.metrics is not None:
            self.metrics.wedge_fallbacks.inc()
