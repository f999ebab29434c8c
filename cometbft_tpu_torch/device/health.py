"""Device health supervisor: the per-process state machine that decides
whether the verification backend (the card / device server / pipeline
backend) may be trusted with signature batches.

The pipeline watchdog alone made a wedged device survivable but paid
for it with a one-way door: `wedged` latched sticky, so a single
transient stall demoted the node to CPU verification for the life of
the process. Worse, nothing detected a device that keeps ANSWERING but
answers WRONG — a silently corrupt backend would feed false verdicts
straight into commit verification. Hardware verify engines are only
deployable when the host can detect and survive engine faults (the
FPGA ECDSA engine of arXiv:2112.02229 pairs every offload with
host-side fault detection), and committee-based consensus lives on this batch-verify hot path
(arXiv:2302.00418).

State machine (one supervisor per process, shared by the blocksync
pipeline, the consensus-path RemoteBatchVerifier, and the device-client
reconnect logic):

    HEALTHY ──trip (watchdog deadline / transport error)──► SUSPECT
    SUSPECT ──backoff window elapsed──► PROBING   (half-open)
    PROBING ──known-answer probe correct──► HEALTHY
    PROBING ──probe transport error / timeout──► SUSPECT (backoff × 2)
    any     ──verdict corruption (canary mismatch)──► QUARANTINED

QUARANTINED is terminal for the process: a device that returned a wrong
VERDICT (not a transport failure — a lie) can never be re-trusted by
probing, because a probe that passes proves nothing about the next
batch. Backoff is jittered exponential: the first trip allows one
immediate half-open attempt (so a transient blip costs one retry, and
`RemoteBatchVerifier`'s retry-once contract still rides a fresh
reconnect), subsequent failures wait base, 2·base, … up to cap.

Canary lanes — how corruption is detected: every device batch gets a
deterministic known-good and known-bad (pubkey, msg, sig) pair spliced
onto the end, stripped from the results before anyone sees them. A
backend that flips verdicts, answers all-true, or answers all-false
mismatches at least one canary; any mismatch quarantines the device and
the WHOLE batch is re-verified on CPU. Device results are never trusted
un-canaried. (This is the transport-level sibling of the in-process
mosaic-miscompile canary, ops/ed25519._run_canary.)

Time flows through `libs/timesource.monotonic`, so under simnet the
backoff windows elapse in virtual time and the `device-flap` /
`device-corrupt` scenarios stay byte-identical per seed.

Copy of `cometbft_tpu/device/health.py` (the port keeps its own). What
differs:
- The canary pair is signed by the port's `crypto/ref_ed25519` copy.
- `DeviceFault` marks an error the device reported from its own kernels
  (the device server's failed flush, `client.DeviceFlushFailed`). It is
  not a transport failure to back off from: `probe` restores SUSPECT and
  re-raises it instead of counting it as a failed probe.
- The port's pipeline (`pipeline/scheduler.py`) treats a canary mismatch
  from a backend that drains nothing (its in-process one) as a kernel
  fault that raises, not as a corrupt remote device to quarantine; the
  device-server backend and `RemoteBatchVerifier` keep this module's
  quarantine-and-re-verify.
"""

from __future__ import annotations

import random
import threading
from typing import Callable, List, Optional, Sequence, Tuple

from ..libs.env import env_bool, env_float
from ..libs import timesource

# env-tunable knobs ([device] config section overrides via configure())
ENV_BACKOFF_BASE = "COMETBFT_TPU_DEVICE_BACKOFF_BASE"      # seconds
ENV_BACKOFF_CAP = "COMETBFT_TPU_DEVICE_BACKOFF_CAP"        # seconds
ENV_PROBE_DEADLINE = "COMETBFT_TPU_DEVICE_PROBE_DEADLINE"  # seconds
ENV_CANARY = "COMETBFT_TPU_DEVICE_CANARY"                  # bool
DEFAULT_BACKOFF_BASE_S = 0.5
DEFAULT_BACKOFF_CAP_S = 30.0
DEFAULT_PROBE_DEADLINE_S = 2.0
JITTER_FRACTION = 0.25  # window *= 1 + uniform(0, JITTER_FRACTION)

# states (the numeric values ARE the device_health_state gauge)
HEALTHY = 0
SUSPECT = 1
PROBING = 2
QUARANTINED = 3
STATE_NAMES = {HEALTHY: "healthy", SUSPECT: "suspect",
               PROBING: "probing", QUARANTINED: "quarantined"}


class AccountedTransportError(ConnectionError):
    """A transport failure whose trip was ALREADY reported to the
    supervisor by the layer that observed it (e.g. shared_client()'s
    failed reconnect), or that made no device contact at all (half-open
    window still closed). Layers that catch one must not report it
    again — a second report_trip would double-count one outage and
    deepen the backoff twice per failure."""


class DeviceFault(Exception):
    """The device answered, and what it answered is that its own kernels
    failed (a build, launch or canary error on the card). Not a transport
    failure: no layer retries it, backs off from it or verifies the batch
    elsewhere in its place; it propagates to the caller."""


# --- canary lanes -------------------------------------------------------------

CANARY_LANES = 2  # one known-good + one known-bad, appended in order

_canary_cache: Optional[Tuple[Tuple[bytes, bytes, bytes],
                              Tuple[bytes, bytes, bytes]]] = None


def canary_pair() -> Tuple[Tuple[bytes, bytes, bytes],
                           Tuple[bytes, bytes, bytes]]:
    """((pub, msg, sig) known-GOOD, (pub, msg, sig) known-BAD) —
    deterministic constants computed once per process with the trusted
    host-side reference implementation (never a device). The bad triple
    is the good one with a flipped signature bit, so the two lanes share
    every shape property with production lanes."""
    global _canary_cache
    if _canary_cache is None:
        from ..crypto import ref_ed25519 as ref
        seed = b"\xc5" * 32
        msg = b"cometbft-tpu device canary lane"  # 31B: fits any server
        pub = ref.pubkey_from_seed(seed)
        sig = ref.sign(seed, msg)
        bad = bytes([sig[0] ^ 0x01]) + sig[1:]
        _canary_cache = ((pub, msg, sig), (pub, msg, bad))
    return _canary_cache


def splice_canaries(pubs: Sequence[bytes], msgs: Sequence[bytes],
                    sigs: Sequence[bytes]
                    ) -> Tuple[List[bytes], List[bytes], List[bytes]]:
    """New lane lists with the canary pair appended (never mutates the
    caller's lists — the CPU re-verify path needs them canary-free)."""
    good, bad = canary_pair()
    return (list(pubs) + [good[0], bad[0]],
            list(msgs) + [good[1], bad[1]],
            list(sigs) + [good[2], bad[2]])


def check_canaries(out: Sequence, n_lanes: Optional[int] = None
                   ) -> Tuple[bool, List[bool]]:
    """(canaries_correct, verdicts with the canary lanes stripped).
    Expected trailing verdicts: [True, False] — good verifies, bad
    fails. `n_lanes` is the caller's real lane count: a response whose
    length is not n_lanes + CANARY_LANES is corruption too — a short
    answer would crash lane mapping and a long one silently shifts
    verdicts onto the wrong signatures. Anything else means the
    backend's verdicts cannot be trusted."""
    verdicts = [bool(v) for v in out]
    if len(verdicts) < CANARY_LANES:
        return False, []
    if n_lanes is not None and len(verdicts) != n_lanes + CANARY_LANES:
        return False, []
    body, tail = verdicts[:-CANARY_LANES], verdicts[-CANARY_LANES:]
    return tail == [True, False], body


# --- the supervisor -----------------------------------------------------------

class DeviceSupervisor:
    """Owns the device health state machine; thread-safe (the blocksync
    pipeline thread, consensus verify paths, and `shared_client()`
    reconnects all report here)."""

    # guarded-by: _lock: _state, _trips_since_healthy, _next_probe_at
    # guarded-by: _lock: trips, probes, quarantines, canary_failures
    # guarded-by: _lock: last_error
    # (flow-aware: _set_state/_emit_state are only ever called under
    # the lock, so they carry it at entry; the read-only state
    # accessors below pragma their deliberate lock-free single-int
    # reads)

    def __init__(self, backoff_base_s: Optional[float] = None,
                 backoff_cap_s: Optional[float] = None,
                 probe_deadline_s: Optional[float] = None,
                 canary: Optional[bool] = None,
                 metrics=None, log=None,
                 clock: Callable[[], float] = timesource.monotonic,
                 jitter_seed: int = 0xDE71CE):
        if backoff_base_s is None:
            backoff_base_s = env_float(ENV_BACKOFF_BASE,
                                       DEFAULT_BACKOFF_BASE_S)
        if backoff_cap_s is None:
            backoff_cap_s = env_float(ENV_BACKOFF_CAP,
                                      DEFAULT_BACKOFF_CAP_S)
        if probe_deadline_s is None:
            probe_deadline_s = env_float(ENV_PROBE_DEADLINE,
                                         DEFAULT_PROBE_DEADLINE_S)
        if canary is None:
            canary = env_bool(ENV_CANARY, True)
        self.backoff_base_s = max(1e-6, backoff_base_s)
        self.backoff_cap_s = max(self.backoff_base_s, backoff_cap_s)
        self.probe_deadline_s = probe_deadline_s
        self.canary = canary
        self.metrics = metrics  # libs/metrics_gen.DeviceMetrics or None
        self.log = log
        self._clock = clock
        # deterministic jitter: a fixed-seed PRNG gives every process
        # the same window sequence (simnet byte-identical logs) while
        # still de-phasing windows within one recovery episode
        self._rng = random.Random(jitter_seed)
        self._lock = threading.Lock()
        self._state = HEALTHY
        self._trips_since_healthy = 0
        self._next_probe_at = 0.0
        self.trips = 0
        self.probes = 0
        self.quarantines = 0
        self.canary_failures = 0
        self.last_error: Optional[BaseException] = None
        self._configured = False

    # --- introspection ----------------------------------------------------

    # The accessors below read _state WITHOUT the lock on purpose: a
    # single aligned int read is atomic under the GIL, the value is a
    # snapshot that can be stale one instruction later regardless, and
    # these sit on the per-batch dispatch hot path where serializing
    # against report_* would add contention for no correctness gain.

    @property
    def state(self) -> int:
        return self._state  # staticcheck: allow(guarded-by)

    def state_name(self) -> str:
        return STATE_NAMES[self._state]  # staticcheck: allow(guarded-by)

    def healthy(self) -> bool:
        return self._state == HEALTHY  # staticcheck: allow(guarded-by)

    def quarantined(self) -> bool:
        return self._state == QUARANTINED  # staticcheck: allow(guarded-by)

    def can_dispatch(self) -> bool:
        """True iff full batches may go to the device right now."""
        return self._state == HEALTHY  # staticcheck: allow(guarded-by)

    # --- configuration (node boot; first caller wins) ---------------------

    def configure(self, device_config=None, metrics=None) -> None:
        """Apply the `[device]` config section + metrics struct. First
        configuration wins (several in-process nodes share one
        supervisor, exactly like pipeline/cache.shared_cache)."""
        if metrics is not None and self.metrics is None:
            self.metrics = metrics
            # under the lock: _emit_state reads _state, and boot-time
            # configure can race a supervisor already fielding reports
            with self._lock:
                self._emit_state()
        if device_config is None or self._configured:
            return
        self._configured = True
        self.backoff_base_s = max(
            1e-6, device_config.probe_backoff_base_ms / 1000.0)
        self.backoff_cap_s = max(
            self.backoff_base_s, device_config.probe_backoff_cap_ms / 1000.0)
        self.probe_deadline_s = device_config.probe_deadline_ms / 1000.0
        self.canary = device_config.canary

    # --- transitions ------------------------------------------------------

    def report_trip(self, exc: BaseException) -> None:
        """A watchdog deadline miss, transport error, or failed
        (re)connect. HEALTHY degrades to SUSPECT with one immediate
        half-open attempt allowed; repeat failures back off
        exponentially (jittered, capped)."""
        with self._lock:
            if self._state == QUARANTINED:
                return
            self.trips += 1
            self.last_error = exc
            self._trips_since_healthy += 1
            window = self._window_s(self._trips_since_healthy)
            self._next_probe_at = self._clock() + window
            self._set_state(SUSPECT)
        self._say(f"device suspect ({type(exc).__name__}: {exc}); "
                  f"next probe in {window:.3f}s")

    def report_corruption(self, detail: str = "") -> None:
        """A canary verdict mismatch: the device LIED. Terminal."""
        # flight-recorder dump BEFORE the state flip: the ring still
        # holds the batch spans that carried the lying canary (the
        # QUARANTINED guard below makes later calls no-ops anyway, so
        # one event dumps once)
        from ..trace import trigger_dump
        trigger_dump("canary-failure", "node", detail)
        with self._lock:
            if self._state == QUARANTINED:
                return
            self.canary_failures += 1
            self.quarantines += 1
            self._set_state(QUARANTINED)
            if self.metrics is not None:
                self.metrics.canary_failures.inc()
                self.metrics.quarantines_total.inc()
        self._say(f"device QUARANTINED: verdict corruption ({detail}); "
                  f"all verification falls back to CPU")

    def report_success(self) -> None:
        """A canary-verified batch (or probe) answered correctly."""
        with self._lock:
            if self._state in (HEALTHY, QUARANTINED):
                return
            self._trips_since_healthy = 0
            self._next_probe_at = 0.0
            self._set_state(HEALTHY)
        self._say("device healthy again; resuming device dispatch")

    def probe_due(self) -> bool:
        """True when SUSPECT and the current backoff window elapsed —
        the caller should run one half-open probe()."""
        with self._lock:
            return (self._state == SUSPECT
                    and self._clock() >= self._next_probe_at)

    def probe(self, verify_fn: Callable[[List[bytes], List[bytes],
                                         List[bytes]], Sequence]) -> bool:
        """One half-open known-answer batch: `verify_fn(pubs, msgs,
        sigs)` must return per-lane verdicts for the canary pair within
        the probe deadline (the caller adapts its backend/client and
        applies the deadline). Correct verdicts restore HEALTHY; wrong
        verdicts quarantine; transport errors/timeouts deepen the
        backoff. Returns True iff the device is HEALTHY afterwards."""
        with self._lock:
            if self._state != SUSPECT:
                return self._state == HEALTHY
            self._set_state(PROBING)
            self.probes += 1
            if self.metrics is not None:
                self.metrics.probes_total.inc()
        good, bad = canary_pair()
        try:
            out = verify_fn([good[0], bad[0]], [good[1], bad[1]],
                            [good[2], bad[2]])
        except Exception as e:  # noqa: BLE001 — timeout or transport:
            # the device is still unreachable, not provably lying
            if isinstance(e, DeviceFault):
                # reachable, and failing in its kernels: surface it
                with self._lock:
                    if self._state == PROBING:
                        self._set_state(SUSPECT)
                raise
            if isinstance(e, AccountedTransportError):
                # the observing layer already reported this trip (which
                # moved PROBING back to SUSPECT), or made no device
                # contact at all because a concurrent verifier consumed
                # the half-open window. The latter reports nothing, so
                # restore SUSPECT here or the state would latch in
                # PROBING forever (no report_* call ever comes, and
                # probe_due() requires SUSPECT)
                with self._lock:
                    if self._state == PROBING:
                        self._set_state(SUSPECT)
                return False
            self.report_trip(e)
            return False
        verdicts = [bool(v) for v in out]
        if verdicts == [True, False]:
            self.report_success()
            return True
        self.report_corruption(
            f"probe verdicts {verdicts} != [True, False]")
        return False

    # --- reconnect gating (device/client.shared_client) -------------------

    def allow_connect(self) -> bool:
        """May the client attempt a (re)connect now? Quarantine never
        reconnects; SUSPECT reconnects ride the same half-open backoff
        windows as probes. Granting an elapsed window CONSUMES it
        (_next_probe_at advances as if the attempt fails): the grant
        is one-shot, so concurrent callers back off instead of
        stampeding the suspect device with parallel full batches. The
        outcome report (report_success / report_trip) supersedes the
        provisional window either way."""
        with self._lock:
            if self._state == QUARANTINED:
                return False
            if self._state == HEALTHY:
                return True
            if self._clock() < self._next_probe_at:
                return False
            self._next_probe_at = self._clock() + self._window_s(
                self._trips_since_healthy + 1)
            return True

    # --- internals --------------------------------------------------------

    def _window_s(self, n: int) -> float:
        """Backoff window after the n-th consecutive failure since the
        device was last HEALTHY (caller holds the lock). n == 1 is
        free: one immediate half-open retry."""
        if n <= 1:
            return 0.0
        window = min(self.backoff_cap_s,
                     self.backoff_base_s * (2.0 ** (n - 2)))
        return window * (1.0 + JITTER_FRACTION * self._rng.random())

    def _set_state(self, state: int) -> None:
        # caller holds the lock
        self._state = state
        self._emit_state()

    def _emit_state(self) -> None:
        if self.metrics is not None:
            self.metrics.health_state.set(self._state)

    def _say(self, msg: str) -> None:
        if self.log is not None:
            self.log(f"device supervisor: {msg}")


# --- process-wide instance ----------------------------------------------------

_shared: Optional[DeviceSupervisor] = None
_shared_lock = threading.Lock()


def shared_supervisor() -> DeviceSupervisor:
    """The per-process supervisor (env-default knobs until a node's
    configure() call). device/client, crypto/batch, and node boot all
    consult the same instance so a quarantine observed on any path
    stops device trust on every path."""
    global _shared
    with _shared_lock:
        if _shared is None:
            _shared = DeviceSupervisor()
        return _shared


def reset_shared_supervisor() -> None:
    """Drop the shared instance (tests; re-reads env knobs)."""
    global _shared
    with _shared_lock:
        _shared = None
