"""Python client for the verify device server, plus the BatchVerifier
adapter that lets any node process offload signature verification to
the host's single card-owner process (the plugin seam
crypto/batch.CreateBatchVerifier selects by key type in the reference,
crypto/batch/batch.go:11-21 — here selected by configuration).

Port of `cometbft_tpu/device/client.py`. What differs:
`RemoteBatchVerifier` takes the `batch_size` and `device` of its local
verifier (the port's `Ed25519BatchVerifier`, whose device defaults to
cuda and raises without a card). The device is resolved only when the
batch is verified locally, so a process without a card can use a
device server. A request whose flush raised on the server (a kernel
build, launch or canary error on the card) is answered FLUSH_FAILED
(`protocol.encode_flush_failed`): `DeviceFuture.result`, `verify` and
`RemoteBatchVerifier.verify` raise `DeviceFlushFailed` and do not verify
the batch locally in its place, where the JAX package's client reads
the failure as UNPROCESSABLE and verifies locally. The native C client
(`device/native.py`, `devclient.cc`) is not ported yet (ROADMAP.md
Queue 1).
"""

from __future__ import annotations

import itertools
import os
import socket
import threading
from typing import Dict, List, Optional, Tuple

from ..libs.env import env_float
from ..trace.context import ctx_of
from . import health
from .protocol import (decode_response, encode_request, is_flush_failed,
                       recv_frame, send_frame)

ENV_VAR = "COMETBFT_TPU_DEVICE_SERVER"  # host:port

# Per-request deadline = base + per_sig * lanes (env-overridable): a
# 64-lane consensus commit should fail over to local verification in
# seconds, while an 8192-lane blocksync tile gets the headroom a cold
# compile or a busy queue needs. The old fixed 60s punished both.
ENV_DEADLINE_BASE = "COMETBFT_TPU_DEVICE_DEADLINE_BASE"
ENV_DEADLINE_PER_SIG = "COMETBFT_TPU_DEVICE_DEADLINE_PER_SIG"
DEFAULT_DEADLINE_BASE_S = 20.0
DEFAULT_DEADLINE_PER_SIG_S = 0.005


def deadline_for(n_lanes: int) -> float:
    """Batch-size-scaled per-request deadline for a device round trip."""
    base = env_float(ENV_DEADLINE_BASE, DEFAULT_DEADLINE_BASE_S)
    per = env_float(ENV_DEADLINE_PER_SIG, DEFAULT_DEADLINE_PER_SIG_S)
    return base + per * max(0, n_lanes)


class DeviceUnprocessable(Exception):
    """The server could not run this batch (oversized message / too
    many lanes) — distinct from per-lane verification failure so the
    caller verifies locally instead of blaming signatures."""


class DeviceFlushFailed(health.DeviceFault):
    """The server's flush of this batch raised: its kernels failed on
    the card. Raised to the caller, never answered by a local verify."""


class DeviceFuture:
    """Handle for an in-flight submit(): the non-blocking seam the
    verification pipeline dispatches through (pipeline/scheduler
    overlaps tile N's device round trip with tile N+1's host marshal)."""

    def __init__(self, client: "DeviceClient", req_id: int, n_lanes: int):
        self._client = client
        self._req_id = req_id
        self._n = n_lanes
        self._ev = threading.Event()

    def done(self) -> bool:
        return self._ev.is_set()

    def cancel(self) -> None:
        """Abandon this request: nothing will wait for the answer, so
        drop the pending entry (the recv routine then discards the late
        response) and any already-stored result. Callers that drop
        in-flight dispatches (pipeline drain on a bad block) MUST
        cancel, or verdict lists accumulate in the shared client's
        _results for the life of the process."""
        c = self._client
        with c._wlock:
            c._pending.pop(self._req_id, None)
            c._results.pop(self._req_id, None)

    def result(self, timeout: Optional[float] = None
               ) -> Tuple[bool, List[bool]]:
        """(batch_ok, per-lane oks); default timeout scales with the
        batch size. Raises TimeoutError on deadline, ConnectionError on
        a dead link, DeviceFlushFailed when the server's flush raised,
        DeviceUnprocessable on a lane-count mismatch."""
        c = self._client
        if timeout is None:
            timeout = deadline_for(self._n)
        if not self._ev.wait(timeout):
            with c._wlock:
                c._pending.pop(self._req_id, None)
                # the answer may have landed between the wait expiring
                # and this lock: drop it too, nobody will collect it
                c._results.pop(self._req_id, None)
            raise TimeoutError("device server did not answer")
        with c._wlock:
            if self._req_id not in c._results:
                raise ConnectionError(f"device link down: {c._dead}")
            answer = c._results.pop(self._req_id)
        if answer is None:
            raise DeviceFlushFailed(
                f"the device server's flush of {self._n} lanes failed")
        batch_ok, oks = answer
        if len(oks) != self._n:
            raise DeviceUnprocessable(
                f"server answered {len(oks)} lanes for {self._n}")
        return batch_ok, oks


class DeviceClient:
    """Thread-safe: concurrent verify() calls multiplex one socket by
    req_id (the MConnection-pattern request/response matching SURVEY
    §5.8 calls for on the verify-offload queue)."""

    def __init__(self, host: str, port: int, timeout: float = 60.0):
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout)
        # timeout above is for CONNECT only; the socket must then block
        # indefinitely on RECV — the receive thread idles between
        # batches and a lingering recv timeout would mark the link dead
        # when merely quiet (per-request deadlines live in verify()).
        # SENDS stay bounded via SO_SNDTIMEO: a wedged server that
        # stops reading must not park sendall under _wlock forever
        # (that would block every verify() caller and defeat the local
        # fallback).
        self._sock.settimeout(None)
        import struct as _struct
        self._sock.setsockopt(
            socket.SOL_SOCKET, socket.SO_SNDTIMEO,
            _struct.pack("ll", 20, 0))
        self._wlock = threading.Lock()
        self._pending: Dict[int, threading.Event] = {}
        # None: the server's flush of that request failed
        self._results: Dict[int, Optional[Tuple[bool, List[bool]]]] = {}
        self._ids = itertools.count(1)
        self._dead: Optional[Exception] = None
        threading.Thread(target=self._recv_routine, daemon=True).start()

    def _recv_routine(self) -> None:
        try:
            while True:
                payload = recv_frame(self._sock)
                req_id, batch_ok, oks = decode_response(payload)
                answer = (None if is_flush_failed(payload)
                          else (batch_ok, oks))
                with self._wlock:
                    ev = self._pending.pop(req_id, None)
                    if ev is not None:  # drop answers nobody awaits
                        self._results[req_id] = answer
                if ev is not None:
                    ev.set()
        except (ConnectionError, OSError, ValueError) as e:
            with self._wlock:
                self._dead = e
                for ev in self._pending.values():
                    ev.set()
                self._pending.clear()

    def submit(self, pubs: List[bytes], msgs: List[bytes],
               sigs: List[bytes], ctx=None) -> DeviceFuture:
        """Non-blocking dispatch: frame the batch onto the wire and
        return a future the receive thread resolves — the seam the
        verification pipeline keeps K tiles in flight through. `ctx`
        (a trace Span/TraceContext) rides the request as the
        backward-compatible trace trailer; None sends the v1 bytes."""
        if not pubs:
            raise ValueError("empty batch")
        tctx = ctx_of(ctx)
        trailer = tctx.to_wire() if tctx is not None else None
        req_id = next(self._ids)
        with self._wlock:
            # check the link BEFORE minting the future: a future that
            # exists when the refusal raises is an orphan nothing can
            # ever resolve
            if self._dead is not None:
                raise ConnectionError(f"device link down: {self._dead}")
            fut = DeviceFuture(self, req_id, len(pubs))
            self._pending[req_id] = fut._ev
            try:
                send_frame(self._sock, encode_request(req_id, pubs,
                                                      msgs, sigs,
                                                      trace=trailer))
            except OSError as e:
                # a timed-out/failed send may have written a PARTIAL
                # frame — the stream is desynchronized; kill the link
                # so shared_client() reconnects instead of stacking
                # frames onto garbage. Closing the socket wakes the
                # recv routine, which fails every OTHER in-flight
                # waiter immediately (they'd otherwise sit out their
                # full timeouts on responses that can never parse).
                self._dead = e
                self._pending.pop(req_id, None)
                try:
                    self._sock.close()
                except OSError:
                    pass
                raise ConnectionError(f"device send failed: {e}") from e
        return fut

    def verify(self, pubs: List[bytes], msgs: List[bytes],
               sigs: List[bytes], timeout: Optional[float] = None
               ) -> Tuple[bool, List[bool]]:
        """Blocking submit + wait. The deadline bounds a WEDGED server
        (kernels are pre-warmed at server start, so a healthy device
        flush is milliseconds; the margin accommodates CPU-backed test
        servers) — callers like RemoteBatchVerifier then degrade to
        local verification rather than stalling the consensus verify
        path forever. Default: batch-size-scaled `deadline_for`."""
        if not pubs:
            return False, []
        return self.submit(pubs, msgs, sigs).result(timeout)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


_shared: Optional[DeviceClient] = None
_shared_lock = threading.Lock()


def shared_client() -> Optional[DeviceClient]:
    """Process-wide client to the address in COMETBFT_TPU_DEVICE_SERVER
    (one socket per process; the server coalesces across processes).
    A dead link is dropped so the next call can reconnect; connect uses
    a short timeout — an unreachable server must not stall the
    consensus-path caller, which falls back to in-process verification.

    Reconnects are supervisor-driven (device/health.py): a quarantined
    device never reconnects, and repeated connect failures ride the
    supervisor's jittered exponential backoff instead of paying the
    connect timeout on every verify call."""
    global _shared
    addr = os.environ.get(ENV_VAR, "")
    if not addr:
        return None
    sup = health.shared_supervisor()
    with _shared_lock:
        if sup.quarantined():
            # corrupt verdicts: no caller may use the device, and the
            # open socket (plus its recv thread) to the condemned
            # server is torn down so nothing can submit to it again
            if _shared is not None:
                _shared.close()
                _shared = None
            return None
        if _shared is not None and _shared._dead is not None:
            _shared.close()
            _shared = None
        if _shared is None:
            if not sup.allow_connect():
                return None
            host, _, port = addr.rpartition(":")
            try:
                _shared = DeviceClient(host or "127.0.0.1", int(port),
                                       timeout=2.0)
            except ValueError:
                return None
            except OSError as e:
                # backoff: the NEXT caller skips the connect attempt
                # until the supervisor's half-open window elapses
                sup.report_trip(e)
                return None
        return _shared


class RemoteBatchVerifier:
    """crypto.BatchVerifier backed by the device server, with an
    in-process fallback: a dead/slow/unwilling server degrades to local
    verification — it must never surface transport errors (or worse,
    false signature verdicts) into commit/vote verification.

    False verdicts are the supervisor's canary-lane job: every device
    batch carries a known-good + known-bad signature pair (stripped
    from the results); a canary mismatch quarantines the device for the
    process and THIS batch verifies locally — a corrupt verdict can
    never reach a commit decision through this seam.

    A flush that failed on the server (`DeviceFlushFailed`: its kernels
    raised) is not degraded to a local verify: it propagates."""

    def __init__(self, client: DeviceClient, supervisor=None,
                 batch_size: Optional[int] = None, device=None):
        self._client = client
        self._supervisor = supervisor  # None → shared_supervisor()
        self._batch_size = batch_size  # of the local verifier
        self._device = device          # of the local verifier
        self._pubs: List[bytes] = []
        self._msgs: List[bytes] = []
        self._sigs: List[bytes] = []

    def __len__(self) -> int:
        return len(self._pubs)

    def add(self, pk, msg: bytes, sig: bytes) -> None:
        self._pubs.append(pk.bytes_())
        self._msgs.append(msg)
        self._sigs.append(sig)

    def _local(self) -> Tuple[bool, List[bool]]:
        from ..crypto.keys import Ed25519BatchVerifier, Ed25519PubKey
        bv = Ed25519BatchVerifier(batch_size=self._batch_size,
                                  device=self._device)
        for p, m, s in zip(self._pubs, self._msgs, self._sigs):
            bv.add(Ed25519PubKey(p), m, s)
        return bv.verify()

    def verify(self) -> Tuple[bool, List[bool]]:
        if not self._pubs:
            return False, []
        sup = self._supervisor or health.shared_supervisor()
        granted = False  # a reconnect already claimed this attempt
        for attempt in (0, 1):
            if not granted and not sup.allow_connect():
                # quarantined (a device that lied once is never asked
                # again), or SUSPECT inside its backoff window: while
                # half-open, only the elapsed-window attempt may reach
                # the device — every other consensus-path batch goes
                # straight local instead of paying the full scaled
                # deadline against a known-suspect server
                break
            granted = False
            pubs, msgs, sigs = self._pubs, self._msgs, self._sigs
            canaried = sup.canary
            if canaried:
                pubs, msgs, sigs = health.splice_canaries(pubs, msgs,
                                                          sigs)
            try:
                batch_ok, oks = self._client.verify(pubs, msgs, sigs)
            except DeviceUnprocessable:
                break  # a retry cannot shrink the batch: go local now
            except TimeoutError as e:
                # the server is wedged but the socket is up: a second
                # attempt would hit the same wedge and DOUBLE the
                # consensus-path stall this deadline exists to bound
                sup.report_trip(e)
                break
            except (ConnectionError, OSError) as e:
                sup.report_trip(e)
                if attempt:
                    break
                # one retry before abandoning the device, riding the
                # FRESH reconnect: shared_client() drops dead links,
                # honors the supervisor's half-open window (the first
                # trip allows one immediate attempt), and an
                # unreachable server fails the connect fast
                fresh = shared_client()
                if fresh is not None:
                    self._client = fresh
                    # the reconnect's allow_connect claimed the
                    # half-open window; this retry IS that attempt
                    granted = True
                continue
            if canaried:
                ok, oks = health.check_canaries(oks, len(self._pubs))
                if not ok:
                    sup.report_corruption("batch canary mismatch")
                    break  # local re-verify below: verdicts untrusted
                # the server's batch_ok covered the known-bad canary;
                # recompute over the real lanes — this return is
                # verdict-verified, so it carries NO taint pragma: a
                # regression in the gating above becomes a lint error
                batch_ok = bool(oks) and all(oks)
                sup.report_success()
                return batch_ok, oks
            # no canaries: the operator opted out of verdict checks
            # (COMETBFT_TPU_DEVICE_CANARY=0) and a completed round
            # trip still clears a transport-level SUSPECT — the
            # un-gated verdict is that opt-out's explicit contract
            sup.report_success()
            # staticcheck: allow(verdict-taint)
            return batch_ok, oks
        return self._local()
