"""MConnection: priority-multiplexed logical channels over one secret
connection (reference p2p/conn/connection.go:81-751).

Shape preserved from the reference:
- per-channel send queues with priorities; the send routine repeatedly
  picks the channel with the least (recently-sent / priority) ratio
  (connection.go:470 sendPacketMsg "least ratio" scheduling),
- messages chunked into packets (channel id, eof flag, data) so a large
  block part cannot starve votes (connection.go:740 maxPacketMsgSize),
- ping/pong keepalive,
- a recv routine reassembling packets per channel and dispatching
  complete messages to the registered handler.

This is also the pattern the verify-offload queue reuses host-side: the
TPU flush queue is a prioritized channel like any other (SURVEY §5.8).

Copy of `cometbft_tpu/p2p/mconn.py` (the port keeps its own).
"""

from __future__ import annotations

import queue
import struct
import threading
import time
from dataclasses import dataclass, field as dc_field
from typing import Callable, Dict, List, Optional

from ..libs.env import env_float
from ..types import proto

MAX_PACKET_PAYLOAD = 1400          # connection.go defaultMaxPacketMsgPayloadSize
# malformed overrides fall back to the defaults (libs/env.py) — a typo
# in a systemd unit must not crash every node at import time
PING_INTERVAL = env_float(
    "COMETBFT_TPU_P2P_PING_INTERVAL_S", 10.0, minimum=0.0)
# a peer that stops answering pings is dead/partitioned — tear the
# connection down so the switch can ban/redial (reference
# connection.go:78 defaultPongTimeout=45s, scaled to our 10s pings).
# Env-overridable so e2e perturbation tests can shrink the window.
PONG_TIMEOUT = env_float(
    "COMETBFT_TPU_P2P_PONG_TIMEOUT_S", 30.0, minimum=0.0)
DEFAULT_SEND_RATE = 5_120_000      # bytes/s, connection.go:725 SendRate
DEFAULT_RECV_RATE = 5_120_000      # connection.go:726 RecvRate

# e2e latency emulation (reference test/e2e/runner/perturb.go's docker
# tc-netem analog): every outbound packet sleeps this long first. Test
# knob only; 0/unset in production.
_SEND_LATENCY_S = env_float(
    "COMETBFT_TPU_P2P_LATENCY_MS", 0.0, minimum=0.0) / 1e3
_PKT_PING = 1
_PKT_PONG = 2
_PKT_MSG = 3


class _RateMonitor:
    """Token-bucket throttle (the role internal/flowrate plays for
    MConnection's sendMonitor/recvMonitor, connection.go:429,567):
    `limit(n)` sleeps just enough to keep the moving average at the
    configured bytes/s."""

    def __init__(self, rate: int, burst_s: float = 0.1):
        self.rate = max(int(rate), 1)
        self._allow = self.rate * burst_s  # start with one burst budget
        self._burst = self.rate * burst_s
        self._last = time.monotonic()

    def limit(self, n: int) -> None:
        now = time.monotonic()
        self._allow = min(self._allow + (now - self._last) * self.rate,
                          self._burst)
        self._last = now
        self._allow -= n
        if self._allow < 0:
            time.sleep(-self._allow / self.rate)


@dataclass
class ChannelDescriptor:
    """reference p2p/conn/connection.go:729-741 ChannelDescriptor."""
    id: int
    priority: int = 1
    send_queue_capacity: int = 100
    recv_message_capacity: int = 22 * 1024 * 1024


class _Channel:
    def __init__(self, desc: ChannelDescriptor):
        self.desc = desc
        self.queue: "queue.Queue[bytes]" = queue.Queue(
            desc.send_queue_capacity)
        self.sending: Optional[bytes] = None
        self.sent_pos = 0
        self.recently_sent = 0
        self.recv_parts: List[bytes] = []
        self.recv_size = 0

    def next_packet(self) -> Optional[bytes]:
        """Pop up to MAX_PACKET_PAYLOAD of the in-flight message."""
        if self.sending is None:
            try:
                self.sending = self.queue.get_nowait()
            except queue.Empty:
                return None
            self.sent_pos = 0
        chunk = self.sending[self.sent_pos:self.sent_pos
                             + MAX_PACKET_PAYLOAD]
        self.sent_pos += len(chunk)
        eof = self.sent_pos >= len(self.sending)
        if eof:
            self.sending = None
        self.recently_sent += len(chunk) + 16
        return (bytes([_PKT_MSG])
                + proto.f_varint(1, self.desc.id)
                + proto.f_varint(2, 1 if eof else 0)
                + proto.f_bytes(3, chunk))

    def has_data(self) -> bool:
        return self.sending is not None or not self.queue.empty()


class MConnection:
    """reference p2p/conn/connection.go MConnection."""

    def __init__(self, conn, descs: List[ChannelDescriptor],
                 on_receive: Callable[[int, bytes], None],
                 on_error: Optional[Callable[[Exception], None]] = None,
                 send_rate: int = DEFAULT_SEND_RATE,
                 recv_rate: int = DEFAULT_RECV_RATE):
        self._conn = conn
        self._send_monitor = _RateMonitor(send_rate)
        self._recv_monitor = _RateMonitor(recv_rate)
        self._channels: Dict[int, _Channel] = {
            d.id: _Channel(d) for d in descs}
        self._on_receive = on_receive
        self._on_error = on_error or (lambda e: None)
        self._send_wake = threading.Event()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        # pong deadline: set when a ping goes out, cleared by the pong
        self._pong_deadline: Optional[float] = None

    def start(self) -> None:
        for fn, name in ((self._send_routine, "send"),
                         (self._recv_routine, "recv")):
            t = threading.Thread(target=fn, name=f"mconn-{name}",
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        self._send_wake.set()
        self._conn.close()

    def send(self, channel_id: int, msg: bytes, block: bool = True) -> bool:
        """Queue a message (reference connection.go:380 Send /
        TrySend with block=False)."""
        ch = self._channels.get(channel_id)
        if ch is None:
            raise ValueError(f"unknown channel {channel_id:#x}")
        try:
            ch.queue.put(msg, block=block, timeout=10 if block else None)
        except queue.Full:
            return False
        self._send_wake.set()
        return True

    # --- routines -------------------------------------------------------------

    def _pick_channel(self) -> Optional[_Channel]:
        """Least recently-sent/priority ratio (connection.go:470)."""
        best, best_ratio = None, None
        for ch in self._channels.values():
            if not ch.has_data():
                continue
            ratio = ch.recently_sent / max(ch.desc.priority, 1)
            if best_ratio is None or ratio < best_ratio:
                best, best_ratio = ch, ratio
        return best

    def _send_routine(self) -> None:
        last_ping = time.monotonic()
        try:
            while not self._stop.is_set():
                # snapshot: the recv routine clears this to None on
                # pong arrival concurrently
                deadline = self._pong_deadline
                if deadline is not None and time.monotonic() > deadline:
                    raise ConnectionError(
                        f"pong timeout ({PONG_TIMEOUT:.0f}s) — peer "
                        f"dead or partitioned")
                ch = self._pick_channel()
                if ch is None:
                    if self._send_wake.wait(timeout=1.0):
                        self._send_wake.clear()
                    if time.monotonic() - last_ping > PING_INTERVAL:
                        self._conn.send_message(bytes([_PKT_PING]))
                        last_ping = time.monotonic()
                        if self._pong_deadline is None:
                            self._pong_deadline = \
                                time.monotonic() + PONG_TIMEOUT
                    continue
                pkt = ch.next_packet()
                if pkt is not None:
                    if _SEND_LATENCY_S > 0:
                        time.sleep(_SEND_LATENCY_S)
                    self._send_monitor.limit(len(pkt))
                    self._conn.send_message(pkt)
                # decay so bursts don't permanently deprioritize
                for c in self._channels.values():
                    c.recently_sent = int(c.recently_sent * 0.8)
        except (ConnectionError, OSError) as e:
            if not self._stop.is_set():
                self._on_error(e)

    def _recv_routine(self) -> None:
        try:
            while not self._stop.is_set():
                raw = self._conn.recv_message()
                if not raw:
                    continue
                # backpressure a flooding peer (recvMonitor,
                # connection.go:567): stop draining faster than the
                # configured rate so TCP pushes back upstream
                self._recv_monitor.limit(len(raw))
                kind = raw[0]
                if kind == _PKT_PING:
                    self._conn.send_message(bytes([_PKT_PONG]))
                    continue
                if kind == _PKT_PONG:
                    self._pong_deadline = None
                    continue
                if kind != _PKT_MSG:
                    raise ConnectionError(f"unknown packet kind {kind}")
                f = proto.parse_fields(raw[1:])
                cid = proto.field_int(f, 1, 0)
                eof = proto.field_int(f, 2, 0)
                data = proto.field_bytes(f, 3, b"")
                ch = self._channels.get(cid)
                if ch is None:
                    raise ConnectionError(f"peer sent unknown channel {cid}")
                ch.recv_size += len(data)
                if ch.recv_size > ch.desc.recv_message_capacity:
                    raise ConnectionError("recv message exceeds capacity")
                ch.recv_parts.append(data)
                if eof:
                    msg = b"".join(ch.recv_parts)
                    ch.recv_parts, ch.recv_size = [], 0
                    self._on_receive(cid, msg)
        except (ConnectionError, OSError) as e:
            if not self._stop.is_set():
                self._on_error(e)
