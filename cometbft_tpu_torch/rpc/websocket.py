"""Minimal RFC 6455 WebSocket endpoint for event subscriptions
(reference rpc/jsonrpc/server/ws_handler.go:41, rpc/core/events.go).

Protocol over the socket: JSON-RPC frames, methods `subscribe`
{"query": ...} / `unsubscribe` / `unsubscribe_all`; matching events are
pushed as {"jsonrpc":"2.0","method":"event","params":{...}} frames —
the reference's subscription push shape.

Copy of `cometbft_tpu/rpc/websocket.py` in the port: the same handshake,
the same frames and the same JSON, byte for byte. What differs:
- a session clears its connection's read timeout (`[rpc] timeout_ms`,
  meant for one HTTP request): the JAX package's session inherits it and
  drops a subscriber that sends nothing for that long, though events
  still flow to it;
- `serve_websocket` takes the server's `Sessions`, so `RPCServer.stop()`
  closes every live session, and a session joins its pump threads before
  it returns;
- `WSClient`, a client of the endpoint (the reference's
  rpc/jsonrpc/client/ws_client.go, its upgrade and framing only), which
  the JAX module lacks.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import socket
import struct
import threading
from typing import Dict, List, Optional

from ..pubsub.query import Query, QueryError

_WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


def is_websocket_upgrade(headers) -> bool:
    return (headers.get("Upgrade", "").lower() == "websocket"
            and "upgrade" in headers.get("Connection", "").lower())


def accept_key(client_key: str) -> str:
    return base64.b64encode(hashlib.sha1(
        (client_key + _WS_MAGIC).encode()).digest()).decode()


def _encode_frame(payload: bytes, opcode: int = 1) -> bytes:
    """Server frame (no masking), FIN set."""
    head = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        head += bytes([n])
    elif n < (1 << 16):
        head += bytes([126]) + struct.pack(">H", n)
    else:
        head += bytes([127]) + struct.pack(">Q", n)
    return head + payload


MAX_FRAME_BYTES = 1 << 20  # reference ws server enforces a ReadLimit


class _FrameReader:
    def __init__(self, rfile):
        self._r = rfile
        self._fragments: Optional[bytes] = None

    def _exact(self, n: int) -> Optional[bytes]:
        b = self._r.read(n)
        return b if len(b) == n else None

    def read_message(self):
        """-> (opcode, payload) for a COMPLETE message (continuation
        frames reassembled), or None on EOF/close/oversize/garbage."""
        while True:
            hdr = self._exact(2)
            if hdr is None:
                return None
            fin = hdr[0] & 0x80
            opcode = hdr[0] & 0x0F
            masked = hdr[1] & 0x80
            n = hdr[1] & 0x7F
            if n == 126:
                raw = self._exact(2)
                if raw is None:
                    return None
                n = struct.unpack(">H", raw)[0]
            elif n == 127:
                raw = self._exact(8)
                if raw is None:
                    return None
                n = struct.unpack(">Q", raw)[0]
            if n > MAX_FRAME_BYTES:
                return None  # drop the connection: refuse to buffer
            mask = self._exact(4) if masked else b"\x00" * 4
            if mask is None:
                return None
            data = self._exact(n)
            if data is None:
                return None
            if masked:
                data = bytes(b ^ mask[i % 4] for i, b in enumerate(data))
            if opcode == 8:  # close
                return None
            if opcode == 0:  # continuation
                if self._fragments is None:
                    return None  # stray continuation: protocol error
                self._fragments += data
                if len(self._fragments) > MAX_FRAME_BYTES:
                    return None
                if fin:
                    out, self._fragments = self._fragments, None
                    return 1, out
                continue
            if not fin:
                self._fragments = data
                continue
            return opcode, data


class Sessions:
    """The live WebSocket sessions of one server: `close_all` ends each
    (its socket shut down, so its blocked read returns), joins the
    thread serving it, and refuses new ones."""

    def __init__(self):
        self._lock = threading.Lock()
        self._live: Dict[int, tuple] = {}
        self._closed = False

    def add(self, key: int, conn, stop: threading.Event) -> bool:
        with self._lock:
            if self._closed:
                return False
            self._live[key] = (conn, stop, threading.current_thread())
            return True

    def remove(self, key: int) -> None:
        with self._lock:
            self._live.pop(key, None)

    def close_all(self) -> None:
        import socket
        with self._lock:
            self._closed = True
            live = list(self._live.values())
        for conn, stop, _thread in live:
            stop.set()
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for _conn, _stop, thread in live:
            thread.join(timeout=5)


def serve_websocket(handler, event_bus, sessions: Sessions) -> None:
    """Run the subscription session on an http.server handler that
    received an Upgrade request. Blocks until the client goes away, or
    until `sessions.close_all()`."""
    key = handler.headers.get("Sec-WebSocket-Key", "")
    handler.send_response(101, "Switching Protocols")
    handler.send_header("Upgrade", "websocket")
    handler.send_header("Connection", "Upgrade")
    handler.send_header("Sec-WebSocket-Accept", accept_key(key))
    handler.end_headers()

    wfile = handler.wfile
    write_lock = threading.Lock()
    subscriber = f"ws-{id(handler)}"
    stop = threading.Event()
    subs: Dict[str, object] = {}
    pumps: List[threading.Thread] = []
    # a subscriber may stay silent while events flow: no read deadline
    handler.connection.settimeout(None)
    if not sessions.add(id(handler), handler.connection, stop):
        return  # the server is stopping

    def push(payload: dict) -> None:
        raw = _encode_frame(json.dumps(payload).encode())
        with write_lock:
            wfile.write(raw)
            wfile.flush()

    def pump(query_raw: str, sub) -> None:
        while not stop.is_set() and not sub.cancelled:
            got = sub.next(timeout=0.2)
            if got is None:
                continue
            event, attrs = got
            try:
                push({"jsonrpc": "2.0", "method": "event",
                      "params": {"query": query_raw, "kind": event.kind,
                                 "attrs": attrs}})
            except (OSError, ValueError):
                # ValueError: http.server closed wfile under us
                return

    reader = _FrameReader(handler.rfile)
    try:
        while not stop.is_set():
            frame = reader.read_message()
            if frame is None:
                break
            opcode, data = frame
            if opcode == 9:  # ping
                with write_lock:
                    wfile.write(_encode_frame(data, opcode=10))
                    wfile.flush()
                continue
            if opcode != 1:
                continue
            try:
                req = json.loads(data)
            except json.JSONDecodeError:
                push({"jsonrpc": "2.0", "id": None,
                      "error": {"code": -32700, "message": "parse error"}})
                continue
            rid = req.get("id")
            method = req.get("method", "")
            params = req.get("params") or {}
            if method == "subscribe":
                try:
                    q = Query(params.get("query", ""))
                except QueryError as e:
                    push({"jsonrpc": "2.0", "id": rid,
                          "error": {"code": -32602, "message": str(e)}})
                    continue
                if q.raw in subs:
                    push({"jsonrpc": "2.0", "id": rid,
                          "error": {"code": -32603,
                                    "message": "already subscribed"}})
                    continue
                sub = event_bus.server.subscribe(subscriber, q,
                                                 buffer=1000)
                subs[q.raw] = sub
                t = threading.Thread(target=pump, args=(q.raw, sub),
                                     name="ws-pump", daemon=True)
                pumps.append(t)
                t.start()
                push({"jsonrpc": "2.0", "id": rid, "result": {}})
            elif method == "unsubscribe":
                qraw = params.get("query", "")
                sub = subs.pop(qraw, None)
                if sub is not None:
                    event_bus.server.unsubscribe(subscriber, Query(qraw))
                push({"jsonrpc": "2.0", "id": rid, "result": {}})
            elif method == "unsubscribe_all":
                event_bus.unsubscribe_all(subscriber)
                subs.clear()
                push({"jsonrpc": "2.0", "id": rid, "result": {}})
            else:
                push({"jsonrpc": "2.0", "id": rid,
                      "error": {"code": -32601,
                                "message": f"unknown method {method}"}})
    except (OSError, ConnectionError, ValueError):
        pass
    finally:
        stop.set()
        event_bus.unsubscribe_all(subscriber)
        for t in pumps:
            t.join(timeout=5)
        sessions.remove(id(handler))


def frame_payload(frame: bytes) -> bytes:
    """The payload of one unmasked frame, header included in `frame`."""
    n = frame[1] & 0x7F
    return frame[2 + {126: 2, 127: 8}.get(n, 0):]


class WSClient:
    """A client of GET /websocket. The upgrade is sent at construction
    and its answer read by `handshake`, so frames may be sent before the
    server serves; `send` masks one frame, `frame` reads one server frame
    as received (header and payload)."""

    def __init__(self, addr, timeout: float = 10.0,
                 key: Optional[bytes] = None):
        self.sock = socket.create_connection(addr, timeout=timeout)
        key64 = base64.b64encode(key or os.urandom(16)).decode()
        self.sock.sendall((f"GET /websocket HTTP/1.1\r\n"
                           f"Host: {addr[0]}:{addr[1]}\r\n"
                           f"Upgrade: websocket\r\nConnection: Upgrade\r\n"
                           f"Sec-WebSocket-Key: {key64}\r\n"
                           f"Sec-WebSocket-Version: 13\r\n\r\n").encode())

    def _exact(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = self.sock.recv(n - len(out))
            if not chunk:
                raise ConnectionError("closed")
            out += chunk
        return out

    def handshake(self) -> bytes:
        """The server's answer to the upgrade; raises unless it is 101."""
        head = b""
        while b"\r\n\r\n" not in head:
            head += self._exact(1)
        status = head.split(b"\r\n", 1)[0]
        if b" 101 " not in status:
            raise ConnectionError(status.decode(errors="replace"))
        return head

    def send(self, payload: bytes, opcode: int = 1) -> None:
        n = len(payload)
        if n < 126:
            head = bytes([0x80 | opcode, 0x80 | n])
        elif n < (1 << 16):
            head = bytes([0x80 | opcode, 0x80 | 126]) + struct.pack(">H", n)
        else:
            head = bytes([0x80 | opcode, 0x80 | 127]) + struct.pack(">Q", n)
        mask = os.urandom(4)
        self.sock.sendall(head + mask + bytes(
            b ^ mask[i % 4] for i, b in enumerate(payload)))

    def frame(self) -> bytes:
        head = self._exact(2)
        n = head[1] & 0x7F
        ext = b""
        if n >= 126:
            ext = self._exact(2 if n == 126 else 8)
            n = int.from_bytes(ext, "big")
        return head + ext + self._exact(n)

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()
