"""Wire protocol for the verify device server (the host↔device boundary
named by SURVEY §5.8 / §7 step 2: a persistent process owns the device;
engines — including non-Python ones via the C shim — submit signature
tiles over a local socket; reference analog: the cgo/gRPC bridge that
would front curve25519-voi if it lived out-of-process).

Framing: every message is u32le length || payload.

Request payload:
    req_id  u64le
    n       u32le
    n × record: pub(32) | sig(64) | msg_len u32le | msg
    [trace_id u64le | span_id u64le]      (optional trailer) bytes

Response payload:
    req_id   u64le
    batch_ok u8       (1 iff every lane verified)
    n        u32le
    n × u8 per-lane validity
    [n × u8 per-lane shard attribution]   (optional trailer)

The attribution trailer is how a MESH-owning server (mesh/executor.py)
reports WHICH shard verified each lane (0xFF = the trusted CPU
re-verify path after a shard canary failure). It is backward
compatible by construction: v1 `decode_response` reads exactly n
verdict bytes and ignores a trailer, so old clients keep working
against a mesh server, and `decode_response_shards` returns None for
a single-chip server that sends no trailer.

The request-side TRACE trailer follows the same stance in the other
direction: a tracing-enabled client appends its flight-recorder
context (trace/context.TraceContext.to_wire — two u64le ids) after the
last lane record, so the server's flush spans can link back to the
submitting node's causal chain. It is appended ONLY when tracing is on
(default wire bytes are unchanged), and the v2 `decode_request`
accepts both forms; `decode_request_trace` returns None for a v1
request.

The protocol is deliberately dumb-binary (no proto/JSON): a C caller
can marshal it with memcpy, and the server's hot loop does one pass of
struct unpacking per tile.

Copy of `cometbft_tpu/device/protocol.py` (the port keeps its own). The
wire is the JAX package's byte for byte, trailers included, so a client
of either package talks to a server of either. What the port adds: a
server whose flush raised answers each of its requests with `batch_ok`
= FLUSH_FAILED (2) and zero lanes (`encode_flush_failed`), where the JAX
package's server sends the UNPROCESSABLE form (0, zero lanes). The
port's client reads it with `is_flush_failed` and raises; a JAX package
client reads a zero-lane answer to a nonzero request, as it does for
UNPROCESSABLE.
"""

from __future__ import annotations

import socket
import struct
from typing import List, Optional, Tuple


def send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(struct.pack("<I", len(payload)) + payload)


def recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        got = sock.recv(n - len(buf))
        if not got:
            raise ConnectionError("peer closed")
        buf += got
    return buf


def recv_frame(sock: socket.socket, max_len: int = 64 << 20) -> bytes:
    (ln,) = struct.unpack("<I", recv_exact(sock, 4))
    if ln > max_len:
        raise ConnectionError(f"frame {ln} exceeds cap {max_len}")
    return recv_exact(sock, ln)


TRACE_TRAILER_LEN = 16  # trace/context.TraceContext wire form (2×u64le)


def encode_request(req_id: int, pubs: List[bytes], msgs: List[bytes],
                   sigs: List[bytes],
                   trace: Optional[bytes] = None) -> bytes:
    parts = [struct.pack("<QI", req_id, len(pubs))]
    for p, m, s in zip(pubs, msgs, sigs):
        if len(p) != 32 or len(s) != 64:
            raise ValueError("pub must be 32 bytes, sig 64")
        parts.append(p)
        parts.append(s)
        parts.append(struct.pack("<I", len(m)))
        parts.append(m)
    if trace is not None:
        if len(trace) != TRACE_TRAILER_LEN:
            raise ValueError(
                f"trace trailer must be {TRACE_TRAILER_LEN} bytes")
        parts.append(trace)
    return b"".join(parts)


def _walk_request(payload: bytes
                  ) -> Tuple[int, List[bytes], List[bytes], List[bytes],
                             int]:
    """One pass over the lane records; returns the parse plus the
    offset where the records end (trailer detection)."""
    try:
        req_id, n = struct.unpack_from("<QI", payload, 0)
        off = 12
        pubs, msgs, sigs = [], [], []
        for _ in range(n):
            pubs.append(payload[off:off + 32])
            sigs.append(payload[off + 32:off + 96])
            (mlen,) = struct.unpack_from("<I", payload, off + 96)
            off += 100
            msgs.append(payload[off:off + mlen])
            off += mlen
    except struct.error as e:  # truncated header OR truncated record
        raise ValueError(f"malformed verify request: {e}") from e
    if (len(payload) - off not in (0, TRACE_TRAILER_LEN)
            or any(len(p) != 32 for p in pubs)):
        raise ValueError("malformed verify request")
    return req_id, pubs, msgs, sigs, off


def decode_request(payload: bytes
                   ) -> Tuple[int, List[bytes], List[bytes], List[bytes]]:
    req_id, pubs, msgs, sigs, _off = _walk_request(payload)
    return req_id, pubs, msgs, sigs


def decode_request_trace(payload: bytes) -> Optional[Tuple[int, int]]:
    """The (trace_id, span_id) trailer, or None for a v1 request that
    carries none (the caller already validated the frame through
    decode_request / _walk_request; garbage still raises the same
    ValueError)."""
    _req_id, _pubs, _msgs, _sigs, off = _walk_request(payload)
    tail = payload[off:]
    if not tail:
        return None
    trace_id, span_id = struct.unpack("<QQ", tail)
    return trace_id, span_id


CPU_SHARD = 0xFF  # attribution sentinel: verdict from CPU re-verify
FLUSH_FAILED = 2  # batch_ok of a zero-lane answer: the flush raised


def encode_flush_failed(req_id: int) -> bytes:
    """The answer to a request whose flush raised on the server."""
    return struct.pack("<QBI", req_id, FLUSH_FAILED, 0)


def is_flush_failed(payload: bytes) -> bool:
    """Is this response `encode_flush_failed`'s form?"""
    return (len(payload) == 13 and payload[8] == FLUSH_FAILED
            and struct.unpack_from("<I", payload, 9)[0] == 0)


def encode_response(req_id: int, batch_ok: bool, oks: List[bool],
                    shards: Optional[List[int]] = None) -> bytes:
    out = (struct.pack("<QBI", req_id, 1 if batch_ok else 0, len(oks))
           + bytes(1 if v else 0 for v in oks))
    if shards is not None:
        if len(shards) != len(oks):
            raise ValueError("shard attribution length mismatch")
        if any(not 0 <= s <= CPU_SHARD for s in shards):
            # a shard id past the u8 range must fail loudly: clamping
            # would alias real shards onto the CPU_SHARD sentinel and
            # silently corrupt the attribution this trailer exists for
            raise ValueError("shard id out of u8 attribution range")
        out += bytes(shards)
    return out


def decode_response(payload: bytes) -> Tuple[int, bool, List[bool]]:
    try:
        req_id, batch_ok, n = struct.unpack_from("<QBI", payload, 0)
    except struct.error as e:
        raise ValueError(f"short response header: {e}") from e
    body = payload[13:13 + n]
    if len(body) != n:
        raise ValueError("malformed verify response")
    return req_id, bool(batch_ok), [b == 1 for b in body]


def decode_response_shards(payload: bytes) -> Optional[List[int]]:
    """The per-lane shard attribution trailer, or None when the server
    sent a v1 (single-chip) response. A trailer of the wrong length is
    malformed — attribution misaligned with verdicts is worse than
    absent."""
    try:
        _req_id, _batch_ok, n = struct.unpack_from("<QBI", payload, 0)
    except struct.error as e:
        raise ValueError(f"short response header: {e}") from e
    tail = payload[13 + n:]
    if not tail:
        return None
    if len(tail) != n:
        raise ValueError("malformed shard attribution trailer")
    return list(tail)
