"""Statesync p2p reactor: snapshot discovery + chunk transfer over the
switch (reference internal/statesync/reactor.go, snapshots/chunks over
SnapshotChannel 0x60 / ChunkChannel 0x61).

Wire (channel 0x60): kind 1 SnapshotsRequest, kind 2 SnapshotsResponse
(repeated embedded snapshots). Channel 0x61: kind 3 ChunkRequest
{height, format, index}, kind 4 ChunkResponse {height, format, index,
chunk, missing}.
`NetSnapshotSource` adapts a connected peer set into the Syncer's
SnapshotSource protocol.

Copy of `cometbft_tpu/statesync/reactor.py` in the port.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

from ..abci.application import Snapshot
from ..p2p.mconn import ChannelDescriptor
from ..types import proto

SNAPSHOT_CHANNEL = 0x60
CHUNK_CHANNEL = 0x61

_SNAP_REQ = 1
_SNAP_RESP = 2
_CHUNK_REQ = 3
_CHUNK_RESP = 4


def _encode_snapshot(s: Snapshot) -> bytes:
    return (proto.f_varint(1, s.height) + proto.f_varint(2, s.format)
            + proto.f_varint(3, s.chunks) + proto.f_bytes(4, s.hash)
            + proto.f_bytes(5, s.metadata))


def _decode_snapshot(b: bytes) -> Snapshot:
    f = proto.parse_fields(b)
    return Snapshot(height=proto.field_int(f, 1, 0),
                    format=proto.field_int(f, 2, 0),
                    chunks=proto.field_int(f, 3, 0),
                    hash=proto.field_bytes(f, 4, b""),
                    metadata=proto.field_bytes(f, 5, b""))


class StatesyncNetReactor:
    """Serves the local app's snapshots and fetches remote ones."""

    def __init__(self, app):
        self.app = app
        self._peers: Dict[str, object] = {}
        self._snapshots: Dict[str, List[Snapshot]] = {}
        # (height, format, index) -> [(serving peer_id, Future)]
        self._pending_chunks: Dict[Tuple[int, int, int],
                                   List[Tuple[str, Future]]] = {}
        # discovery waiters: (future, peer ids still to answer)
        self._snap_waiters: List[Tuple[Future, set]] = []
        self._lock = threading.Lock()

    # --- p2p.Reactor ----------------------------------------------------------

    def get_channels(self) -> List[ChannelDescriptor]:
        return [ChannelDescriptor(id=SNAPSHOT_CHANNEL, priority=3),
                ChannelDescriptor(id=CHUNK_CHANNEL, priority=1,
                                  recv_message_capacity=32 * 1024 * 1024)]

    def add_peer(self, peer) -> None:
        with self._lock:
            self._peers[peer.id] = peer
        peer.try_send(SNAPSHOT_CHANNEL, bytes([_SNAP_REQ]))

    def remove_peer(self, peer, reason: str) -> None:
        with self._lock:
            self._peers.pop(peer.id, None)
            self._snapshots.pop(peer.id, None)
            # fail this peer's in-flight chunk fetches immediately (the
            # syncer re-requests elsewhere) instead of letting callers
            # block out their full timeout, and stop discovery waiting
            # on an answer that will never come
            dead: List[Future] = []
            for key in list(self._pending_chunks):
                rest = []
                for pid, f in self._pending_chunks[key]:
                    (dead if pid == peer.id else rest).append((pid, f))
                if rest:
                    self._pending_chunks[key] = rest
                else:
                    del self._pending_chunks[key]
            done_waiters: List[Future] = []
            for fut, pending in self._snap_waiters:
                pending.discard(peer.id)
                if not pending:
                    done_waiters.append(fut)
            self._snap_waiters = [(f, p) for f, p in self._snap_waiters
                                  if p]
        for _pid, fut in dead:
            if not fut.done():
                fut.set_result(None)
        for fut in done_waiters:
            if not fut.done():
                fut.set_result(True)

    def receive(self, channel_id: int, peer, raw: bytes) -> None:
        if not raw:
            raise ValueError("empty statesync message")
        kind, body = raw[0], raw[1:]
        if kind == _SNAP_REQ:
            snaps = self.app.list_snapshots()
            out = b"".join(proto.f_embed(1, _encode_snapshot(s))
                           for s in snaps[:16])
            peer.try_send(SNAPSHOT_CHANNEL, bytes([_SNAP_RESP]) + out)
        elif kind == _SNAP_RESP:
            f = proto.parse_fields(body)
            snaps = [_decode_snapshot(b)
                     for b in proto.field_all_bytes(f, 1)]
            done_waiters: List[Future] = []
            with self._lock:
                self._snapshots[peer.id] = snaps
                for fut, pending in self._snap_waiters:
                    pending.discard(peer.id)
                    if not pending:
                        done_waiters.append(fut)
                self._snap_waiters = [(f, p) for f, p in
                                      self._snap_waiters if p]
            for fut in done_waiters:
                if not fut.done():
                    fut.set_result(True)
        elif kind == _CHUNK_REQ:
            f = proto.parse_fields(body)
            h = proto.field_int(f, 1, 0)
            fmt = proto.field_int(f, 2, 0)
            idx = proto.field_int(f, 3, 0)
            chunk = self.app.load_snapshot_chunk(h, fmt, idx)
            resp = (proto.f_varint(1, h) + proto.f_varint(2, fmt)
                    + proto.f_varint(3, idx) + proto.f_bytes(4, chunk)
                    + proto.f_varint(5, 0 if chunk else 1))
            peer.try_send(CHUNK_CHANNEL, bytes([_CHUNK_RESP]) + resp)
        elif kind == _CHUNK_RESP:
            f = proto.parse_fields(body)
            key = (proto.field_int(f, 1, 0), proto.field_int(f, 2, 0),
                   proto.field_int(f, 3, 0))
            missing = proto.field_int(f, 5, 0)
            chunk = None if missing else proto.field_bytes(f, 4, b"")
            with self._lock:
                # only resolve futures whose request went to THIS peer —
                # peer A's late (or 'missing') response must not consume
                # a retry already re-issued to peer B
                entry = self._pending_chunks.get(key, [])
                futs = [(p, f) for p, f in entry if p == peer.id]
                rest = [(p, f) for p, f in entry if p != peer.id]
                if rest:
                    self._pending_chunks[key] = rest
                else:
                    self._pending_chunks.pop(key, None)
            for _pid, fut in futs:
                if not fut.done():
                    fut.set_result(chunk)
        else:
            raise ValueError(f"unknown statesync message kind {kind}")

    # --- client API -----------------------------------------------------------

    def discover_snapshots(self, timeout: float = 5.0
                           ) -> List[Tuple[Snapshot, str]]:
        with self._lock:
            peers = list(self._peers.values())
            fut: Future = Future()
            # the waiter resolves when EVERY queried peer has answered
            # (or left) — a fast empty response must not mask a slower
            # peer that does hold a snapshot
            pending = {p.id for p in peers}
            if pending:
                self._snap_waiters.append((fut, pending))
            else:
                fut.set_result(True)
        for p in peers:
            p.try_send(SNAPSHOT_CHANNEL, bytes([_SNAP_REQ]))
        try:
            fut.result(timeout=timeout)
        except Exception:
            pass
        with self._lock:
            self._snap_waiters = [(f, p) for f, p in self._snap_waiters
                                  if f is not fut]
        with self._lock:
            return [(s, pid) for pid, snaps in self._snapshots.items()
                    for s in snaps]

    def fetch_chunk(self, peer_id: str, height: int, format_: int,
                    index: int, timeout: float = 30.0) -> Optional[bytes]:
        with self._lock:
            peer = self._peers.get(peer_id)
            if peer is None:
                return None
            key = (height, format_, index)
            fut: Future = Future()
            self._pending_chunks.setdefault(key, []).append(
                (peer_id, fut))
        peer.try_send(CHUNK_CHANNEL, bytes([_CHUNK_REQ])
                      + proto.f_varint(1, height)
                      + proto.f_varint(2, format_)
                      + proto.f_varint(3, index))
        try:
            return fut.result(timeout=timeout)
        except Exception:
            # timed out: drop the stale future so retries don't
            # accumulate entries for the reactor's lifetime
            with self._lock:
                rest = [(pid, f) for pid, f in
                        self._pending_chunks.get(key, ())
                        if f is not fut]
                if rest:
                    self._pending_chunks[key] = rest
                else:
                    self._pending_chunks.pop(key, None)
            return None


class NetSnapshotSource:
    """Syncer.SnapshotSource over one serving peer."""

    def __init__(self, reactor: StatesyncNetReactor, peer_id: str,
                 snapshots: List[Snapshot]):
        self.reactor = reactor
        self.peer_id = peer_id
        self._snapshots = snapshots

    def list_snapshots(self) -> List[Snapshot]:
        return self._snapshots

    def fetch_chunk(self, height: int, format_: int, chunk: int) -> bytes:
        got = self.reactor.fetch_chunk(self.peer_id, height, format_,
                                       chunk)
        if got is None:
            raise ConnectionError(
                f"peer {self.peer_id[:8]} failed chunk {chunk}")
        return got


def net_snapshot_sources(reactor: StatesyncNetReactor
                         ) -> List[NetSnapshotSource]:
    """Group discovered snapshots per serving peer."""
    by_peer: Dict[str, List[Snapshot]] = {}
    for snap, pid in reactor.discover_snapshots():
        by_peer.setdefault(pid, []).append(snap)
    return [NetSnapshotSource(reactor, pid, snaps)
            for pid, snaps in by_peer.items()]
