"""Blocksync over p2p: serve blocks to catching-up peers and fetch
blocks from them (reference internal/blocksync/reactor.go:133-547).

Wire messages on the blocksync channel (0x40, reference reactor.go:31):
  kind 1 StatusRequest   {}
  kind 2 StatusResponse  {base=1, height=2, sealable=3}
  kind 3 BlockRequest    {height=1}
  kind 4 BlockResponse   {height=1, block=2}
  kind 5 NoBlockResponse {height=1}
  kind 6 SealRequest     {start=1, count=2}          (sealsync/)
  kind 7 SealResponse    {start=1, tuples=2 repeated} (empty = none)

`NetSource` adapts request/response over the Switch into the PeerSource
protocol, so `BlocksyncReactor` (the tile-verified engine) and the
prefetching `BlockPool` run unchanged over real TCP peers — per-height
requester workers give the reference's pipelined fetch shape
(pool.go:616,776), with the TPU tile verify overlapping network pulls.
`NetSealSource` does the same for sealsync's SealSource: seal spans
are served by the attached SealProvider (bounded + shed — an
overloaded provider answers an EMPTY response, never queues), and the
status response's `sealable` field advertises the provider tip so an
adopted-but-not-backfilled node is already a useful upstream.

Copy of `cometbft_tpu/engine/reactor.py` over the port's `sealsync`
(`SealTuple`, `SealProvider`). What differs: a block request still
unanswered when its peer is removed (a ban, a dropped link) is sent again
to another peer, as the reference's pool redoes its requesters
(pool.go RemovePeer); the JAX package leaves it to its 20 s timeout, and
the pool then reads the height as missing and the sync stalls.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

from ..p2p.mconn import ChannelDescriptor
from ..types import proto
from ..types.block import Block, BlockID, Commit, Header

BLOCKSYNC_CHANNEL = 0x40

_STATUS_REQ = 1
_STATUS_RESP = 2
_BLOCK_REQ = 3
_BLOCK_RESP = 4
_NO_BLOCK = 5
_SEAL_REQ = 6
_SEAL_RESP = 7


def _msg(kind: int, body: bytes = b"") -> bytes:
    return bytes([kind]) + body


class BlocksyncNetReactor:
    """p2p.Reactor serving + requesting blocks (reactor.go Receive)."""

    def __init__(self, block_store, state_getter=None,
                 seal_provider=None):
        self.block_store = block_store
        self.state_getter = state_getter
        self.seal_provider = seal_provider
        self._peers: Dict[str, object] = {}
        self._peer_status: Dict[str, int] = {}
        self._peer_seal_status: Dict[str, int] = {}
        self._pending: Dict[int, List[Future]] = {}
        self._asked: Dict[int, str] = {}   # height -> peer id asked last
        self._pending_seals: Dict[int, List[Future]] = {}
        self._lock = threading.Lock()
        # seconds spent in Block.decode of received blocks, and their
        # count (the recv threads of every peer add, under _lock)
        self.decode_s = 0.0
        self.blocks_decoded = 0

    # --- p2p.Reactor ----------------------------------------------------------

    def get_channels(self) -> List[ChannelDescriptor]:
        return [ChannelDescriptor(id=BLOCKSYNC_CHANNEL, priority=5)]

    def add_peer(self, peer) -> None:
        with self._lock:
            self._peers[peer.id] = peer
        peer.try_send(BLOCKSYNC_CHANNEL, _msg(_STATUS_REQ))

    def remove_peer(self, peer, reason: str) -> None:
        redo = []
        with self._lock:
            self._peers.pop(peer.id, None)
            self._peer_status.pop(peer.id, None)
            self._peer_seal_status.pop(peer.id, None)
            for h, pid in list(self._asked.items()):
                if pid != peer.id or not self._pending.get(h):
                    continue
                nxt = self._pick_peer(h)
                if nxt is None:
                    break
                self._asked[h] = nxt.id
                redo.append((h, nxt))
        for h, nxt in redo:
            nxt.try_send(BLOCKSYNC_CHANNEL,
                         _msg(_BLOCK_REQ, proto.f_varint(1, h)))

    def receive(self, channel_id: int, peer, raw: bytes) -> None:
        kind, body = raw[0], raw[1:]
        if kind == _STATUS_REQ:
            resp = (proto.f_varint(1, self.block_store.base())
                    + proto.f_varint(2, self.block_store.height()))
            if self.seal_provider is not None:
                resp += proto.f_varint(3, self.seal_provider.status()[1])
            peer.try_send(BLOCKSYNC_CHANNEL, _msg(_STATUS_RESP, resp))
        elif kind == _STATUS_RESP:
            f = proto.parse_fields(body)
            with self._lock:
                self._peer_status[peer.id] = proto.field_int(f, 2, 0)
                self._peer_seal_status[peer.id] = proto.field_int(f, 3, 0)
        elif kind == _BLOCK_REQ:
            self._serve_block(peer, proto.field_int(
                proto.parse_fields(body), 1, 0))
        elif kind == _BLOCK_RESP:
            f = proto.parse_fields(body)
            h = proto.field_int(f, 1, 0)
            t0 = time.perf_counter()
            blk = Block.decode(proto.field_bytes(f, 2, b""))
            dt = time.perf_counter() - t0
            with self._lock:
                self.decode_s += dt
                self.blocks_decoded += 1
            self._resolve(h, (blk, peer.id))
        elif kind == _NO_BLOCK:
            f = proto.parse_fields(body)
            self._resolve(proto.field_int(f, 1, 0), None)
        elif kind == _SEAL_REQ:
            f = proto.parse_fields(body)
            self._serve_seals(peer, proto.field_int(f, 1, 0),
                              proto.field_int(f, 2, 0))
        elif kind == _SEAL_RESP:
            f = proto.parse_fields(body)
            from ..sealsync.chain import SealTuple
            tuples = [SealTuple.decode(b)
                      for b in proto.field_all_bytes(f, 2)]
            self._resolve_seals(proto.field_int(f, 1, 0),
                                (tuples, peer.id))
        else:
            raise ValueError(f"unknown blocksync message kind {kind}")

    # --- server side ----------------------------------------------------------

    def _serve_block(self, peer, height: int) -> None:
        """reactor.go:175 respondToPeer, incl. the synthetic tip+1
        successor carrying the seen commit so a peer can seal our tip."""
        store_h = self.block_store.height()
        blk: Optional[Block] = None
        if 1 <= height <= store_h:
            blk = self.block_store.load_block(height)
        elif height == store_h + 1 and store_h >= 1:
            seen = self.block_store.load_seen_commit(store_h)
            tip = self.block_store.load_block(store_h)
            if seen is not None and tip is not None:
                blk = Block(
                    header=Header(
                        chain_id=tip.header.chain_id, height=height,
                        validators_hash=tip.header.next_validators_hash,
                        proposer_address=b"\x00" * 20),
                    last_commit=seen)
        if blk is None:
            peer.try_send(BLOCKSYNC_CHANNEL,
                          _msg(_NO_BLOCK, proto.f_varint(1, height)))
            return
        peer.try_send(BLOCKSYNC_CHANNEL, _msg(_BLOCK_RESP,
                      proto.f_varint(1, height)
                      + proto.f_bytes(2, blk.encode())))

    def _serve_seals(self, peer, start: int, count: int) -> None:
        """Seal-span serving (sealsync/): prefix semantics — the
        provider stops at the first unsealable height, and overload
        sheds to an EMPTY response (the peer retries elsewhere; an
        unbounded queue here would let laggards sink a healthy
        node)."""
        tuples = []
        if self.seal_provider is not None and start >= 1 and count >= 1:
            from ..sealsync.provider import SealsyncOverloaded
            try:
                tuples = self.seal_provider.serve(start, count)
            except SealsyncOverloaded:
                tuples = []
        body = proto.f_varint(1, start)
        for t in tuples:
            body += proto.f_bytes(2, t.encode())
        peer.try_send(BLOCKSYNC_CHANNEL, _msg(_SEAL_RESP, body))

    # --- client side ----------------------------------------------------------

    def _resolve(self, height: int, result) -> None:
        with self._lock:
            futs = self._pending.pop(height, [])
            self._asked.pop(height, None)
        for fut in futs:
            if not fut.done():
                fut.set_result(result)

    def _resolve_seals(self, start: int, result) -> None:
        with self._lock:
            futs = self._pending_seals.pop(start, [])
        for fut in futs:
            if not fut.done():
                fut.set_result(result)

    def broadcast_status_request(self) -> None:
        with self._lock:
            peers = list(self._peers.values())
        for p in peers:
            p.try_send(BLOCKSYNC_CHANNEL, _msg(_STATUS_REQ))

    def max_peer_height(self):
        """Max height any peer reported, or None when no peer has
        answered a status request yet (0 is a real answer: a fresh
        chain)."""
        with self._lock:
            if not self._peer_status:
                return None
            return max(self._peer_status.values())

    def max_peer_sealable(self):
        """Max SEALABLE tip any peer advertised (status field 3), or
        None before any answer — the sealsync analog of
        max_peer_height."""
        with self._lock:
            if not self._peer_seal_status:
                return None
            return max(self._peer_seal_status.values())

    def request_seals(self, start: int, count: int,
                      timeout: float = 20.0):
        """Blocking seal-span fetch from the best seal-serving peer;
        returns (tuples, peer_id) or None."""
        with self._lock:
            candidates = [p for p in self._peers.values()
                          if self._peer_seal_status.get(p.id, 0) >= start]
            if not candidates:
                candidates = list(self._peers.values())
            if not candidates:
                return None
            peer = candidates[start % len(candidates)]
            fut: Future = Future()
            self._pending_seals.setdefault(start, []).append(fut)
        peer.try_send(BLOCKSYNC_CHANNEL,
                      _msg(_SEAL_REQ, proto.f_varint(1, start)
                           + proto.f_varint(2, count)))
        try:
            return fut.result(timeout=timeout)
        except Exception:
            return None

    def _pick_peer(self, height: int):
        """The peer asked for `height`: one whose status covers it
        (height + 1: the tip's synthetic successor), spread by height,
        or any peer; None when peerless. Caller holds the lock."""
        candidates = [p for p in self._peers.values()
                      if self._peer_status.get(p.id, 0) + 1 >= height]
        if not candidates:
            candidates = list(self._peers.values())
        return candidates[height % len(candidates)] if candidates else None

    def request_block_async(self, height: int) -> Optional[Future]:
        """Send a BlockRequest to the best-known peer and return the
        Future its response will resolve (None when peerless). The
        non-blocking half of request_block — simnet's cooperative
        source polls the future between virtual delivery events."""
        with self._lock:
            peer = self._pick_peer(height)
            if peer is None:
                return None
            fut: Future = Future()
            self._pending.setdefault(height, []).append(fut)
            self._asked[height] = peer.id
        peer.try_send(BLOCKSYNC_CHANNEL,
                      _msg(_BLOCK_REQ, proto.f_varint(1, height)))
        return fut

    def request_block(self, height: int, timeout: float = 20.0
                      ) -> Optional[Tuple[Block, str]]:
        """Blocking fetch from the best-known peer (one bpRequester's
        work, pool.go:776)."""
        fut = self.request_block_async(height)
        if fut is None:
            return None
        try:
            return fut.result(timeout=timeout)
        except Exception:
            return None


class NetSource:
    """PeerSource over the reactor (plugs into engine.blocksync +
    engine.pool unchanged)."""

    def __init__(self, reactor: BlocksyncNetReactor, switch=None):
        self.reactor = reactor
        self.switch = switch
        self._served_by: Dict[int, str] = {}

    def max_height(self) -> int:
        self.reactor.broadcast_status_request()
        # deliberately WALL clock: this sleep-poll loop cannot advance a
        # virtual clock, so seaming it through libs/timesource would
        # spin forever under simnet. The simulable form of this wait is
        # request_block_async + a cooperative pump (simnet's
        # _SimNetSource implements max_height that way).
        deadline = time.monotonic() + 5  # staticcheck: allow(wallclock)
        while time.monotonic() < deadline:  # staticcheck: allow(wallclock)
            h = self.reactor.max_peer_height()
            if h is not None:  # 0 is a real answer (fresh chain)
                return h
            time.sleep(0.05)  # staticcheck: allow(reactor-sleep) — see above
        return 0

    def fetch(self, height: int):
        got = self.reactor.request_block(height)
        if got is None:
            return None
        blk, peer_id = got
        self._served_by[height] = peer_id
        return blk, BlockID()  # engine recomputes part sets itself

    def ban(self, height: int) -> None:
        """Drop + ban the peer that served a bad block
        (reactor.go:498-513)."""
        peer_id = self._served_by.get(height)
        if peer_id is None or self.switch is None:
            return
        for peer in self.switch.peers():
            if peer.id == peer_id:
                self.switch.stop_peer(peer, f"bad block at {height}",
                                      ban=True)


class NetSealSource:
    """sealsync.SealSource over the reactor: the p2p adapter the node's
    boot-time SealAdopter plugs in (docs/SEALSYNC.md)."""

    def __init__(self, reactor: BlocksyncNetReactor, switch=None):
        self.reactor = reactor
        self.switch = switch
        self._served_by: Dict[int, str] = {}

    def max_height(self) -> int:
        self.reactor.broadcast_status_request()
        # WALL clock for the same reason as NetSource.max_height: this
        # sleep-poll cannot advance a virtual clock; simnet sources
        # implement the SealSource protocol cooperatively instead.
        deadline = time.monotonic() + 5  # staticcheck: allow(wallclock)
        while time.monotonic() < deadline:  # staticcheck: allow(wallclock)
            h = self.reactor.max_peer_sealable()
            if h is not None:
                return h
            time.sleep(0.05)  # staticcheck: allow(reactor-sleep) — see above
        return 0

    def fetch_seals(self, start: int, count: int):
        got = self.reactor.request_seals(start, count)
        if got is None:
            return []
        tuples, peer_id = got
        self._served_by[start] = peer_id
        return tuples

    def ban(self, height: int) -> None:
        """Ban the peer whose span covered `height` — spans are keyed
        by their start, so blame the newest span at or below it."""
        starts = [s for s in self._served_by if s <= height]
        if not starts or self.switch is None:
            return
        peer_id = self._served_by.get(max(starts))
        for peer in self.switch.peers():
            if peer.id == peer_id:
                self.switch.stop_peer(peer, f"bad seal span at {height}",
                                      ban=True)
