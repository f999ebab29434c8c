"""Peer exchange: address book + PEX reactor
(reference p2p/pex/addrbook.go:920, p2p/pex/pex_reactor.go:761).

Channel 0x00: kind 1 = AddrsRequest, kind 2 = AddrsResponse (repeated
"id@host:port" strings). The reactor answers requests from its book,
requests addresses from every new peer, and an ensure-peers loop dials
book entries while below the outbound target.

Copy of `cometbft_tpu/p2p/pex.py` in the port, over the port's `mconn`
and `Switch`: the same messages and the same address-book file, so a port
node exchanges addresses with a JAX-package node. What differs: `stop()`
joins the ensure-peers thread.
"""

from __future__ import annotations

import json
import os
import random
import threading
from typing import Dict, List, Optional, Tuple

from ..types import proto
from .mconn import ChannelDescriptor

PEX_CHANNEL = 0x00
_REQ = 1
_RESP = 2


class AddressBook:
    """File-backed peer address book (reference pex/addrbook.go)."""

    def __init__(self, path: Optional[str] = None,
                 rng: Optional[random.Random] = None):
        self.path = path
        self._addrs: Dict[str, Tuple[str, int]] = {}
        self._lock = threading.Lock()
        # pick() shuffles with a seeded instance, never the global RNG
        # (simnet byte-identical logs). Standalone books derive from
        # their path; PexReactor.attach upgrades an un-injected book to
        # a node-key-derived seed so two nodes shuffle differently.
        self._rng_injected = rng is not None
        self._rng = rng if rng is not None \
            else random.Random(f"addrbook:{path}")
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    d = json.load(f)
                self._addrs = {k: (v[0], v[1]) for k, v in d.items()}
            except (ValueError, OSError):
                pass

    def add(self, node_id: str, host: str, port: int) -> None:
        with self._lock:
            self._addrs[node_id] = (host, int(port))
        self._persist()

    def remove(self, node_id: str) -> None:
        with self._lock:
            self._addrs.pop(node_id, None)
        self._persist()

    def pick(self, exclude: set, n: int = 1) -> List[Tuple[str, str, int]]:
        with self._lock:
            cands = [(i, h, p) for i, (h, p) in self._addrs.items()
                     if i not in exclude]
        self._rng.shuffle(cands)
        return cands[:n]

    def entries(self) -> List[Tuple[str, str, int]]:
        with self._lock:
            return [(i, h, p) for i, (h, p) in self._addrs.items()]

    def __len__(self) -> int:
        return len(self._addrs)

    def _persist(self) -> None:
        if not self.path:
            return
        with self._lock:
            data = {k: list(v) for k, v in self._addrs.items()}
        tmp = self.path + ".tmp"
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, self.path)


def _encode_addrs(addrs: List[Tuple[str, str, int]]) -> bytes:
    return b"".join(proto.f_string(1, f"{i}@{h}:{p}")
                    for i, h, p in addrs)


def _decode_addrs(body: bytes) -> List[Tuple[str, str, int]]:
    out = []
    for raw in proto.field_all_bytes(proto.parse_fields(body), 1):
        try:
            ident, _, hostport = raw.decode().partition("@")
            host, _, port = hostport.rpartition(":")
            out.append((ident, host, int(port)))
        except ValueError:
            continue
    return out


class PexReactor:
    """reference p2p/pex/pex_reactor.go."""

    def __init__(self, book: AddressBook, max_outbound: int = 10,
                 ensure_interval_s: float = 5.0):
        self.book = book
        self.max_outbound = max_outbound
        self.ensure_interval_s = ensure_interval_s
        self._switch = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def attach(self, switch) -> None:
        self._switch = switch
        # upgrade a book that was not given an explicit RNG to a
        # node-key-derived seed: deterministic per node, distinct
        # between nodes (the path-derived default collides when every
        # node uses an in-memory book with path=None)
        if not self.book._rng_injected:
            self.book._rng = random.Random(
                b"pex-book:" + switch.priv_key.bytes_())

    def get_channels(self) -> List[ChannelDescriptor]:
        return [ChannelDescriptor(id=PEX_CHANNEL, priority=1,
                                  send_queue_capacity=10)]

    def add_peer(self, peer) -> None:
        # learn the peer's listen address and ask it for more
        info = peer.node_info
        if info.listen_addr:
            host, _, port = info.listen_addr.rpartition(":")
            try:
                self.book.add(peer.id, host, int(port))
            except ValueError:
                pass
        peer.try_send(PEX_CHANNEL, bytes([_REQ]))

    def remove_peer(self, peer, reason: str) -> None:
        if "bad block" in reason or "reactor error" in reason:
            self.book.remove(peer.id)

    def receive(self, channel_id: int, peer, raw: bytes) -> None:
        kind, body = raw[0], raw[1:]
        if kind == _REQ:
            addrs = [e for e in self.book.entries() if e[0] != peer.id]
            peer.try_send(PEX_CHANNEL,
                          bytes([_RESP]) + _encode_addrs(addrs[:50]))
        elif kind == _RESP:
            for ident, host, port in _decode_addrs(body)[:50]:
                if ident and host:
                    self.book.add(ident, host, port)
        else:
            raise ValueError(f"unknown pex message kind {kind}")

    # --- ensure-peers loop (pex_reactor.go ensurePeersRoutine) ---------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._ensure_loop,
                                        name="pex-ensure", daemon=True)
        self._thread.start()

    def _ensure_loop(self) -> None:
        while not self._stop.wait(self.ensure_interval_s):
            self.ensure_peers()

    def ensure_peers(self) -> None:
        if self._switch is None:
            return
        peers = self._switch.peers()
        out = sum(1 for p in peers if p.outbound)
        if out >= self.max_outbound:
            return
        connected = {p.id for p in peers} | self._switch.banned
        connected.add(self._switch.transport.node_id
                      if self._switch.transport else "")
        for ident, host, port in self.book.pick(
                connected, self.max_outbound - out):
            try:
                self._switch.dial(host, port)
            except OSError:
                self.book.remove(ident)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
