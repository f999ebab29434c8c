"""Switch: peer lifecycle + reactor dispatch (reference p2p/switch.go:166,
274, p2p/base_reactor.go, p2p/peer.go).

Reactors register channel descriptors; the switch owns peers (each an
MConnection over a SecretConnection) and routes inbound messages to the
reactor that claimed the channel. Broadcast fans a message to every
connected peer's channel queue.

Copy of `cometbft_tpu/p2p/switch.py` (the port keeps its own); peer
exchange is `p2p/pex.py`.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, List, Optional, Protocol, Tuple

from ..crypto.keys import Ed25519PrivKey
from .conn import SecretConnection
from .mconn import ChannelDescriptor, MConnection
from .transport import NodeInfo, Transport, node_info_for


class Reactor(Protocol):
    """reference p2p/base_reactor.go Reactor."""

    def get_channels(self) -> List[ChannelDescriptor]: ...
    def add_peer(self, peer: "Peer") -> None: ...
    def remove_peer(self, peer: "Peer", reason: str) -> None: ...
    def receive(self, channel_id: int, peer: "Peer", msg: bytes) -> None: ...


class PeerLike(Protocol):
    """The peer surface reactors may rely on (reference p2p/peer.go
    Peer interface, reduced to what the reactors here actually call).
    Implementations: `Peer` below (MConnection over a secret TCP
    connection) and `simnet.transport.SimPeer` (virtual-time in-memory
    link). Reactors MUST stay inside this surface or the simulator can
    no longer run them unmodified."""

    id: str

    def send(self, channel_id: int, msg: bytes) -> bool: ...
    def try_send(self, channel_id: int, msg: bytes) -> bool: ...


class Peer:
    """reference p2p/peer.go peer."""

    def __init__(self, switch: "Switch", sc: SecretConnection,
                 info: NodeInfo, outbound: bool):
        self.switch = switch
        self.node_info = info
        self.id = info.node_id
        self.outbound = outbound
        self._mconn = MConnection(
            sc, switch.channel_descriptors(),
            on_receive=lambda cid, msg: switch._dispatch(self, cid, msg),
            on_error=lambda e: switch.stop_peer(self, f"conn error: {e}"),
            send_rate=switch.send_rate, recv_rate=switch.recv_rate)

    def start(self) -> None:
        self._mconn.start()

    def stop(self) -> None:
        self._mconn.stop()

    def send(self, channel_id: int, msg: bytes) -> bool:
        ok = self._mconn.send(channel_id, msg, block=True)
        if ok:  # dropped sends must not count as traffic
            self._count_send(channel_id, len(msg))
        return ok

    def try_send(self, channel_id: int, msg: bytes) -> bool:
        ok = self._mconn.send(channel_id, msg, block=False)
        if ok:
            self._count_send(channel_id, len(msg))
        return ok

    def _count_send(self, channel_id: int, n: int) -> None:
        m = self.switch.metrics
        if m is not None:
            m.message_send_bytes_total.inc(n, ch_id=f"{channel_id:#x}")

    def __repr__(self) -> str:
        return f"Peer{{{self.id[:12]} {'out' if self.outbound else 'in'}}}"


class Switch:
    """reference p2p/switch.go Switch."""

    def __init__(self, priv_key: Ed25519PrivKey, network: str,
                 moniker: str = "node",
                 send_rate: int = 5_120_000,
                 recv_rate: int = 5_120_000,
                 rng: Optional[random.Random] = None):
        self.priv_key = priv_key
        self.network = network
        self.send_rate = send_rate
        self.recv_rate = recv_rate
        # reconnect jitter comes from a node-key-derived (or injected)
        # instance, never the global RNG: simnet's byte-identical-log
        # guarantee requires every random draw in the process to be a
        # pure function of (scenario, seed, node key)
        self._rng = rng if rng is not None \
            else random.Random(b"p2p-switch:" + priv_key.seed)
        self._reactors: List[Reactor] = []
        self._chan_to_reactor: Dict[int, Reactor] = {}
        # guarded-by: _lock: _peers
        self._peers: Dict[str, Peer] = {}
        self._lock = threading.RLock()
        self._moniker = moniker
        self.transport: Optional[Transport] = None
        self.banned: set = set()
        # persistent peers: (host, port) -> last-known peer id ("" until
        # a dial succeeds). The ensure-peers routine re-dials any entry
        # whose peer is not currently connected — liveness depends on
        # this: a simultaneous-dial race can close BOTH duplicate
        # connections (each side keeps a different one), and without
        # re-dialing the isolated node never hears another vote and
        # stops scheduling timeouts after its own prevote (reference
        # p2p/pex ensurePeers + switch reconnectToPeer).
        self._persistent: Dict[Tuple[str, int], str] = {}
        self._ensure_stop = threading.Event()
        self._ensure_thread: Optional[threading.Thread] = None
        # optional generated metrics struct (libs/metrics_gen.P2PMetrics
        # — reference p2p/metrics.go); None until the node wires it
        self.metrics = None

    # --- setup ----------------------------------------------------------------

    def add_reactor(self, reactor: Reactor) -> None:
        for d in reactor.get_channels():
            if d.id in self._chan_to_reactor:
                raise ValueError(f"channel {d.id:#x} already claimed")
            self._chan_to_reactor[d.id] = reactor
        self._reactors.append(reactor)

    def channel_descriptors(self) -> List[ChannelDescriptor]:
        return [d for r in self._reactors for d in r.get_channels()]

    def listen(self, host: str = "127.0.0.1", port: int = 0):
        channels = bytes(self._chan_to_reactor.keys())
        self.transport = Transport(
            self.priv_key,
            node_info_for(self.priv_key, self.network, channels,
                          self._moniker))
        addr = self.transport.listen(host, port)
        self.transport.accept_loop(self._on_connection)
        return addr

    def dial(self, host: str, port: int) -> None:
        """reference switch.go DialPeerWithAddress."""
        if self.transport is None:
            self.listen()

        def on_conn(sc: SecretConnection, info: NodeInfo,
                    outbound: bool) -> None:
            addr = (host, port)
            if addr in self._persistent:
                self._persistent[addr] = info.node_id
            self._on_connection(sc, info, outbound)

        try:
            self.transport.dial(host, port, on_conn)
        except OSError:
            # count here so EVERY dial path (persistent re-dial, PEX,
            # RPC dial_peers) feeds the metric
            if self.metrics is not None:
                self.metrics.peer_dial_failures.inc()
            raise

    def add_persistent_peer(self, host: str, port: int) -> None:
        """Register for dial-now + re-dial-forever (reference
        config persistent_peers semantics)."""
        self._persistent[(host, port)] = ""
        if self._ensure_thread is None:
            self._ensure_thread = threading.Thread(
                target=self._ensure_peers_routine, name="ensure-peers",
                daemon=True)
            self._ensure_thread.start()

    def _persistent_connected(self, addr: Tuple[str, int]) -> bool:
        pid = self._persistent.get(addr, "")
        with self._lock:
            return bool(pid) and pid in self._peers

    def _ensure_peers_routine(self) -> None:
        while not self._ensure_stop.is_set():
            for addr in list(self._persistent):
                if self._persistent_connected(addr):
                    continue
                pid = self._persistent.get(addr, "")
                if pid and pid in self.banned:
                    # a configured persistent peer overrides a ban (it
                    # can be banned before we learn its id, e.g. when
                    # it connected inbound first and tripped a reactor
                    # error) — unban and reconnect; transient errors
                    # must not cut a configured link forever
                    self.banned.discard(pid)
                try:
                    self.dial(*addr)
                except OSError:
                    pass  # counted in dial(); retried next round
            # jitter desynchronizes simultaneous re-dials between two
            # nodes that each just closed the other's duplicate (the
            # node-key-derived seed keeps the two nodes' draws distinct
            # AND each node's schedule deterministic)
            self._ensure_stop.wait(1.0 + self._rng.random())

    # --- peer lifecycle -------------------------------------------------------

    def _on_connection(self, sc: SecretConnection, info: NodeInfo,
                       outbound: bool) -> None:
        with self._lock:
            if info.node_id in self.banned:
                sc.close()
                return
            if info.node_id == self.transport.node_id:
                sc.close()  # self-connection
                return
            if info.node_id in self._peers:
                sc.close()  # duplicate
                return
            peer = Peer(self, sc, info, outbound)
            self._peers[info.node_id] = peer
            if self.metrics is not None:  # inside the lock: a racing
                self.metrics.peers.set(len(self._peers))  # stop_peer
                # must not be overwritten with a stale count
        peer.start()
        for r in self._reactors:
            r.add_peer(peer)

    def stop_peer(self, peer: Peer, reason: str,
                  ban: bool = False) -> None:
        """reference switch.go StopPeerForError (persistent peers are
        never banned — a single transient reactor error must not cut a
        configured link forever; the reference reconnects them too,
        switch.go:222 isPersistent check)."""
        with self._lock:
            if self._peers.get(peer.id) is not peer:
                return
            del self._peers[peer.id]
            if ban and peer.id not in self._persistent.values():
                self.banned.add(peer.id)
            if self.metrics is not None:
                self.metrics.peers.set(len(self._peers))
        peer.stop()
        for r in self._reactors:
            r.remove_peer(peer, reason)

    def peers(self) -> List[Peer]:
        with self._lock:
            return list(self._peers.values())

    def broadcast(self, channel_id: int, msg: bytes) -> None:
        """reference switch.go:274 Broadcast (non-blocking per peer)."""
        for peer in self.peers():
            peer.try_send(channel_id, msg)

    # --- dispatch -------------------------------------------------------------

    def _dispatch(self, peer: Peer, channel_id: int, msg: bytes) -> None:
        if self.metrics is not None:
            self.metrics.message_receive_bytes_total.inc(
                len(msg), ch_id=f"{channel_id:#x}")
        reactor = self._chan_to_reactor.get(channel_id)
        if reactor is None:
            self.stop_peer(peer, f"unclaimed channel {channel_id:#x}")
            return
        try:
            reactor.receive(channel_id, peer, msg)
        except Exception as e:  # noqa: BLE001 — a peer's bad message
            # must not kill the recv routine; drop the peer instead
            self.stop_peer(peer, f"reactor error: {e}", ban=True)

    def stop(self) -> None:
        self._ensure_stop.set()
        if self.transport is not None:
            self.transport.close()
        for peer in self.peers():
            self.stop_peer(peer, "switch stopping")
        if self._ensure_thread is not None:
            self._ensure_thread.join(timeout=5)
