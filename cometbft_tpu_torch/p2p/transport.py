"""TCP transport with the upgrade pipeline: accept/dial → secret
connection → node-info handshake (reference p2p/transport.go:195-582,
p2p/node_info.go).

Copy of `cometbft_tpu/p2p/transport.py` over the port's
`SecretConnection`.
"""

from __future__ import annotations

import socket
import threading
from dataclasses import dataclass, field as dc_field
from typing import Callable, List, Optional, Tuple

from ..crypto.keys import Ed25519PrivKey
from ..types import proto
from .conn import SecretConnection, HandshakeError
from .mconn import PONG_TIMEOUT


@dataclass
class NodeInfo:
    """reference p2p/node_info.go DefaultNodeInfo (subset that matters
    for compatibility checks)."""
    node_id: str                 # hex of address(pubkey)
    network: str                 # chain id
    moniker: str = "node"
    channels: bytes = b""        # supported channel ids
    listen_addr: str = ""

    def encode(self) -> bytes:
        return (proto.f_string(1, self.node_id)
                + proto.f_string(2, self.network)
                + proto.f_string(3, self.moniker)
                + proto.f_bytes(4, self.channels)
                + proto.f_string(5, self.listen_addr))

    @classmethod
    def decode(cls, buf: bytes) -> "NodeInfo":
        f = proto.parse_fields(buf)
        return cls(
            node_id=proto.field_bytes(f, 1, b"").decode(),
            network=proto.field_bytes(f, 2, b"").decode(),
            moniker=proto.field_bytes(f, 3, b"").decode(),
            channels=proto.field_bytes(f, 4, b""),
            listen_addr=proto.field_bytes(f, 5, b"").decode())

    def compatible_with(self, other: "NodeInfo") -> Optional[str]:
        """reference node_info.go CompatibleWith: same network + at least
        one common channel."""
        if self.network != other.network:
            return f"different networks: {self.network} vs {other.network}"
        if self.channels and other.channels and \
                not set(self.channels) & set(other.channels):
            return "no common channels"
        return None


class Transport:
    """reference p2p/transport.go MultiplexTransport."""

    def __init__(self, priv_key: Ed25519PrivKey, node_info: NodeInfo):
        self.priv_key = priv_key
        self.node_info = node_info
        self._listener: Optional[socket.socket] = None
        self._stop = threading.Event()

    @property
    def node_id(self) -> str:
        return self.node_info.node_id

    def listen(self, host: str = "127.0.0.1", port: int = 0
               ) -> Tuple[str, int]:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, port))
        s.listen(64)
        self._listener = s
        addr = s.getsockname()
        self.node_info.listen_addr = f"{addr[0]}:{addr[1]}"
        return addr

    def accept_loop(self, on_conn: Callable) -> None:
        """Accept + upgrade in a thread per connection; on_conn(sc, info,
        outbound=False)."""
        def loop():
            while not self._stop.is_set():
                try:
                    raw, _addr = self._listener.accept()
                except OSError:
                    return
                threading.Thread(
                    target=self._upgrade, args=(raw, on_conn, False),
                    daemon=True).start()
        self._accept_thread = threading.Thread(
            target=loop, name="transport-accept", daemon=True)
        self._accept_thread.start()

    def dial(self, host: str, port: int, on_conn: Callable) -> None:
        raw = socket.create_connection((host, port), timeout=10)
        self._upgrade(raw, on_conn, True)

    def _upgrade(self, raw: socket.socket, on_conn: Callable,
                 outbound: bool) -> None:
        """secret conn + node info exchange (transport.go:582 upgrade)."""
        try:
            raw.settimeout(10)
            sc = SecretConnection(raw, self.priv_key)
            sc.send_message(self.node_info.encode())
            peer_info = NodeInfo.decode(sc.recv_message())
            # the authenticated key must match the claimed node id
            derived = self.peer_id_of(sc)
            if peer_info.node_id != derived:
                raise HandshakeError(
                    f"node id {peer_info.node_id} != key-derived {derived}")
            err = self.node_info.compatible_with(peer_info)
            if err is not None:
                raise HandshakeError(err)
            # post-handshake: a finite socket timeout instead of
            # blocking forever. Pings flow every PING_INTERVAL (10s)
            # both ways, so an alive peer always produces traffic well
            # inside this window; a frozen/partitioned peer trips
            # socket.timeout (an OSError) in whichever routine is
            # stuck — including a sendall blocked on a full TCP buffer,
            # which the mconn-level pong deadline alone cannot catch
            raw.settimeout(2 * PONG_TIMEOUT)
            on_conn(sc, peer_info, outbound)
        except (HandshakeError, ConnectionError, OSError, ValueError):
            try:
                raw.close()
            except OSError:
                pass

    @staticmethod
    def peer_id_of(sc: SecretConnection) -> str:
        return sc.peer_pubkey.address().hex()

    def close(self) -> None:
        self._stop.set()
        if self._listener is not None:
            try:
                # wakes a blocked accept(); close() alone does not
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
        thread = getattr(self, "_accept_thread", None)
        if thread is not None:
            thread.join(timeout=5)


def node_info_for(priv_key: Ed25519PrivKey, network: str,
                  channels: bytes, moniker: str = "node") -> NodeInfo:
    return NodeInfo(node_id=priv_key.pub_key().address().hex(),
                    network=network, moniker=moniker, channels=channels)
