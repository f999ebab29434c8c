"""Proxy: the four named ABCI connections (reference
proxy/multi_app_conn.go:10-56, proxy/client.go:41-301).

consensus / mempool / query / snapshot each get their own client so a
slow query can never block FinalizeBlock. Local creator shares one
in-process Application behind a mutex (the reference's committing local
client); remote creator dials the ABCI socket server once per
connection — four independent sockets, like the reference.

Copy of `cometbft_tpu/proxy/multi_app_conn.py` in the port. The socket
creator dials the port's `abci/socket.SocketClient`; the gRPC creator
raises NotImplementedError when called: the gRPC ABCI client needs the
grpcio package and is not ported (ROADMAP.md Queue 1 item 11.4).
"""

from __future__ import annotations

import threading
from typing import Callable

from ..abci.application import Application


class _LockedApp:
    """Serialize calls into a shared in-process app (the reference's
    local client mutex, proxy/client.go:85-120)."""

    def __init__(self, app: Application, lock: threading.Lock):
        self._app = app
        self._lock = lock

    def __getattr__(self, name):
        target = getattr(self._app, name)
        if not callable(target):
            return target
        lock = self._lock

        def wrapped(*args, **kwargs):
            with lock:
                return target(*args, **kwargs)
        return wrapped


def local_client_creator(app: Application) -> Callable[[], Application]:
    """reference proxy.NewLocalClientCreator."""
    lock = threading.Lock()

    def create() -> Application:
        return _LockedApp(app, lock)
    return create


def remote_client_creator(host: str, port: int) -> Callable[[], Application]:
    """reference proxy.NewRemoteClientCreator (socket transport)."""
    def create() -> Application:
        from ..abci.socket import SocketClient
        return SocketClient(host, port)
    return create


def remote_grpc_client_creator(host: str, port: int
                               ) -> Callable[[], Application]:
    """reference proxy.NewRemoteClientCreator with transport=grpc —
    four independent channels, one per named connection."""
    raise NotImplementedError(
        "a remote gRPC ABCI app needs abci/grpc.py and the grpcio "
        "package, not ported yet (ROADMAP.md Queue 1 item 11.4)")


class AppConns:
    """reference proxy/multi_app_conn.go multiAppConn."""

    def __init__(self, client_creator: Callable[[], Application]):
        self.consensus = client_creator()
        self.mempool = client_creator()
        self.query = client_creator()
        self.snapshot = client_creator()

    def stop(self) -> None:
        for conn in (self.consensus, self.mempool, self.query,
                     self.snapshot):
            close = getattr(conn, "close", None)
            if close is not None:
                close()
