"""ABCI over a socket: server hosting an Application out-of-process and
the matching client (reference abci/server/socket_server.go,
abci/client/socket_client.go, internal/protoio length-delimited framing).

Framing: uvarint message length || payload. Payload: u8 method id ||
JSON body (the node-local serialization — this framework's two sides are
both in-tree; the reference's gogoproto Request/Response envelope plays
the same role). Requests are processed strictly in order per connection,
matching the reference's ordered-response contract
(socket_client.go didn't multiplex either).

The method-id/body codec is transport-independent: `dispatch_request`
(app side) and `AppClientCodec` (client side) are shared with the gRPC
flavor (abci/grpc.py), so both transports speak byte-identical bodies.

Copy of `cometbft_tpu/abci/socket.py` in the port: the same method ids,
the same JSON bodies byte for byte and the same framing, so a port client
talks to a JAX-package `ABCIServer` and the reverse. What differs:
`ABCIServer.stop()` shuts down every accepted connection and joins the
accept thread and each connection's thread (the JAX package's server
leaves them to die with the process). The gRPC flavor is not ported
(ROADMAP.md Queue 1 item 11.4: it needs the grpcio package).
"""

from __future__ import annotations

import json
import socket
import threading
import time
from typing import Optional, Tuple

from ..types import proto
from .application import (Application, CheckTxResult,
                          RequestFinalizeBlock, ResponseCommit,
                          ResponseFinalizeBlock, ResponseInfo,
                          ValidatorUpdate)
from ..types.proto import Timestamp

_M_ECHO = 0
_M_INFO = 1
_M_CHECK_TX = 2
_M_PREPARE = 3
_M_PROCESS = 4
_M_FINALIZE = 5
_M_COMMIT = 6
_M_QUERY = 7
_M_INIT_CHAIN = 8
_M_FLUSH = 9
_M_QUERY_PROVE = 10
_M_LIST_SNAPSHOTS = 11
_M_LOAD_SNAPSHOT_CHUNK = 12
_M_OFFER_SNAPSHOT = 13
_M_APPLY_SNAPSHOT_CHUNK = 14
_M_EXTEND_VOTE = 15
_M_VERIFY_VOTE_EXT = 16


def _send_msg(sock, method: int, body: dict) -> None:
    payload = bytes([method]) + json.dumps(body).encode()
    sock.sendall(proto.uvarint(len(payload)) + payload)


class _Reader:
    def __init__(self, sock):
        self._sock = sock
        self._buf = b""

    def read_msg(self) -> Tuple[int, dict]:
        ln, used = self._read_uvarint()
        while len(self._buf) < used + ln:
            self._fill()
        payload = self._buf[used:used + ln]
        self._buf = self._buf[used + ln:]
        return payload[0], json.loads(payload[1:] or b"{}")

    def _read_uvarint(self):
        while True:
            try:
                return proto.read_uvarint(self._buf, 0)
            except (ValueError, IndexError):
                self._fill()

    def _fill(self):
        chunk = self._sock.recv(65536)
        if not chunk:
            raise ConnectionError("ABCI peer closed")
        self._buf += chunk


def _hx(b: bytes) -> str:
    return b.hex()


def _unhx(s: str) -> bytes:
    return bytes.fromhex(s)


def dispatch_request(app: Application, method: int, b: dict) -> dict:
    """App-side method dispatch: decode the JSON body, call the
    Application, encode the response body. Shared by the socket server
    (below) and the gRPC server (abci/grpc.py) — one codec, two
    transports (the reference's gogoproto Request/Response oneof plays
    this role for its socket AND grpc servers)."""
    if method in (_M_ECHO, _M_FLUSH):
        return b
    if method == _M_INFO:
        r = app.info()
        return {"data": r.data, "version": r.version,
                "app_version": r.app_version,
                "last_block_height": r.last_block_height,
                "last_block_app_hash": _hx(r.last_block_app_hash)}
    if method == _M_CHECK_TX:
        r = app.check_tx(_unhx(b["tx"]))
        return {"code": r.code, "gas_wanted": r.gas_wanted,
                "log": r.log}
    if method == _M_PREPARE:
        llc = b.get("local_last_commit")
        if llc is not None:
            llc = [(e["index"], _unhx(e["address"]),
                    _unhx(e["extension"])) for e in llc]
        txs = app.prepare_proposal([_unhx(t) for t in b["txs"]],
                                   b["max_tx_bytes"],
                                   local_last_commit=llc)
        return {"txs": [_hx(t) for t in txs]}
    if method == _M_PROCESS:
        ok = app.process_proposal([_unhx(t) for t in b["txs"]],
                                  b["height"])
        return {"accept": bool(ok)}
    if method == _M_INIT_CHAIN:
        vals = [ValidatorUpdate(v["type"], _unhx(v["pub_key"]),
                                v["power"])
                for v in b.get("validators", [])]
        updates, app_hash = app.init_chain(
            b["chain_id"], b["initial_height"], vals,
            _unhx(b["app_state"]))
        return {"app_hash": _hx(app_hash),
                "updates": [{"type": u.pub_key_type,
                             "pub_key": _hx(u.pub_key_bytes),
                             "power": u.power} for u in updates]}
    if method == _M_FINALIZE:
        req = RequestFinalizeBlock(
            txs=[_unhx(t) for t in b["txs"]],
            height=b["height"],
            time=Timestamp(b["time_s"], b["time_ns"]),
            proposer_address=_unhx(b["proposer"]),
            hash=_unhx(b["hash"]),
            next_validators_hash=_unhx(b["next_vals"]))
        r = app.finalize_block(req)
        return json.loads(r.encode())
    if method == _M_COMMIT:
        r = app.commit()
        return {"retain_height": r.retain_height}
    if method == _M_QUERY:
        code, value = app.query(b["path"], _unhx(b["data"]))
        return {"code": code, "value": _hx(value)}
    if method == _M_QUERY_PROVE:
        from ..rpc.codec import proof_json
        code, value, height, pf = app.query_prove(
            b["path"], _unhx(b["data"]))
        out = {"code": code, "value": _hx(value), "height": height}
        if pf is not None:
            out["proof"] = proof_json(pf)
        return out
    if method == _M_LIST_SNAPSHOTS:
        return {"snapshots": [
            {"height": s.height, "format": s.format,
             "chunks": s.chunks, "hash": _hx(s.hash),
             "metadata": _hx(s.metadata)}
            for s in app.list_snapshots()]}
    if method == _M_LOAD_SNAPSHOT_CHUNK:
        return {"chunk": _hx(app.load_snapshot_chunk(
            b["height"], b["format"], b["chunk"]))}
    if method == _M_OFFER_SNAPSHOT:
        from .application import Snapshot
        snap = Snapshot(b["snapshot"]["height"],
                        b["snapshot"]["format"],
                        b["snapshot"]["chunks"],
                        _unhx(b["snapshot"]["hash"]),
                        _unhx(b["snapshot"]["metadata"]))
        return {"result": app.offer_snapshot(
            snap, _unhx(b["app_hash"]))}
    if method == _M_APPLY_SNAPSHOT_CHUNK:
        return {"result": app.apply_snapshot_chunk(
            b["index"], _unhx(b["chunk"]), b["sender"])}
    if method == _M_EXTEND_VOTE:
        return {"extension": _hx(app.extend_vote(
            b["height"], b["round"]))}
    if method == _M_VERIFY_VOTE_EXT:
        return {"ok": bool(app.verify_vote_extension(
            b["height"], _unhx(b["addr"]), _unhx(b["ext"])))}
    raise ValueError(f"unknown ABCI method {method}")


class ABCIServer:
    """Hosts an Application for remote consensus engines (reference
    abci/server/socket_server.go)."""

    def __init__(self, app: Application, host: str = "127.0.0.1",
                 port: int = 0):
        self.app = app
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(8)
        self.addr = self._listener.getsockname()
        self._stop = threading.Event()
        # one lock across connections: the app sees a serialized request
        # stream even with 4 named connections (the reference's apps
        # rely on the same global ordering)
        self._app_lock = threading.Lock()
        self._accept_thread: Optional[threading.Thread] = None
        self._conns: dict = {}        # accepted socket -> its thread
        self._conns_lock = threading.Lock()

    def start(self) -> None:
        def accept_loop():
            while not self._stop.is_set():
                try:
                    conn, _ = self._listener.accept()
                except OSError:
                    return
                t = threading.Thread(target=self._serve_conn, args=(conn,),
                                     name="abci-conn", daemon=True)
                with self._conns_lock:
                    if self._stop.is_set():
                        conn.close()
                        return
                    self._conns[conn] = t
                t.start()
        self._accept_thread = threading.Thread(
            target=accept_loop, name="abci-accept", daemon=True)
        self._accept_thread.start()

    def _serve_conn(self, conn) -> None:
        reader = _Reader(conn)
        try:
            while not self._stop.is_set():
                method, body = reader.read_msg()
                with self._app_lock:
                    resp = self._handle(method, body)
                _send_msg(conn, method, resp)
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _handle(self, method: int, b: dict) -> dict:
        return dispatch_request(self.app, method, b)

    def stop(self) -> None:
        """Closes the listener and every accepted connection, and joins
        the accept thread and each connection's thread."""
        self._stop.set()
        try:
            # shutdown wakes the accept(); close alone does not
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
        with self._conns_lock:
            conns = list(self._conns.items())
            self._conns.clear()
        for conn, _t in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)  # wakes its recv()
            except OSError:
                pass
        for _conn, t in conns:
            t.join(timeout=5)


class AppClientCodec:
    """Application-shaped client over an abstract `_call(method, body)`
    transport. SocketClient supplies the framed-socket transport below;
    GRPCClient (abci/grpc.py) supplies the gRPC one — consumers
    (BlockExecutor, mempool, proxy) cannot tell either from an
    in-process app."""

    def _call(self, method: int, body: dict) -> dict:
        raise NotImplementedError

    # --- Application interface ------------------------------------------------

    def echo(self, msg: str) -> str:
        return self._call(_M_ECHO, {"msg": msg})["msg"]

    def info(self) -> ResponseInfo:
        r = self._call(_M_INFO, {})
        return ResponseInfo(r["data"], r["version"], r["app_version"],
                            r["last_block_height"],
                            _unhx(r["last_block_app_hash"]))

    def check_tx(self, tx: bytes) -> CheckTxResult:
        r = self._call(_M_CHECK_TX, {"tx": _hx(tx)})
        return CheckTxResult(code=r["code"], gas_wanted=r["gas_wanted"],
                             log=r["log"])

    def init_chain(self, chain_id, initial_height, validators,
                   app_state_bytes):
        vals = []
        for v in validators or []:
            if hasattr(v, "pub_key_bytes"):       # ValidatorUpdate
                vals.append({"type": v.pub_key_type,
                             "pub_key": _hx(v.pub_key_bytes),
                             "power": v.power})
            else:                                  # types.Validator
                vals.append({"type": v.pub_key.type_(),
                             "pub_key": _hx(v.pub_key.bytes_()),
                             "power": v.voting_power})
        r = self._call(_M_INIT_CHAIN, {
            "chain_id": chain_id, "initial_height": initial_height,
            "validators": vals, "app_state": _hx(app_state_bytes)})
        updates = [ValidatorUpdate(u["type"], _unhx(u["pub_key"]),
                                   u["power"]) for u in r["updates"]]
        return updates, _unhx(r["app_hash"])

    def prepare_proposal(self, txs, max_tx_bytes,
                         local_last_commit=None):
        llc = None
        if local_last_commit is not None:
            llc = [{"index": i, "address": _hx(a), "extension": _hx(e)}
                   for i, a, e in local_last_commit]
        r = self._call(_M_PREPARE, {
            "txs": [_hx(t) for t in txs], "max_tx_bytes": max_tx_bytes,
            "local_last_commit": llc})
        return [_unhx(t) for t in r["txs"]]

    def process_proposal(self, txs, height) -> bool:
        return self._call(_M_PROCESS, {"txs": [_hx(t) for t in txs],
                                       "height": height})["accept"]

    def finalize_block(self, req: RequestFinalizeBlock
                       ) -> ResponseFinalizeBlock:
        r = self._call(_M_FINALIZE, {
            "txs": [_hx(t) for t in req.txs], "height": req.height,
            "time_s": req.time.seconds, "time_ns": req.time.nanos,
            "proposer": _hx(req.proposer_address), "hash": _hx(req.hash),
            "next_vals": _hx(req.next_validators_hash)})
        return ResponseFinalizeBlock.decode(json.dumps(r).encode())

    def commit(self) -> ResponseCommit:
        return ResponseCommit(
            self._call(_M_COMMIT, {})["retain_height"])

    def query(self, path: str, data: bytes):
        r = self._call(_M_QUERY, {"path": path, "data": _hx(data)})
        return r["code"], _unhx(r["value"])

    def query_prove(self, path: str, data: bytes):
        from ..rpc.codec import proof_from_json
        r = self._call(_M_QUERY_PROVE, {"path": path, "data": _hx(data)})
        return (r["code"], _unhx(r["value"]), r["height"],
                proof_from_json(r.get("proof")))

    # --- snapshot connection (reference abci/client socket flavor) -------

    def list_snapshots(self):
        from .application import Snapshot
        r = self._call(_M_LIST_SNAPSHOTS, {})
        return [Snapshot(s["height"], s["format"], s["chunks"],
                         _unhx(s["hash"]), _unhx(s["metadata"]))
                for s in r["snapshots"]]

    def load_snapshot_chunk(self, height: int, format_: int,
                            chunk: int) -> bytes:
        return _unhx(self._call(_M_LOAD_SNAPSHOT_CHUNK, {
            "height": height, "format": format_, "chunk": chunk})["chunk"])

    def offer_snapshot(self, snapshot, app_hash: bytes) -> str:
        return self._call(_M_OFFER_SNAPSHOT, {
            "snapshot": {"height": snapshot.height,
                         "format": snapshot.format,
                         "chunks": snapshot.chunks,
                         "hash": _hx(snapshot.hash),
                         "metadata": _hx(snapshot.metadata)},
            "app_hash": _hx(app_hash)})["result"]

    def apply_snapshot_chunk(self, index: int, chunk: bytes,
                             sender: str) -> str:
        return self._call(_M_APPLY_SNAPSHOT_CHUNK, {
            "index": index, "chunk": _hx(chunk),
            "sender": sender})["result"]

    def extend_vote(self, height: int, round_: int) -> bytes:
        return _unhx(self._call(_M_EXTEND_VOTE, {
            "height": height, "round": round_})["extension"])

    def verify_vote_extension(self, height: int, addr: bytes,
                              ext: bytes) -> bool:
        return bool(self._call(_M_VERIFY_VOTE_EXT, {
            "height": height, "addr": _hx(addr),
            "ext": _hx(ext)})["ok"])


class SocketClient(AppClientCodec):
    """Framed-socket transport for AppClientCodec (reference
    abci/client/socket_client.go)."""

    def __init__(self, host: str, port: int,
                 connect_retry_s: float = 30.0):
        # retry the dial: under a process supervisor the app routinely
        # comes up a moment after the node (the reference socket client
        # retries the same way)
        # deliberately wall clock: retries a REAL TCP connect to an
        # external app process — under a virtual clock this loop could
        # never time out
        deadline = time.monotonic() + connect_retry_s
        while True:
            try:
                self._sock = socket.create_connection((host, port),
                                                      timeout=5)
                break
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.5)
        # blocking from here on: a per-call timeout would desynchronize
        # the request/response stream (a late response to a timed-out
        # call gets read as the answer to the NEXT call — silent wrong
        # state if the method ids happen to match). Slow ABCI calls
        # (long finalize_block) must block, not corrupt.
        self._sock.settimeout(None)
        self._reader = _Reader(self._sock)
        self._lock = threading.Lock()

    def _call(self, method: int, body: dict) -> dict:
        with self._lock:
            _send_msg(self._sock, method, body)
            got_method, resp = self._reader.read_msg()
            if got_method != method:
                raise ConnectionError(
                    f"out-of-order ABCI response {got_method} != {method}")
            return resp

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
