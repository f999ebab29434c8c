"""The port's WebSocket endpoint (`rpc/websocket.py`, GET /websocket of
`rpc/server.py`) and sqlite indexer (`indexer/sqlite.py`), held against
the JAX package on the CPU:

- one scripted WebSocket session (the handshake, subscribe, a duplicate
  and a malformed subscription, NewBlock event frames, ping/pong,
  unsubscribe, unsubscribe_all, an unknown method, a non-JSON frame)
  receives byte-identical frames from a port and a JAX RPC server; the
  port's session outlives the server's per-request timeout and is closed
  by `RPCServer.stop()`, which then leaves no thread behind;
- the same events indexed into the port's and the JAX package's sqlite
  sinks give the same table rows, and `tx_search`/`block_search` pages
  equal to theirs and to the port's kv indexer for every operator of the
  query grammar (=, <, <=, >, >=, CONTAINS, EXISTS, AND).

No tolerance: bytes, rows and pages are compared exactly.
"""

import json
import threading
import time
import types

import pytest
import torch

from _torch_node import mod
from cometbft_tpu_torch.rpc.websocket import WSClient, frame_payload

SIDES = ("jax", "port")

torch.set_num_threads(1)


# --- WebSocket ------------------------------------------------------------

def _server(side, timeout_s=10.0):
    server = mod(side, "rpc.server")
    bus = mod(side, "pubsub.events").EventBus()
    srv = server.RPCServer(server.RPCEnvironment(chain_id="ws",
                                                 event_bus=bus),
                           "127.0.0.1", 0, timeout_s=timeout_s)
    srv.start()
    return srv, bus


def _connect(addr):
    c = WSClient(addr, key=b"0123456789abcdef")
    head = c.handshake()
    # the server's clock and version lines aside
    return c, b"\r\n".join(ln for ln in head.split(b"\r\n")
                           if not ln.startswith((b"Date:", b"Server:")))


def _json(frame: bytes):
    return json.loads(frame_payload(frame))


def _call(c, obj) -> bytes:
    c.send(json.dumps(obj).encode())
    return c.frame()


def _block(h):
    return types.SimpleNamespace(header=types.SimpleNamespace(height=h))


def _session(side) -> list:
    srv, bus = _server(side)
    try:
        s, head = _connect(srv.addr)
        frames = [head]
        new_block = "tm.event = 'NewBlock'"
        frames.append(_call(s, {"jsonrpc": "2.0", "id": 1,
                                "method": "subscribe",
                                "params": {"query": new_block}}))
        frames.append(_call(s, {"jsonrpc": "2.0", "id": 2,
                                "method": "subscribe",
                                "params": {"query": new_block}}))
        frames.append(_call(s, {"jsonrpc": "2.0", "id": 3,
                                "method": "subscribe",
                                "params": {"query": "tm.event =="}}))
        frames.append(_call(s, {"jsonrpc": "2.0", "id": 4,
                                "method": "subscribe",
                                "params": {"query": "block.height > 5"}}))
        for h in (4, 7):
            bus.publish_new_block(_block(h), None)
            # NewBlock at 4 matches one subscription, at 7 both
            frames += sorted(s.frame() for _ in range(1 if h == 4 else 2))
        bus.publish_new_block_header(_block(3).header)
        s.send(b"still-there", opcode=9)
        frames.append(s.frame())
        frames.append(_call(s, {"jsonrpc": "2.0", "id": 5,
                                "method": "unsubscribe",
                                "params": {"query": new_block}}))
        bus.publish_new_block(_block(2), None)     # nothing matches now
        frames.append(_call(s, {"jsonrpc": "2.0", "id": 6,
                                "method": "unsubscribe_all"}))
        bus.publish_new_block(_block(9), None)
        frames.append(_call(s, {"jsonrpc": "2.0", "id": 7,
                                "method": "bogus"}))
        s.send(b"{not json")
        frames.append(s.frame())
        s.close()
        return frames
    finally:
        srv.stop()


def test_websocket_session_frames_byte_identical():
    port, jax = _session("port"), _session("jax")
    assert port == jax
    assert len(port) == 13
    events = [_json(f) for f in port[5:8]]
    assert [e["params"]["attrs"]["block.height"] for e in events] == \
        [["4"], ["7"], ["7"]]


def test_port_session_outlives_the_request_timeout_and_stop_closes_it():
    before = set(threading.enumerate())
    srv, bus = _server("port", timeout_s=0.3)
    s, _head = _connect(srv.addr)
    reply = _call(s, {"jsonrpc": "2.0", "id": 1, "method": "subscribe",
                      "params": {"query": "tm.event = 'NewBlock'"}})
    assert _json(reply)["result"] == {}
    time.sleep(0.8)       # silent past the server's 0.3 s read timeout
    bus.publish_new_block(_block(5), None)
    event = _json(s.frame())
    assert event["params"]["attrs"]["block.height"] == ["5"]
    t0 = time.monotonic()
    srv.stop()
    assert time.monotonic() - t0 < 5
    s.sock.settimeout(5)
    assert s.sock.recv(1) == b""  # the session is closed
    s.close()
    left = [t for t in threading.enumerate() if t not in before]
    assert not left, left


# --- sqlite ---------------------------------------------------------------

class _Res:
    code = 0


def _populate(txi, bki) -> None:
    for h in range(1, 7):
        bki.index(h, {"block.height": [str(h)],
                      "reward.amount": [str(100 * h)],
                      "reward.denom": ["stake" if h % 2 else "atom"]})
        for i in range(3):
            txi.index(h, i, b"tx-%d-%d" % (h, i), _Res(),
                      {"tx.height": [str(h)],
                       "transfer.sender": [("alice", "bob", "carol")[i]],
                       "transfer.amount": [str(h * 10 + i)]})


@pytest.fixture(scope="module")
def sinks(tmp_path_factory):
    out = {}
    for side in SIDES:
        d = str(tmp_path_factory.mktemp(f"sqlite-{side}"))
        out[side] = mod(side, "indexer.sqlite").open_sqlite_indexers(d)
        out[side] += (d,)
        _populate(*out[side][:2])
    db = mod("port", "db.kv").MemDB()
    kv = mod("port", "indexer.kv")
    out["kv"] = (kv.TxIndexer(db), kv.BlockIndexer(db), None)
    _populate(*out["kv"][:2])
    yield out
    for side in SIDES:
        out[side][0].close()
        out[side][1].close()


def test_sqlite_rows_equal_jax(sinks):
    import sqlite3
    rows = {}
    for side in SIDES:
        conn = sqlite3.connect(f"{sinks[side][2]}/indexer.sqlite")
        rows[side] = {t: conn.execute(f"SELECT * FROM {t} ORDER BY "
                                      f"rowid").fetchall()
                      for t in ("tx_results", "tx_attributes",
                                "block_attributes")}
        conn.close()
    assert rows["port"] == rows["jax"]
    assert len(rows["port"]["tx_results"]) == 18


TX_QUERIES = [
    "tx.height = 2", "tx.height < 3", "tx.height <= 3", "tx.height > 4",
    "tx.height >= 5", "transfer.sender = 'alice'",
    "transfer.sender CONTAINS 'ar'", "transfer.amount EXISTS",
    "transfer.sender = 'bob' AND tx.height > 2",
    "transfer.amount >= 31 AND transfer.amount < 52",
    "transfer.sender = 'dave'",
]
BLOCK_QUERIES = [
    "block.height = 3", "block.height < 3", "block.height <= 3",
    "block.height > 4", "block.height >= 5", "reward.amount = 300",
    "reward.denom CONTAINS 'to'", "reward.amount EXISTS",
    "block.height >= 2 AND reward.denom = 'atom'", "reward.amount < 0",
]


def _routes(side, sink):
    """The RPC routes over the sink; a block_search page lists heights
    (there is no block store behind them)."""
    server = mod("port" if side == "kv" else side, "rpc.server")

    class Routes(server.Routes):
        def block(self, height=None):
            return height
    return Routes(server.RPCEnvironment(
        chain_id="idx", tx_indexer=sink[0], block_indexer=sink[1]))


def _pages(routes, route, query) -> list:
    fn = getattr(routes, route)
    return [fn(query=query, page=page, per_page=4, order_by=order)
            for order in ("asc", "desc") for page in (1, 2)]


@pytest.mark.parametrize("route,query",
                         [("tx_search", q) for q in TX_QUERIES] +
                         [("block_search", q) for q in BLOCK_QUERIES])
def test_search_pages_equal_jax_and_kv(sinks, route, query):
    got = {side: _pages(_routes(side, sinks[side]), route, query)
           for side in ("port", "jax", "kv")}
    assert got["port"] == got["jax"] == got["kv"]
