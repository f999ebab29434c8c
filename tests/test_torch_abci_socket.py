"""ABCI over a socket in the port (`abci/socket.py`, `abci/grammar.py`,
`proxy/multi_app_conn.remote_client_creator`, `cmd abci-cli`), held
against the JAX package on the CPU:

- every method's request and response frames, from one scripted session
  through each package's `AppClientCodec`, `_send_msg` and
  `dispatch_request` over a fresh kvstore, are byte-identical;
- a port `SocketClient` against a JAX `ABCIServer` and the reverse give
  the answers of the port's client on the port's server, and a stopped
  server leaves no thread behind;
- a port node and a JAX node with `proxy_app = tcp://`, each on its own
  package's `ABCIServer` over a `RecordingApp`, replay the seeded 6-block
  chain in their handshakes to the same app hash and the same recorded
  calls;
- `check_sequence` gives the JAX package's verdict, position and
  expectation on clean-start, statesync and recovery traces and on
  broken ones;
- `abci-cli echo`, `info`, `query` and `check_tx` print what the JAX CLI
  prints.

No tolerance: frames, answers and printed lines are compared exactly.
"""

import json
import threading

import pytest
import torch

from _torch_node import dev, mod, port_chain, write_home

SIDES = ("jax", "port")
METHODS = ("echo", "info", "check_tx", "prepare", "process", "finalize",
           "commit", "query", "init_chain", "flush", "query_prove",
           "list_snapshots", "load_snapshot_chunk", "offer_snapshot",
           "apply_snapshot_chunk", "extend_vote", "verify_vote_ext")

torch.set_num_threads(1)


class _Sink:
    def __init__(self, data: bytes = b""):
        self.buf = data

    def sendall(self, b: bytes) -> None:
        self.buf += b

    def recv(self, n: int) -> bytes:
        out, self.buf = self.buf[:n], self.buf[n:]
        return out


def _script(side, c) -> list:
    """Every ABCI method through the client `c`, in a legal order, on a
    fresh kvstore -> the answers as plain values."""
    app_mod = mod(side, "abci.application")
    proto = mod(side, "types.proto")
    out = [c.echo("hello"), tuple(vars(c.info()).values())]
    upd = app_mod.ValidatorUpdate("ed25519", bytes(range(32)), 10)
    out.append(c.init_chain("abci-chain", 1, [upd], b""))
    out += [vars(c.check_tx(t)) for t in (b"a=1", b"", b"bad\xff")]
    for h in range(1, 6):
        txs = [f"k{h}=v{h}".encode(), f"x{h}=y".encode()]
        llc = [(0, b"\x01" * 20, b"ext")] if h == 2 else None
        out.append(c.prepare_proposal(txs, 1 << 20, local_last_commit=llc))
        out.append(c.process_proposal(txs, h))
        r = c.finalize_block(app_mod.RequestFinalizeBlock(
            txs=txs, height=h, time=proto.Timestamp(1_700_000_000 + h, 7),
            proposer_address=b"\x02" * 20, hash=bytes([h]) * 32,
            next_validators_hash=b"\x03" * 32))
        out.append(r.encode())
        out.append(c.commit().retain_height)
    out.append(c.query("/store", b"k1"))
    for key in (b"k2", b"k0"):
        code, value, height, pf = c.query_prove("/store", key)
        out.append((code, value, height, type(pf).__name__,
                    json.dumps(mod(side, "rpc.codec").proof_json(pf))))
    snaps = c.list_snapshots()
    out.append([tuple(vars(s).values()) for s in snaps])
    chunk = c.load_snapshot_chunk(5, 1, 0)
    out.append(chunk)
    out.append(c.offer_snapshot(snaps[0], c.info().last_block_app_hash))
    out.append(c.apply_snapshot_chunk(0, chunk, "peer"))
    out.append(c.extend_vote(6, 0))
    out.append(c.verify_vote_extension(6, b"\x01" * 20, b"ext"))
    return out


@pytest.fixture(scope="module")
def frames():
    """side -> {method id: [request + response frame bytes]}, and the
    scripted answers."""
    out = {}
    for side in SIDES:
        sock = mod(side, "abci.socket")
        app = mod(side, "abci.kvstore").KVStoreApplication()
        got: dict = {}

        class Recorded(sock.AppClientCodec):
            def _call(self, method, body):
                req, resp = _Sink(), _Sink()
                sock._send_msg(req, method, body)
                m, b = sock._Reader(_Sink(req.buf)).read_msg()
                sock._send_msg(resp, m, sock.dispatch_request(app, m, b))
                got.setdefault(method, []).append(req.buf + resp.buf)
                return sock._Reader(_Sink(resp.buf)).read_msg()[1]
        c = Recorded()
        answers = _script(side, c)
        c._call(sock._M_FLUSH, {"x": 1})
        out[side] = (got, answers)
    return out


@pytest.mark.parametrize("method", range(len(METHODS)),
                         ids=list(METHODS))
def test_frames_byte_identical(frames, method):
    assert mod("port", "abci.socket")._M_FLUSH == METHODS.index("flush")
    port, jax = frames["port"][0], frames["jax"][0]
    assert port.get(method) and port[method] == jax[method]


def _answers_over_tcp(server_side, client_side) -> list:
    before = {t.ident for t in threading.enumerate()}
    server = mod(server_side, "abci.socket").ABCIServer(
        mod(server_side, "abci.kvstore").KVStoreApplication())
    server.start()
    client = mod(client_side, "abci.socket").SocketClient(*server.addr)
    try:
        out = _script(client_side, client)
    finally:
        client.close()
        server.stop()
    if server_side == "port":   # the JAX server does not join its own
        assert not [t for t in threading.enumerate()
                    if t.ident not in before and t.name.startswith("abci")]
    return out


@pytest.mark.parametrize("server_side,client_side",
                         [("jax", "port"), ("port", "jax")])
def test_client_and_server_across_packages(frames, server_side,
                                           client_side):
    same = _answers_over_tcp("port", "port")
    assert same == frames["port"][1]
    assert _answers_over_tcp(server_side, client_side) == \
        (same if client_side == "port" else frames["jax"][1])


def test_port_server_stop_joins_its_threads():
    sock = mod("port", "abci.socket")
    before = set(threading.enumerate())
    server = sock.ABCIServer(mod("port", "abci.kvstore").KVStoreApplication())
    server.start()
    clients = [sock.SocketClient(*server.addr) for _ in range(4)]
    assert clients[0].echo("x") == "x"
    server.stop()
    assert not [t for t in threading.enumerate()
                if t not in before and t.name in ("abci-accept",
                                                  "abci-conn")]
    for c in clients:
        c.close()


@pytest.fixture(scope="module")
def chain():
    return port_chain(6, n_validators=4, seed=3)


def test_remote_app_nodes_reach_the_same_app_hash(tmp_path, chain):
    """`proxy_app = tcp://` in both packages: each node's handshake
    replays the 6 blocks through the socket into its package's
    ABCIServer; the app hashes, the recorded calls and their grammar
    verdicts agree."""
    got = {}
    for side in SIDES:
        app = mod(side, "abci.grammar").RecordingApp(
            mod(side, "abci.kvstore").KVStoreApplication())
        server = mod(side, "abci.socket").ABCIServer(app)
        server.start()
        home = str(tmp_path / side)
        write_home(side, home, chain, 6)
        cfg = mod(side, "config").Config.load(home)
        cfg.base.block_sync = False
        cfg.rpc.enable = False
        cfg.p2p.laddr = "127.0.0.1:0"
        cfg.base.proxy_app = f"tcp://{server.addr[0]}:{server.addr[1]}"
        try:
            nd = mod(side, "node.node").Node(cfg, **dev(side))
            info = nd.app_conns.query.info()
            got[side] = (info.last_block_height, info.last_block_app_hash,
                         nd.consensus.state.app_hash, list(app.calls),
                         app.check())
            nd.start()
            nd.stop()
        finally:
            server.stop()
    assert got["port"][:4] == got["jax"][:4]
    assert got["port"][0] == 6 and got["port"][1] == got["port"][2]
    assert got["port"][3] == ["init_chain"] + ["finalize_block",
                                               "commit"] * 6
    assert got["port"][4] == (True, None) and got["jax"][4][0]


TRACES = {
    "clean_start": (["init_chain", "prepare_proposal", "process_proposal",
                     "finalize_block", "commit", "process_proposal",
                     "finalize_block", "commit"], True),
    "statesync": (["init_chain", "offer_snapshot", "offer_snapshot",
                   "apply_snapshot_chunk", "apply_snapshot_chunk",
                   "finalize_block", "commit", "finalize_block", "commit"],
                  True),
    "statesync_aborted_attempt": (["init_chain", "offer_snapshot",
                                   "apply_snapshot_chunk", "offer_snapshot",
                                   "apply_snapshot_chunk", "finalize_block",
                                   "commit"], True),
    "recovery": (["finalize_block", "commit", "prepare_proposal",
                  "finalize_block", "commit"], False),
    "vote_extensions_filtered": (["init_chain", "extend_vote",
                                  "finalize_block", "verify_vote_extension",
                                  "commit"], True),
    "commit_before_finalize": (["init_chain", "commit"], True),
    "no_init_chain": (["finalize_block", "commit"], True),
    "finalize_twice": (["init_chain", "finalize_block", "finalize_block",
                        "commit"], True),
    "offer_without_chunks": (["init_chain", "offer_snapshot",
                              "finalize_block", "commit"], True),
    "statesync_then_nothing": (["init_chain", "offer_snapshot",
                                "apply_snapshot_chunk"], True),
    "empty": ([], False),
    "trailing_prepare": (["finalize_block", "commit", "prepare_proposal"],
                         False),
}


def _verdict(side, calls, clean):
    ok, err = mod(side, "abci.grammar").check_sequence(calls, clean)
    return ok, None if err is None else (err.pos, err.got, err.expected,
                                         str(err))


@pytest.mark.parametrize("name", sorted(TRACES))
def test_grammar_verdicts_equal_jax(name):
    calls, clean = TRACES[name]
    assert _verdict("port", calls, clean) == _verdict("jax", calls, clean)


@pytest.fixture(scope="module")
def cli_server():
    app = mod("port", "abci.kvstore").KVStoreApplication()
    app.init_chain("cli", 1, [], b"")
    r = mod("port", "abci.application").RequestFinalizeBlock(
        txs=[b"k1=v1"], height=1,
        time=mod("port", "types.proto").Timestamp(1_700_000_001, 0),
        proposer_address=b"\x02" * 20)
    app.finalize_block(r)
    app.commit()
    server = mod("port", "abci.socket").ABCIServer(app)
    server.start()
    yield f"tcp://{server.addr[0]}:{server.addr[1]}"
    server.stop()


@pytest.mark.parametrize("argv", [["echo", "ping"], ["info"],
                                  ["query", "k1"], ["check_tx", "a=b"]],
                         ids=["echo", "info", "query", "check_tx"])
def test_abci_cli_prints_as_jax(cli_server, capsys, argv):
    printed = {}
    for side in SIDES:
        rc = mod(side, "cmd.main").main(["abci-cli", *argv,
                                         "--address", cli_server])
        printed[side] = (rc, capsys.readouterr().out)
    assert printed["port"] == printed["jax"]
    assert printed["port"][0] == 0 and printed["port"][1]
