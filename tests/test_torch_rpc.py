"""The port's JSON-RPC server and client (`cometbft_tpu_torch/rpc/`), held
against the JAX package on the CPU.

One home is written (the port's `generate_chain`: 6 blocks, 4
validators, 3 txs a block, FileDB stores at height 6) and copied twice;
each package's `reindex` command builds its copy's indexes, and a JAX
`Node` and a port `Node` (block sync off, not started: only their RPC
servers serve) open a copy each, replaying the 6 blocks into a fresh
kvstore in their handshakes. The port's `RPCClient` then asks both:

- every read route gives equal JSON (`status` without its node-identity
  and clock fields), and the proof of `tx` verifies against the
  header's `data_hash`;
- bad parameters give the same error codes and messages;
- the unsafe routes are gated by `[rpc] unsafe` as in the JAX package;
- CORS answers and TLS serving are the same.

Results are JSON and error codes: no tolerance.
"""

import os
import shutil
import subprocess

import pytest

from _torch_node import mod, port_chain, write_home

SIDES = ("jax", "port")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rpc")
    chain = port_chain(6, n_validators=4, seed=5, txs_per_block=3)
    src = str(tmp / "src")
    write_home("port", src, chain, 6)
    nodes, clients = {}, {}
    from cometbft_tpu_torch.rpc.client import RPCClient
    try:
        for side in SIDES:
            home = str(tmp / side)
            shutil.copytree(src, home)
            assert mod(side, "cmd.main").main(
                ["reindex", "--home", home]) == 0
            config = mod(side, "config")
            cfg = config.Config.load(home)
            cfg.base.block_sync = False
            cfg.rpc.laddr = "127.0.0.1:0"
            cfg.p2p.laddr = "127.0.0.1:0"
            node = mod(side, "node.node").Node(
                cfg, **({"device": "cpu"} if side == "port" else {}))
            node.rpc_server.start()
            nodes[side] = node
            clients[side] = RPCClient(*node.rpc_server.addr, timeout=30)
        yield chain, nodes, clients
    finally:
        for node in nodes.values():
            node.stop()


def _call(client, method, **params):
    from cometbft_tpu_torch.rpc.client import RPCClientError
    try:
        return ("ok", client.call(method, **params))
    except RPCClientError as e:
        return ("error", str(e))


def _tx_hash(chain, height: int, index: int) -> str:
    from cometbft_tpu_torch.types.block import tx_hash
    return tx_hash(chain.blocks[height - 1].data.txs[index]).hex().upper()


def _h3(chain) -> str:
    return chain.blocks[2].hash().hex()


# (method, params) or (method, params of the chain)
ROUTES = [
    ("block", {"height": 3}), ("block", {}),
    ("blockchain", {"min_height": 2, "max_height": 5}),
    ("blockchain", {}),
    ("commit", {"height": 3}), ("commit", {"height": 6}),
    ("commit", {}),
    ("header", {"height": 2}), ("header", {}),
    ("header_by_hash", lambda c: {"hash": _h3(c)}),
    ("block_by_hash", lambda c: {"hash": _h3(c)}),
    ("block_results", {"height": 2}), ("block_results", {}),
    ("validators", {"height": 1}),
    ("validators", {"height": 2, "page": 1, "per_page": 3}),
    ("validators", {"height": 2, "page": 2, "per_page": 3}),
    ("genesis", {}), ("genesis_chunked", {"chunk": 0}),
    ("consensus_params", {"height": 2}), ("consensus_params", {}),
    ("abci_info", {}),
    ("abci_query", {"path": "/store", "data": b"k2-1".hex()}),
    ("abci_query", {"path": "/store", "data": b"k4-0".hex(),
                    "prove": True}),
    ("abci_query", {"path": "/store", "data": b"absent".hex(),
                    "prove": True}),
    ("tx", lambda c: {"hash": _tx_hash(c, 4, 1), "prove": True}),
    ("tx", lambda c: {"hash": _tx_hash(c, 2, 0)}),
    ("tx_search", {"query": "tx.height > 2", "per_page": 4,
                   "page": 2}),
    ("tx_search", {"query": "tx.height >= 1", "order_by": "desc"}),
    ("block_search", {"query": "block.height > 3"}),
    ("check_tx", {"tx": b"fresh=tx".hex()}),
    ("check_tx", {"tx": b"no-equals-sign".hex()}),
    ("num_unconfirmed_txs", {}), ("unconfirmed_txs", {}),
    ("health", {}),
    # bad parameters
    ("block", {"height": 99}), ("block", {"height": "abc"}),
    ("commit", {"height": 0}), ("header", {"height": -3}),
    ("blockchain", {"min_height": 5, "max_height": 2}),
    ("validators", {"height": 99}),
    ("validators", {"height": 1, "page": 9, "per_page": 3}),
    ("block_results", {"height": 42}),
    ("block_by_hash", {"hash": "zz"}),
    ("header_by_hash", {"hash": "00" * 32}),
    ("tx", {"hash": "zz"}), ("tx", {"hash": "00" * 32}),
    ("tx_search", {"query": "tx.height >"}),
    ("block_search", {"query": ""}),
    ("abci_query", {"path": "/store", "data": "xyz"}),
    ("genesis_chunked", {"chunk": 7}),
    ("consensus_params", {"height": 77}),
    ("no_such_route", {}),
    ("broadcast_evidence", {"evidence": "deadbeef"}),
    ("unsafe_flush_mempool", {}), ("dial_peers", {"peers": "x:1"}),
    ("light_status", {}), ("seal_status", {}),
]


@pytest.mark.parametrize("case", range(len(ROUTES)),
                         ids=[f"{i}-{m}" for i, (m, _) in enumerate(ROUTES)])
def test_route_answers_match(served, case):
    chain, _nodes, clients = served
    method, params = ROUTES[case]
    if callable(params):
        params = params(chain)
    assert _call(clients["jax"], method, **params) == \
        _call(clients["port"], method, **params)


def _status_core(st: dict) -> dict:
    st = dict(st)
    st.pop("node_info", None)
    st.pop("validator_info", None)
    sync = dict(st.pop("sync_info"))
    for k in list(sync):
        if "time" in k:
            sync.pop(k)
    st["sync_info"] = sync
    return st


def test_status_matches_without_identity_and_clock(served):
    chain, _nodes, clients = served
    out = {s: _status_core(clients[s].status()) for s in SIDES}
    assert out["jax"] == out["port"]
    assert out["port"]["sync_info"]["latest_block_height"] == 6
    assert out["port"]["sync_info"]["latest_block_hash"] == \
        chain.blocks[5].hash().hex()


def test_tx_proof_verifies_against_data_hash(served):
    chain, _nodes, clients = served
    from cometbft_tpu_torch.rpc.codec import proof_from_json
    from cometbft_tpu_torch.types.block import tx_hash
    t = clients["port"].call("tx", hash=_tx_hash(chain, 5, 2), prove=True)
    proof = proof_from_json(t["proof"]["proof"])
    raw = bytes.fromhex(t["tx"])
    assert proof.verify(bytes.fromhex(t["proof"]["root_hash"]),
                        tx_hash(raw))
    assert chain.blocks[4].header.data_hash.hex() == t["proof"]["root_hash"]


def test_handshake_replayed_both_apps_to_the_chain(served):
    chain, nodes, clients = served
    info = {s: clients[s].call("abci_info") for s in SIDES}
    assert info["jax"] == info["port"]
    assert nodes["port"].consensus.state.app_hash == \
        nodes["jax"].consensus.state.app_hash
    assert nodes["port"].consensus.state.last_block_height == 6


@pytest.mark.parametrize("unsafe", [False, True])
def test_unsafe_routes_gated_as_in_jax(unsafe):
    from cometbft_tpu_torch.rpc.client import RPCClient
    out = {}
    for side in SIDES:
        server = mod(side, "rpc.server")
        mempool = mod(side, "mempool.mempool").CListMempool(
            lambda tx: (0, 0))
        srv = server.RPCServer(server.RPCEnvironment(
            chain_id="gate", mempool=mempool, unsafe=unsafe), "127.0.0.1",
            0)
        srv.start()
        try:
            c = RPCClient(*srv.addr, timeout=30)
            out[side] = [_call(c, m) for m in (
                "unsafe_flush_mempool", "dial_seeds", "dial_peers",
                "health")]
        finally:
            srv.stop()
    assert out["jax"] == out["port"]
    assert out["port"][3] == ("ok", {})
    assert (out["port"][0][0] == "ok") == unsafe


def _raw(addr, method: str, path: str, headers: dict, tls=None):
    import http.client
    if tls is None:
        conn = http.client.HTTPConnection(*addr, timeout=30)
    else:
        conn = http.client.HTTPSConnection(*addr, timeout=30, context=tls)
    try:
        conn.request(method, path, headers=headers)
        resp = conn.getresponse()
        body = resp.read()
        keep = {k.lower(): v for k, v in resp.getheaders()
                if k.lower().startswith("access-control") or
                k.lower() in ("vary", "content-type")}
        return resp.status, keep, body
    finally:
        conn.close()


@pytest.mark.parametrize("origin", ["https://a.example", "https://evil"])
def test_cors_answers_match(origin):
    out = {}
    for side in SIDES:
        server = mod(side, "rpc.server")
        srv = server.RPCServer(server.RPCEnvironment(chain_id="cors"),
                               "127.0.0.1", 0,
                               cors_origins="https://a.example",
                               cors_methods="GET,POST",
                               cors_headers="Content-Type")
        srv.start()
        try:
            out[side] = [_raw(srv.addr, verb, "/health",
                              {"Origin": origin})
                         for verb in ("OPTIONS", "GET")]
        finally:
            srv.stop()
    assert out["jax"] == out["port"]


def test_tls_serving_matches(tmp_path):
    import ssl
    key, cert = str(tmp_path / "k.pem"), str(tmp_path / "c.pem")
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048",
                    "-nodes", "-subj", "/CN=localhost", "-days", "1",
                    "-keyout", key, "-out", cert], check=True,
                   capture_output=True, timeout=60)
    ctx = ssl.create_default_context(cafile=cert)
    ctx.check_hostname = False
    out = {}
    for side in SIDES:
        server = mod(side, "rpc.server")
        srv = server.RPCServer(server.RPCEnvironment(chain_id="tls"),
                               "127.0.0.1", 0, tls_cert_file=cert,
                               tls_key_file=key)
        srv.start()
        try:
            assert srv.tls
            status, _h, body = _raw(srv.addr, "GET", "/health", {}, ctx)
            out[side] = (status, body)
        finally:
            srv.stop()
    assert out["jax"] == out["port"]
    assert out["port"][0] == 200
    assert os.path.exists(cert)
