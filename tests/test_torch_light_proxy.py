"""The port's verifying light proxy (`light/rpc.py`: `VerifyingClient`,
`LightProxy`, `build_light_proxy`) held against the JAX package's on the
CPU. A JAX node and a port node serve copies of one home holding the
seeded 12-block, 4-validator chain; each package's proxy trusts height 1,
takes its own package's node as primary and the other as witness:

- `abci_query` (a present key with its proof, an absent key with its
  absence proof), `block`, `commit`, `validators` and `header` answer
  the same JSON from both proxies, equal to the primary's;
- over a one-route stub in front of the port node both proxies refuse a
  forged block, forged validators, a forged proof and a proofless empty
  value with -32001, and the port proxy keeps no fatal error;
- a kernel fault in a read (the commit route's verify raising
  `KernelCanaryError`) is answered -32603 and kept in `LightProxy.fatal`,
  on which `cmd light` exits 1.

Every commit holds 4 signatures: both light clients verify per signature
on the host. No tolerance: answers are compared exactly.
"""

import copy

import pytest
import torch

from _torch_node import mod, port_chain, rpc_addr, serving_node

SIDES = ("jax", "port")
CHAIN_LEN = 12
TRUST_PERIOD = 10**9

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def net(tmp_path_factory):
    chain = port_chain(CHAIN_LEN, n_validators=4, seed=5)
    servers = {}
    try:
        for side in SIDES:
            servers[side] = serving_node(
                side, str(tmp_path_factory.mktemp(f"lp-{side}")), chain,
                CHAIN_LEN)
        yield chain, servers
    finally:
        for nd in servers.values():
            nd.stop()


def _proxy(side, chain, primary: str, witness: str):
    """`side`'s light proxy over `primary` with one witness, started."""
    if side == "port":
        proxy = mod("port", "light.rpc").build_light_proxy(
            chain.chain_id, primary, [witness], trusted_height=1,
            trusted_hash=chain.blocks[0].hash().hex(),
            trust_period=TRUST_PERIOD, device="cpu")
    else:
        client = mod("jax", "light.client")
        provider = mod("jax", "light.provider")
        rpc = mod("jax", "rpc.client")
        lrpc = mod("jax", "light.rpc")

        def dial(addr):
            host, _, port = addr.rpartition(":")
            return rpc.RPCClient(host, int(port))
        light = client.LightClient(
            chain.chain_id,
            client.TrustOptions(TRUST_PERIOD, 1, chain.blocks[0].hash()),
            provider.HTTPProvider(chain.chain_id, dial(primary)),
            [provider.HTTPProvider(chain.chain_id, dial(witness))],
            mod("jax", "light.store").LightStore(mod("jax", "db.kv").MemDB()))
        proxy = lrpc.LightProxy(lrpc.VerifyingClient(light, dial(primary)))
    proxy.start()
    return proxy


def _client(proxy):
    return mod("port", "rpc.client").RPCClient(*proxy.addr)


def _key(chain) -> bytes:
    """A key the chain's third block wrote (the proofs are against the
    app's previous committed state, height 11)."""
    return chain.blocks[2].data.txs[0].split(b"=")[0]


READS = {
    "abci_query_present": ("abci_query", "present"),
    "abci_query_absent": ("abci_query", "absent"),
    "block_5": ("block", {"height": 5}),
    "block_12": ("block", {"height": 12}),
    "commit_5": ("commit", {"height": 5}),
    "commit_11": ("commit", {"height": 11}),
    "validators_5": ("validators", {"height": 5}),
    "validators_11": ("validators", {"height": 11}),
    "header_7": ("header", {"height": 7}),
}


@pytest.fixture(scope="module")
def proxies(net):
    chain, servers = net
    out = {}
    try:
        for side in SIDES:
            other = "jax" if side == "port" else "port"
            out[side] = _proxy(side, chain, rpc_addr(servers[side]),
                               rpc_addr(servers[other]))
        yield out
    finally:
        for p in out.values():
            p.stop()


def _params(chain, spec):
    if spec == "present":
        return {"path": "/store", "data": _key(chain).hex()}
    if spec == "absent":
        return {"path": "/store", "data": b"no-such-key".hex()}
    return spec


@pytest.mark.parametrize("name", sorted(READS))
def test_verified_reads_equal_jax(net, proxies, name):
    chain, servers = net
    method, spec = READS[name]
    params = _params(chain, spec)
    got = {side: _client(proxies[side]).call(method, **params)
           for side in SIDES}
    assert got["port"] == got["jax"]
    direct = mod("port", "rpc.client").RPCClient(*servers["port"]
                                                 .rpc_server.addr)
    if method == "abci_query":
        want = direct.abci_query_prove(params["path"],
                                       bytes.fromhex(params["data"]))
    else:
        want = direct.call(method, **params)
    assert got["port"] == want
    if spec == "present":
        assert got["port"]["value"] and got["port"]["proof"]
    assert proxies["port"].fatal is None


def _forge_block(r):
    r = copy.deepcopy(r)
    r["block"]["data"]["txs"][0] = b"forged=1".hex()
    return r


def _forge_validators(r):
    r = copy.deepcopy(r)
    r["validators"][0]["voting_power"] = \
        int(r["validators"][0]["voting_power"]) + 1
    return r


def _forge_proof(r):
    r = copy.deepcopy(r)
    r["value"] = b"forged".hex()
    return r


def _forge_proofless(r):
    r = {k: v for k, v in r.items() if k != "proof"}
    r["value"] = ""
    return r


FORGERIES = {
    "block": ("block", _forge_block, {"height": 6}),
    "validators": ("validators", _forge_validators, {"height": 6}),
    "proof": ("abci_query", _forge_proof, "present"),
    "proofless_empty_value": ("abci_query", _forge_proofless, "present"),
}


def _stub(servers, route):
    """A port RPC server answering as the port node, but with the first
    answer of `route`'s method at the forged height (or any height for
    abci_query) forged: the proxy's own read is the first; the light
    client's later fetch of the same light block stays honest."""
    rpc_server = mod("port", "rpc.server")
    real = mod("port", "rpc.client").RPCClient(*servers["port"]
                                               .rpc_server.addr)
    method, forge, spec = FORGERIES[route]
    forged = []

    def forging(**kw):
        r = real.call(method, **kw)
        if not forged and (spec == "present" or
                           int(kw.get("height", 0)) == spec["height"]):
            forged.append(kw)
            return forge(r)
        return r
    methods = {n: (lambda n=n: lambda **kw: real.call(n, **kw))()
               for n in ("health", "status", "block", "commit", "header",
                         "validators", "abci_query")}
    methods[method] = forging
    srv = rpc_server.RPCServer(None, "127.0.0.1", 0, methods=methods)
    srv.start()
    return srv


@pytest.mark.parametrize("route", sorted(FORGERIES))
def test_forged_answers_refused_like_jax(net, route):
    chain, servers = net
    method, _forge, spec = FORGERIES[route]
    errors = {}
    for side in SIDES:
        stub = _stub(servers, route)
        proxy = _proxy(side, chain, "%s:%d" % stub.addr,
                       rpc_addr(servers["jax"]))
        try:
            with pytest.raises(Exception) as e:
                _client(proxy).call(method, **_params(chain, spec))
            errors[side] = str(e.value).split(":")[0]
            if side == "port":
                assert proxy.fatal is None
        finally:
            proxy.stop()
            stub.stop()
    assert errors["port"] == errors["jax"] == "-32001"


def test_kernel_fault_in_a_read_is_fatal(net, monkeypatch, capsys):
    from cometbft_tpu_torch.ops.ed25519 import KernelCanaryError
    from cometbft_tpu_torch.types import validation
    chain, servers = net
    fault = KernelCanaryError("canary lane accepted")
    real = validation.verify_commit_light

    def verify(chain_id, vals, block_id, height, *a, **kw):
        if height == 9:
            raise fault
        return real(chain_id, vals, block_id, height, *a, **kw)
    monkeypatch.setattr(validation, "verify_commit_light", verify)
    proxy = _proxy("port", chain, rpc_addr(servers["port"]),
                   rpc_addr(servers["jax"]))
    try:
        with pytest.raises(Exception) as e:
            _client(proxy).call("commit", height=9)
        assert str(e.value).startswith("-32603")
        assert proxy.fatal is fault
    finally:
        proxy.stop()
    # the command stops on it and exits 1
    lrpc = mod("port", "light.rpc")
    real_build = lrpc.build_light_proxy
    built = []

    def build(*a, **kw):
        built.append(real_build(*a, **kw))
        built[0].fatal = fault
        return built[0]
    monkeypatch.setattr(lrpc, "build_light_proxy", build)
    rc = mod("port", "cmd.main").main([
        "light", chain.chain_id, "--primary", rpc_addr(servers["port"]),
        "--witnesses", rpc_addr(servers["jax"]), "--trusted-height", "1",
        "--trusted-hash", chain.blocks[0].hash().hex(), "--trust-period",
        str(TRUST_PERIOD), "--device", "cpu"])
    assert rc == 1
    assert "light proxy failed" in capsys.readouterr().err
