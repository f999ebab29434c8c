"""The port's node configuration and files (`cometbft_tpu_torch/config.py`,
`node/node.py` save/load of genesis and node keys), held against the JAX
package on the CPU:

- a `config.toml` written by one package loads in the other with an
  equal `asdict`, both ways, and the default files are byte-identical;
- `validate_basic` rejects the same bad sections with the same message
  (the cases of tests/test_node.py:78-92 and one for each other check);
- genesis, node-key and FilePV files are byte-identical when written from
  the same keys, and each package reads the other's;
- every branch the port has not ported raises NotImplementedError naming
  its ROADMAP.md item at `Node` construction, and never falls back.

Results are dicts, bytes and exception types: no tolerance.
"""

import dataclasses
import json
import os

import pytest

from _torch_node import mod, write_validators

SIDES = ("jax", "port")
BOTH_WAYS = [("jax", "port"), ("port", "jax")]


def _custom(cfg):
    """Every section off its defaults (the values tests/test_node.py's
    round trip sets, and more)."""
    cfg.base.chain_id = "toml-chain"
    cfg.base.moniker = 'quoted "moniker"'
    cfg.base.db_backend = "filedb"
    cfg.p2p.persistent_peers = "127.0.0.1:1,127.0.0.1:2"
    cfg.rpc.cors_allowed_origins = "*"
    cfg.rpc.light_farm = True
    cfg.mempool.size = 99
    cfg.mempool.ingest_batch = True
    cfg.statesync.enable = True
    cfg.statesync.rpc_servers = "127.0.0.1:1,127.0.0.1:2"
    cfg.statesync.trust_height = 7
    cfg.statesync.trust_hash = "ab" * 32
    cfg.blocksync.pipeline_depth = 2
    cfg.blocksync.seal_sync = True
    cfg.device.probe_deadline_ms = 1234
    cfg.consensus.timeout_propose = 1234
    cfg.consensus.skip_timeout_commit = False
    cfg.storage.discard_abci_responses = True
    cfg.tx_index.indexer = "null"
    cfg.instrumentation.prometheus = True
    return cfg


@pytest.mark.parametrize("writer,reader", BOTH_WAYS)
def test_config_toml_loads_in_the_other_package(tmp_path, writer, reader):
    w = mod(writer, "config")
    r = mod(reader, "config")
    _custom(w.Config(root_dir=str(tmp_path))).write()
    loaded = r.Config.load(str(tmp_path))
    again = w.Config.load(str(tmp_path))
    assert dataclasses.asdict(loaded) == dataclasses.asdict(again)
    assert loaded.base.moniker == 'quoted "moniker"'
    assert loaded.statesync.trust_hash == "ab" * 32


@pytest.mark.parametrize("custom", [False, True])
def test_config_files_are_byte_identical(tmp_path, custom):
    texts = []
    for side in SIDES:
        cfg = mod(side, "config").Config(root_dir=str(tmp_path / side))
        if custom:
            _custom(cfg)
        with open(cfg.write(), "rb") as f:
            texts.append(f.read())
    assert texts[0] == texts[1]


BAD = {
    # tests/test_node.py:78-92
    "statesync_without_anchor": lambda c: setattr(c.statesync, "enable",
                                                  True),
    "unknown_indexer": lambda c: setattr(c.tx_index, "indexer", "elastic"),
    "unknown_blocksync_version": lambda c: setattr(c.blocksync, "version",
                                                   "v9"),
    # the other checks of validate_basic
    "empty_chain_id": lambda c: setattr(c.base, "chain_id", ""),
    "unknown_db_backend": lambda c: setattr(c.base, "db_backend", "rocks"),
    "unix_proxy_app": lambda c: setattr(c.base, "proxy_app",
                                        "unix:///tmp/app.sock"),
    "proxy_app_without_port": lambda c: setattr(c.base, "proxy_app",
                                                "tcp://host"),
    "negative_timeout": lambda c: setattr(c.consensus, "timeout_prevote",
                                          -1),
    "rpc_body_zero": lambda c: setattr(c.rpc, "max_body_bytes", 0),
    "rpc_timeout_zero": lambda c: setattr(c.rpc, "timeout_ms", 0),
    "tls_cert_without_key": lambda c: setattr(c.rpc, "tls_cert_file",
                                              "cert.pem"),
    "pipeline_depth_zero": lambda c: setattr(c.blocksync, "pipeline_depth",
                                             0),
    "pipeline_depth_65": lambda c: setattr(c.blocksync, "pipeline_depth",
                                           65),
    "seal_max_skip_zero": lambda c: setattr(c.blocksync, "seal_max_skip",
                                            0),
    "seal_tile_huge": lambda c: setattr(c.blocksync, "seal_tile", 2048),
    "probe_base_zero": lambda c: setattr(c.device, "probe_backoff_base_ms",
                                         0),
    "probe_cap_below_base": lambda c: setattr(
        c.device, "probe_backoff_cap_ms", 1),
    "probe_deadline_zero": lambda c: setattr(c.device, "probe_deadline_ms",
                                             0),
    "mesh_devices_255": lambda c: setattr(c.device, "mesh_devices", 255),
    "mesh_indivisible": lambda c: (setattr(c.device, "mesh_devices", 3),
                                   setattr(c.device, "mesh_sig_parallel",
                                           2)),
    "mesh_tiles_zero": lambda c: setattr(c.device, "mesh_tiles_per_shard",
                                         0),
    "pruning_interval_zero": lambda c: setattr(c.storage,
                                               "pruning_interval_ms", 0),
    "pruning_service_without_laddr": lambda c: setattr(
        c.grpc, "pruning_service", True),
    "trace_ring_zero": lambda c: setattr(c.instrumentation, "trace_ring",
                                         0),
    "statesync_one_server": lambda c: (
        setattr(c.statesync, "enable", True),
        setattr(c.statesync, "rpc_servers", "127.0.0.1:1")),
    "statesync_bad_hash": lambda c: (
        setattr(c.statesync, "enable", True),
        setattr(c.statesync, "rpc_servers", "a:1,b:2"),
        setattr(c.statesync, "trust_height", 1),
        setattr(c.statesync, "trust_hash", "zz")),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_validate_basic_rejects_the_same_sections(tmp_path, case):
    errors = []
    for side in SIDES:
        cfg = mod(side, "config").Config(root_dir=str(tmp_path))
        cfg.validate_basic()
        BAD[case](cfg)
        with pytest.raises(ValueError) as e:
            cfg.validate_basic()
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def _fixed_key(side, seed: bytes):
    return mod(side, "crypto.keys").Ed25519PrivKey(seed)


@pytest.mark.parametrize("writer,reader", BOTH_WAYS)
def test_genesis_files_are_identical_and_cross_read(tmp_path, writer,
                                                    reader):
    w_node = mod(writer, "node.node")
    r_node = mod(reader, "node.node")
    sstate = mod(writer, "state.state")
    validator = mod(writer, "types.validator")
    proto = mod(writer, "types.proto")
    secp = mod(writer, "crypto.secp256k1")
    keys = [_fixed_key(writer, bytes([i]) * 32).pub_key() for i in (1, 2)]
    keys.append(secp.Secp256k1PrivKey(bytes([3]) * 32).pub_key())
    gen = sstate.GenesisDoc(
        chain_id="g", initial_height=5,
        genesis_time=proto.Timestamp(1_700_000_123, 456),
        validators=[validator.Validator(k, 7 + i)
                    for i, k in enumerate(keys)],
        app_state=b"\x00app", app_hash=b"\x11" * 32,
        bls_pops={b"\x01" * 48: b"\x02" * 96})
    pw, pr = str(tmp_path / "w.json"), str(tmp_path / "r.json")
    w_node.save_genesis(gen, pw)
    back = r_node.load_genesis(pw)
    r_node.save_genesis(back, pr)
    with open(pw, "rb") as a, open(pr, "rb") as b:
        assert a.read() == b.read()
    assert back.chain_id == "g" and back.initial_height == 5
    assert [(v.pub_key.type_(), v.pub_key.bytes_(), v.voting_power)
            for v in back.validators] == [
        (v.pub_key.type_(), v.pub_key.bytes_(), v.voting_power)
        for v in gen.validators]
    assert back.bls_pops == gen.bls_pops
    assert (back.app_state, back.app_hash) == (gen.app_state, gen.app_hash)


@pytest.mark.parametrize("writer,reader", BOTH_WAYS)
def test_node_key_files_are_identical_and_cross_read(tmp_path, writer,
                                                     reader, monkeypatch):
    seed = bytes(range(32))
    paths = {}
    for side in SIDES:
        keys = mod(side, "crypto.keys")
        monkeypatch.setattr(keys.Ed25519PrivKey, "generate",
                            staticmethod(lambda s=side: _fixed_key(s, seed)))
        paths[side] = str(tmp_path / side / "node_key.json")
        mod(side, "node.node").load_or_generate_node_key(paths[side])
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    key = mod(reader, "node.node").load_or_generate_node_key(paths[writer])
    assert key.pub_key().address() == _fixed_key(
        writer, seed).pub_key().address()
    with open(paths[writer]) as f:
        assert json.load(f)["node_id"] == key.pub_key().address().hex()


@pytest.mark.parametrize("writer,reader", BOTH_WAYS)
def test_privval_files_cross_read(tmp_path, writer, reader):
    import random
    path = str(tmp_path / "pv.json")
    pv = mod(writer, "privval.file").FilePV.generate(path, random.Random(3))
    pv._save()
    back = mod(reader, "privval.file").FilePV.load(path)
    assert back.get_pub_key().bytes_() == pv.get_pub_key().bytes_()


# --- branches the port does not have yet ---------------------------------

UNPORTED = {
    "device_mesh": ({"device__mesh": True}, "item 5"),
    "grpc_laddr": ({"grpc__laddr": "127.0.0.1:0"}, "item 11.2"),
    "grpc_privileged": ({"grpc__privileged_laddr": "127.0.0.1:0",
                         "grpc__pruning_service": True}, "item 11.2"),
    "remote_grpc_app": ({"base__proxy_app": "grpc://127.0.0.1:26658"},
                        "item 11.4"),
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_branches_raise_at_construction(tmp_path, case):
    from cometbft_tpu_torch.node.node import Node, save_genesis
    fields, item = UNPORTED[case]
    _paths, gen = write_validators(tmp_path, 1)
    cfg = mod("port", "config").Config(root_dir=str(tmp_path / "home"))
    cfg.base.db_backend = "memdb"
    for key, value in fields.items():
        section, _, name = key.partition("__")
        setattr(getattr(cfg, section), name, value)
    save_genesis(gen, cfg.path(cfg.base.genesis_file))
    with pytest.raises(NotImplementedError) as e:
        Node(cfg, device="cpu")
    assert f"ROADMAP.md Queue 1 {item}" in str(e.value)
    assert not os.path.exists(cfg.path("data/cs.wal"))


# --- branches ported since node boot --------------------------------------

PORTED = {
    # the rpc_servers answer nothing: the light client has no trust root
    # (StateSyncError) and the boot falls back to blocksync from genesis
    "statesync_enable": {"statesync__enable": True,
                         "statesync__rpc_servers": "127.0.0.1:1,"
                                                   "127.0.0.1:2",
                         "statesync__trust_height": 1,
                         "statesync__trust_hash": "ab" * 32,
                         "statesync__discovery_time_ms": 1000},
    "sqlite_indexer": {"tx_index__indexer": "sqlite"},
    "remote_socket_app": {},     # proxy_app: an ABCIServer's address
}


def _websocket(addr):
    """An open WebSocket session on a node's RPC, subscribed to NewBlock."""
    from cometbft_tpu_torch.rpc.websocket import WSClient
    ws = WSClient(addr, timeout=30)
    ws.send(json.dumps({"jsonrpc": "2.0", "id": 1, "method": "subscribe",
                        "params": {"query": "tm.event = 'NewBlock'"}}
                       ).encode())
    ws.handshake()
    return ws.sock


@pytest.mark.parametrize("case", sorted(PORTED))
def test_ported_branches_build_a_working_node(tmp_path, case):
    """Each branch that raised before its module was ported builds a
    node that commits a tx, reads it back and finds it indexed; with a
    WebSocket subscriber still connected, stop() (and the app server's)
    leaves no thread running."""
    import threading
    from _torch_node import make_node, wait_for
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.abci.socket import ABCIServer
    from cometbft_tpu_torch.node.node import save_genesis
    from cometbft_tpu_torch.pubsub.query import Query
    before = set(threading.enumerate())
    paths, gen = write_validators(tmp_path, 1)
    gpath = str(tmp_path / "genesis.json")
    save_genesis(gen, gpath)
    fields = dict(PORTED[case])
    server = nd = None
    try:
        if case == "remote_socket_app":
            server = ABCIServer(KVStoreApplication())
            server.start()
            fields["base__proxy_app"] = "tcp://%s:%d" % server.addr
        nd = make_node("port", str(tmp_path / "home"), gpath, paths[0],
                       block_sync=case == "statesync_enable", **fields)
        nd.start()
        ws = _websocket(nd.rpc_server.addr)
        wait_for(lambda: nd.consensus.state.last_block_height >= 1,
                 "the first commit")
        assert nd.mempool.check_tx(b"branch=works") == 0
        wait_for(lambda: nd.app_conns.query.query("/store", b"branch")
                 == (0, b"works"), "the tx committed")
        wait_for(lambda: nd.tx_indexer.search(Query("tx.height > 0")),
                 "the tx indexed")
        assert nd.boot_error is None
        if case == "statesync_enable":
            assert nd.statesync_state is None
        if case == "sqlite_indexer":
            assert os.path.exists(nd.config.path("data/indexer.sqlite"))
    finally:
        if nd is not None:
            nd.stop()
        if server is not None:
            server.stop()
    ws.settimeout(10)
    while ws.recv(1 << 16):     # stop() closed the session: EOF, no hang
        pass
    ws.close()

    def left():
        return [t.name for t in set(threading.enumerate()) - before
                if t.is_alive()]
    try:
        wait_for(lambda: not left(), "the node's threads ended", 10)
    except TimeoutError:
        raise AssertionError(f"threads left running: {left()}")
