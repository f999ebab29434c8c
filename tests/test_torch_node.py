"""The port's `Node` (`cometbft_tpu_torch/node/node.py`) with its reactors
(consensus, blocksync, mempool, evidence, statesync), held against the
JAX package on the CPU, over loopback TCP:

- a net of 4 port validators commits heights; a tx sent through RPC to
  one node reaches another node's app; `broadcast_tx_commit` succeeds
  and the tx's proof verifies against the header's `data_hash`; evidence
  sent through `broadcast_evidence` reaches every other node's pool;
- a mixed net of 2 JAX and 2 port validators commits the same block
  and app hashes, and txs and evidence gossip both ways between them;
- a node boots from stores the other package wrote: the handshake
  replays to the same app hash and the recovery doctor gives the same
  report;
- `stop()` ends every thread and listener the node started;
- a JAX `Syncer` restores an app from a port node's snapshots;
- a fresh interpreter boots a port node without loading jax.

The boot sync (`start()` with block sync on) is held in
tests/test_torch_node_boot.py.

Port nodes run with `device="cpu"`; every wait has its own deadline.
Results are heights, hashes and reports: no tolerance.
"""

import json
import os
import subprocess
import sys
import threading

import pytest
import torch

from _torch_node import (make_net, mod, port_chain, start_mesh, stop_all,
                         wait_for, write_home)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = ("jax", "port")
BOOT_BLOCKS = 18   # the first boot tile holds 16 commits x 4 = 64 lanes

torch.set_num_threads(1)


def _height(nd) -> int:
    return nd.consensus.state.last_block_height


def _double_sign(nd, side: str, height: int = 1):
    """Two conflicting precommits from `nd`'s validator at `height`,
    signed with its key past the privval guard (tests/
    test_evidence_gossip.py's trick, in `side`'s types)."""
    block = mod(side, "types.block")
    evidence = mod(side, "types.evidence")
    proto = mod(side, "types.proto")
    vote = mod(side, "types.vote")
    pv = nd.priv_validator
    vals = nd.state_store.load_validators(height)
    idx, _val = vals.get_by_address(pv.address())

    def make(tag):
        v = vote.Vote(type_=vote.PRECOMMIT_TYPE, height=height, round=0,
                      block_id=block.BlockID(tag * 32, block.PartSetHeader(
                          1, tag * 32)),
                      timestamp=proto.Timestamp.now(),
                      validator_address=pv.address(), validator_index=idx)
        v.signature = pv.priv_key.sign(v.sign_bytes(nd.genesis.chain_id))
        return v
    return evidence.DuplicateVoteEvidence.from_conflict(
        make(b"\xaa"), make(b"\xbb"), vals,
        nd.consensus.state.last_block_time)


def _has_evidence(nd, ev_hash: bytes) -> bool:
    pool = nd.evidence_pool
    return (ev_hash in pool._committed
            or any(e.hash() == ev_hash for e in pool._pending))


def _rpc(nd):
    from cometbft_tpu_torch.rpc.client import RPCClient
    return RPCClient(*nd.rpc_server.addr, timeout=30)


def test_four_port_nodes_commit_and_serve_rpc(tmp_path):
    from cometbft_tpu_torch.rpc.codec import proof_from_json
    from cometbft_tpu_torch.types.block import tx_hash
    nodes = make_net(tmp_path, ["port"] * 4)
    try:
        start_mesh(nodes)
        wait_for(lambda: all(_height(n) >= 2 for n in nodes), "height 2")
        r = _rpc(nodes[2]).broadcast_tx_sync(b"net=works")
        assert r["code"] == 0
        rpc1 = _rpc(nodes[1])
        wait_for(lambda: bytes.fromhex(rpc1.abci_query(
            "/store", b"net")["value"]) == b"works", "tx at node 1")
        done = rpc1.call("broadcast_tx_commit", tx=b"committed=yes".hex())
        assert done["tx_result"]["code"] == 0 and done["height"] > 0
        wait_for(lambda: rpc1.call(
            "tx_search", query=f"tx.height = {done['height']}")[
                "total_count"] >= 1, "tx indexed")
        t = rpc1.call("tx", hash=done["hash"], prove=True)
        proof = proof_from_json(t["proof"]["proof"])
        assert proof.verify(bytes.fromhex(t["proof"]["root_hash"]),
                            tx_hash(b"committed=yes"))
        hdr = rpc1.call("header", height=t["height"])["header"]
        assert hdr["data_hash"] == t["proof"]["root_hash"]
        ev = _double_sign(nodes[0], "port")
        out = rpc1.call("broadcast_evidence", evidence=ev.encode().hex())
        assert out["hash"] == ev.hash().hex().upper()
        wait_for(lambda: all(_has_evidence(n, ev.hash()) for n in nodes),
                 "evidence gossiped")
    finally:
        stop_all(nodes)


def test_mixed_net_commits_the_same_hashes_and_gossips(tmp_path):
    nodes = make_net(tmp_path, ["jax", "port", "jax", "port"])
    try:
        start_mesh(nodes)
        wait_for(lambda: all(_height(n) >= 4 for n in nodes), "height 4")
        for h in (1, 2, 3):
            blocks = {n.block_store.load_block(h).hash() for n in nodes}
            apps = {n.block_store.load_block(h + 1).header.app_hash
                    for n in nodes if n.block_store.height() > h}
            assert len(blocks) == 1 and len(apps) == 1, h
        # mempool gossip both ways: a tx into a JAX node reaches a port
        # node's app, and one into a port node a JAX node's app
        for src, dst, key in ((0, 1, b"from-jax"), (3, 2, b"from-port")):
            _rpc(nodes[src]).broadcast_tx_sync(key + b"=1")
            wait_for(lambda d=dst, k=key: nodes[d].app_conns.query.query(
                "/store", k)[1] == b"1", f"tx {key!r} at node {dst}")
        # evidence gossip both ways
        for src, side in ((1, "port"), (0, "jax")):
            ev = _double_sign(nodes[src], side)
            _rpc(nodes[src]).call("broadcast_evidence",
                                  evidence=ev.encode().hex())
            wait_for(lambda e=ev: all(_has_evidence(n, e.hash())
                                      for n in nodes),
                     f"{side} evidence gossiped")
    finally:
        stop_all(nodes)


@pytest.fixture(scope="module")
def chain():
    return port_chain(BOOT_BLOCKS, n_validators=4, seed=7)


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_boot_from_stores_of_the_other_package(tmp_path, chain, writer,
                                               reader):
    homes = {}
    reports, apps = {}, {}
    for side in (writer, reader):
        homes[side] = str(tmp_path / side)
        write_home(writer, homes[side], chain, 10, blocks=11)
        cfg = mod(side, "config").Config.load(homes[side])
        cfg.base.block_sync = False
        cfg.rpc.enable = False
        nd = mod(side, "node.node").Node(
            cfg, **({"device": "cpu"} if side == "port" else {}))
        try:
            reports[side] = nd.recovery_report
            apps[side] = (_height(nd), nd.consensus.state.app_hash,
                          nd.app_conns.query.info().last_block_app_hash)
        finally:
            nd.stop()
    assert apps[writer] == apps[reader]
    assert apps[reader][0] == 10
    assert apps[reader][1] == chain.blocks[10].header.app_hash
    assert repr(reports[writer]) == repr(reports[reader])


def test_stop_ends_every_thread_and_listener(tmp_path):
    """One validator with every service on (RPC, Prometheus, the ingest
    flusher, indexer, pruner, reconciler, a persistent peer that never
    answers): after stop() no thread it started is alive and its ports
    refuse connections."""
    import socket
    before = set(threading.enumerate())
    nodes = make_net(tmp_path, ["port"])
    nd = nodes[0]
    nd.config.instrumentation.prometheus = True
    nd.config.instrumentation.prometheus_laddr = "127.0.0.1:0"
    nd.config.p2p.persistent_peers = "127.0.0.1:9"
    try:
        nd.start()
        wait_for(lambda: _height(nd) >= 2, "height 2")
        import urllib.request
        body = urllib.request.urlopen(
            f"http://{nd.metrics_addr[0]}:{nd.metrics_addr[1]}/",
            timeout=30).read().decode()
        assert "crypto_pallas_canary_runs" in body
        assert "CUDA RLC kernels" in body
        addrs = [nd.rpc_server.addr, nd.metrics_addr, nd.p2p_addr]
    finally:
        nd.stop()

    def left():
        return [t.name for t in set(threading.enumerate()) - before
                if t.is_alive()]
    try:
        wait_for(lambda: not left(), "the node's threads ended", 10)
    except TimeoutError:
        raise AssertionError(f"threads left running: {left()}")
    for host, port in addrs:
        with pytest.raises(OSError):
            socket.create_connection((host, port), timeout=2).close()


class _Sink:
    """A JAX-side reactor that holds a node's other channels and drops
    what arrives on them (a peer that sends on a channel its switch lacks
    is dropped)."""

    def __init__(self, ids):
        from cometbft_tpu.p2p.mconn import ChannelDescriptor
        self._channels = [ChannelDescriptor(id=i) for i in ids]

    def get_channels(self):
        return self._channels

    def add_peer(self, peer):
        pass

    def remove_peer(self, peer, reason):
        pass

    def receive(self, channel_id, peer, raw):
        pass


def test_jax_syncer_restores_from_port_snapshots(tmp_path, chain):
    """A port node at height 10 serves its kvstore's snapshot over its
    statesync reactor; a JAX `Syncer` on a JAX switch restores a fresh
    app from it, anchored by a light client over the same chain."""
    from cometbft_tpu.abci.kvstore import KVStoreApplication as JApp
    from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
    from cometbft_tpu.db.kv import MemDB as JMemDB
    from cometbft_tpu.engine.chain_gen import generate_chain as jgen
    from cometbft_tpu.light import LightClient, LightStore, TrustOptions
    from cometbft_tpu.p2p.switch import Switch as JSwitch
    from cometbft_tpu.statesync.reactor import (StatesyncNetReactor,
                                                net_snapshot_sources)
    from cometbft_tpu.statesync.stateprovider import LightStateProvider
    from cometbft_tpu.statesync.syncer import Syncer
    from cometbft_tpu.types.proto import Timestamp as JTs
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_light import ChainProvider
    home = str(tmp_path / "snap")
    write_home("port", home, chain, 10, blocks=11)
    cfg = mod("port", "config").Config.load(home)
    cfg.base.block_sync = False
    cfg.rpc.enable = False
    cfg.p2p.laddr = "127.0.0.1:0"
    nd = mod("port", "node.node").Node(cfg, device="cpu")
    nd.app_conns.snapshot.list_snapshots()   # capture the snapshot blob
    sw = JSwitch(JPriv.generate(), chain.chain_id, "syncer")
    fresh = JApp()
    reactor = StatesyncNetReactor(fresh)
    sw.add_reactor(reactor)
    sw.add_reactor(_Sink([d.id for r in nd.switch._reactors
                          for d in r.get_channels()
                          if d.id not in (0x60, 0x61)]))
    try:
        nd.start()
        sw.dial(*nd.p2p_addr)
        wait_for(lambda: sw.peers(), "the JAX switch's peer")
        sources = net_snapshot_sources(reactor)
        assert sources and sources[0].list_snapshots()[0].height == 10
        jchain = jgen(BOOT_BLOCKS, n_validators=4, seed=7)
        assert jchain.blocks[0].hash() == chain.blocks[0].hash()
        lc = LightClient(
            chain.chain_id,
            TrustOptions(period_seconds=10**9, height=1,
                         hash=jchain.blocks[0].hash()),
            ChainProvider(jchain), [], LightStore(JMemDB()),
            now_fn=lambda: JTs(1_700_000_000 + 40, 0))
        state = Syncer(fresh, LightStateProvider(lc, jchain.genesis),
                       sources).sync()
        served = nd.app_conns.query.info()
        assert state.last_block_height == 10
        assert fresh.last_app_hash == served.last_block_app_hash
        assert fresh.state == nd.app_conns.query._app.state
    finally:
        sw.stop()
        nd.stop()


def test_fresh_interpreter_boots_without_jax(tmp_path):
    """`cmd.main init`, then a CPU node booted to height 1, in a fresh
    interpreter: no jax, no JAX-package and no `cryptography` module is
    ever loaded."""
    code = (
        "import json, sys, time\n"
        "from cometbft_tpu_torch.cmd.main import main\n"
        f"home = {str(tmp_path / 'solo')!r}\n"
        "assert main(['init', '--home', home, '--chain-id', 'solo']) == 0\n"
        "from cometbft_tpu_torch.config import Config\n"
        "from cometbft_tpu_torch.node import Node\n"
        "cfg = Config.load(home)\n"
        "cfg.consensus.timeout_commit = 50\n"
        "cfg.rpc.laddr = cfg.p2p.laddr = '127.0.0.1:0'\n"
        "node = Node(cfg, device='cpu')\n"
        "node.start()\n"
        "t0 = time.monotonic()\n"
        "while node.consensus.state.last_block_height < 1:\n"
        "    assert time.monotonic() - t0 < 60, 'no height 1'\n"
        "    time.sleep(0.05)\n"
        "node.stop()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'cometbft_tpu', 'cryptography')]\n"
        "print(json.dumps(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=90)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []
