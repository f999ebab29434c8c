"""The port's catch-up over p2p (engine/reactor, engine/pool, p2p/) into
FileDB stores, held against the JAX package on the CPU, over localhost
TCP on the 12-block, 4-validator chain of tests/test_p2p_blocksync.py.

The JAX package only generates chains and serves them (its
BlocksyncNetReactor behind its Switch); it never syncs here (a JAX sync
at batch 64 jits the RLC kernel on XLA:CPU for minutes). The port syncs
through `PooledSource(NetSource(reactor, switch))` and
`BlocksyncReactor(device="cpu")` into `open_db("filedb", ...)` stores,
as the node's catch-up builds it (cometbft_tpu/node/node.py:591-701):

- from a port peer (serving from FileDB stores) and from a JAX-package
  peer, each sync reaches the height and the app hash of the chain the
  JAX package's `generate_chain` makes from the same seed, with every
  block byte-identical;
- a sync stopped at height 6, its stores closed and reopened (FileDB
  replays its log), the recovery doctor (no repair), the state loaded
  from the StateStore at the kept app's height, and resumed over a new
  connection, ends at the same state;
- a peer that serves a tampered block is banned through `NetSource.ban`
  -> `Switch.stop_peer(ban=True)`, and the sync ends as the port's
  in-memory sync of the same chain with the same tampered block ends
  (the same bans, state and app), its honest peer serving the rest;
- `SealAdopter` over `NetSealSource` against a JAX-package peer serving
  an aggregated chain adopts what the JAX package's adopter adopts over
  `ChainSealSource` of that chain (defaults: one pivot, one plain
  `bls_miller_finalexp` call on the CPU).

Tiles here hold 4 validators x 5 heights = 20 lanes, under the 64 that
`verify_lanes` batches, so commits verify per signature on the host; the
RLC kernels on this path are driven on the card by chip_smoke.py.
Results are heights, hashes, bytes and ban lists: no tolerance.
"""

import time

import pytest
import torch

from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
from cometbft_tpu.db.kv import MemDB as JMemDB
from cometbft_tpu.engine import chain_gen as jcg
from cometbft_tpu.engine import reactor as jreactor
from cometbft_tpu.p2p import switch as jswitch
from cometbft_tpu.store.blockstore import BlockStore as JStore

from cometbft_tpu_torch.abci.kvstore import KVStoreApplication as PApp
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey as PPriv
from cometbft_tpu_torch.db import kv as pkv
from cometbft_tpu_torch.engine import blocksync as pbs
from cometbft_tpu_torch.engine import chain_gen as pcg
from cometbft_tpu_torch.engine import pool as ppool
from cometbft_tpu_torch.engine import reactor as preactor
from cometbft_tpu_torch.p2p import switch as pswitch
from cometbft_tpu_torch.pipeline.cache import SigCache
from cometbft_tpu_torch.state.execution import BlockExecutor as PExec
from cometbft_tpu_torch.state.state import State as PState
from cometbft_tpu_torch.state.state import StateStore as PStateStore
from cometbft_tpu_torch.store import recovery as prec
from cometbft_tpu_torch.store.blockstore import BlockStore as PStore

CHAIN_ID = "tpu-chain"
TILE = 5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def chains():
    kw = dict(n_blocks=12, n_validators=4, txs_per_block=2,
              chain_id=CHAIN_ID)
    return (jcg.generate_chain(**kw),
            pcg.generate_chain(device="cpu", **kw))


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.02)
    return True


class _Peer:
    """A serving node: its chain in a block store behind a Switch."""

    def __init__(self, side, chain, store_dir=None, lie_at=None,
                 seal=False):
        if side == "jax":
            store = JStore(JMemDB())
            sw = jswitch.Switch(JPriv.generate(), chain.chain_id, "jax")
            net, prov_mod = jreactor, None
            if seal:
                from cometbft_tpu.sealsync.provider import SealProvider
                prov_mod = SealProvider
        else:
            self.db = pkv.open_db("filedb", "blockstore", store_dir)
            store = PStore(self.db)
            sw = pswitch.Switch(PPriv.generate(), chain.chain_id, "port")
            net, prov_mod = preactor, None
        for i, blk in enumerate(chain.blocks):
            store.save_block(blk, blk.make_part_set(),
                             chain.seen_commits[i])
        served = _Lying(store, lie_at) if lie_at else store
        self.reactor = net.BlocksyncNetReactor(
            served, seal_provider=prov_mod(store) if prov_mod else None)
        sw.add_reactor(self.reactor)
        self.switch = sw
        self.addr = sw.listen()

    def stop(self):
        self.switch.stop()


class _Lying:
    """A block store that serves a tampered block at one height."""

    def __init__(self, store, height):
        self._store, self._height = store, height

    def __getattr__(self, name):
        return getattr(self._store, name)

    def load_block(self, height):
        blk = self._store.load_block(height)
        return (pcg._corrupt_block(blk, "data")
                if height == self._height else blk)


class _Node:
    """The syncing port node: FileDB stores under d, a kept kvstore app,
    a Switch dialled to the peers."""

    def __init__(self, d, app=None):
        self.dir = d
        self.bdb = pkv.open_db("filedb", "blockstore", d)
        self.sdb = pkv.open_db("filedb", "state", d)
        self.store = PStore(self.bdb)
        self.state_store = PStateStore(self.sdb)
        if app is None:
            app = PApp()
            app.init_chain(CHAIN_ID, 1, [], b"")
        self.app = app
        self.executor = PExec(app, state_store=self.state_store,
                              block_store=self.store, device="cpu")
        self.switch = pswitch.Switch(PPriv.generate(), CHAIN_ID, "syncer")
        self.net = preactor.BlocksyncNetReactor(self.store)
        self.switch.add_reactor(self.net)

    def dial(self, *peers):
        for p in peers:
            n = len(self.switch.peers())
            self.switch.dial(*p.addr)
            assert _wait(lambda: len(self.switch.peers()) == n + 1)
        # every peer's status in before the pool schedules requests
        assert _wait(lambda: len(self.net._peer_status) == len(peers))

    def sync(self, state, target=None):
        src = preactor.NetSource(self.net, self.switch)
        pooled = ppool.PooledSource(src, state.last_block_height + 1,
                                    lookahead=32, n_workers=4)
        engine = pbs.BlocksyncReactor(
            self.executor, self.store, pooled, CHAIN_ID, tile_size=TILE,
            batch_size=64, cache=SigCache(), device="cpu")
        try:
            return engine.sync(state, target), engine, src
        finally:
            pooled.stop()

    def close(self):
        self.switch.stop()
        self.bdb.close()
        self.sdb.close()


def _check_chain(state, node, jchain, top=12):
    assert state.last_block_height == node.store.height() == top
    for h in range(1, top + 1):
        assert node.store.load_block(h).hash() == \
            jchain.blocks[h - 1].hash()


def _final_app_hash(jchain):
    """The app hash after the last block: the header of no block holds
    it, so replay the JAX chain's txs through the JAX kvstore."""
    from cometbft_tpu.abci.kvstore import KVStoreApplication
    from cometbft_tpu.state.execution import BlockExecutor
    from cometbft_tpu.state.state import State
    app = KVStoreApplication()
    app.init_chain(jchain.chain_id, 1, [], b"")
    st = State.from_genesis(jchain.genesis)
    ex = BlockExecutor(app)
    for i, blk in enumerate(jchain.blocks):
        st, _ = ex.apply_block(st, jchain.block_ids[i], blk, verified=True)
    return st.app_hash, app.state


@pytest.fixture(scope="module")
def jax_final(chains):
    return _final_app_hash(chains[0])


@pytest.mark.parametrize("server", ["port", "jax"])
def test_catch_up_over_tcp_into_filedb(tmp_path, chains, jax_final, server):
    jchain, pchain = chains
    peer = _Peer(server, jchain if server == "jax" else pchain,
                 store_dir=str(tmp_path / "peer"))
    node = _Node(str(tmp_path / "node"))
    try:
        node.dial(peer)
        state = PState.from_genesis(pchain.genesis)
        state, engine, _ = node.sync(state)
        _check_chain(state, node, jchain)
        assert (state.app_hash, node.app.state) == jax_final
        assert engine.stats.blocks_applied == 12
        assert node.state_store.load().last_block_height == 12
    finally:
        peer.stop()
        node.close()
    # the stores replay from disk to the same chain
    bdb = pkv.open_db("filedb", "blockstore", str(tmp_path / "node"))
    assert PStore(bdb).height() == 12
    bdb.close()


def test_stop_reopen_doctor_resume(tmp_path, chains, jax_final):
    jchain, pchain = chains
    peer = _Peer("jax", jchain)
    d = str(tmp_path / "node")
    node = _Node(d)
    try:
        node.dial(peer)
        state, _, _ = node.sync(PState.from_genesis(pchain.genesis), 6)
        assert state.last_block_height == 6
        app = node.app
        node.close()                     # a clean stop
        node = _Node(d, app=app)  # FileDB replays its logs
        report = prec.run_doctor(block_store=node.store,
                                 state_store=node.state_store, db_dir=d)
        assert report.count() == 0
        assert report.block_height == report.state_height == 6
        state = node.state_store.load()
        assert state.last_block_height == app.last_height == 6
        node.dial(peer)
        state, _, _ = node.sync(state)
        _check_chain(state, node, jchain)
        assert (state.app_hash, app.state) == jax_final
    finally:
        peer.stop()
        node.close()


def test_tampered_block_bans_the_peer(tmp_path, chains):
    """Two peers, the second serving tampered data at height 5 (the
    request for height h goes to peer h % 2 of the two, in connection
    order). The liar is banned at 5 and its connection stopped; the
    honest peer serves 5 again; the sync ends as the in-memory sync with
    the same tampered block ends."""
    jchain, pchain = chains
    honest = _Peer("jax", jchain)
    liar = _Peer("port", pchain, store_dir=str(tmp_path / "liar"),
                 lie_at=5)
    node = _Node(str(tmp_path / "node"))
    liar_id = liar.switch.priv_key.pub_key().address().hex()
    stopped = []
    real_stop = node.switch.stop_peer

    def spy(peer, reason, ban=False):
        stopped.append((peer.id, ban))
        real_stop(peer, reason, ban=ban)
    node.switch.stop_peer = spy
    try:
        node.dial(honest, liar)
        state, engine, src = node.sync(PState.from_genesis(pchain.genesis))
        assert stopped == [(liar_id, True)]
        assert liar_id in node.switch.banned
        assert [p.id for p in node.switch.peers()] != [liar_id]
        # the in-memory sync of the same chain, tampered the same way
        app = PApp()
        app.init_chain(CHAIN_ID, 1, [], b"")
        mem_src = pcg.LocalChainSource(pchain, {5: "data"})
        mem = pbs.BlocksyncReactor(PExec(app, device="cpu"),
                                   PStore(pkv.MemDB()), mem_src, CHAIN_ID,
                                   tile_size=TILE, batch_size=64,
                                   cache=SigCache(), device="cpu")
        mstate = mem.sync(PState.from_genesis(pchain.genesis))
        assert mem_src.banned == [5]
        assert state.last_block_height == mstate.last_block_height == 12
        assert state.app_hash == mstate.app_hash
        assert node.app.state == app.state
        assert engine.stats.blocks_applied == mem.stats.blocks_applied
        _check_chain(state, node, jchain)
    finally:
        honest.stop()
        liar.stop()
        node.close()


def test_seal_adoption_over_p2p(tmp_path):
    """A JAX-package peer serves an aggregated chain's seals; the port's
    SealAdopter adopts them over NetSealSource to the tip with one pivot,
    the records the JAX package's adopter installs over ChainSealSource
    of the same chain."""
    from cometbft_tpu.aggsig import aggregate as jagg
    from cometbft_tpu.aggsig.verify import PairingChecker
    from cometbft_tpu.pipeline.cache import SigCache as JSigCache
    from cometbft_tpu.sealsync import SealAdopter as JAdopter
    from cometbft_tpu.state.state import State as JState
    from cometbft_tpu_torch.aggsig import aggregate as pagg
    from cometbft_tpu_torch.sealsync import SealAdopter
    jchain = jcg.generate_chain(n_blocks=3, n_validators=4,
                                chain_id="seal-chain", seed=7,
                                key_type="bls12_381", aggregate=True)
    # the JAX package's adoption over its in-memory source
    jagg.reset_pop_registry()
    jstore = JStore(JMemDB())
    jtip = JAdopter(jchain.chain_id, jstore, jcg.ChainSealSource(jchain),
                    cache=JSigCache(4096), checker=PairingChecker("cpu"),
                    shards=1).adopt(JState.from_genesis(jchain.genesis))
    # the port's over p2p, from a JAX-package peer
    peer = _Peer("jax", jchain, seal=True)
    pagg.reset_pop_registry()
    pgen, _ = pcg.make_genesis(4, jchain.chain_id, 7,
                               key_type="bls12_381")
    assert pgen.validators[0].pub_key.bytes_() == \
        jchain.genesis.validators[0].pub_key.bytes_()
    switch = pswitch.Switch(PPriv.generate(), jchain.chain_id, "adopter")
    net = preactor.BlocksyncNetReactor(PStore(pkv.MemDB()))
    switch.add_reactor(net)
    store = PStore(pkv.MemDB())
    try:
        switch.dial(*peer.addr)
        assert _wait(lambda: switch.peers())
        src = preactor.NetSealSource(net, switch)
        adopter = SealAdopter(jchain.chain_id, store, src, cache=SigCache(),
                              device="cpu")
        tip = adopter.adopt(PState.from_genesis(pgen))
    finally:
        peer.stop()
        switch.stop()
    assert tip == jtip == jchain.max_height() == store.adopted_tip()
    assert store.adopted_seal_heights() == jstore.adopted_seal_heights()
    for h in store.adopted_seal_heights():
        pb, ph, pc = store.load_adopted_seal(h)
        jb, jh, jc = jstore.load_adopted_seal(h)
        assert (pb.encode(), ph.encode(), pc.encode()) == \
            (jb.encode(), jh.encode(), jc.encode())


def test_unanswered_request_goes_to_another_peer_when_its_peer_leaves():
    """A block request whose peer is removed before it answers (a ban, a
    dropped link) is asked again of another peer at once (reference
    pool.go RemovePeer redoes its requesters), where the JAX package's
    reactor leaves it to its 20 s timeout; removing a peer that holds no
    request resends nothing."""
    class FakePeer:
        def __init__(self, pid):
            self.id, self.sent = pid, []

        def try_send(self, ch, raw):
            self.sent.append(raw)
            return True

    net = preactor.BlocksyncNetReactor(PStore(pkv.MemDB()))
    a, b, c = FakePeer("a"), FakePeer("b"), FakePeer("c")
    for p in (a, b, c):
        net.add_peer(p)
    fut = net.request_block_async(13)          # 13 % 3: asks b
    want = bytes([3]) + bytes([8, 13])          # BlockRequest{height=13}
    assert b.sent[-1] == want and a.sent == [bytes([1])]
    net.remove_peer(a, "unrelated")
    assert a.sent == [bytes([1])] and c.sent == [bytes([1])]
    net.remove_peer(b, "banned")                 # c, the one left
    assert c.sent[-1] == want
    net._resolve(13, ("block", "c"))
    assert fut.result(timeout=1) == ("block", "c")
