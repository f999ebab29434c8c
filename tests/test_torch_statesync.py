"""The port's statesync consumer (`statesync/syncer.py`,
`statesync/stateprovider.py`, `Node._run_statesync`, `cmd bootstrap-state`)
held against the JAX package on the CPU, over the seeded 12-block,
4-validator chain both packages generate byte for byte (a kvstore app at
12 keeps the snapshots at 10 and 5):

- the port's `Syncer` and `LightStateProvider` against the JAX package's:
  a restore (the same app state and bootstrapped `State` bytes), a
  tampered chunk, no snapshots, a tip snapshot that cannot be anchored
  (header 12 missing: snapshot 10 refused, 5 restored), and a primary
  serving a consistently signed fork at 12 that the witness catches;
- a port `Node` with `[statesync] enable` restoring over TCP from a JAX
  node's snapshots, and a JAX node from a port node's: both blocksync 11
  and 12 and end with byte-identical state stores and seen commits;
- `bootstrap-state` from each package's CLI writing the same stores;
- faults during the anchor: a kernel fault (a verify raising
  `KernelCanaryError`, and a failed build) sets the port node's
  `boot_error`, starts no consensus and runs no blocksync from genesis,
  where the JAX package falls back to blocksync from genesis; a peer's
  fault (a wrong trust hash) falls back to blocksync from genesis in
  both.

Every commit holds 4 signatures (under `BATCH_VERIFY_THRESHOLD`), so both
light clients verify per signature on the host and the JAX side never
compiles its RLC jit. Port code runs with `device="cpu"`. Results are
bytes, heights and exception types: no tolerance.
"""

import dataclasses
import os

import pytest
import torch

from _torch_node import dev, make_node, mod, port_chain, rpc_addr, \
    serving_node, wait_for

SIDES = ("jax", "port")
CHAIN_LEN = 12
SEED = 11
TRUST_PERIOD = 10**9

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def chains():
    port = port_chain(CHAIN_LEN, n_validators=4, seed=SEED)
    jax = mod("jax", "engine.chain_gen").generate_chain(
        CHAIN_LEN, n_validators=4, seed=SEED, txs_per_block=2)
    assert [b.hash() for b in jax.blocks] == [b.hash() for b in port.blocks]
    return {"jax": jax, "port": port}


def _serving_app(side, chain, height=CHAIN_LEN):
    app = mod(side, "abci.kvstore").KVStoreApplication()
    app.init_chain(chain.chain_id, 1, [], b"")
    ex = mod(side, "state.execution").BlockExecutor(app, **dev(side))
    st = mod(side, "state.state").State.from_genesis(chain.genesis)
    for h in range(1, height + 1):
        st, _ = ex.apply_block(st, chain.block_ids[h - 1],
                               chain.blocks[h - 1], verified=True)
    return app


def _provider(side, chain, top=CHAIN_LEN, forge_at=None):
    """The chain's light blocks up to `top` (above it: not found); at
    `forge_at`, a fork with a forged app hash that every validator
    signed."""
    base = mod(side, "engine.chain_gen").ChainLightProvider
    provider = mod(side, "light.provider")
    types = mod(side, "light.types")
    block = mod(side, "types.block")
    cg = mod(side, "engine.chain_gen")

    class Provider(base):
        def light_block(self, height):
            height = height or top
            if height > top:
                raise provider.ErrLightBlockNotFound(f"height {height}")
            if height != forge_at:
                return super().light_block(height)
            real = chain.blocks[height - 1]
            vals = chain.valsets[height - 1]
            hdr = dataclasses.replace(real.header, app_hash=b"\x66" * 32)
            fake = dataclasses.replace(real, header=hdr)
            fid = block.BlockID(fake.hash(), fake.make_part_set().header)
            commit = cg.sign_commit(chain.chain_id, height, 0, fid, vals,
                                    chain.keys)
            return types.LightBlock(types.SignedHeader(hdr, commit),
                                    vals.copy())
    return Provider(chain)


def _state_provider(side, chain, primary=None, witnesses=()):
    client = mod(side, "light.client")
    proto = mod(side, "types.proto")
    lc = client.LightClient(
        chain.chain_id,
        client.TrustOptions(period_seconds=TRUST_PERIOD, height=1,
                            hash=chain.blocks[0].hash()),
        primary or _provider(side, chain), list(witnesses),
        mod(side, "light.store").LightStore(mod(side, "db.kv").MemDB()),
        now_fn=lambda: proto.Timestamp(1_700_000_000 + CHAIN_LEN + 5, 0),
        **dev(side))
    return mod(side, "statesync.stateprovider").LightStateProvider(
        lc, chain.genesis)


def _sync(side, chain, source=None, primary=None, witnesses=()):
    """-> (outcome, fresh app): the restored height and State bytes, or
    the error's class name."""
    syncer = mod(side, "statesync.syncer")
    sstate = mod(side, "state.state")
    app = mod(side, "abci.kvstore").KVStoreApplication()
    src = source or syncer.AppSnapshotSource(_serving_app(side, chain))
    s = syncer.Syncer(app, _state_provider(side, chain, primary, witnesses),
                      [src])
    try:
        st = s.sync()
    except syncer.StateSyncError as e:
        return ("error", type(e).__name__), app, s
    return (st.last_block_height, sstate._state_to_json(st)), app, s


def test_restore_matches_jax(chains):
    out = {side: _sync(side, chains[side]) for side in SIDES}
    assert out["port"][0] == out["jax"][0]
    assert out["port"][0][0] == 10
    assert out["port"][1].state == out["jax"][1].state != {}
    assert out["port"][1].last_app_hash == out["jax"][1].last_app_hash
    assert out["port"][2].refused == []


def test_tampered_chunk_is_refused_like_jax(chains):
    out = {}
    for side in SIDES:
        base = mod(side, "statesync.syncer").AppSnapshotSource

        class Tampered(base):
            def fetch_chunk(self, height, format_, chunk):
                raw = super().fetch_chunk(height, format_, chunk)
                return raw[:-1] + bytes([raw[-1] ^ 1])
        src = Tampered(_serving_app(side, chains[side]))
        out[side] = _sync(side, chains[side], source=src)
    assert out["port"][0] == out["jax"][0] == ("error", "StateSyncError")
    assert out["port"][1].state == out["jax"][1].state == {}
    assert [h for h, _ in out["port"][2].refused] == [10, 5]


def test_no_snapshots_like_jax(chains):
    out = {}
    for side in SIDES:
        src = mod(side, "statesync.syncer").AppSnapshotSource(
            mod(side, "abci.kvstore").KVStoreApplication())
        out[side] = _sync(side, chains[side], source=src)[0]
    assert out["port"] == out["jax"] == ("error", "StateSyncError")


def test_unanchorable_tip_snapshot_is_skipped_like_jax(chains):
    """Header 12 does not exist yet: snapshot 10 cannot be anchored (its
    state needs 10, 11 and 12) and is refused as the peers' fault before
    the app is touched; snapshot 5 restores in the same sync."""
    out = {side: _sync(side, chains[side],
                       primary=_provider(side, chains[side], top=11))
           for side in SIDES}
    assert out["port"][0] == out["jax"][0]
    assert out["port"][0][0] == 5
    assert out["port"][1].state == out["jax"][1].state
    refused = out["port"][2].refused
    assert [h for h, _ in refused] == [10]
    assert "ErrLightBlockNotFound" in refused[0][1]


def test_forged_primary_caught_by_the_witness_like_jax(chains):
    """The primary serves a fork at 12 signed by every validator; the
    honest witness's header differs, so snapshot 10 is refused
    (ConflictingHeadersError) and 5, below the fork, restores."""
    out = {}
    for side in SIDES:
        c = chains[side]
        out[side] = _sync(side, c, primary=_provider(side, c, forge_at=12),
                          witnesses=[_provider(side, c)])
    assert out["port"][0] == out["jax"][0]
    assert out["port"][0][0] == 5
    refused = out["port"][2].refused
    assert [h for h, _ in refused] == [10]
    assert "ConflictingHeaders" in refused[0][1]


# --- nodes over TCP -------------------------------------------------------

@pytest.fixture(scope="module")
def servers(chains, tmp_path_factory):
    """A JAX and a port node, each over its own copy of a home holding
    the 12 blocks (state at 12), block sync off, RPC on: their handshakes
    replay the chain into fresh kvstore apps, which keep snapshots 10 and
    5. Neither is a validator, so the chain stays at 12."""
    nodes = {}
    try:
        for side in SIDES:
            nodes[side] = serving_node(
                side, str(tmp_path_factory.mktemp(f"server-{side}")),
                chains["port"], CHAIN_LEN)
        yield nodes
    finally:
        for nd in nodes.values():
            nd.stop()


def _syncing_node(side, tmp_path, chain, servers, peer: str, name: str,
                  trust_hash=None, discovery_ms=20_000):
    """A fresh `side` node with [statesync] on: the primary is `peer`'s
    server (also its persistent peer), the witness the other server."""
    other = "jax" if peer == "port" else "port"
    h, p = servers[peer].p2p_addr
    gpath = os.path.join(servers[peer].home, "config", "genesis.json")
    return make_node(
        side, str(tmp_path / name), gpath, block_sync=True, moniker=name,
        rpc__enable=False, p2p__persistent_peers=f"{h}:{p}",
        statesync__enable=True,
        statesync__rpc_servers=f"{rpc_addr(servers[peer])},"
                               f"{rpc_addr(servers[other])}",
        statesync__trust_height=1,
        statesync__trust_hash=(trust_hash or chain.blocks[0].hash()).hex(),
        statesync__trust_period_seconds=TRUST_PERIOD,
        statesync__discovery_time_ms=discovery_ms)


def _consensus_running(nd) -> bool:
    thread = nd.consensus._thread
    return thread is not None and thread.is_alive()


def _dump(db) -> list:
    return list(db.iterate())


def test_nodes_statesync_from_each_other_to_the_same_stores(
        tmp_path, chains, servers):
    """A port node restores from the JAX server's snapshots, a JAX node
    from the port server's; each blocksyncs 11 and 12 and starts
    consensus. Their state stores, seen commits and app hashes are
    byte-identical, and their blocks are the chain's."""
    chain = chains["port"]
    nodes = {}
    try:
        for side in SIDES:
            peer = "jax" if side == "port" else "port"
            nodes[side] = _syncing_node(side, tmp_path, chain, servers,
                                        peer, f"sync-{side}")
            nodes[side].start()
        for side, nd in nodes.items():
            wait_for(lambda: _consensus_running(nd) and
                     nd.consensus.state.last_block_height >= CHAIN_LEN,
                     f"the {side} node's consensus at {CHAIN_LEN + 1}")
        port, jax = nodes["port"], nodes["jax"]
        assert port.boot_error is None
        assert port.statesync_state.last_block_height == 10
        assert port.statesync_syncer.refused == []
        assert port.block_store.load_block(10) is None
        assert [port.block_store.load_block(h).hash() for h in (11, 12)] \
            == [b.hash() for b in chain.blocks[10:12]]
        assert port.consensus.state.app_hash == \
            jax.consensus.state.app_hash == \
            servers["port"].consensus.state.app_hash
        assert _dump(port.state_store._db) == _dump(jax.state_store._db)
        for h in (10, 11, 12):
            assert port.block_store.load_seen_commit(h).encode() == \
                jax.block_store.load_seen_commit(h).encode()
        assert port.app_conns.query.query("/store", b"")[0] == \
            jax.app_conns.query.query("/store", b"")[0]
    finally:
        for nd in nodes.values():
            nd.stop()


def test_bootstrap_state_cli_writes_the_same_stores(tmp_path, chains,
                                                    servers):
    chain = chains["port"]
    dumps = {}
    for side in SIDES:
        home = str(tmp_path / side)
        cli = mod(side, "cmd.main").main
        assert cli(["init", "--home", home]) == 0
        cfg = mod(side, "config").Config.load(home)
        cfg.base.db_backend = "filedb"
        cfg.statesync.rpc_servers = \
            f"{rpc_addr(servers['port'])},{rpc_addr(servers['jax'])}"
        cfg.statesync.trust_height = 1
        cfg.statesync.trust_hash = chain.blocks[0].hash().hex()
        cfg.statesync.trust_period_seconds = TRUST_PERIOD
        cfg.write()
        with open(os.path.join(servers["port"].home, "config",
                               "genesis.json")) as f, \
                open(cfg.path(cfg.base.genesis_file), "w") as g:
            g.write(f.read())
        argv = ["bootstrap-state", "--home", home, "--height", "10"]
        assert cli(argv + (["--device", "cpu"] if side == "port" else [])) \
            == 0
        kv = mod(side, "db.kv")
        ddir = cfg.path(cfg.base.db_dir)
        dumps[side] = [_dump(kv.open_db("filedb", name, ddir))
                       for name in ("state", "blockstore")]
        # a second bootstrap into the same stores is refused
        assert cli(argv + (["--device", "cpu"] if side == "port" else [])) \
            == 1
    assert dumps["port"] == dumps["jax"]
    assert dumps["port"][0] and dumps["port"][1]


def _verify_raising(monkeypatch, side, error):
    validation = mod(side, "types.validation")
    real = validation.verify_commit_light

    def verify(chain_id, vals, block_id, height, *a, **kw):
        if height > 1:     # past the trust root: the anchor's verify
            raise error
        return real(chain_id, vals, block_id, height, *a, **kw)
    monkeypatch.setattr(validation, "verify_commit_light", verify)


@pytest.mark.parametrize("fault", ["canary", "build"])
def test_kernel_fault_in_the_anchor_stops_the_boot(tmp_path, chains,
                                                   servers, fault,
                                                   monkeypatch):
    """Port: the boot stops with the error in `boot_error`; no
    consensus, no block stored (no blocksync from genesis). The JAX
    package, given the same fault, falls back to blocksync from genesis
    and starts consensus."""
    from cometbft_tpu_torch.ops.ed25519 import KernelCanaryError
    errors = {"canary": KernelCanaryError("canary lane accepted"),
              "build": RuntimeError("nvcc failed for rlc_window_sums")}
    chain = chains["port"]
    nodes = {}
    try:
        for side in SIDES:
            _verify_raising(monkeypatch, side, errors[fault])
            # the JAX node retries its failing candidates until discovery
            # ends, then falls back
            nodes[side] = _syncing_node(side, tmp_path, chain, servers,
                                        "port", f"fault-{side}",
                                        discovery_ms=2_000)
            nodes[side].start()
        port, jax = nodes["port"], nodes["jax"]
        wait_for(lambda: port.boot_error is not None, "the port boot error")
        assert port.boot_error is errors[fault]
        wait_for(lambda: _consensus_running(jax), "the JAX consensus")
        assert not _consensus_running(port)
        assert port.block_store.height() == 0
        assert port.statesync_state is None
    finally:
        for nd in nodes.values():
            nd.stop()


@pytest.mark.parametrize("side", SIDES)
def test_peer_fault_falls_back_to_blocksync_from_genesis(tmp_path, chains,
                                                         servers, side):
    """A trust hash no server's header has: the light client refuses the
    trust root (a peer's fault, StateSyncError), and the node blocksyncs
    from genesis to 12 and starts consensus, in both packages."""
    chain = chains["port"]
    nd = _syncing_node(side, tmp_path, chain, servers, "port",
                       f"bad-root-{side}", trust_hash=b"\x42" * 32)
    try:
        nd.start()
        wait_for(lambda: _consensus_running(nd) and
                 nd.consensus.state.last_block_height >= CHAIN_LEN,
                 "blocksync from genesis")
        assert getattr(nd, "boot_error", None) is None
        assert nd.block_store.load_block(1).hash() == chain.blocks[0].hash()
    finally:
        nd.stop()
