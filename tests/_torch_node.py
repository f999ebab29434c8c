"""Node-boot helpers for the port's tests, built the same way with either
package: node homes (config.toml, genesis.json, FileDB or in-memory
stores), seeded validator keys, nets of in-process `Node`s over loopback
TCP, and deadlines that fail a wait instead of hanging it.

Each package reads the files the other writes (config, genesis, FilePV
keys), so a home written once can be opened by a JAX-package node and by
a port node. Port nodes always run with `device="cpu"` here.
"""

import importlib
import os
import random
import time

PKGS = {"jax": "cometbft_tpu", "port": "cometbft_tpu_torch"}
CHAIN_ID = "node-net"
DEADLINE_S = 60.0


def mod(side: str, name: str):
    return importlib.import_module(f"{PKGS[side]}.{name}")


def dev(side: str) -> dict:
    """The port's entry points run on the card unless told the CPU."""
    return {"device": "cpu"} if side == "port" else {}


def wait_for(cond, what: str, deadline_s: float = DEADLINE_S,
             step: float = 0.05) -> float:
    """Polls `cond` until it holds -> seconds waited; raises TimeoutError
    past the deadline."""
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > deadline_s:
            raise TimeoutError(f"{what}: not reached in {deadline_s} s")
        time.sleep(step)
    return time.monotonic() - t0


def fast_config(side: str, root: str, moniker: str = "n",
                backend: str = "memdb"):
    """A node config with short consensus timeouts (commit 50 ms),
    loopback listeners on free ports and the RPC's unsafe routes on."""
    config = mod(side, "config")
    cfg = config.Config(root_dir=str(root))
    cfg.base.moniker = moniker
    cfg.base.chain_id = CHAIN_ID
    cfg.base.db_backend = backend
    cfg.rpc.unsafe = True
    cfg.rpc.laddr = "127.0.0.1:0"
    cfg.p2p.laddr = "127.0.0.1:0"
    cfg.consensus = config.ConsensusTimeoutsConfig(
        timeout_propose=400, timeout_propose_delta=200,
        timeout_prevote=150, timeout_prevote_delta=100,
        timeout_precommit=150, timeout_precommit_delta=100,
        timeout_commit=50, skip_timeout_commit=True,
        wal_file="data/cs.wal")
    return cfg


def write_validators(tmp, n: int, seed: int = 17):
    """n FilePV key files (port-written) and a genesis over their keys
    (sorted by address, power 10) -> (pv paths, GenesisDoc of the port)."""
    file = mod("port", "privval.file")
    sstate = mod("port", "state.state")
    validator = mod("port", "types.validator")
    proto = mod("port", "types.proto")
    rng = random.Random(seed)
    paths, vals = [], []
    for i in range(n):
        path = os.path.join(str(tmp), f"pv{i}.json")
        pv = file.FilePV.generate(path, rng)
        pv._save()
        paths.append(path)
        vals.append(validator.Validator(pv.get_pub_key(), 10))
    order = sorted(range(n), key=lambda i: vals[i].address)
    gen = sstate.GenesisDoc(chain_id=CHAIN_ID,
                            genesis_time=proto.Timestamp(1_700_000_000, 0),
                            validators=[vals[i] for i in order])
    return [paths[i] for i in order], gen


def make_node(side: str, root: str, genesis_path: str, pv_path=None,
              backend: str = "memdb", block_sync: bool = False,
              moniker: str = "n", **cfg_fields):
    """A `Node` of `side` over the home `root` (its genesis read from
    `genesis_path` by that package)."""
    node = mod(side, "node.node")
    file = mod(side, "privval.file")
    os.makedirs(os.path.join(str(root), "config"), exist_ok=True)
    cfg = fast_config(side, root, moniker, backend)
    cfg.base.block_sync = block_sync
    for key, value in cfg_fields.items():
        section, _, name = key.partition("__")
        setattr(getattr(cfg, section), name, value)
    pv = file.FilePV.load(pv_path) if pv_path else None
    return node.Node(cfg, genesis=node.load_genesis(genesis_path),
                     priv_validator=pv, **dev(side))


def make_net(tmp, sides, seed: int = 17):
    """One validator node per entry of `sides` ("jax" or "port"), sharing
    a genesis; the nodes are built, not started."""
    paths, gen = write_validators(tmp, len(sides), seed)
    gpath = os.path.join(str(tmp), "genesis.json")
    mod("port", "node.node").save_genesis(gen, gpath)
    return [make_node(side, os.path.join(str(tmp), f"node{i}"), gpath,
                      paths[i], moniker=f"n{i}")
            for i, side in enumerate(sides)]


def start_mesh(nodes) -> None:
    """Starts every node and dials each pair once."""
    for nd in nodes:
        nd.start()
    addrs = [nd.p2p_addr for nd in nodes]
    for i, nd in enumerate(nodes):
        for j, (h, p) in enumerate(addrs):
            if j > i:
                try:
                    nd.switch.dial(h, p)
                except OSError:
                    pass


def stop_all(nodes) -> None:
    for nd in nodes:
        if nd is not None:
            nd.stop()


def port_chain(n_blocks: int, n_validators: int = 4, seed: int = 1,
               txs_per_block: int = 2):
    return mod("port", "engine.chain_gen").generate_chain(
        n_blocks, n_validators=n_validators, seed=seed,
        txs_per_block=txs_per_block, device="cpu")


def write_home(side: str, root: str, chain, height: int,
               backend: str = "filedb", blocks: int = None) -> None:
    """A home for `chain` written by `side`: config.toml (filedb),
    genesis.json, the block store holding blocks 1..`blocks` (default
    `height`) with their seen commits, and a state store at `height`
    with each height's FinalizeBlock response (applied without
    verification: the generator verified the chain)."""
    config = mod(side, "config")
    kv = mod(side, "db.kv")
    node = mod(side, "node.node")
    blockstore = mod(side, "store.blockstore")
    sstate = mod(side, "state.state")
    execution = mod(side, "state.execution")
    kvstore = mod(side, "abci.kvstore")
    cfg = config.Config(root_dir=str(root))
    cfg.base.chain_id = chain.chain_id
    cfg.base.db_backend = backend
    cfg.write()
    gen = sstate.GenesisDoc(
        chain_id=chain.genesis.chain_id,
        genesis_time=chain.genesis.genesis_time,
        validators=_revalidators(side, chain.genesis.validators),
        app_hash=chain.genesis.app_hash)
    node.save_genesis(gen, cfg.path(cfg.base.genesis_file))
    ddir = cfg.path(cfg.base.db_dir)
    block = mod(side, "types.block")
    bs = blockstore.BlockStore(kv.open_db(backend, "blockstore", ddir))
    ss = sstate.StateStore(kv.open_db(backend, "state", ddir))
    app = kvstore.KVStoreApplication()
    app.init_chain(chain.chain_id, 1, [], b"")
    ex = execution.BlockExecutor(app, state_store=ss, **dev(side))
    state = sstate.State.from_genesis(gen)
    ss.save(state)
    for h in range(1, (blocks or height) + 1):
        b = block.Block.decode(chain.blocks[h - 1].encode())
        parts = b.make_part_set()
        bs.save_block(b, parts, block.Commit.decode(
            chain.seen_commits[h - 1].encode()))
        if h <= height:
            state, _ = ex.apply_block(
                state, block.BlockID(b.hash(), parts.header), b,
                verified=True)
    bs._db.close()
    ss._db.close()


def _revalidators(side: str, vals):
    keys = mod(side, "crypto.keys")
    validator = mod(side, "types.validator")
    return [validator.Validator(
        keys.pubkey_from_type_bytes(v.pub_key.type_(), v.pub_key.bytes_()),
        v.voting_power) for v in vals]


def serving_node(side: str, home: str, chain, height: int):
    """A started `side` node over a home holding the chain's blocks
    1..`height` (state at `height`, `write_home`), block sync off, RPC and
    p2p on loopback ports: its handshake replays the chain into a fresh
    kvstore, which keeps the snapshots of the last two multiples of 5. It
    is no validator, so the chain stays at `height`. `node.home` is the
    home."""
    write_home(side, home, chain, height)
    cfg = mod(side, "config").Config.load(home)
    cfg.base.block_sync = False
    cfg.p2p.laddr = cfg.rpc.laddr = "127.0.0.1:0"
    nd = mod(side, "node.node").Node(cfg, **dev(side))
    nd.start()
    nd.home = home
    return nd


def rpc_addr(nd) -> str:
    h, p = nd.rpc_server.addr
    return f"{h}:{p}"
