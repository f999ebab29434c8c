"""CLI (reference cmd/cometbft/commands/: init, start, testnet, show-*,
rollback, reset, inspect, light, compact).

    python -m cometbft_tpu_torch.cmd.main init --home DIR
    python -m cometbft_tpu_torch.cmd.main start --home DIR [--device cpu]
    python -m cometbft_tpu_torch.cmd.main testnet --v 4 --o DIR
    python -m cometbft_tpu_torch.cmd.main rollback --home DIR [--hard]
    python -m cometbft_tpu_torch.cmd.main reset --home DIR
    python -m cometbft_tpu_torch.cmd.main show-node-id --home DIR
    python -m cometbft_tpu_torch.cmd.main show-validator --home DIR
    python -m cometbft_tpu_torch.cmd.main inspect --home DIR
    python -m cometbft_tpu_torch.cmd.main compact --home DIR
    python -m cometbft_tpu_torch.cmd.main bootstrap-state --home DIR \
        [--height H] [--device cpu]
    python -m cometbft_tpu_torch.cmd.main light CHAIN_ID --primary H:P \
        --witnesses H:P --trusted-height N --trusted-hash HEX [--device cpu]
    python -m cometbft_tpu_torch.cmd.main abci-cli echo|info|query|check_tx \
        [ARG] --address tcp://H:P

Copy of `cometbft_tpu/cmd/main.py` in the port. `start`,
`bootstrap-state` and `light` take `--device`, the torch device they
verify on (default cuda; `cpu` runs every kernel's plain version, and a
node's blocksync natively). There is no compile cache to enable: the CUDA
kernels build at first use into `build/` (`ops/_build.py`). `start` exits
1 when the node's boot fails (a kernel build, launch or canary fault
during the statesync anchor or the boot sync); `bootstrap-state` lets
such an error out, and `light` exits 1 on it. `abci-cli` speaks the
socket transport; a `grpc://` address raises NotImplementedError (gRPC
needs the grpcio package, ROADMAP.md Queue 1 item 11.4).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

from ..types.proto import Timestamp


def _cfg(home: str):
    from ..config import Config
    path = os.path.join(home, "config/config.toml")
    if os.path.exists(path):
        return Config.load(home)
    cfg = Config(root_dir=home)
    return cfg


def cmd_init(args) -> int:
    """reference commands/init.go: config + genesis + privval + node key."""
    from ..config import Config
    from ..privval.file import FilePV
    from ..node.node import save_genesis
    from ..state.state import GenesisDoc
    from ..types.validator import Validator
    home = args.home
    os.makedirs(os.path.join(home, "config"), exist_ok=True)
    os.makedirs(os.path.join(home, "data"), exist_ok=True)
    cfg = Config(root_dir=home)
    if args.chain_id:
        cfg.base.chain_id = args.chain_id
    cfg.write()
    pv = FilePV.load_or_generate(cfg.path(cfg.base.priv_validator_file))
    gen_path = cfg.path(cfg.base.genesis_file)
    if not os.path.exists(gen_path):
        save_genesis(GenesisDoc(
            chain_id=cfg.base.chain_id,
            genesis_time=Timestamp.now(),
            validators=[Validator(pv.get_pub_key(), 10)]), gen_path)
    print(f"initialized node home at {home}")
    return 0


def cmd_start(args) -> int:
    """reference commands/run_node.go."""
    from ..node.node import Node
    cfg = _cfg(args.home)
    if args.p2p_laddr:
        cfg.p2p.laddr = args.p2p_laddr
    if args.rpc_laddr:
        cfg.rpc.laddr = args.rpc_laddr
    if args.persistent_peers:
        cfg.p2p.persistent_peers = args.persistent_peers
    if getattr(args, "proxy_app", ""):
        cfg.base.proxy_app = args.proxy_app
    import faulthandler
    import signal as _signal
    import time
    faulthandler.register(_signal.SIGUSR1)  # live thread dump for hangs

    def _terminate(signum, frame):
        raise KeyboardInterrupt
    _signal.signal(_signal.SIGTERM, _terminate)  # stop cleanly on kill
    # the device is resolved once, here: cuda unless --device says else
    node = Node(cfg, device=args.device or None)
    node.consensus.on_commit = lambda block, commit: print(
        f"committed height={block.header.height} "
        f"round={commit.round} txs={len(block.data.txs)}", flush=True)
    node.start()
    print(f"node started: p2p={node.p2p_addr} "
          f"rpc={node.rpc_server.addr if node.rpc_server else None} "
          f"device={node.device}", flush=True)
    try:
        # the boot sync runs on a thread: its fault is only seen here
        while node.boot_error is None:
            time.sleep(0.2)
        print(f"node boot failed: {node.boot_error!r}", file=sys.stderr,
              flush=True)
        return 1
    except KeyboardInterrupt:
        return 0
    finally:
        node.stop()


def cmd_testnet(args) -> int:
    """reference commands/testnet.go: write N validator homes sharing a
    genesis, with deterministic ports and a full persistent-peer mesh —
    the homes must form a network when started as-is."""
    from ..config import Config
    from ..privval.file import FilePV
    from ..node.node import save_genesis
    from ..state.state import GenesisDoc
    from ..types.validator import Validator
    n = args.v
    base_port = args.base_port
    p2p_ports = [base_port + 2 * i for i in range(n)]
    rpc_ports = [base_port + 2 * i + 1 for i in range(n)]
    pvs, vals = [], []
    for i in range(n):
        home = os.path.join(args.o, f"node{i}")
        os.makedirs(os.path.join(home, "config"), exist_ok=True)
        os.makedirs(os.path.join(home, "data"), exist_ok=True)
        cfg = Config(root_dir=home)
        cfg.base.chain_id = args.chain_id
        cfg.base.moniker = f"node{i}"
        cfg.p2p.laddr = f"127.0.0.1:{p2p_ports[i]}"
        cfg.rpc.laddr = f"127.0.0.1:{rpc_ports[i]}"
        cfg.p2p.persistent_peers = ",".join(
            f"127.0.0.1:{p}" for j, p in enumerate(p2p_ports) if j != i)
        cfg.write()
        pv = FilePV.load_or_generate(
            cfg.path(cfg.base.priv_validator_file))
        pvs.append(pv)
        vals.append(Validator(pv.get_pub_key(), 10))
    order = sorted(range(n), key=lambda i: vals[i].address)
    gen = GenesisDoc(chain_id=args.chain_id,
                     genesis_time=Timestamp.now(),
                     validators=[vals[i] for i in order])
    for i in range(n):
        save_genesis(gen, os.path.join(args.o, f"node{i}",
                                       "config/genesis.json"))
    print(f"wrote {n} node homes under {args.o} "
          f"(p2p ports {p2p_ports[0]}..{p2p_ports[-1]})")
    return 0


def cmd_rollback(args) -> int:
    """reference commands/rollback.go."""
    from ..db.kv import open_db
    from ..state.rollback import rollback_state
    from ..state.state import StateStore
    from ..store.blockstore import BlockStore
    cfg = _cfg(args.home)
    ddir = cfg.path(cfg.base.db_dir)
    ss = StateStore(open_db(cfg.base.db_backend, "state", ddir))
    bs = BlockStore(open_db(cfg.base.db_backend, "blockstore", ddir))
    state = rollback_state(ss, bs, remove_block=args.hard)
    print(f"rolled back to height {state.last_block_height} "
          f"(app_hash {state.app_hash.hex()[:16]})")
    return 0


def cmd_bootstrap_state(args) -> int:
    """Offline state bootstrap (reference node/node.go:152
    BootstrapState + commands/bootstrap_state.go): with the node
    STOPPED, fetch a light-verified state at --height from the
    [statesync] rpc_servers and write it (plus the seen commit) into
    the stores, so the next `start` continues from there without
    replaying history. The app must separately hold matching state
    (e.g. restored from its own snapshot/backup). The light client runs
    on `--device` (default cuda); its errors propagate."""
    from ..db.kv import open_db
    from ..node.node import load_genesis
    from ..state.state import StateStore
    from ..statesync.stateprovider import light_provider_from_config
    from ..store.blockstore import BlockStore
    cfg = _cfg(args.home)
    ss_cfg = cfg.statesync
    ss_cfg.enable = True  # reuse its validation for the trust anchor
    ss_cfg.validate_basic()
    gen = load_genesis(cfg.path(cfg.base.genesis_file))
    ddir = cfg.path(cfg.base.db_dir)
    store = StateStore(open_db(cfg.base.db_backend, "state", ddir))
    existing = store.load()
    if existing is not None and existing.last_block_height > 0:
        # reference BootstrapState refuses a non-empty state store: the
        # app and block store still hold the old height, and clobbering
        # the state would desync all three with no error until start
        print(f"refusing to bootstrap: state store already at height "
              f"{existing.last_block_height} (run `reset` first if you "
              f"really mean to discard it)", file=sys.stderr)
        return 1
    provider = light_provider_from_config(ss_cfg, gen,
                                          device=args.device or None)
    height = args.height or ss_cfg.trust_height
    state = provider.state(height)
    store.save(state)
    BlockStore(open_db(cfg.base.db_backend, "blockstore", ddir)) \
        .bootstrap_seen_commit(height, provider.commit(height))
    print(f"bootstrapped state at height {height} "
          f"(app_hash {state.app_hash.hex()[:16]})")
    return 0


def cmd_reset(args) -> int:
    """reference commands/reset.go unsafe-reset-all: wipe data, keep the
    privval key but reset its sign state carefully — we keep the state
    (never reset a double-sign guard automatically)."""
    cfg = _cfg(args.home)
    ddir = cfg.path(cfg.base.db_dir)
    if os.path.isdir(ddir):
        shutil.rmtree(ddir)
    os.makedirs(ddir, exist_ok=True)
    print(f"reset data dir {ddir} (privval sign-state preserved)")
    return 0


def cmd_show_node_id(args) -> int:
    """The P2P identity (from the persisted node key, NOT the validator
    privval key — they are different identities, p2p/node_key.go)."""
    from ..node.node import load_or_generate_node_key
    cfg = _cfg(args.home)
    key = load_or_generate_node_key(cfg.path(cfg.base.node_key_file))
    print(key.pub_key().address().hex())
    return 0


def cmd_show_validator(args) -> int:
    from ..privval.file import FilePV
    cfg = _cfg(args.home)
    pv = FilePV.load_or_generate(cfg.path(cfg.base.priv_validator_file))
    print(json.dumps({"type": "ed25519",
                      "value": pv.get_pub_key().bytes_().hex()}))
    return 0


def cmd_inspect(args) -> int:
    """reference internal/inspect: read-only view over a stopped node's
    data dirs."""
    from ..db.kv import open_db
    from ..state.state import StateStore
    from ..store.blockstore import BlockStore
    cfg = _cfg(args.home)
    ddir = cfg.path(cfg.base.db_dir)
    bs = BlockStore(open_db(cfg.base.db_backend, "blockstore", ddir))
    ss = StateStore(open_db(cfg.base.db_backend, "state", ddir))
    st = ss.load()
    out = {"base": bs.base(), "height": bs.height(),
           "state_height": st.last_block_height if st else None,
           "app_hash": st.app_hash.hex() if st else None,
           "validators": len(st.validators) if st else None}
    print(json.dumps(out, indent=1))
    return 0


def cmd_compact(args) -> int:
    """reference commands/compact.go."""
    from ..db.kv import open_db
    cfg = _cfg(args.home)
    ddir = cfg.path(cfg.base.db_dir)
    for name in ("blockstore", "state", "indexer"):
        db = open_db(cfg.base.db_backend, name, ddir)
        compact = getattr(db, "compact", None)
        if compact is not None:
            compact()
        db.close()
    print("compacted")
    return 0


def cmd_light(args) -> int:
    """Run a light-client proxy against a full node (reference
    cmd/cometbft/commands/light.go): all reads served from --laddr are
    verified against light-client-checked headers. Exits 1 when a read
    fails for a reason that is not the peers' fault (a kernel fault:
    `LightProxy.fatal`)."""
    import time
    from ..light.rpc import build_light_proxy
    proxy = build_light_proxy(
        args.chain_id, args.primary, args.witnesses.split(","),
        laddr=args.laddr, trusted_height=args.trusted_height,
        trusted_hash=args.trusted_hash, trust_period=args.trust_period,
        device=args.device or None)
    proxy.start()
    t_height = proxy.client.light.latest_trusted().height
    print(f"light proxy listening on {proxy.addr} "
          f"(primary {args.primary}, trusted height {t_height}, device "
          f"{proxy.client.light.device})", flush=True)
    try:
        while proxy.fatal is None:
            time.sleep(0.2)
        print(f"light proxy failed: {proxy.fatal!r}", file=sys.stderr,
              flush=True)
        return 1
    except KeyboardInterrupt:
        return 0
    finally:
        proxy.stop()


def cmd_abci_cli(args) -> int:
    """Minimal abci-cli (reference abci/cmd/abci-cli): poke an ABCI
    server — echo / info / query / check_tx — for debugging external
    apps before pointing a node at them. The socket transport only: a
    grpc:// address raises (the gRPC client is not ported)."""
    addr = args.address
    if addr.startswith("grpc://"):
        raise NotImplementedError(
            "abci-cli over grpc:// needs abci/grpc.py and the grpcio "
            "package, not ported yet (ROADMAP.md Queue 1 item 11.4)")
    from ..abci.socket import SocketClient
    host, _, port = addr.removeprefix("tcp://").rpartition(":")
    c = SocketClient(host or "127.0.0.1", int(port), connect_retry_s=5.0)
    try:
        if args.abci_command == "echo":
            print(c.echo(args.arg or "hello"))
        elif args.abci_command == "info":
            i = c.info()
            print(f"data={i.data} version={i.version} "
                  f"height={i.last_block_height} "
                  f"app_hash={i.last_block_app_hash.hex()}")
        elif args.abci_command == "query":
            code, value = c.query(args.path, (args.arg or "").encode())
            print(f"code={code} value={value!r}")
        elif args.abci_command == "check_tx":
            r = c.check_tx((args.arg or "").encode())
            print(f"code={r.code} log={r.log!r}")
        else:
            print(f"unknown abci command {args.abci_command!r} "
                  f"(echo|info|query|check_tx)", file=sys.stderr)
            return 1
        return 0
    finally:
        c.close()


def cmd_device_server(args) -> int:
    from ..device.server import main as device_main
    return device_main(["--laddr", args.laddr,
                        "--bucket", str(args.bucket),
                        "--max-msg-len", str(args.max_msg_len)]
                       + (["--device", args.device] if args.device else []))


def cmd_reindex(args) -> int:
    """Rebuild the tx/block indexes from stored blocks + saved ABCI
    responses (reference commands/reindex_event.go)."""
    from ..abci.application import ResponseFinalizeBlock
    from ..db.kv import open_db
    from ..indexer.kv import BlockIndexer, TxIndexer, reindex_block
    from ..state.state import StateStore
    from ..store.blockstore import BlockStore
    cfg = _cfg(args.home)
    be, ddir = cfg.base.db_backend, cfg.path(cfg.base.db_dir)
    blocks = BlockStore(open_db(be, "blockstore", ddir))
    states = StateStore(open_db(be, "state", ddir))
    idx_db = open_db(be, "indexer", ddir)
    txi, bli = TxIndexer(idx_db), BlockIndexer(idx_db)
    lo = args.start_height or blocks.base()
    hi = args.end_height or blocks.height()
    n_blocks = n_txs = 0
    for h in range(lo, hi + 1):
        blk = blocks.load_block(h)
        raw = states.load_finalize_block_response(h)
        if blk is None or raw is None:
            continue
        n_txs += reindex_block(txi, bli, blk,
                               ResponseFinalizeBlock.decode(raw))
        n_blocks += 1
    print(f"reindexed {n_blocks} blocks / {n_txs} txs "
          f"(heights {lo}..{hi})")
    return 0


def cmd_debug(args) -> int:
    """Capture a running node's state into a debug directory
    (reference commands/debug/: status, net_info, consensus dumps,
    recent blockchain info over live RPC)."""
    from ..rpc.client import RPCClient, RPCClientError
    host, _, port = args.rpc.rpartition(":")
    rpc = RPCClient(host or "127.0.0.1", int(port), timeout=10)
    os.makedirs(args.o, exist_ok=True)
    captured = []
    for name in ("status", "net_info", "consensus_state",
                 "dump_consensus_state", "consensus_params",
                 "num_unconfirmed_txs", "blockchain"):
        try:
            out = rpc.call(name)
        except (RPCClientError, OSError) as e:
            out = {"error": str(e)}
        with open(os.path.join(args.o, f"{name}.json"), "w") as f:
            json.dump(out, f, indent=1)
        captured.append(name)
    print(f"wrote {len(captured)} dumps to {args.o}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cometbft_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    def add(name, fn, **extra_args):
        sp = sub.add_parser(name)
        sp.add_argument("--home", default=os.path.expanduser("~/.cometbft_tpu"))
        for flag, kw in extra_args.items():
            sp.add_argument(f"--{flag.replace('_', '-')}", **kw)
        sp.set_defaults(fn=fn)
        return sp

    add("init", cmd_init, chain_id={"default": ""})
    add("start", cmd_start, p2p_laddr={"default": ""},
        rpc_laddr={"default": ""}, persistent_peers={"default": ""},
        proxy_app={"default": ""},
        device={"default": "", "help": "torch device the node verifies "
                "on: cuda (the default) or cpu"})
    tn = sub.add_parser("testnet")
    tn.add_argument("--v", type=int, default=4)
    tn.add_argument("--o", default="./testnet")
    tn.add_argument("--chain-id", dest="chain_id", default="tpu-testnet")
    tn.add_argument("--base-port", dest="base_port", type=int,
                    default=26656)
    tn.set_defaults(fn=cmd_testnet)
    rb = add("rollback", cmd_rollback)
    rb.add_argument("--hard", action="store_true")
    bsst = add("bootstrap-state", cmd_bootstrap_state)
    bsst.add_argument("--height", type=int, default=0)
    bsst.add_argument("--device", default="",
                      help="torch device the light client verifies on: "
                      "cuda (the default) or cpu")
    add("reset", cmd_reset)
    add("show-node-id", cmd_show_node_id)
    add("show-validator", cmd_show_validator)
    add("inspect", cmd_inspect)
    add("compact", cmd_compact)
    lt = sub.add_parser("light")
    lt.add_argument("chain_id")
    lt.add_argument("--primary", required=True,
                    help="host:port of the full node to proxy")
    lt.add_argument("--witnesses", default="",
                    help="comma-separated host:port cross-check nodes")
    lt.add_argument("--laddr", default="127.0.0.1:0")
    lt.add_argument("--trusted-height", dest="trusted_height", type=int,
                    default=0)
    lt.add_argument("--trusted-hash", dest="trusted_hash", default="")
    lt.add_argument("--trust-period", dest="trust_period", type=int,
                    default=168 * 3600)
    lt.add_argument("--device", default="",
                    help="torch device the light client verifies on: cuda "
                    "(the default) or cpu")
    lt.set_defaults(fn=cmd_light)
    ac = sub.add_parser("abci-cli")
    ac.add_argument("abci_command")
    ac.add_argument("arg", nargs="?", default="")
    ac.add_argument("--address", default="tcp://127.0.0.1:26658")
    ac.add_argument("--path", default="/store")
    ac.set_defaults(fn=cmd_abci_cli)
    dv = sub.add_parser("device-server")
    dv.add_argument("--laddr", default="127.0.0.1:28657")
    dv.add_argument("--bucket", type=int, default=1024)
    dv.add_argument("--max-msg-len", dest="max_msg_len", type=int,
                    default=256)
    dv.add_argument("--device", default="",
                    help="torch device the flushes run on (default cuda)")
    dv.set_defaults(fn=cmd_device_server)
    ri = add("reindex", cmd_reindex)
    ri.add_argument("--start-height", dest="start_height", type=int,
                    default=0)
    ri.add_argument("--end-height", dest="end_height", type=int,
                    default=0)
    dbg = sub.add_parser("debug")
    dbg.add_argument("--rpc", default="127.0.0.1:26657")
    dbg.add_argument("--o", default="./debug-dump")
    dbg.set_defaults(fn=cmd_debug)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
