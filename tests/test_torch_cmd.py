"""The port's command line (`python -m cometbft_tpu_torch.cmd.main`), held
against the JAX package's CLI on the CPU:

- `init` and `testnet` write the same files (config.toml byte for byte;
  keys are random, so genesis files are compared without their keys and
  clock), and each package reads the other's keys (`show-node-id`,
  `show-validator` print the same);
- `reset`, `inspect`, `compact`, `rollback` (soft and `--hard`) and
  `reindex` on copies of one home (the port's 6-block chain in FileDB
  stores) print the same and leave byte-identical data files;
- `debug` against one RPC server writes the same dumps;
- each package's `start` boots a node from the other's `init` and
  commits height 1, and exits 0 on SIGTERM;
- `light`, `bootstrap-state` and `abci-cli` raise NotImplementedError
  naming their ROADMAP.md item.

Results are bytes and printed text: no tolerance.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

import pytest

from _torch_node import mod, port_chain, write_home

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = ("jax", "port")
MODULE = {"jax": "cometbft_tpu.cmd.main", "port": "cometbft_tpu_torch.cmd.main"}


def _run(side: str, argv, capsys):
    """-> (exit code, stdout), or (exception type, message) where the
    command raises."""
    capsys.readouterr()
    try:
        rc = mod(side, "cmd.main").main(argv)
    except Exception as e:  # noqa: BLE001 — compared across packages
        capsys.readouterr()
        return type(e).__name__, str(e)
    return rc, capsys.readouterr().out


def _files(root: str) -> dict:
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _genesis_shape(path: str) -> dict:
    with open(path) as f:
        g = json.load(f)
    g.pop("genesis_time")
    g["validators"] = [{k: v for k, v in val.items() if k != "pub_key"}
                       for val in g["validators"]]
    return g


def test_init_writes_the_same_files_and_keys_cross_read(tmp_path, capsys):
    outs, files = {}, {}
    for side in SIDES:
        home = str(tmp_path / side)
        outs[side] = _run(side, ["init", "--home", home, "--chain-id",
                                 "cli-chain"], capsys)
        files[side] = _files(home)
    assert outs["jax"][0] == outs["port"][0] == 0
    assert outs["jax"][1].replace(str(tmp_path / "jax"), "H") == \
        outs["port"][1].replace(str(tmp_path / "port"), "H")
    assert sorted(files["jax"]) == sorted(files["port"])
    assert files["jax"]["config/config.toml"] == \
        files["port"]["config/config.toml"]
    assert _genesis_shape(str(tmp_path / "jax/config/genesis.json")) == \
        _genesis_shape(str(tmp_path / "port/config/genesis.json"))
    for home in SIDES:
        for cmd in ("show-node-id", "show-validator"):
            seen = {side: _run(side, [cmd, "--home", str(tmp_path / home)],
                               capsys) for side in SIDES}
            assert seen["jax"] == seen["port"], (home, cmd)
    # the validator key is the genesis validator, in either package
    with open(tmp_path / "jax/config/genesis.json") as f:
        gen_key = json.load(f)["validators"][0]["pub_key"]
    shown = _run("port", ["show-validator", "--home",
                          str(tmp_path / "jax")], capsys)[1]
    assert json.loads(shown)["value"] == gen_key


def test_testnet_writes_the_same_homes(tmp_path, capsys):
    files, outs = {}, {}
    for side in SIDES:
        out = str(tmp_path / side)
        outs[side] = _run(side, ["testnet", "--v", "4", "--o", out,
                                 "--chain-id", "tn", "--base-port",
                                 "36656"], capsys)
        files[side] = _files(out)
    assert outs["jax"][1].replace(str(tmp_path / "jax"), "H") == \
        outs["port"][1].replace(str(tmp_path / "port"), "H")
    assert sorted(files["jax"]) == sorted(files["port"])
    for i in range(4):
        name = f"node{i}/config/config.toml"
        assert files["jax"][name] == files["port"][name]
        assert _genesis_shape(str(tmp_path / "jax" / f"node{i}" /
                                  "config/genesis.json")) == \
            _genesis_shape(str(tmp_path / "port" / f"node{i}" /
                                  "config/genesis.json"))
    # every node of a home set shares one genesis, in either package
    for side in SIDES:
        gens = {files[side][f"node{i}/config/genesis.json"]
                for i in range(4)}
        assert len(gens) == 1
    # the other package reads each node's validator key
    for i in range(4):
        home = str(tmp_path / "jax" / f"node{i}")
        seen = {s: _run(s, ["show-validator", "--home", home], capsys)
                for s in SIDES}
        assert seen["jax"] == seen["port"]


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    """The port's 6-block, 4-validator chain in FileDB stores (the state
    at 6)."""
    root = str(tmp_path_factory.mktemp("cli") / "home")
    chain = port_chain(6, n_validators=4, seed=11, txs_per_block=2)
    write_home("port", root, chain, 6)
    return root


def _copies(home: str, tmp_path):
    out = {}
    for side in SIDES:
        out[side] = str(tmp_path / side)
        shutil.copytree(home, out[side])
    return out


COMMANDS = {
    "inspect": ["inspect"],
    "reset": ["reset"],
    "compact": ["compact"],
    "rollback": ["rollback"],
    "rollback_hard": ["rollback", "--hard"],
    "reindex": ["reindex"],
    "reindex_range": ["reindex", "--start-height", "2", "--end-height",
                      "4"],
}


@pytest.mark.parametrize("case", sorted(COMMANDS))
def test_commands_on_copies_of_one_home(home, tmp_path, capsys, case):
    homes = _copies(home, tmp_path)
    outs = {}
    for side in SIDES:
        argv = [COMMANDS[case][0], "--home", homes[side]] + \
            COMMANDS[case][1:]
        outs[side] = _run(side, argv, capsys)
    assert outs["jax"][0] == outs["port"][0] == 0
    assert outs["jax"][1].replace(homes["jax"], "H") == \
        outs["port"][1].replace(homes["port"], "H")
    assert _files(homes["jax"]) == _files(homes["port"])


def test_inspect_reads_the_stores(home, tmp_path, capsys):
    rc, out = _run("port", ["inspect", "--home", home], capsys)
    got = json.loads(out)
    assert rc == 0 and got["height"] == 6 and got["state_height"] == 6
    assert got["validators"] == 4


def test_debug_writes_the_same_dumps(tmp_path, capsys):
    server = mod("port", "rpc.server")
    srv = server.RPCServer(server.RPCEnvironment(chain_id="dbg"),
                           "127.0.0.1", 0)
    srv.start()
    try:
        dumps = {}
        for side in SIDES:
            out = str(tmp_path / side)
            rc, _ = _run(side, ["debug", "--rpc",
                                f"{srv.addr[0]}:{srv.addr[1]}", "--o", out],
                         capsys)
            assert rc == 0
            dumps[side] = _files(out)
    finally:
        srv.stop()
    assert dumps["jax"] == dumps["port"]
    assert len(dumps["port"]) == 7


def test_unported_commands_raise():
    """abci-cli over grpc:// needs the gRPC transport, which is not
    ported yet (ROADMAP.md Queue 1 item 11.4)."""
    from cometbft_tpu_torch.cmd.main import main
    with pytest.raises(NotImplementedError) as e:
        main(["abci-cli", "echo", "--address", "grpc://127.0.0.1:1"])
    assert "ROADMAP.md Queue 1 item 11.4" in str(e.value)


@pytest.fixture(scope="module")
def chain_server(tmp_path_factory):
    """A port node serving the seeded 12-block, 4-validator chain over
    RPC, and a port ABCIServer over a fresh kvstore."""
    from _torch_node import port_chain, serving_node
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.abci.socket import ABCIServer
    chain = port_chain(12, n_validators=4, seed=5)
    nd = serving_node("port", str(tmp_path_factory.mktemp("srv")), chain,
                      12)
    abci = ABCIServer(KVStoreApplication())
    abci.start()
    yield chain, nd, abci
    abci.stop()
    nd.stop()


@pytest.mark.parametrize("command", ["light", "bootstrap-state",
                                     "abci-cli"])
def test_ported_commands_run(tmp_path, capsys, chain_server, command,
                             monkeypatch):
    """Each command that raised before its module was ported runs:
    `light` serves a verified read until stopped, `bootstrap-state`
    writes a light-verified state, `abci-cli` answers over the socket."""
    from _torch_node import rpc_addr
    from cometbft_tpu_torch.cmd.main import main
    from cometbft_tpu_torch.light import rpc as lrpc
    chain, nd, abci = chain_server
    addr, root = rpc_addr(nd), chain.blocks[0].hash().hex()
    if command == "abci-cli":
        assert main(["abci-cli", "echo", "hi", "--address",
                     "tcp://%s:%d" % abci.addr]) == 0
        assert capsys.readouterr().out == "hi\n"
    elif command == "bootstrap-state":
        home = str(tmp_path / "home")
        assert main(["init", "--home", home]) == 0
        cfg = mod("port", "config").Config.load(home)
        cfg.statesync.rpc_servers = f"{addr},{addr}"
        cfg.statesync.trust_height = 1
        cfg.statesync.trust_hash = root
        cfg.statesync.trust_period_seconds = 10**9
        cfg.write()
        shutil.copy(os.path.join(nd.home, "config", "genesis.json"),
                    cfg.path(cfg.base.genesis_file))
        assert main(["bootstrap-state", "--home", home, "--height", "7",
                     "--device", "cpu"]) == 0
        assert "bootstrapped state at height 7" in capsys.readouterr().out
    else:
        real = lrpc.build_light_proxy
        answers = []

        def build(*a, **kw):
            proxy = real(*a, **kw)
            start = proxy.start

            def start_then_read():
                start()
                c = mod("port", "rpc.client").RPCClient(*proxy.addr)
                answers.append(c.call("block", height=6))
            proxy.start = start_then_read
            return proxy
        real_sleep = time.sleep

        def sleep(s):
            # the command's wait loop: Ctrl-C at its first sleep
            if threading.current_thread() is threading.main_thread():
                raise KeyboardInterrupt
            real_sleep(s)
        monkeypatch.setattr(lrpc, "build_light_proxy", build)
        monkeypatch.setattr(time, "sleep", sleep)
        assert main(["light", chain.chain_id, "--primary", addr,
                     "--witnesses", addr, "--trusted-height", "1",
                     "--trusted-hash", root, "--trust-period",
                     str(10**9), "--device", "cpu"]) == 0
        assert answers[0]["block"]["header"]["height"] == 6


@pytest.mark.parametrize("starter,initer", [("port", "jax"),
                                            ("jax", "port")])
def test_start_boots_from_the_other_packages_init(tmp_path, capsys,
                                                  starter, initer):
    home = str(tmp_path / "home")
    assert _run(initer, ["init", "--home", home, "--chain-id", "boot"],
                capsys)[0] == 0
    config = mod(initer, "config")
    cfg = config.Config.load(home)
    cfg.consensus.timeout_propose = 400
    cfg.consensus.timeout_commit = 50
    cfg.base.block_sync = False   # no peer: skip the 5 s status wait
    cfg.write()
    argv = [sys.executable, "-m", MODULE[starter], "start", "--home", home,
            "--p2p-laddr", "127.0.0.1:0", "--rpc-laddr", "127.0.0.1:0"]
    env = dict(os.environ)
    if starter == "port":
        argv += ["--device", "cpu"]
        env.pop("PYTHONPATH", None)
    else:
        env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout),
                              daemon=True)
    reader.start()
    try:
        deadline = time.monotonic() + 60
        while not any(ln.startswith("committed height=1") for ln in lines):
            assert time.monotonic() < deadline and proc.poll() is None, \
                (lines, proc.poll())
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        reader.join(timeout=10)
        proc.stdout.close()
        proc.stderr.close()
    assert rc == 0 if starter == "port" else rc in (0, -signal.SIGTERM)
