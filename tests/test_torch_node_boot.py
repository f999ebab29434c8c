"""The port `Node`'s boot sync (`Node.start` with block sync on:
`_sync_then_consensus`, `_device_batch_size`, `_prewarm_kernels`,
`boot_error`), held against the JAX package on the CPU over loopback TCP,
against a JAX node that serves the 18-block, 4-validator chain of the
port's `generate_chain` from FileDB stores:

- a fresh port node catches up through `start()` natively (batch 0) and
  with `_device_batch_size` set to 64, so the plain kernels run through
  the node's device route (the pipeline at depth 4 on the in-process
  backend), reaching the serving node's height, blocks and app hash, as
  a fresh JAX node does;
- against a peer serving a tampered signature at height 9 both packages'
  fresh nodes ban it, stop at the same height with the same app hash and
  start consensus there;
- a kernel fault during the boot sync (a raising window-sums kernel, a
  tripped canary) or in the node's prewarm starts no consensus and is
  kept in `boot_error`.

Port nodes run with `device="cpu"`; every wait has its own deadline.
Results are heights, hashes and exception types: no tolerance.
"""

import time

import pytest
import torch

from _torch_node import make_node, mod, port_chain, stop_all, wait_for, \
    write_home

SIDES = ("jax", "port")
BOOT_BLOCKS = 18   # the first boot tile holds 16 commits x 4 = 64 lanes

torch.set_num_threads(1)


def _height(nd) -> int:
    return nd.consensus.state.last_block_height


@pytest.fixture(scope="module")
def chain():
    return port_chain(BOOT_BLOCKS, n_validators=4, seed=7)


@pytest.fixture
def server(tmp_path, chain):
    """A JAX node serving the chain's 18 blocks from FileDB stores (its
    state at 18), not a validator, started with block sync off."""
    home = str(tmp_path / "server")
    write_home("jax", home, chain, BOOT_BLOCKS)
    cfg = mod("jax", "config").Config.load(home)
    cfg.base.block_sync = False
    cfg.rpc.enable = False
    cfg.p2p.laddr = "127.0.0.1:0"
    nd = mod("jax", "node.node").Node(cfg)
    nd.start()
    yield nd
    nd.stop()


def _fresh(side: str, tmp_path, chain, peer, name: str):
    from cometbft_tpu_torch.node.node import save_genesis
    gpath = str(tmp_path / f"{name}-genesis.json")
    write = mod(side, "node.node").save_genesis if side == "jax" \
        else save_genesis
    gen = chain.genesis
    write(mod(side, "state.state").GenesisDoc(
        chain_id=gen.chain_id, genesis_time=gen.genesis_time,
        validators=[mod(side, "types.validator").Validator(
            mod(side, "crypto.keys").pubkey_from_type_bytes(
                v.pub_key.type_(), v.pub_key.bytes_()), v.voting_power)
            for v in gen.validators]), gpath)
    h, p = peer.p2p_addr
    return make_node(side, str(tmp_path / name), gpath, block_sync=True,
                     moniker=name, rpc__enable=False,
                     p2p__persistent_peers=f"{h}:{p}")


def _reset_caches():
    for side in SIDES:
        mod(side, "pipeline.cache").reset_shared_cache()


def _consensus_running(nd) -> bool:
    thread = nd.consensus._thread
    return thread is not None and thread.is_alive()


@pytest.mark.parametrize("route", ["native", "plain_kernels"])
def test_fresh_port_node_catches_up_from_a_jax_node(tmp_path, chain,
                                                    server, route,
                                                    monkeypatch):
    from cometbft_tpu_torch.node.node import Node
    from cometbft_tpu_torch.ops import ed25519 as ped
    _reset_caches()
    if route == "plain_kernels":
        monkeypatch.setattr(Node, "_device_batch_size",
                            lambda self, n: 64)
    before = dict(ped.STATS)
    nd = _fresh("port", tmp_path, chain, server, "fresh")
    try:
        nd.start()
        wait_for(lambda: _consensus_running(nd) or nd.boot_error,
                 "boot sync")
        assert nd.boot_error is None
        wait_for(lambda: _height(nd) >= BOOT_BLOCKS, "the server's height")
        assert nd.consensus.state.app_hash == \
            server.consensus.state.app_hash
        assert [nd.block_store.load_block(h).hash()
                for h in range(1, BOOT_BLOCKS + 1)] == \
            [b.hash() for b in chain.blocks]
        engine = nd.boot_engine
        assert engine is not None and engine.stats.sigs_verified >= 64
        if route == "plain_kernels":
            assert engine.pipeline_depth == 4
            assert ped.STATS["rlc_pass"] > before["rlc_pass"]
        else:
            assert engine.verifier.batch_size == 0
    finally:
        nd.stop()


def test_fresh_jax_node_catches_up_the_same(tmp_path, chain, server):
    _reset_caches()
    nd = _fresh("jax", tmp_path, chain, server, "jfresh")
    try:
        nd.start()
        wait_for(lambda: _height(nd) >= BOOT_BLOCKS, "the server's height")
        assert nd.consensus.state.app_hash == \
            server.consensus.state.app_hash
    finally:
        nd.stop()


def _short_pool(monkeypatch):
    """The boot pool's wait for a block a banned peer never sends: 2 s
    (30 s by default), in both packages."""
    for side in SIDES:
        cls = mod(side, "engine.pool").PooledSource
        defaults = list(cls.__init__.__defaults__)
        defaults[-1] = 2.0
        monkeypatch.setattr(cls.__init__, "__defaults__", tuple(defaults))


def test_tampered_peer_stops_both_packages_at_the_same_height(
        tmp_path, chain, monkeypatch):
    """The server's block 10 carries a last commit with one flipped
    signature byte: each fresh node bans it at the tile that holds
    height 9, keeps what it applied, and starts consensus there."""
    _short_pool(monkeypatch)
    from cometbft_tpu_torch.engine.chain_gen import _corrupt_block
    bad = port_chain(BOOT_BLOCKS, n_validators=4, seed=7)
    bad.blocks[9] = _corrupt_block(bad.blocks[9], "sig")
    home = str(tmp_path / "liar")
    write_home("jax", home, bad, BOOT_BLOCKS)
    cfg = mod("jax", "config").Config.load(home)
    cfg.base.block_sync = False
    cfg.rpc.enable = False
    cfg.p2p.laddr = "127.0.0.1:0"
    liar = mod("jax", "node.node").Node(cfg)
    liar.start()
    fresh = {}
    try:
        _reset_caches()
        for side in SIDES:
            fresh[side] = _fresh(side, tmp_path, chain, liar, f"{side}-f")
            fresh[side].start()
        for side in SIDES:
            wait_for(lambda s=side: _consensus_running(fresh[s]),
                     f"{side} consensus after the ban")
        heights = {s: _height(fresh[s]) for s in SIDES}
        assert heights["jax"] == heights["port"] < 9, heights
        assert fresh["port"].consensus.state.app_hash == \
            fresh["jax"].consensus.state.app_hash
        assert fresh["port"].boot_error is None
    finally:
        stop_all(fresh.values())
        liar.stop()


def _raise_from_window_sums(monkeypatch):
    from cometbft_tpu_torch.ops import cuda_verify as cv

    def boom(*_a):
        raise RuntimeError("rlc_window_sums launch failed: cudaError 1")
    monkeypatch.setattr(cv, "rlc_window_sums_plain", boom)
    return RuntimeError


def _trip_the_canary(monkeypatch):
    from cometbft_tpu_torch.ops import cuda_verify as cv
    from cometbft_tpu_torch.ops import ed25519 as ped
    monkeypatch.setitem(ped._canary, "dispatches", 0)
    monkeypatch.setattr(cv, "rlc_epilogue_plain",
                        lambda *a: torch.tensor(True))
    return ped.KernelCanaryError


FAULTS = {
    # the kernels warmed (this process's prewarm memo), then the boot
    # sync's first flush fails
    "sync_kernel_error": (True, _raise_from_window_sums),
    "sync_canary_trip": (True, _trip_the_canary),
    # the node's own prewarm fails
    "prewarm_kernel_error": (False, _raise_from_window_sums),
}


@pytest.mark.parametrize("case", sorted(FAULTS))
def test_kernel_fault_during_boot_starts_no_consensus(tmp_path, chain,
                                                      server, case,
                                                      monkeypatch):
    from cometbft_tpu_torch.node.node import Node
    from cometbft_tpu_torch.ops import ed25519 as ped
    warm, fault = FAULTS[case]
    _reset_caches()
    monkeypatch.setattr(Node, "_device_batch_size", lambda self, n: 64)
    if warm:
        ped.prewarm_verify_kernels(64, device="cpu")
    else:
        monkeypatch.setattr(ped, "_prewarmed", set())
    err = fault(monkeypatch)
    nd = _fresh("port", tmp_path, chain, server, "faulty")
    try:
        nd.start()
        wait_for(lambda: nd.boot_error is not None, "the boot error")
        assert isinstance(nd.boot_error, err), repr(nd.boot_error)
        time.sleep(0.3)
        assert not _consensus_running(nd)
        assert _height(nd) < BOOT_BLOCKS
    finally:
        nd.stop()
