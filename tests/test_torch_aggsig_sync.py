"""The slice as a whole: a chain of aggregated BLS commits generated and
synced by the port (cometbft_tpu_torch) and by the JAX package, on the
CPU, from the same seed.

- `generate_chain(n_blocks=2, n_validators=4, key_type="bls12_381",
  aggregate=True, seed=7)` gives the JAX package's chain byte for byte:
  block hashes, block ids, the encoded AggregatedCommit seals, app and
  validator hashes. The port's executor verified height 1's seal through
  the plain fused kernel on the way.
- `BlocksyncReactor.sync` reaches the JAX package's final state (height,
  app hash, validators hash, last block id, the kvstore's contents and
  the stats) at pipeline depth 1 and 2. The port settles each tile's
  pending seals in one `bls_miller_finalexp` call (2 seals + 2 canary
  items: bucket 4), counted through a spy on the wrapper; on the CPU no
  kernel launches.
- With {2: "sig"} (a flipped aggregate byte in height 1's seal) both
  packages ban the same height and still complete.
- The whole-aggregate verdict is cached: a second `verify_commit` of the
  same seal makes no kernel call.
- A sequential light client trusted at height 1 verifies height 2 (its
  aggregated commit through the plain fused kernel) to the JAX package's
  header and trusted heights.
- The seal source's forged seals, and the seal tuples it serves, equal
  the JAX package's byte for byte.
- No fallback: a wrapper that raises, and a plain version that answers a
  canary wrong (KernelCanaryError), propagate out of `sync` at depth 1
  and 2.

The JAX side runs `batch_size=0` (its host oracle settles the seals).
Both packages' signature caches are reset before each sync.
"""

import dataclasses

import pytest
import torch

from cometbft_tpu.abci.kvstore import KVStoreApplication as JApp
from cometbft_tpu.db.kv import MemDB as JMemDB
from cometbft_tpu.engine import blocksync as jbs
from cometbft_tpu.engine import chain_gen as jcg
from cometbft_tpu.pipeline.cache import reset_shared_cache as jreset_cache
from cometbft_tpu.state.execution import BlockExecutor as JExec
from cometbft_tpu.state.state import State as JState
from cometbft_tpu.store.blockstore import BlockStore as JStore

from cometbft_tpu_torch.abci.kvstore import KVStoreApplication as PApp
from cometbft_tpu_torch.aggsig import verify as paggv
from cometbft_tpu_torch.db.kv import MemDB as PMemDB
from cometbft_tpu_torch.engine import blocksync as pbs
from cometbft_tpu_torch.engine import chain_gen as pcg
from cometbft_tpu_torch.ops import bls12 as pb
from cometbft_tpu_torch.ops.ed25519 import KernelCanaryError
from cometbft_tpu_torch.pipeline.cache import \
    reset_shared_cache as preset_cache
from cometbft_tpu_torch.pipeline.cache import shared_cache as pshared_cache
from cometbft_tpu_torch.state.execution import BlockExecutor as PExec
from cometbft_tpu_torch.state.state import State as PState
from cometbft_tpu_torch.store.blockstore import BlockStore as PStore
from cometbft_tpu_torch.types import validation as pval

CHAIN = dict(n_blocks=2, n_validators=4, txs_per_block=1,
             chain_id="aggsig-test", seed=7, key_type="bls12_381",
             aggregate=True)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def chains():
    return (jcg.generate_chain(**CHAIN),
            pcg.generate_chain(**CHAIN, device="cpu"))


@pytest.fixture
def miller_calls(monkeypatch):
    """Lane counts of every `bls_miller_finalexp` wrapper call."""
    calls = []
    real = pb.bls_miller_finalexp

    def spy(lines, bits):
        calls.append(lines.shape[-1])
        return real(lines, bits)
    monkeypatch.setattr(pb, "bls_miller_finalexp", spy)
    return calls


def _sync(side, chain, corrupt=None, depth=1):
    """One fresh node synced from genesis -> (state, stats, banned, app)."""
    jreset_cache()
    preset_cache()
    if side == "jax":
        app = JApp()
        executor = JExec(app)
        store = JStore(JMemDB())
        state = JState.from_genesis(chain.genesis)
        src = jcg.LocalChainSource(chain, dict(corrupt or {}))
        reactor = jbs.BlocksyncReactor(executor, store, src, chain.chain_id,
                                       tile_size=4, batch_size=0,
                                       pipeline_depth=depth)
    else:
        app = PApp()
        executor = PExec(app, device="cpu")
        store = PStore(PMemDB())
        state = PState.from_genesis(chain.genesis)
        src = pcg.LocalChainSource(chain, dict(corrupt or {}))
        reactor = pbs.BlocksyncReactor(executor, store, src, chain.chain_id,
                                       tile_size=4, batch_size=64,
                                       pipeline_depth=depth, device="cpu")
    app.init_chain(chain.chain_id, 1, [], b"")
    state = reactor.sync(state)
    return state, reactor.stats, list(src.banned), app


def test_aggregated_chain_matches_jax(chains):
    jchain, pchain = chains
    assert pb.LAUNCHES == {"bls_hard_pow": 0, "bls_miller_finalexp": 0}
    for jblk, pblk, jid, pid, jc, pc in zip(
            jchain.blocks, pchain.blocks, jchain.block_ids,
            pchain.block_ids, jchain.seen_commits, pchain.seen_commits):
        assert type(pc).__name__ == "AggregatedCommit"
        assert pblk.hash() == jblk.hash()
        assert pid.encode() == jid.encode()
        assert pblk.encode() == jblk.encode()
        assert pblk.header.app_hash == jblk.header.app_hash
        assert pblk.header.validators_hash == jblk.header.validators_hash
        assert pc.encode() == jc.encode()
    assert pchain.genesis.bls_pops == jchain.genesis.bls_pops


@pytest.mark.parametrize("depth", [1, 2])
def test_sync_matches_jax(chains, miller_calls, depth):
    jchain, pchain = chains
    jst, jstats, jbanned, japp = _sync("jax", jchain, depth=depth)
    pst, pstats, pbanned, papp = _sync("port", pchain, depth=depth)
    assert pst.last_block_height == jst.last_block_height == 2
    assert pst.app_hash == jst.app_hash
    assert pst.validators.hash() == jst.validators.hash()
    assert pst.last_block_id.encode() == jst.last_block_id.encode()
    assert papp.state == japp.state
    assert dataclasses.asdict(pstats) == dataclasses.asdict(jstats)
    assert pbanned == jbanned == []
    # one settle for the tile: heights 1 and 2's seals + 2 canaries
    assert miller_calls == [4]
    assert pb.LAUNCHES == {"bls_hard_pow": 0, "bls_miller_finalexp": 0}


def test_tampered_sync_bans_like_jax(chains, miller_calls):
    jchain, pchain = chains
    jst, _, jbanned, japp = _sync("jax", jchain, {2: "sig"})
    pst, _, pbanned, papp = _sync("port", pchain, {2: "sig"})
    assert pbanned == jbanned and pbanned
    assert pst.last_block_height == jst.last_block_height == 2
    assert pst.app_hash == jst.app_hash and papp.state == japp.state
    assert miller_calls and set(miller_calls) == {4}


def test_aggregate_verdict_cached(chains, miller_calls):
    _, pchain = chains
    preset_cache()
    args = (pchain.chain_id, pchain.valsets[1], pchain.block_ids[1], 2,
            pchain.seen_commits[1])
    pval.verify_commit(*args, device="cpu")
    assert miller_calls == [4]        # the seal + 2 canaries, padded
    pval.verify_commit(*args[:4], type(pchain.seen_commits[1]).decode(
        pchain.seen_commits[1].encode()), device="cpu")
    assert miller_calls == [4]        # a whole-aggregate cache hit
    assert pshared_cache().hits.get("aggsig", 0) >= 1


def test_light_client_over_aggregated_chain(chains, miller_calls):
    from cometbft_tpu import light as jlight
    from cometbft_tpu_torch import light as plight
    got = []
    for light, chain, dev in ((jlight, chains[0], {}),
                              (plight, chains[1], {"device": "cpu"})):
        jreset_cache()
        preset_cache()
        mod = jcg if light is jlight else pcg
        db = JMemDB() if light is jlight else PMemDB()
        now = type(chain.genesis.genesis_time)(1_700_000_010, 0)
        opts = light.TrustOptions(period_seconds=10**9, height=1,
                                  hash=chain.blocks[0].hash())
        lc = light.LightClient(chain.chain_id, opts,
                               mod.ChainLightProvider(chain), [],
                               light.LightStore(db), sequential=True,
                               now_fn=lambda: now, **dev)
        lb = lc.verify_light_block_at_height(2)
        got.append((lb.header.hash(),
                    [h for h in (1, 2) if lc.trusted_light_block(h)]))
    assert got[0] == got[1] and got[1][1] == [1, 2]
    # the adjacent step checks the commit (and its trusting form) through
    # the fused kernel, one seal + 2 canaries a call
    assert miller_calls and set(miller_calls) == {4}


@pytest.mark.parametrize("mode", ["sig", "bitmap"])
def test_forged_seals_match_jax(chains, mode):
    """The seal source's forgeries (`_forge_seal`) byte for byte with the
    JAX package's; the port's seal source serves them at the corrupt
    height as the JAX package's does (`fetch_seals`, the seal tuples byte
    for byte), and a ban clears its corruption."""
    jchain, pchain = chains
    got = pcg._forge_seal(pchain, pchain.seen_commits[1], mode)
    assert got.encode() == jcg._forge_seal(
        jchain, jchain.seen_commits[1], mode).encode()
    assert got.agg_sig != pchain.seen_commits[1].agg_sig
    src = pcg.ChainSealSource(pchain, {2: mode})
    jsrc = jcg.ChainSealSource(jchain, {2: mode})
    assert src.max_height() == 2
    served = src.fetch_seals(1, 2)
    assert [t.encode() for t in served] == \
        [t.encode() for t in jsrc.fetch_seals(1, 2)]
    assert served[1].commit.encode() == got.encode()
    src.ban(2)
    assert src.banned == [2] and src.corrupt == {}
    assert src.fetch_seals(2, 1)[0].commit.encode() == \
        pchain.seen_commits[1].encode()


@pytest.mark.parametrize("depth", [1, 2])
def test_kernel_error_propagates_out_of_sync(chains, monkeypatch, depth):
    _, pchain = chains

    def boom(*_a):
        raise RuntimeError("bls_miller_finalexp launch failed: cudaError 1")
    monkeypatch.setattr(pb, "bls_miller_finalexp", boom)
    with pytest.raises(RuntimeError, match="launch failed"):
        _sync("port", pchain, depth=depth)


@pytest.mark.parametrize("depth", [1, 2])
def test_canary_mismatch_raises_out_of_sync(chains, monkeypatch, depth):
    _, pchain = chains

    def all_true(lines, bits):
        b = lines.shape[-1]
        return (torch.zeros((6, 2, 24, b), dtype=torch.int32),
                torch.ones((b,), dtype=torch.bool))
    monkeypatch.setattr(pb, "bls_miller_finalexp_plain", all_true)
    paggv.reset_shared_finalexp()
    try:
        with pytest.raises(KernelCanaryError):
            _sync("port", pchain, depth=depth)
        assert paggv.shared_pairing("cpu").canary_failures == 1
    finally:
        paggv.reset_shared_finalexp()
