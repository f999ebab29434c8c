"""The port's seal sync (cometbft_tpu_torch/sealsync/) held against the JAX
package's, on the CPU, on the reference test's chain (tests/test_sealsync.py
:52-81): 6 blocks of 4 BLS validators with aggregated seals and a joiner
admitted at height 2 (its val-tx with a proof of possession), so the set
changes at height 4 and every span crosses a real epoch boundary. Both
packages build the chain from seed 5.

Every result is bytes, a height, a verdict or an exception class, so the
tolerance is none. The port's adopter runs on `device="cpu"`, where the
`bls_miller_finalexp` wrapper runs its plain torch version (seconds a
call, so the adoptions are few and share a module-scoped clean adoption's
signature cache where the reference test starts cold; what each case
asserts is unchanged by it). The JAX package's runs on its host oracle
(`PairingChecker("cpu")`).

Held: `fetch_seals` tuples byte for byte (`SealTuple.encode`, the epoch
payload included); `plan_adoption`'s pivots, per-height valset hashes
and new PoPs, and the same `SealChainError` height and reason for each of
the reference's rejection cases; `adopt()` reaching the same tip with the
same adopted records and the same signature-cache keys (`b"aggsig|"` for
every height), one wrapper call per tile of pivots; the deep forgery
banned at the same height, then adopted; `AdoptionError` after
`max_attempts`; `install_adopted` refusing unsettled pivots;
`SealProvider.serve` equal, shedding at its in-flight bound. The port's
no-fallback rule: a wrapper that raises and a plain version that answers
a canary wrong both propagate out of `adopt()`, and neither bans.
"""

import dataclasses

import pytest
import torch

from cometbft_tpu.aggsig import aggregate as jagg
from cometbft_tpu.aggsig import verify as jaggv
from cometbft_tpu.crypto import bls12381 as jbls
from cometbft_tpu.db.kv import MemDB as JMemDB
from cometbft_tpu.engine import chain_gen as jcg
from cometbft_tpu.libs import metrics as jmetrics
from cometbft_tpu.libs import metrics_gen as jmgen
from cometbft_tpu.pipeline import cache as jcache
from cometbft_tpu import sealsync as jss
from cometbft_tpu.sealsync import adopter as jadopter
from cometbft_tpu.state.state import State as JState
from cometbft_tpu.store.blockstore import BlockStore as JStore

from cometbft_tpu_torch.aggsig import aggregate as pagg
from cometbft_tpu_torch.aggsig import verify as paggv
from cometbft_tpu_torch.crypto import bls12381 as pbls
from cometbft_tpu_torch.db.kv import MemDB as PMemDB
from cometbft_tpu_torch.engine import chain_gen as pcg
from cometbft_tpu_torch.libs import metrics as pmetrics
from cometbft_tpu_torch.libs import metrics_gen as pmgen
from cometbft_tpu_torch.ops import bls12 as pb
from cometbft_tpu_torch.ops.ed25519 import KernelCanaryError
from cometbft_tpu_torch.pipeline import cache as pcache
from cometbft_tpu_torch import sealsync as pss
from cometbft_tpu_torch.sealsync import adopter as padopter
from cometbft_tpu_torch.state.state import State as PState
from cometbft_tpu_torch.store.blockstore import BlockStore as PStore

SIDES = {
    "jax": dict(agg=jagg, bls=jbls, cg=jcg, ss=jss, ad=jadopter,
                State=JState, Store=JStore, MemDB=JMemDB, cache=jcache,
                reg=jmetrics.Registry, mgen=jmgen),
    "port": dict(agg=pagg, bls=pbls, cg=pcg, ss=pss, ad=padopter,
                 State=PState, Store=PStore, MemDB=PMemDB, cache=pcache,
                 reg=pmetrics.Registry, mgen=pmgen),
}
CHAIN_ID = "sealsync-test"
EPOCH_H = 4  # val-tx lands at height 2 -> the set changes at height 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def chains():
    """The reference test's chain from each package: side -> (chain,
    joiner key)."""
    out = {}
    for side, s in SIDES.items():
        joiner = s["bls"].Bls12381PrivKey.generate(b"\x5e" * 32)
        pk = joiner.pub_key().bytes_()
        tx = (b"val:" + pk.hex().encode() + b"!10!"
              + s["agg"].pop_prove(joiner).hex().encode())
        kw = {"device": "cpu"} if side == "port" else {}
        out[side] = (s["cg"].generate_chain(
            n_blocks=6, n_validators=4, txs_per_block=1, chain_id=CHAIN_ID,
            seed=5, key_type="bls12_381", aggregate=True,
            val_tx_heights={2: tx}, extra_keys=[joiner], **kw), joiner)
    return out


@pytest.fixture(scope="module")
def tuples(chains):
    return {side: SIDES[side]["cg"].ChainSealSource(
        chains[side][0]).fetch_seals(1, 6) for side in SIDES}


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


def _genesis_state(side, chain):
    """The genesis state, with the PoP registry as a fresh node holds it
    (the genesis keys only: the joiner's PoP must ride the seal stream)."""
    SIDES[side]["agg"].reset_pop_registry()
    return SIDES[side]["State"].from_genesis(chain.genesis)


def _adopter(side, chain, source, cache=None, **kw):
    """A fresh store and adopter on a side: the reference test's tile 2
    and max skip 2; the port on the CPU, the JAX package on its host
    oracle."""
    s = SIDES[side]
    store = s["Store"](s["MemDB"]())
    cache = cache if cache is not None else s["cache"].SigCache(4096)
    metrics = s["mgen"].SealsyncMetrics(s["reg"]())
    kw.setdefault("tile_size", 2)
    kw.setdefault("max_skip", 2)
    if side == "port":
        kw["device"] = "cpu"
    else:
        kw["checker"] = jaggv.PairingChecker("cpu")
    adopter = s["ss"].SealAdopter(chain.chain_id, store, source,
                                  cache=cache, shards=1, metrics=metrics,
                                  **kw)
    return adopter, store, cache, metrics


def _records(store, tip):
    out = []
    for h in range(1, tip + 1):
        bid, hdr, cmt = store.load_adopted_seal(h)
        out.append((bid.encode(), hdr.hash(), cmt.encode()))
    return out


@pytest.fixture(scope="module")
def adopted(chains):
    """One clean adoption from genesis on each side: side -> (tip,
    store, cache, metrics, wrapper lane counts)."""
    out = {}
    for side in SIDES:
        chain = chains[side][0]
        state = _genesis_state(side, chain)
        adopter, store, cache, metrics = _adopter(
            side, chain, SIDES[side]["cg"].ChainSealSource(chain))
        real = pb.bls_miller_finalexp
        calls = []

        def spy(lines, bits, _real=real):
            calls.append(lines.shape[-1])
            return _real(lines, bits)
        pb.bls_miller_finalexp = spy
        try:
            tip = adopter.adopt(state)
        finally:
            pb.bls_miller_finalexp = real
        out[side] = (tip, store, cache, metrics, calls)
    return out


# --- the chain and the seal stream --------------------------------------------

def test_chains_match_jax(chains):
    jchain, pchain = chains["jax"][0], chains["port"][0]
    for jblk, pblk, jc, pc in zip(jchain.blocks, pchain.blocks,
                                  jchain.seen_commits, pchain.seen_commits):
        assert pblk.hash() == jblk.hash()
        assert pc.encode() == jc.encode()
    assert pchain.valsets[EPOCH_H - 1].hash() != pchain.valsets[0].hash()


def test_fetch_seals_match_jax(tuples):
    jt, pt = tuples["jax"], tuples["port"]
    assert [t.height for t in pt] == list(range(1, 7))
    assert [t.encode() for t in pt] == [t.encode() for t in jt]
    assert pt[EPOCH_H - 1].valset is not None and pt[0].valset is None
    assert [t.height for t in pt if t.valset is not None] == [EPOCH_H]


@pytest.mark.parametrize("height", [1, EPOCH_H])
def test_seal_tuple_roundtrip(tuples, height):
    t = tuples["port"][height - 1]
    back = pss.SealTuple.decode(t.encode())
    assert back.encode() == t.encode()
    jback = jss.SealTuple.decode(t.encode())
    assert jback.encode() == t.encode()
    assert back.pops == t.pops == jback.pops
    if t.valset is not None:
        assert back.valset.hash() == t.header.validators_hash


@pytest.mark.parametrize("mode", ["sig", "bitmap"])
def test_forged_seal_stream_matches_jax(chains, mode):
    """The seal source serves `_forge_seal`'s forgery at the tip until a
    ban, as the JAX package's does, byte for byte."""
    got = {}
    for side, s in SIDES.items():
        src = s["cg"].ChainSealSource(chains[side][0], {6: mode})
        forged = src.fetch_seals(5, 2)
        src.ban(6)
        honest = src.fetch_seals(5, 2)
        got[side] = ([t.encode() for t in forged],
                     [t.encode() for t in honest], src.banned)
    assert got["port"] == got["jax"]
    assert got["port"][0][1] != got["port"][1][1]


# --- plan_adoption --------------------------------------------------------------

def _plan(side, chains, tuples, max_skip=2):
    chain = chains[side][0]
    vals = chain.valsets[0]          # the genesis set
    return SIDES[side]["ss"].plan_adoption(chain.chain_id, 0, vals,
                                           tuples, max_skip=max_skip)


@pytest.mark.parametrize("max_skip", [1, 2, 64])
def test_plan_adoption_matches_jax(chains, tuples, max_skip):
    plans = {side: _plan(side, chains, tuples[side], max_skip)
             for side in SIDES}
    jp, pp = plans["jax"], plans["port"]
    assert pp.pivots == jp.pivots
    assert (pp.start, pp.tip) == (jp.start, jp.tip) == (1, 6)
    assert {h: v.hash() for h, v in pp.vals_for.items()} == \
        {h: v.hash() for h, v in jp.vals_for.items()}
    assert pp.new_pops == jp.new_pops
    assert chains["port"][1].pub_key().bytes_() in pp.new_pops
    assert 6 in pp.pivots and EPOCH_H - 1 in pp.pivots


def _forge(side, chains, tuples, case):
    """The reference test's rejection cases, built on a side's tuples:
    -> (chain id, tuples)."""
    ts = list(tuples)
    chain_id = CHAIN_ID
    if case == "non_contiguous":
        ts = ts[:1] + ts[2:]
    elif case == "wrong_chain_id":
        chain_id = "other-chain"
    elif case == "broken_header_chain":
        hdr = dataclasses.replace(ts[1].header, app_hash=b"\x13" * 32)
        cmt = dataclasses.replace(
            ts[1].commit, block_id=dataclasses.replace(
                ts[1].commit.block_id, hash=hdr.hash()))
        ts[1] = dataclasses.replace(ts[1], header=hdr, commit=cmt)
    elif case == "commit_not_sealing_header":
        cmt = dataclasses.replace(
            ts[1].commit, block_id=dataclasses.replace(
                ts[1].commit.block_id, hash=b"\x66" * 32))
        ts[1] = dataclasses.replace(ts[1], commit=cmt)
    elif case == "epoch_without_valset":
        ts[EPOCH_H - 1] = dataclasses.replace(ts[EPOCH_H - 1], valset=None,
                                              pops={})
    elif case == "wrong_served_valset":
        vals = chains[side][0].valsets[0]
        ts[EPOCH_H - 1] = dataclasses.replace(ts[EPOCH_H - 1],
                                              valset=vals.copy(), pops={})
    elif case == "empty":
        ts = []
    return chain_id, ts


@pytest.mark.parametrize("case", [
    "non_contiguous", "wrong_chain_id", "broken_header_chain",
    "commit_not_sealing_header", "epoch_without_valset",
    "wrong_served_valset", "empty"])
def test_plan_rejections_match_jax(chains, tuples, case):
    got = {}
    for side, s in SIDES.items():
        chain_id, ts = _forge(side, chains, tuples[side], case)
        vals = chains[side][0].valsets[0]
        with pytest.raises(s["ss"].SealChainError) as ei:
            s["ss"].plan_adoption(chain_id, 0, vals, ts, max_skip=2)
        got[side] = (ei.value.height, ei.value.reason)
    assert got["port"] == got["jax"]


# --- adopt ------------------------------------------------------------------------

def test_adopt_matches_jax(adopted, chains):
    """Same tip, same adopted records, same cache keys (every height's
    whole-aggregate `b"aggsig|"` entry, pivots and skipped alike), same
    metrics; the port's two tiles of pivots were two wrapper calls of
    2 pivots + 2 canaries (bucket 4)."""
    jtip, jstore, jcache_, jm, _ = adopted["jax"]
    ptip, pstore, pcache_, pm, calls = adopted["port"]
    assert ptip == jtip == 6
    assert pstore.adopted_tip() == jstore.adopted_tip() == 6
    assert _records(pstore, 6) == _records(jstore, 6)
    assert list(pcache_._entries) == list(jcache_._entries)
    assert len(pcache_._entries) == 6
    for name in ("seals_adopted", "pivots_verified", "pairings_skipped",
                 "adoptions_rejected", "adopted_tip"):
        assert getattr(pm, name).value() == getattr(jm, name).value()
    assert calls == [4, 4]
    assert pb.LAUNCHES == {"bls_hard_pow": 0, "bls_miller_finalexp": 0}


def test_adopted_heights_are_cache_hits(adopted, chains, miller_calls):
    """The no-double-pairing contract: body backfill marshals every
    adopted commit as an "ok" seal, one height at a time, and no
    wrapper call is made."""
    _tip, _store, cache, _m, _calls = adopted["port"]
    chain = chains["port"][0]
    for h in range(1, 7):
        vs = chain.valsets[h - 1]
        seal = paggv.prepare_full_commit(
            chain.chain_id, vs, chain.seen_commits[h - 1],
            vs.total_voting_power() * 2 // 3, cache=cache)
        assert seal.status == "ok", f"height {h} would pair again"
    assert miller_calls == []


def test_deep_forgery_banned_then_adopted(adopted, chains, miller_calls):
    """The "bitmap" forgery at the tip: structure and tally pass, only
    the pivot's pairing rejects it. Both sides ban 6, count one
    rejection and adopt the honest span on the retry. The port's
    adopter starts from the clean adoption's cache, so only the forged
    pivot pends: one wrapper call (1 + 2 canaries, bucket 4)."""
    got = {}
    for side, s in SIDES.items():
        chain = chains[side][0]
        state = _genesis_state(side, chain)
        src = s["cg"].ChainSealSource(chain, {6: "bitmap"})
        adopter, store, _c, metrics = _adopter(side, chain, src,
                                               cache=adopted[side][2])
        got[side] = (adopter.adopt(state), list(src.banned),
                     metrics.adoptions_rejected.value(),
                     store.adopted_tip(), _records(store, 6))
    assert got["port"] == got["jax"]
    assert got["port"][:4] == (6, [6], 1, 6)
    assert miller_calls == [4]


def test_adoption_fails_after_max_attempts(adopted, chains):
    """Every retry lands on another lying provider ("sig" at the tip):
    AdoptionError after 2 attempts, nothing installed, on both sides."""
    got = {}
    for side, s in SIDES.items():
        chain = chains[side][0]
        state = _genesis_state(side, chain)

        class Stubborn(s["cg"].ChainSealSource):
            def ban(self, height):
                super().ban(height)
                self.corrupt[6] = "sig"

        src = Stubborn(chain, {6: "sig"})
        adopter, store, _c, metrics = _adopter(
            side, chain, src, cache=adopted[side][2], max_attempts=2)
        with pytest.raises(s["ss"].AdoptionError):
            adopter.adopt(state)
        got[side] = (metrics.adoptions_rejected.value(), src.banned,
                     store.adopted_tip(), store.load_adopted_seal(1))
    assert got["port"] == got["jax"] == (2, [6, 6], 0, None)


@pytest.mark.parametrize("verdicts", ["one_false", "wrong_arity"])
def test_install_refuses_unsettled_pivots(chains, tuples, verdicts):
    got = {}
    for side, s in SIDES.items():
        chain = chains[side][0]
        plan = _plan(side, chains, tuples[side])
        adopter, store, _c, _m = _adopter(side, chain,
                                          s["cg"].ChainSealSource(chain))
        bad = [True] * len(plan.pivots)
        if verdicts == "one_false":
            bad[-1] = False
        else:
            bad = [True]
        with pytest.raises(s["ss"].AdoptionError, match="unsettled"):
            adopter.install_adopted(plan, bad)
        got[side] = (store.adopted_tip(), store.load_adopted_seal(1))
    assert got["port"] == got["jax"] == (0, None)


def test_adopt_target_and_noop(chains, adopted):
    """A target below the anchor adopts nothing; a partial target stops
    there. From the clean adoption's cache, pivots 2 and 3 are hits: no
    pairing on either side."""
    got = {}
    for side, s in SIDES.items():
        chain = chains[side][0]
        state = _genesis_state(side, chain)
        adopter, store, _c, _m = _adopter(
            side, chain, s["cg"].ChainSealSource(chain),
            cache=adopted[side][2])
        got[side] = (adopter.adopt(state, target=0),
                     adopter.adopt(state, target=3), store.adopted_tip())
    assert got["port"] == got["jax"] == (0, 3, 3)


# --- the port's device rules ------------------------------------------------------

def test_adopter_device_and_default_checker(chains):
    chain = chains["port"][0]
    adopter, _s, _c, _m = _adopter("port", chain,
                                   pcg.ChainSealSource(chain))
    assert adopter.device == torch.device("cpu")
    assert adopter._pairing() is paggv.shared_pairing("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            pss.SealAdopter(CHAIN_ID, PStore(PMemDB()),
                            pcg.ChainSealSource(chain), shards=1)


def test_mesh_switch(monkeypatch):
    """Off (one card): one shard, as the JAX package's on one device.
    On: the port raises naming its ROADMAP item."""
    assert padopter._mesh_shards() == 1
    monkeypatch.setenv("COMETBFT_TPU_MESH_VERIFY", "1")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        padopter._mesh_shards()


def test_kernel_error_propagates_out_of_adopt(chains, monkeypatch):
    chain = chains["port"][0]
    state = _genesis_state("port", chain)

    def boom(*_a):
        raise RuntimeError("bls_miller_finalexp launch failed: cudaError 1")
    monkeypatch.setattr(pb, "bls_miller_finalexp", boom)
    src = pcg.ChainSealSource(chain)
    adopter, store, _c, metrics = _adopter("port", chain, src)
    with pytest.raises(RuntimeError, match="launch failed"):
        adopter.adopt(state)
    assert src.banned == [] and metrics.adoptions_rejected.value() == 0
    assert store.adopted_tip() == 0


def test_canary_mismatch_propagates_out_of_adopt(chains, monkeypatch):
    """A plain fused kernel that answers the known-not-one canary True:
    KernelCanaryError out of adopt(), counted on the checker; not a ban,
    not a host re-verify."""
    chain = chains["port"][0]
    state = _genesis_state("port", chain)

    def all_true(lines, bits):
        b = lines.shape[-1]
        return (torch.zeros((6, 2, 24, b), dtype=torch.int32),
                torch.ones((b,), dtype=torch.bool))
    monkeypatch.setattr(pb, "bls_miller_finalexp_plain", all_true)
    checker = paggv.PairingChecker(device="cpu")
    src = pcg.ChainSealSource(chain)
    adopter, store, _c, metrics = _adopter("port", chain, src,
                                           checker=checker)
    with pytest.raises(KernelCanaryError):
        adopter.adopt(state)
    assert checker.canary_failures == 1
    assert src.banned == [] and store.adopted_tip() == 0


# --- the provider -------------------------------------------------------------------

def test_provider_serves_adopted_prefix_like_jax(adopted):
    """A store of adopted records only, no state store: the run ends at
    the epoch boundary it cannot attest, on both sides."""
    got = {}
    for side, s in SIDES.items():
        store = adopted[side][1]
        prov = s["ss"].SealProvider(
            store, metrics=s["mgen"].SealsyncMetrics(s["reg"]()))
        out = prov.serve(1, 100)
        got[side] = (prov.status(), [t.encode() for t in out])
    assert got["port"] == got["jax"]
    assert got["port"][0] == (0, 6) and len(got["port"][1]) == EPOCH_H - 1


@pytest.mark.parametrize("start,count", [(2, 1), (1, 0), (7, 3)])
def test_provider_windows_like_jax(adopted, start, count):
    got = {side: [t.encode() for t in SIDES[side]["ss"].SealProvider(
        adopted[side][1]).serve(start, count)] for side in SIDES}
    assert got["port"] == got["jax"]


def test_provider_sheds_at_inflight_bound(adopted):
    got = {}
    for side, s in SIDES.items():
        metrics = s["mgen"].SealsyncMetrics(s["reg"]())
        prov = s["ss"].SealProvider(adopted[side][1], max_inflight=0,
                                    metrics=metrics)
        with pytest.raises(s["ss"].SealsyncOverloaded):
            prov.serve(1, 4)
        got[side] = metrics.serve_sheds.value()
    assert got["port"] == got["jax"] == 1


def test_pop_registry_left_for_other_modules(chains):
    """Leave each package's PoP registry as generated chains expect it."""
    for side, s in SIDES.items():
        chain, joiner = chains[side]
        _genesis_state(side, chain)
        assert s["agg"].register_pop(joiner.pub_key().bytes_(),
                                     s["agg"].pop_prove(joiner))
