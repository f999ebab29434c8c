"""The port's blocksync catch-up (cometbft_tpu_torch/engine/blocksync.py and
the host modules under it) held against the JAX package's, on the CPU.

- The port's `generate_chain` gives the JAX package's chain byte for byte:
  block hashes, block ids, encoded last commits, app hashes and validator
  hashes (RFC 8032 signing is deterministic; every encoder is a copy).
- `BlocksyncReactor.sync` reaches the same final state (height, app hash,
  validators hash, last block id, the kvstore's contents), the same stats
  and the same bans on both sides: a clean chain, a tampered signature at
  height 7, tampered data at height 5, and a validator-set change. The
  JAX side runs `batch_size=0`, its host per-signature path, so nothing
  is jitted; the port runs `batch_size=64` on tiles of 9 heights × 8
  validators, so its tiles reach the torch RLC path (`ops.ed25519.STATS`
  shows it) and the tampered-signature tile is attributed per lane.
- A source that keeps serving a corrupt block exhausts the retries with
  BlockValidationError on both sides.
- `TiledCommitVerifier.verify_tile` gives the same per-commit verdicts on
  a tile mixing clean commits, a tampered signature, a wrong-height
  commit, a malformed signature and an under-2/3 commit.
- COMETBFT_TPU_MESH_VERIFY verifies on one device, with the JAX
  package's verdicts, unless it is exactly "1" on a host with more than
  one card (the JAX package's `mesh_available`); only then does the
  unported mesh branch raise.
- Mixed-curve validator sets (70 ed25519, 3 sr25519 and 3 secp256k1
  keys; commits signed over the main chain's block ids): `verify_commit`
  passes or raises the same error at the same index as the JAX package's,
  clean and with tampered lanes, through `MixedBatchVerifier` (its
  ed25519 bucket on the torch RLC path here, per signature on the JAX
  side); `verify_tile` on a tile mixing the main chain's commits with
  mixed-set commits gives the JAX package's per-commit verdicts (the
  mixed commits decided at marshal as `AggSeal` "ok" and "fail" on both
  sides).
- Mesh routing, still unported, raises NotImplementedError; the seal
  source serves no seal from a chain of per-signature commits, as the
  JAX package's does; the aggsig branches answer: BLS genesis keys with
  their PoPs, and `Commit.decode` of the aggregated wire form;
  device="cuda" raises without a card.
"""

import dataclasses

import pytest
import torch

from cometbft_tpu.pipeline.cache import reset_shared_cache as jreset_cache
from cometbft_tpu.types import validation as jval

from cometbft_tpu.abci.kvstore import KVStoreApplication as JApp
from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
from cometbft_tpu.db.kv import MemDB as JMemDB
from cometbft_tpu.engine import blocksync as jbs
from cometbft_tpu.engine import chain_gen as jcg
from cometbft_tpu.state.execution import BlockExecutor as JExec
from cometbft_tpu.state.execution import BlockValidationError as JBVE
from cometbft_tpu.state.state import State as JState
from cometbft_tpu.store.blockstore import BlockStore as JStore
from cometbft_tpu.types.block import CommitSig as JCommitSig

from cometbft_tpu_torch.abci.kvstore import KVStoreApplication as PApp
from cometbft_tpu_torch.crypto import ref_ed25519 as ref
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey as PPriv
from cometbft_tpu_torch.db.kv import MemDB as PMemDB
from cometbft_tpu_torch.engine import blocksync as pbs
from cometbft_tpu_torch.engine import chain_gen as pcg
from cometbft_tpu_torch.ops import ed25519 as ped
from cometbft_tpu_torch.state.execution import BlockExecutor as PExec
from cometbft_tpu_torch.state.execution import BlockValidationError as PBVE
from cometbft_tpu_torch.state.state import State as PState
from cometbft_tpu_torch.store.blockstore import BlockStore as PStore
from cometbft_tpu_torch.pipeline.cache import \
    reset_shared_cache as preset_cache
from cometbft_tpu_torch.types.block import CommitSig as PCommitSig
from cometbft_tpu_torch.types import validation as pval

import _torch_mixed as tm

TILE = 9          # 9 heights x 8 validators: one corrupt commit leaves 64
BATCH = 64        # the port's RLC bucket on the CPU


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Eager torch at 64 lanes is launch-bound on the CPU; one thread
    runs it several times faster than a contended pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _val_tx(pub: bytes) -> bytes:
    return b"val:" + pub.hex().encode() + b"!15"


@pytest.fixture(scope="module")
def chains():
    """(jax, port) chain pairs, each built once: "main" is 12 blocks of 8
    validators, "valset" the 4-validator chain of tests/test_blocksync.py
    whose set changes at height 4."""
    out = {"main": (jcg.generate_chain(n_blocks=12, n_validators=8, seed=1),
                    pcg.generate_chain(n_blocks=12, n_validators=8, seed=1,
                                       device="cpu"))}
    jkey, pkey = JPriv(b"\x99" * 32), PPriv(b"\x99" * 32)
    out["valset"] = (
        jcg.generate_chain(n_blocks=10, n_validators=4, seed=3,
                           val_tx_heights={4: _val_tx(
                               jkey.pub_key().bytes_())},
                           extra_keys=[jkey]),
        pcg.generate_chain(n_blocks=10, n_validators=4, seed=3,
                           val_tx_heights={4: _val_tx(
                               pkey.pub_key().bytes_())},
                           extra_keys=[pkey], device="cpu"))
    return out


def _sync(side, chain, corrupt=None, source_cls=None, max_retries=3):
    """One fresh node synced from genesis. -> (state, stats, banned,
    app)."""
    if side == "jax":
        app = JApp()
        executor = JExec(app)
        store = JStore(JMemDB())
        state = JState.from_genesis(chain.genesis)
        src = (source_cls or jcg.LocalChainSource)(chain, dict(corrupt or {}))
        reactor = jbs.BlocksyncReactor(executor, store, src, chain.chain_id,
                                       tile_size=TILE, batch_size=0,
                                       max_retries=max_retries)
    else:
        app = PApp()
        executor = PExec(app, device="cpu")
        store = PStore(PMemDB())
        state = PState.from_genesis(chain.genesis)
        src = (source_cls or pcg.LocalChainSource)(chain, dict(corrupt or {}))
        reactor = pbs.BlocksyncReactor(executor, store, src, chain.chain_id,
                                       tile_size=TILE, batch_size=BATCH,
                                       max_retries=max_retries,
                                       device="cpu")
    app.init_chain(chain.chain_id, 1, [], b"")
    state = reactor.sync(state)
    return state, reactor.stats, list(src.banned), app


def test_chain_matches_jax_byte_for_byte(chains):
    for jchain, pchain in chains.values():
        assert pchain.chain_id == jchain.chain_id
        assert len(pchain.blocks) == len(jchain.blocks)
        for jb, pb, jid, pid, jc, pc in zip(
                jchain.blocks, pchain.blocks, jchain.block_ids,
                pchain.block_ids, jchain.seen_commits, pchain.seen_commits):
            assert pb.hash() == jb.hash()
            assert pid.encode() == jid.encode()
            assert pb.encode() == jb.encode()
            assert pb.last_commit.encode() == jb.last_commit.encode()
            assert pb.header.app_hash == jb.header.app_hash
            assert pb.header.validators_hash == jb.header.validators_hash
            assert pc.encode() == jc.encode()


@pytest.mark.parametrize("name,corrupt", [
    ("main", None), ("main", {7: "sig"}), ("main", {5: "data"}),
    ("valset", None)])
def test_sync_matches_jax(chains, name, corrupt):
    jchain, pchain = chains[name]
    stats0 = dict(ped.STATS)
    jst, jstats, jbanned, japp = _sync("jax", jchain, corrupt)
    pst, pstats, pbanned, papp = _sync("port", pchain, corrupt)

    assert pst.last_block_height == jst.last_block_height == \
        jchain.max_height()
    assert pst.app_hash == jst.app_hash
    assert pst.validators.hash() == jst.validators.hash()
    assert pst.last_block_id.encode() == jst.last_block_id.encode()
    assert papp.state == japp.state
    assert dataclasses.asdict(pstats) == dataclasses.asdict(jstats)
    assert pbanned == jbanned
    if corrupt == {7: "sig"}:
        assert pbanned and pbanned[0] in (6, 7)
    elif corrupt == {5: "data"}:
        assert pbanned == [5]
    else:
        assert pbanned == []
    if name == "valset":
        assert pstats.respeculations >= 1
        assert pst.validators.has_address(
            PPriv(b"\x99" * 32).pub_key().address())
    elif corrupt == {7: "sig"}:
        # the first tile (64 lanes) fails its RLC equation on the
        # tampered lane and is attributed per lane
        assert ped.STATS["per_lane"] > stats0["per_lane"]
    else:
        assert ped.STATS["rlc_pass"] > stats0["rlc_pass"]


def test_stubborn_source_exhausts_retries(chains):
    jchain, pchain = chains["main"]

    class JStubborn(jcg.LocalChainSource):
        def ban(self, height):
            self.banned.append(height)   # keeps serving corrupt data

    class PStubborn(pcg.LocalChainSource):
        def ban(self, height):
            self.banned.append(height)

    with pytest.raises(JBVE):
        _sync("jax", jchain, {3: "sig"}, JStubborn, max_retries=2)
    with pytest.raises(PBVE):
        _sync("port", pchain, {3: "sig"}, PStubborn, max_retries=2)


def _mixed_tile(chain, bs, commit_sig_cls):
    """Entries for heights 1..10 of `chain`, with the commit of height 2
    carrying a tampered s, 4 a wrong height, 6 a 63-byte signature, and
    8 only five of eight signatures (under 2/3 of the power)."""
    entries = []
    for h in range(1, 11):
        commit = chain.seen_commits[h - 1]
        sigs = list(commit.signatures)
        if h == 2:
            s = sigs[3]
            sigs[3] = commit_sig_cls(
                s.block_id_flag, s.validator_address, s.timestamp,
                s.signature[:40] + bytes([s.signature[40] ^ 1])
                + s.signature[41:])
        elif h == 6:
            s = sigs[5]
            sigs[5] = commit_sig_cls(s.block_id_flag, s.validator_address,
                                     s.timestamp, s.signature[:63])
        elif h == 8:
            for i in (0, 2, 4):
                sigs[i] = commit_sig_cls.absent()
        commit = dataclasses.replace(commit, signatures=sigs)
        if h == 4:
            commit = dataclasses.replace(commit, height=5)
        entries.append(bs.TileEntry(
            height=h, block=chain.blocks[h - 1],
            block_id=chain.block_ids[h - 1],
            valset=chain.valsets[h - 1], commit=commit))
    return entries


def test_verify_tile_matches_jax(chains):
    jchain, pchain = chains["main"]
    jent = _mixed_tile(jchain, jbs, JCommitSig)
    pent = _mixed_tile(pchain, pbs, PCommitSig)
    jbs.TiledCommitVerifier(jchain.chain_id, batch_size=0).verify_tile(jent)
    stats0 = dict(ped.STATS)
    pbs.TiledCommitVerifier(pchain.chain_id, batch_size=BATCH,
                            device="cpu").verify_tile(pent)
    want = [True, False, True, False, True, False, True, False, True, True]
    assert [e.commit_ok for e in jent] == want
    assert [e.commit_ok for e in pent] == want
    # 69 lanes: one chunk attributed per lane, one passed by RLC
    assert ped.STATS["per_lane"] == stats0["per_lane"] + 1
    assert ped.STATS["rlc_pass"] == stats0["rlc_pass"] + 1


@pytest.fixture(scope="module")
def mixed(chains):
    """Per side, a 76-key mixed set and its commits for heights 1..3 of
    the main chain, signed over that chain's block ids: (set, commits)."""
    specs = tm.key_specs(21, n_ed=70, n_sr=3, n_secp=3)
    out = {}
    for side, chain in zip(("jax", "port"), chains["main"]):
        vals = tm.valset(side, specs)
        keys = {k.pub_key().address(): k
                for k in (tm.make_key(side, t, r) for t, r in specs)}
        cg = jcg if side == "jax" else pcg
        out[side] = (vals, [cg.sign_commit(chain.chain_id, h, 0,
                                           chain.block_ids[h - 1], vals,
                                           keys) for h in (1, 2, 3)])
    return out


def _bad_lanes(vals, types):
    """The index of the first validator of each of `types` in `vals`."""
    first = {}
    for i, v in enumerate(vals.validators):
        first.setdefault(v.pub_key.type_(), i)
    return sorted(first[t] for t in types)


@pytest.mark.parametrize("bad_types", [
    (), ("secp256k1",), ("ed25519", "sr25519", "secp256k1")])
def test_mixed_verify_commit_matches_jax(chains, mixed, bad_types):
    outcomes = []
    stats0 = dict(ped.STATS)
    for side, chain in zip(("jax", "port"), chains["main"]):
        jreset_cache()
        preset_cache()
        vals, commits = mixed[side]
        sig_cls = JCommitSig if side == "jax" else PCommitSig
        commit = tm.tamper(sig_cls, commits[1], _bad_lanes(vals, bad_types))
        validation = jval if side == "jax" else pval
        kw = {} if side == "jax" else {"device": "cpu"}
        try:
            validation.verify_commit(chain.chain_id, vals,
                                     chain.block_ids[1], 2, commit, **kw)
            outcomes.append(None)
        except validation.CommitVerificationError as e:
            outcomes.append((type(e).__name__, getattr(e, "idx", None)))
    assert outcomes[0] == outcomes[1]
    bad = _bad_lanes(mixed["port"][0], bad_types)
    assert outcomes[1] == (("ErrWrongSignature", bad[0]) if bad else None)
    # the 70 ed25519 lanes ran the torch RLC path, attributed per lane
    # when one of them was tampered
    moved = {k: ped.STATS[k] - stats0[k] for k in ("rlc_pass", "per_lane")}
    assert moved == ({"rlc_pass": 0, "per_lane": 1}
                     if "ed25519" in bad_types
                     else {"rlc_pass": 1, "per_lane": 0})


def test_mixed_verify_tile_matches_jax(chains, mixed):
    """The main chain's tile of `_mixed_tile` plus three mixed-set
    commits: clean, one tampered secp256k1 lane, and a wrong height."""
    verdicts = []
    for side, chain in zip(("jax", "port"), chains["main"]):
        jreset_cache()
        preset_cache()
        bs, sig_cls = (jbs, JCommitSig) if side == "jax" else (pbs,
                                                               PCommitSig)
        vals, commits = mixed[side]
        extra = [tm.tamper(sig_cls, commits[1],
                           _bad_lanes(vals, ("secp256k1",))),
                 commits[0], dataclasses.replace(commits[2], height=2)]
        entries = _mixed_tile(chain, bs, sig_cls) + [
            bs.TileEntry(height=h, block=chain.blocks[h - 1],
                         block_id=chain.block_ids[h - 1], valset=vals,
                         commit=c)
            for h, c in zip((2, 1, 3), extra)]
        stats0 = dict(ped.STATS)
        if side == "jax":
            bs.TiledCommitVerifier(chain.chain_id,
                                   batch_size=0).verify_tile(entries)
        else:
            bs.TiledCommitVerifier(chain.chain_id, batch_size=BATCH,
                                   device="cpu").verify_tile(entries)
        verdicts.append([e.commit_ok for e in entries])
    assert verdicts[0] == verdicts[1] == [
        True, False, True, False, True, False, True, False, True, True,
        False, True, False]
    # the main chain's lanes (one chunk attributed, one passed) and the
    # clean mixed commit's ed25519 bucket; the tampered one fails on its
    # secp256k1 lane and its bucket passes
    assert ped.STATS["per_lane"] == stats0["per_lane"] + 1
    assert ped.STATS["rlc_pass"] == stats0["rlc_pass"] + 3


def test_unported_branches_raise(chains, monkeypatch):
    jchain, pchain = chains["main"]
    # mesh routing: only where the JAX package would take it, the
    # variable exactly "1" on a host with more than one card
    monkeypatch.setenv("COMETBFT_TPU_MESH_VERIFY", "1")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError):
        pbs.verify_lanes([b"\x00" * 32] * 64, [b""] * 64, [b"\x00" * 64] * 64,
                         BATCH, device="cpu")
    # seal sync is ported: a chain of per-signature commits has no seal
    # to serve, in either package
    assert pcg.ChainSealSource(pchain).fetch_seals(1, 1) == [] == \
        jcg.ChainSealSource(jchain).fetch_seals(1, 1)
    # BLS genesis keys come with their proofs of possession, as in the
    # JAX package (the same seeded keys and PoP bytes)
    gen, keys = pcg.make_genesis(2, key_type="bls12_381")
    jgen, _ = jcg.make_genesis(2, key_type="bls12_381")
    assert gen.bls_pops == jgen.bls_pops and len(gen.bls_pops) == 2
    assert {k.type_() for k in keys.values()} == {"bls12_381"}
    # the generator signs with ed25519 or BLS keys only (the JAX package
    # makes ed25519 keys for any other type it is given)
    with pytest.raises(ValueError):
        pcg.make_genesis(2, key_type="sr25519")
    # the aggregated wire form (field 6) decodes as an AggregatedCommit
    agg = pchain.seen_commits[0].encode() + bytes([0x32, 1, 0])  # field 6
    got = type(pchain.seen_commits[0]).decode(agg)
    assert type(got).__name__ == "AggregatedCommit"
    assert got.agg_sig == b"\x00"
    assert got.encode() == jcg.Commit.decode(agg).encode()


@pytest.mark.parametrize("value", ["1", "true"])
def test_mesh_switch_verifies_like_jax_on_one_device(chains, monkeypatch,
                                                     value):
    """COMETBFT_TPU_MESH_VERIFY set (to "1" on a host with at most one
    card, or to anything but "1") verifies on one device, as the JAX
    package's `mesh_available` rule does, with the same verdicts."""
    jchain, pchain = chains["main"]
    jent = _mixed_tile(jchain, jbs, JCommitSig)
    pent = _mixed_tile(pchain, pbs, PCommitSig)
    pubs, msgs, sigs = [], [], []
    for e in pent:
        pbs.marshal_commit(pchain.chain_id, e, pubs, msgs, sigs)
    monkeypatch.setenv("COMETBFT_TPU_MESH_VERIFY", value)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert not pbs.mesh_available()
    out = pbs.verify_lanes(pubs, msgs, sigs, BATCH, device="cpu")
    assert list(out) == list(jbs.verify_lanes(pubs, msgs, sigs, 0))
    assert list(out) == [ref.verify(*t) for t in zip(pubs, msgs, sigs)]
    jbs.TiledCommitVerifier(jchain.chain_id, batch_size=0).verify_tile(jent)
    pbs.TiledCommitVerifier(pchain.chain_id, batch_size=BATCH,
                            device="cpu").verify_tile(pent)
    assert [e.commit_ok for e in pent] == [e.commit_ok for e in jent]


def test_cuda_requested_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present here")
    with pytest.raises(RuntimeError):
        PExec(PApp())
    with pytest.raises(RuntimeError):
        pbs.TiledCommitVerifier("c", batch_size=BATCH, device="cuda")
    with pytest.raises(RuntimeError):
        pcg.generate_chain(n_blocks=1, n_validators=1)
