"""The port's BLS aggregate-commit path (cometbft_tpu_torch/aggsig/,
types/agg_commit.py and the BLS branches of crypto/, state/ and
types/validation.py) held against the JAX package's, on the CPU, on the
same seeded keys, chains and commits.

Every result is bytes, a verdict or an exception class, so the tolerance
is none. The port's pairing checks run on `device="cpu"`, where the kernel
wrappers run their plain torch versions (a few seconds a verdict, so the
commits below are few and module-scoped); the JAX package's run on its
pure-Python host oracle.

Mirrors tests/test_aggsig.py: the bitmap codec, aggregate = sum of
signatures, PoP round trip and forgery, the rogue-key attack stopped
exactly by the PoP gate, `register_pops_batch` attribution (the host
route on the CPU, the kernel route whenever the pairing checker is on
cuda), the wire form (the port's `AggregatedCommit.encode()`
bytes are the JAX package's, and `Commit.decode` gives an
`AggregatedCommit`), the `validate_basic` rejections, the assembly gate,
clean and tampered verdicts with the same exception classes (the
multi-group aggregates of per-validator timestamps take the host Miller
product and then the plain hard chain), `BlsBatchVerifier` attribution
and `MixedBatchVerifier`'s BLS bucket, genesis PoPs through
`State.from_genesis`, and a BLS validator update.

The port's no-fallback rule, which replaces what
`test_finalexp_checker_kernel_error_degrades` and
`test_pairing_checker_kernel_error_degrades` assert for the JAX package:
a kernel wrapper that raises propagates out of `verify_commit` (the
supervisor hears of it first), and a plain version that answers a canary
wrong raises `KernelCanaryError` from both checkers, counted and
reported. The chain, the syncs and the verdict cache are in
test_torch_aggsig_sync.py.
"""

import dataclasses
import random

import pytest
import torch

from cometbft_tpu.abci.application import ValidatorUpdate as JUpdate
from cometbft_tpu.aggsig import aggregate as jagg
from cometbft_tpu.aggsig import verify as jaggv
from cometbft_tpu.crypto import batch as jbatch
from cometbft_tpu.crypto import bls12381 as jbls
from cometbft_tpu.crypto.secp256k1 import Secp256k1PrivKey as JSecp
from cometbft_tpu.crypto.sr25519 import Sr25519PrivKey as JSr
from cometbft_tpu.engine import chain_gen as jcg
from cometbft_tpu.state import execution as jexec
from cometbft_tpu.state.state import State as JState
from cometbft_tpu.types import agg_commit as jac
from cometbft_tpu.types import block as jblock
from cometbft_tpu.types import validation as jval

from cometbft_tpu_torch.abci.application import ValidatorUpdate as PUpdate
from cometbft_tpu_torch.aggsig import aggregate as pagg
from cometbft_tpu_torch.aggsig import verify as paggv
from cometbft_tpu_torch.crypto import batch as pbatch
from cometbft_tpu_torch.crypto import bls12381 as pbls
from cometbft_tpu_torch.crypto.secp256k1 import Secp256k1PrivKey as PSecp
from cometbft_tpu_torch.crypto.sr25519 import Sr25519PrivKey as PSr
from cometbft_tpu_torch.engine import chain_gen as pcg
from cometbft_tpu_torch.libs.metrics import Registry
from cometbft_tpu_torch.libs.metrics_gen import AggsigMetrics
from cometbft_tpu_torch.ops import bls12 as pb
from cometbft_tpu_torch.ops.ed25519 import KernelCanaryError
from cometbft_tpu_torch.pipeline.cache import \
    reset_shared_cache as preset_cache
from cometbft_tpu_torch.state import execution as pexec
from cometbft_tpu_torch.state.state import State as PState
from cometbft_tpu_torch.types import agg_commit as pac
from cometbft_tpu_torch.types import block as pblock
from cometbft_tpu_torch.types import validation as pval

SIDES = {
    "jax": dict(agg=jagg, aggv=jaggv, bls=jbls, ac=jac, blk=jblock,
                val=jval, cg=jcg, batch=jbatch, State=JState, ex=jexec,
                Update=JUpdate, Sr=JSr, Secp=JSecp),
    "port": dict(agg=pagg, aggv=paggv, bls=pbls, ac=pac, blk=pblock,
                 val=pval, cg=pcg, batch=pbatch, State=PState, ex=pexec,
                 Update=PUpdate, Sr=PSr, Secp=PSecp),
}
CHAIN_ID = "aggsig-plain"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _verify(side, *args, **kw):
    """verify_commit on a side (the port on the CPU): None, or the
    exception's class name."""
    try:
        if side == "port":
            kw["device"] = "cpu"
        SIDES[side]["val"].verify_commit(*args, **kw)
        return None
    except SIDES[side]["val"].CommitVerificationError as e:
        return type(e).__name__


@pytest.fixture(scope="module")
def plain():
    """A 1-block, 4-validator BLS chain with plain per-lane commits
    (per-validator timestamps) from each package, seed 8, and the same
    block's commit signed with uniform timestamps (one pairing group)."""
    out = {}
    for side, s in SIDES.items():
        kw = {"device": "cpu"} if side == "port" else {}
        chain = s["cg"].generate_chain(
            n_blocks=1, n_validators=4, txs_per_block=1, chain_id=CHAIN_ID,
            seed=8, key_type="bls12_381", **kw)
        uniform = s["cg"].sign_commit(CHAIN_ID, 1, 0, chain.block_ids[0],
                                      chain.valsets[0], chain.keys,
                                      uniform_ts=True)
        out[side] = (chain, uniform)
    return out


# --- primitives ---------------------------------------------------------------

def test_bitmap_codec_matches_jax():
    for bits in ([True, False, False, True, True, False, False, False, True],
                 [], [False] * 8, [True] * 17):
        enc = pagg.bitmap_encode(bits)
        assert enc == jagg.bitmap_encode(bits)
        assert pagg.bitmap_decode(enc, len(bits)) == bits
    for bad, n in ((b"\x09\x01", 8), (b"\xff\x01", 7), (b"\x00", 9)):
        for mod in (pagg, jagg):
            with pytest.raises(ValueError):
                mod.bitmap_decode(bad, n)


def test_aggregate_is_sum_of_signatures():
    msg = b"one shared canonical message, longer than thirty-two bytes"
    keys = [pbls.Bls12381PrivKey.generate(seed=bytes([i]) * 4)
            for i in range(3)]
    sigs = [k.sign(msg) for k in keys]
    assert sigs == [jbls.Bls12381PrivKey.generate(seed=bytes([i]) * 4)
                    .sign(msg) for i in range(3)]
    s_agg = pagg.aggregate_signatures(sigs)
    assert s_agg == jagg.aggregate_signatures(sigs)
    acc = None
    for s in sigs:
        pt = pbls.g2_decompress(s)
        acc = pt if acc is None else pbls._fq2.pt_add(acc, pt)
    assert pbls.g2_compress(acc) == s_agg
    for mod in (pagg, jagg):
        with pytest.raises(ValueError):
            mod.aggregate_signatures([])
        with pytest.raises(ValueError):
            mod.aggregate_signatures([b"\x00" * 96])


def test_pop_roundtrip_and_forgery():
    sk = pbls.Bls12381PrivKey.generate(seed=b"pop-key")
    other = pbls.Bls12381PrivKey.generate(seed=b"other-key")
    pub, opub = sk.pub_key().bytes_(), other.pub_key().bytes_()
    pop = pagg.pop_prove(sk)
    assert pop == jagg.pop_prove(jbls.Bls12381PrivKey(sk.bytes_()))
    cases = [(pub, pop), (opub, pop), (pub, pagg.pop_prove(other)),
             (b"\x00" * 48, pop)]
    got = [pagg.pop_verify(p, q) for p, q in cases]
    assert got == [jagg.pop_verify(p, q) for p, q in cases] == \
        [True, False, False, False]


def test_rogue_key_attack_rejected_by_pop(monkeypatch):
    """pk_rogue = pk_atk - pk_victim makes the two-signer aggregate
    verify with the attacker's lone signature: the PoP gate rejects it
    on both sides, and with the gate off the pairing holds on both (the
    port's through the plain fused kernel)."""
    outcomes = {}
    for side, s in SIDES.items():
        bls, agg = s["bls"], s["agg"]
        blk = s["blk"]
        from importlib import import_module
        pkg = "cometbft_tpu_torch" if side == "port" else "cometbft_tpu"
        proto = import_module(pkg + ".types.proto")
        vmod = import_module(pkg + ".types.validator")
        atk = bls.Bls12381PrivKey.generate(seed=b"attacker")
        victim = bls.Bls12381PrivKey.generate(seed=b"victim")
        v_pub = victim.pub_key()
        agg.register_pop(v_pub.bytes_(), agg.pop_prove(victim))
        rogue_pt = bls._fq.pt_add(atk.pub_key().point,
                                  bls._fq.pt_neg(v_pub.point))
        rogue = bls.Bls12381PubKey(bls.g1_compress(rogue_pt))
        vals = vmod.ValidatorSet([vmod.Validator(rogue, 10),
                                  vmod.Validator(v_pub, 10)])
        bid = blk.BlockID(b"\x11" * 32, blk.PartSetHeader(1, b"\x22" * 32))
        ts = proto.Timestamp(1_700_000_123, 0)
        sigs = [blk.CommitSig(blk.BLOCK_ID_FLAG_COMMIT, v.pub_key.address(),
                              ts, b"") for v in vals.validators]
        commit = s["ac"].AggregatedCommit(
            height=1, round=0, block_id=bid, signatures=sigs,
            bitmap=agg.bitmap_encode([True, True]), agg_sig=b"\x00" * 96)
        msg = commit.vote_sign_bytes("rogue-chain", 0)
        h = bls.hash_to_g2_cached(bls._fixed_msg(msg))
        commit.agg_sig = bls.g2_compress(bls._fq2.pt_mul(atk._sk, h))
        gated = _verify(side, "rogue-chain", vals, bid, 1, commit)
        monkeypatch.setattr(s["aggv"], "has_pop", lambda _pub: True)
        outcomes[side] = (gated, _verify(side, "rogue-chain", vals, bid, 1,
                                         commit))
    assert outcomes["port"] == outcomes["jax"] == \
        ("AggregateVerificationError", None)


def test_register_pops_batch_attribution():
    got = {}
    for side, s in SIDES.items():
        bls, agg = s["bls"], s["agg"]
        a = bls.Bls12381PrivKey.generate(seed=b"batch-a")
        c = bls.Bls12381PrivKey.generate(seed=b"batch-c")
        good_a = agg.pop_prove(a)
        ok = agg.register_pops_batch({a.pub_key().bytes_(): good_a,
                                      c.pub_key().bytes_(): good_a})
        got[side] = (ok, agg.has_pop(a.pub_key().bytes_()),
                     agg.has_pop(c.pub_key().bytes_()),
                     agg.registered_pop(a.pub_key().bytes_()) == good_a)
    assert got["port"] == got["jax"] == (False, True, False, True)


def test_register_pops_batch_kernel_route(monkeypatch):
    """With the pairing checker on cuda, PoPs ride the fused kernel as
    exact per-key 2-pair lanes (3 decompressible lanes + 2 canaries),
    from a cold process; on the CPU the host RLC route admits them. The
    card is stood in for by `torch.cuda.is_available`, a checker whose
    device reads cuda and a host-honest kernel entry."""
    keys = [pbls.Bls12381PrivKey.generate(seed=b"pop-kernel-%d" % i)
            for i in range(3)]
    pubs = [k.pub_key().bytes_() for k in keys]
    pops = {pubs[0]: pagg.pop_prove(keys[0]),
            pubs[1]: pagg.pop_prove(keys[1]),
            pubs[2]: pagg.pop_prove(keys[0]),    # wrong signer: invalid
            b"\x05" * 48: b"\x00" * 5}           # malformed lane
    batches = []

    def honest(items, device=None):
        batches.append(len(items))
        return [pbls.multi_pairing_is_one([pq for pq in it
                                           if None not in pq])
                for it in items]
    pc = paggv.PairingChecker(device="cpu")
    pc.device = torch.device("cuda")
    monkeypatch.setattr(pb, "miller_finalexp_is_one_batch", honest)
    checked_on = []

    def shared(device=None):
        checked_on.append(torch.device(device))
        return pc
    monkeypatch.setattr(paggv, "shared_pairing", shared)
    saved = dict(pagg._POP_OK)
    try:
        pagg.reset_pop_registry()
        assert pagg.register_pops_batch(dict(pops), device="cpu") is False
        assert batches == [] and checked_on == []    # the CPU: host RLC
        assert [pagg.has_pop(p) for p in pubs] == [True, True, False]
        pagg.reset_pop_registry()
        monkeypatch.setattr(pagg.torch.cuda, "is_available", lambda: True)
        assert pagg.register_pops_batch(dict(pops)) is False
        assert batches == [5]                        # cold, on the card
        assert checked_on == [torch.device("cuda")]
        assert [pagg.has_pop(p) for p in pubs] == [True, True, False]
        assert pagg.register_pops_batch({pubs[0]: pops[pubs[0]]}) is True
        assert batches == [5]                    # nothing re-verified
    finally:
        with pagg._POP_LOCK:
            pagg._POP_OK.clear()
            pagg._POP_OK.update(saved)


# --- the AggregatedCommit seal ------------------------------------------------

def test_wire_form_matches_jax(plain):
    seals = {side: SIDES[side]["ac"].from_commit(plain[side][1])
             for side in SIDES}
    enc = seals["port"].encode()
    assert enc == seals["jax"].encode()
    assert seals["port"].hash() == seals["jax"].hash()
    dec = pblock.Commit.decode(enc)
    assert isinstance(dec, pac.AggregatedCommit)
    assert dec.encode() == enc and dec.hash() == seals["port"].hash()
    assert dec.covered_indices() == [0, 1, 2, 3]
    twin = pblock.Commit(height=dec.height, round=dec.round,
                         block_id=dec.block_id, signatures=dec.signatures)
    assert twin.hash() != dec.hash()
    assert type(pblock.Commit.decode(twin.encode())) is pblock.Commit


def test_validate_basic_rejections_match_jax(plain):
    def cases(side):
        ac = SIDES[side]["ac"]
        c = ac.from_commit(plain[side][1])
        sigs = list(c.signatures)
        sigs[0] = dataclasses.replace(sigs[0], signature=b"\x01" * 96)
        bm = SIDES[side]["agg"].bitmap_encode([True, True, True, False])
        out = []
        for bad in (dataclasses.replace(c, bitmap=bm),
                    dataclasses.replace(c, agg_sig=b"\x01" * 64),
                    dataclasses.replace(c, bitmap=c.bitmap + b"\x00"),
                    dataclasses.replace(c, signatures=sigs),
                    dataclasses.replace(c, height=0)):
            try:
                bad.validate_basic()
                out.append(None)
            except ValueError as e:
                out.append(str(e))
        c.validate_basic()
        return out
    got = cases("port")
    assert got == cases("jax")
    assert None not in got and "missing from bitmap" in got[0]
    assert "per-lane signature" in got[3]


def test_assembly_gate_matches_jax(plain):
    for side, s in SIDES.items():
        chain = plain[side][0]
        commit, vals = chain.seen_commits[0], chain.valsets[0]
        got = s["ac"].maybe_aggregate(commit, vals)
        assert isinstance(got, s["ac"].AggregatedCommit)
        assert got.covered_indices() == [0, 1, 2, 3]
        saved = dict(s["agg"]._POP_OK)
        try:
            s["agg"].reset_pop_registry()
            assert s["ac"].maybe_aggregate(commit, vals) is commit
        finally:
            with s["agg"]._POP_LOCK:
                s["agg"]._POP_OK.update(saved)
        kw = {"device": "cpu"} if side == "port" else {}
        ed = s["cg"].generate_chain(n_blocks=1, n_validators=2,
                                    txs_per_block=1, chain_id="ed-gate",
                                    seed=3, **kw)
        assert s["ac"].maybe_aggregate(ed.seen_commits[0],
                                       ed.valsets[0]) is ed.seen_commits[0]
    assert pac.from_commit(plain["port"][0].seen_commits[0]).encode() == \
        jac.from_commit(plain["jax"][0].seen_commits[0]).encode()


# --- verdicts -------------------------------------------------------------------

def test_verdict_equivalence_clean_and_tampered(plain, monkeypatch):
    """Plain and aggregated forms of the per-validator-timestamp commit,
    clean and with a tampered lane: the same verdicts and exception
    classes. The aggregated forms are multi-group (4 messages, 5 pairs),
    so the port takes the host Miller product and then the plain hard
    chain (`bls_hard_pow`), once each."""
    hard = []
    real = pb.bls_hard_pow
    monkeypatch.setattr(pb, "bls_hard_pow",
                        lambda *a: hard.append(a[0].shape) or real(*a))
    got = {}
    for side, s in SIDES.items():
        preset_cache()
        chain = plain[side][0]
        commit, vals = chain.seen_commits[0], chain.valsets[0]
        bid = chain.block_ids[0]
        val0 = vals.validators[0]
        wrong = chain.keys[val0.address].sign(b"some other message!!")
        tampered = dataclasses.replace(commit, signatures=[
            dataclasses.replace(cs, signature=wrong) if i == 0 else cs
            for i, cs in enumerate(commit.signatures)])
        got[side] = [_verify(side, CHAIN_ID, vals, bid, 1, c)
                     for c in (commit, s["ac"].from_commit(commit),
                               tampered, s["ac"].from_commit(tampered))]
    assert got["port"] == got["jax"] == [
        None, None, "ErrWrongSignature", "AggregateVerificationError"]
    assert hard == [(6, 2, 24, 4), (6, 2, 24, 4)]
    assert pb.LAUNCHES == {"bls_hard_pow": 0, "bls_miller_finalexp": 0}


def test_bls_batch_verifier_attribution():
    msgs = [b"batch message %d, padded well past thirty-two bytes" % i
            for i in range(3)]
    got = {}
    for side, s in SIDES.items():
        keys = [s["bls"].Bls12381PrivKey.generate(seed=b"bv%d" % i)
                for i in range(3)]
        res = []
        for bad in (None, 2):
            bv = s["agg"].BlsBatchVerifier()
            for i, (k, m) in enumerate(zip(keys, msgs)):
                bv.add(k.pub_key(), m, k.sign(msgs[1] if i == bad else m))
            res.append(bv.verify())
        res.append(s["agg"].BlsBatchVerifier().verify())
        got[side] = res
    assert got["port"] == got["jax"] == [
        (True, [True] * 3), (False, [True, True, False]), (False, [])]


def test_mixed_batch_routes_bls():
    msg = b"mixed-batch message padded well past thirty-two bytes!!"
    got = {}
    for side, s in SIDES.items():
        rng = random.Random(11)
        bkey = s["bls"].Bls12381PrivKey.generate(seed=b"mixed-b")
        skey, ckey = s["Sr"].generate(rng), s["Secp"].generate(rng)
        mixed = (s["batch"].MixedBatchVerifier(device="cpu")
                 if side == "port" else s["batch"].MixedBatchVerifier())
        mixed.add(skey.pub_key(), msg, skey.sign(msg))
        mixed.add(bkey.pub_key(), msg, bkey.sign(msg))
        mixed.add(ckey.pub_key(), msg, ckey.sign(msg))
        mixed.add(bkey.pub_key(), msg, b"\x00" * 96)
        got[side] = mixed.verify()
    assert got["port"] == got["jax"] == (False, [True, True, True, False])


# --- state ----------------------------------------------------------------------

def test_genesis_pops_through_state(plain):
    """State.from_genesis registers the genesis PoPs (the host RLC route:
    no card here), and a bad PoP stays unregistered, on both sides."""
    got = {}
    for side, s in SIDES.items():
        gen = plain[side][0].genesis
        pubs = sorted(gen.bls_pops)
        saved = dict(s["agg"]._POP_OK)
        try:
            s["agg"].reset_pop_registry()
            s["State"].from_genesis(gen)
            clean = [s["agg"].has_pop(p) for p in pubs]
            s["agg"].reset_pop_registry()
            pops = dict(gen.bls_pops)
            pops[pubs[1]] = pops[pubs[0]]
            s["State"].from_genesis(dataclasses.replace(gen, bls_pops=pops))
            got[side] = (clean, [s["agg"].has_pop(p) for p in pubs])
        finally:
            with s["agg"]._POP_LOCK:
                s["agg"]._POP_OK.update(saved)
    assert got["port"] == got["jax"] == ([True] * 4,
                                        [True, False, True, True])


def test_bls_validator_update():
    got = {}
    for side, s in SIDES.items():
        key = s["bls"].Bls12381PrivKey.generate(seed=b"val-update")
        other = s["bls"].Bls12381PrivKey.generate(seed=b"val-update-2")
        pub = key.pub_key().bytes_()
        vals = s["ex"].validator_updates_to_validators(
            [s["Update"]("bls12_381", pub, 10, s["agg"].pop_prove(key))])
        res = [(v.pub_key.type_(), v.pub_key.bytes_(), v.voting_power)
               for v in vals]
        opub = other.pub_key().bytes_()
        try:
            s["ex"].validator_updates_to_validators(
                [s["Update"]("bls12_381", opub, 10,
                             s["agg"].pop_prove(key))])
            res.append(None)
        except s["ex"].BlockValidationError as e:
            res.append(type(e).__name__)
        res.append(s["agg"].has_pop(pub))
        got[side] = res
    assert got["port"] == got["jax"]
    assert got["port"][1:] == ["BlockValidationError", True]


# --- no fallback ----------------------------------------------------------------

class _Sup:
    def __init__(self):
        self.trips = []
        self.corruptions = []

    def report_trip(self, exc):
        self.trips.append(exc)

    def report_corruption(self, detail=""):
        self.corruptions.append(detail)


def test_kernel_error_propagates_from_verify_commit(plain, monkeypatch):
    """A wrapper that raises (a failed build or launch) propagates out
    of verify_commit: no quarantine, no host verdict; an attached
    supervisor hears of it first."""
    chain, uniform = plain["port"]
    seal = pac.from_commit(uniform)

    def boom(*_a):
        raise RuntimeError("bls_miller_finalexp launch failed: cudaError 1")
    monkeypatch.setattr(pb, "bls_miller_finalexp", boom)
    preset_cache()
    with pytest.raises(RuntimeError, match="launch failed"):
        pval.verify_commit(CHAIN_ID, chain.valsets[0], chain.block_ids[0],
                           1, seal, device="cpu")
    sup = _Sup()
    pc = paggv.PairingChecker(device="cpu", supervisor=sup)
    items = [[(pbls.G1_GEN, pbls.G2_GEN)]]
    with pytest.raises(RuntimeError, match="launch failed"):
        pc.check(items)
    assert len(sup.trips) == 1 and not sup.corruptions
    monkeypatch.setattr(pb, "bls_hard_pow", boom)
    fx = paggv.FinalExpChecker(device="cpu", supervisor=sup)
    with pytest.raises(RuntimeError, match="launch failed"):
        fx.check([pbls.F12_ONE])
    assert len(sup.trips) == 2


def test_canary_mismatch_raises(plain, monkeypatch):
    """A plain version that answers the known-not-one canary True: both
    checkers count it, report it and raise KernelCanaryError, and so
    does verify_commit; nothing re-verifies on the CPU."""
    def all_true(kernel_out):
        def fake(*args):
            b = args[0].shape[-1]
            return (torch.zeros((6, 2, 24, b), dtype=torch.int32),
                    torch.ones((b,), dtype=torch.bool))
        return fake
    monkeypatch.setattr(pb, "bls_miller_finalexp_plain", all_true(None))
    monkeypatch.setattr(pb, "bls_hard_pow_plain", all_true(None))
    metrics = AggsigMetrics(Registry())
    monkeypatch.setattr(paggv, "_metrics", None)   # restored afterwards
    paggv.set_metrics(metrics)
    sup = _Sup()
    pc = paggv.PairingChecker(device="cpu", supervisor=sup)
    with pytest.raises(KernelCanaryError):
        pc.check([[(pbls.G1_GEN, pbls.G2_GEN)]])
    fx = paggv.FinalExpChecker(device="cpu", supervisor=sup)
    with pytest.raises(KernelCanaryError):
        fx.check([pbls.F12_ONE])
    assert sup.corruptions == ["bls miller canary", "bls finalexp canary"]
    assert pc.canary_failures == fx.canary_failures == 1
    assert metrics.canary_failures.value() == 2
    chain, uniform = plain["port"]
    preset_cache()
    paggv.reset_shared_finalexp()
    with pytest.raises(KernelCanaryError):
        pval.verify_commit(CHAIN_ID, chain.valsets[0], chain.block_ids[0],
                           1, pac.from_commit(uniform), device="cpu")
    assert paggv.shared_pairing("cpu").canary_failures == 1
    paggv.reset_shared_finalexp()


def test_shared_checkers_one_per_device():
    paggv.reset_shared_finalexp()
    pc = paggv.shared_pairing("cpu")
    assert pc is paggv.shared_pairing(torch.device("cpu"))
    assert pc.finalexp is paggv.shared_finalexp("cpu")
    assert pc.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            paggv.shared_pairing()
        with pytest.raises(RuntimeError):
            paggv.FinalExpChecker()
    paggv.reset_shared_finalexp()
