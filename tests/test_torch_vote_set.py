"""The port's vote bookkeeping and its durable companions held against the
JAX package's, on the CPU: `libs/bits.BitArray`, `types/vote_set.VoteSet`
(with `add_votes` at more than 64 votes), `types/extended_commit`, the
blockstore's extended commits, `privval/file.FilePV`, the evidence pool
and the consensus wire messages.

Keys and messages come from seeds. Every result is bytes, a bool, an
integer or an exception class, so the tolerance is none:
- the same bit operations give the same words;
- the same votes, added in the same order, give the same tallies, the same
  2/3 majority, the same `make_commit().encode()` and extended-commit
  bytes and the same errors;
- `add_votes` of a 72-vote burst (clean, tampered, duplicate, conflicting
  and misaddressed votes) gives the JAX package's verdicts, and the port's
  batch (its torch RLC path on the CPU) gives its own per-vote verdicts;
  the JAX side's batch of more than 64 lanes verifies per signature on
  XLA:CPU, outside its compile window;
- a FilePV state file written by either package loads in the other, the
  same signing sequence writes the same bytes, and the double-sign guard
  raises the same errors;
- duplicate-vote evidence verifies (or fails) the same and encodes the
  same;
- every consensus message encodes to the same wire bytes and decodes in
  the other package.
"""

import os
import random

import pytest
import torch

import _torch_consensus as tc

torch.set_num_threads(1)

J, P = tc.side("jax"), tc.side("port")
SIDES = {"jax": J, "port": P}
CHAIN = "vote-set-chain"


@pytest.fixture(autouse=True)
def _fresh_caches():
    for s in SIDES.values():
        s.cache.reset_shared_cache()
    yield
    for s in SIDES.values():
        s.cache.reset_shared_cache()


def _keys(n: int, seed: int = 5):
    rng = random.Random(seed)
    return [bytes(rng.randrange(256) for _ in range(32)) for _ in range(n)]


def _valset(s, seeds, power=10):
    vals = [s.validator.Validator(
        s.keys.Ed25519PrivKey(sd).pub_key(), power) for sd in seeds]
    return s.validator.ValidatorSet(vals)


def _bid(s, tag: bytes):
    return s.block.BlockID(tag * 32, s.block.PartSetHeader(1, tag * 32))


def _vote(s, vals, seeds, idx, bid, type_=2, height=3, round_=0,
          ts=10, tamper=False):
    val = vals.validators[idx]
    seed = next(sd for sd in seeds
                if s.keys.Ed25519PrivKey(sd).pub_key().address()
                == val.address)
    v = s.vote.Vote(type_=type_, height=height, round=round_, block_id=bid,
                    timestamp=s.proto.Timestamp(1_700_000_000 + ts, idx),
                    validator_address=val.address, validator_index=idx)
    sig = s.keys.Ed25519PrivKey(seed).sign(v.sign_bytes(CHAIN))
    if tamper:
        sig = bytes([sig[0] ^ 1]) + sig[1:]
    v.signature = sig
    return v


def _verdict(x):
    return type(x).__name__ if isinstance(x, Exception) else x


# --- BitArray -------------------------------------------------------------------

def test_bit_array_matches_jax():
    rng = random.Random(3)
    out = {}
    for name, s in SIDES.items():
        r = random.Random(7)
        a, b = s.bits.BitArray(130), s.bits.BitArray(70)
        for i in rng.sample(range(130), 40):
            a.set_index(i, True)
        for i in range(0, 70, 3):
            b.set_index(i, True)
        a.set_index(200, True)
        res = [a.to_words(), b.to_words(), a.or_(b).to_words(),
               a.and_(b).to_words(), a.not_().to_words(),
               a.sub(b).to_words(), a.num_true_bits(), a.ones()[:9],
               a.is_full(), a.not_().or_(a).is_full(), b.is_empty(),
               a.pick_random(r), repr(b),
               a == s.bits.BitArray.from_words(130, a.to_words())]
        c = s.bits.BitArray(70)
        c.update(b)
        res.append(c.to_words())
        out[name] = res
        rng = random.Random(3)
    assert out["port"] == out["jax"]


# --- VoteSet --------------------------------------------------------------------

def _tally(vs):
    return (vs.bit_array().to_words(), vs.sum,
            vs.maj23.encode() if vs.maj23 else None,
            vs.has_two_thirds_majority(), vs.has_two_thirds_any(),
            vs.has_all(), vs.is_commit(), repr(vs))


def test_vote_set_tallies_and_commit_match_jax():
    """Eight validators: nil votes, votes for two blocks, a peer's 2/3
    claim, a conflicting vote, an exact duplicate, a misaddressed vote and
    one from a wrong height; after each add the same tally, then the same
    commit and extended-commit bytes."""
    seeds = _keys(8)
    out = {}
    for name, s in SIDES.items():
        vals = _valset(s, seeds)
        vs = s.vote_set.VoteSet(CHAIN, 3, 0, 2, vals)
        x, y = _bid(s, b"\x11"), _bid(s, b"\x22")
        script = [(0, x), (1, s.block.BlockID()), (2, y), (3, x)]
        log = []
        for idx, bid in script:
            log.append(_verdict(vs.add_vote(_vote(s, vals, seeds, idx,
                                                  bid))))
            log.append(_tally(vs))
        vs.set_peer_maj23("peer", x)
        bad = [_vote(s, vals, seeds, 2, x),           # conflicts, tracked
               _vote(s, vals, seeds, 0, x),           # exact duplicate
               _vote(s, vals, seeds, 4, x, ts=99),    # fine
               _vote(s, vals, seeds, 5, x, height=4),  # wrong height
               _vote(s, vals, seeds, 6, x, tamper=True)]
        mis = _vote(s, vals, seeds, 7, x)
        mis.validator_index = 6
        bad.append(mis)
        bad += [_vote(s, vals, seeds, i, x) for i in (5, 6, 7)]
        for v in bad:
            try:
                log.append(_verdict(vs.add_vote(v)))
            except s.vote_set.VoteError as e:
                log.append((type(e).__name__, getattr(e, "added", None)))
            log.append(_tally(vs))
        commit = vs.make_commit()
        ext = vs.make_extended_commit()
        log += [commit.encode(), ext.encode(), ext.to_commit().encode(),
                ext.extensions(), [v.encode() for v in vs.list_votes()],
                vs.bit_array_by_block_id(x).to_words(),
                vs.get_by_address(vals.validators[3].address).encode()]
        out[name] = log
    assert out["port"] == out["jax"]
    assert out["port"][-7] == out["port"][-5]   # to_commit strips
    assert P.extended_commit.ExtendedCommit.decode(out["port"][-6]).encode() \
        == out["port"][-6]


def test_add_votes_batch_matches_jax_and_per_vote():
    """A 72-vote burst through `add_votes`: 67 clean, a tampered
    signature, an exact duplicate inside the burst, a conflicting vote
    (no 2/3 claim, so it is not kept), a misaddressed one and a vote for
    another height. The port batches on device="cpu" (its torch RLC
    path) and gives the JAX package's verdicts and tallies, and the
    same verdicts as adding each vote alone."""
    seeds = _keys(72, seed=9)
    out = {}
    for name, s in SIDES.items():
        s.cache.reset_shared_cache()
        vals = _valset(s, seeds)
        x, y = _bid(s, b"\x31"), _bid(s, b"\x32")
        votes = [_vote(s, vals, seeds, i, x) for i in range(68)]
        votes[7] = _vote(s, vals, seeds, 7, x, tamper=True)
        votes.append(_vote(s, vals, seeds, 3, x))          # duplicate
        votes.append(_vote(s, vals, seeds, 5, y))          # conflicting
        mis = _vote(s, vals, seeds, 70, x)
        mis.validator_index = 71
        votes.append(mis)
        votes.append(_vote(s, vals, seeds, 71, x, height=9))
        vs = s.vote_set.VoteSet(CHAIN, 3, 0, 2, vals)
        got = vs.add_votes(votes, **tc.dev(s))
        out[name] = ([_verdict(g) for g in got], _tally(vs),
                     vs.make_commit().encode())
        if name == "port":
            s.cache.reset_shared_cache()
            one = s.vote_set.VoteSet(CHAIN, 3, 0, 2, vals)
            single = []
            for v in votes:
                try:
                    single.append(one.add_vote(v))
                except s.vote_set.VoteError as e:
                    single.append(e)
            assert [_verdict(g) for g in single] == out[name][0]
            assert _tally(one) == _tally(vs)
    assert out["port"] == out["jax"]
    verdicts = out["port"][0]
    assert verdicts[7] == "ErrVoteInvalidSignature"
    assert verdicts[68] is False
    assert verdicts[69] == "ErrVoteConflictingVotes"
    assert verdicts.count(True) == 67


def test_add_votes_needs_a_device_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present here")
    seeds = _keys(2)
    vals = _valset(P, seeds)
    vs = P.vote_set.VoteSet(CHAIN, 3, 0, 2, vals)
    with pytest.raises(RuntimeError):
        vs.add_votes([_vote(P, vals, seeds, 0, _bid(P, b"\x01"))])


def test_extended_commit_round_trip_through_blockstore():
    """`BlockStore.load_extended_commit` reads what `save_block` wrote,
    byte-identical with the JAX package's store, and None where no
    extended commit was saved."""
    from cometbft_tpu.engine import chain_gen as jcg
    from cometbft_tpu_torch.engine import chain_gen as pcg
    out = {}
    for name, s, cg in (("jax", J, jcg), ("port", P, pcg)):
        chain = cg.generate_chain(2, 4, chain_id=CHAIN, seed=3, **tc.dev(s))
        ec = s.extended_commit.ExtendedCommit(
            height=1, round=0, block_id=chain.block_ids[0],
            signatures=[s.extended_commit.ExtendedCommitSig(
                cs, b"ext%d" % i, b"\x07" * 64 if cs.for_block() else b"")
                for i, cs in enumerate(chain.seen_commits[0].signatures)])
        store = s.blockstore.BlockStore(s.kv.MemDB())
        b1, b2 = chain.blocks
        store.save_block(b1, b1.make_part_set(), chain.seen_commits[0],
                         extended_commit=ec)
        store.save_block(b2, b2.make_part_set(), chain.seen_commits[1])
        got = store.load_extended_commit(1)
        out[name] = (got.encode(), got.extensions(),
                     got.to_commit().encode(),
                     store.load_extended_commit(2))
    assert out["port"] == out["jax"]
    assert out["port"][3] is None


# --- FilePV ---------------------------------------------------------------------

def _pv_script(s, path, seed):
    pv = s.file.FilePV(s.keys.Ed25519PrivKey(seed), path)
    x, y = _bid(s, b"\x41"), _bid(s, b"\x42")
    log = []

    def vote(type_, h, r, bid, ts=0):
        v = s.vote.Vote(type_=type_, height=h, round=r, block_id=bid,
                        timestamp=s.proto.Timestamp(1_700_000_000 + ts, 0),
                        validator_address=pv.address(), validator_index=0)
        try:
            pv.sign_vote(CHAIN, v)
            log.append(v.signature)
        except s.file.DoubleSignError as e:
            log.append(("DoubleSignError", str(e)))
        with open(path, "rb") as f:
            log.append(f.read())

    vote(1, 5, 0, x)
    vote(1, 5, 0, x, ts=3)      # timestamp only: the same signature
    vote(1, 5, 0, y)            # conflicting prevote
    vote(2, 5, 0, x)
    vote(1, 5, 0, x)            # step regression
    vote(2, 4, 0, x)            # height regression
    prop = s.vote.Proposal(height=6, round=1, pol_round=-1, block_id=x,
                           timestamp=s.proto.Timestamp(1_700_000_009, 0))
    pv.sign_proposal(CHAIN, prop)
    log.append(prop.signature)
    vote(2, 6, 0, x)            # round regression
    return pv, log


def test_file_pv_state_and_guard_match_jax(tmp_path):
    seed = _keys(1, seed=21)[0]
    logs = {}
    for name, s in SIDES.items():
        _pv, logs[name] = _pv_script(s, str(tmp_path / f"{name}.json"),
                                     seed)
    assert logs["port"] == logs["jax"]
    # each package loads the other's file and goes on from its state
    for a, b in (("jax", "port"), ("port", "jax")):
        pv = SIDES[b].file.FilePV.load(str(tmp_path / f"{a}.json"))
        assert pv.last.height == 6 and pv.last.step == 1
        assert pv.priv_key.seed == seed
        v = SIDES[b].vote.Vote(
            type_=1, height=6, round=0, block_id=_bid(SIDES[b], b"\x41"),
            timestamp=SIDES[b].proto.Timestamp(1_700_000_010, 0),
            validator_address=pv.address(), validator_index=0)
        with pytest.raises(SIDES[b].file.DoubleSignError):
            pv.sign_vote(CHAIN, v)
    # load_or_generate drops an orphaned temp file in both
    for name, s in SIDES.items():
        path = str(tmp_path / f"{name}.json")
        with open(path + ".tmp", "wb") as f:
            f.write(b"{torn")
        assert s.file.FilePV.load_or_generate(path).last.height == 6
        assert not os.path.exists(path + ".tmp")


# --- evidence -------------------------------------------------------------------

def test_duplicate_vote_evidence_matches_jax():
    seeds = _keys(4, seed=13)
    out = {}
    for name, s in SIDES.items():
        gen = s.sstate.GenesisDoc(
            chain_id=CHAIN, genesis_time=s.proto.Timestamp(1_700_000_000, 0),
            validators=_valset(s, seeds).validators)
        state = s.sstate.State.from_genesis(gen)
        vals = state.validators
        a = _vote(s, vals, seeds, 2, _bid(s, b"\x51"), height=1)
        b = _vote(s, vals, seeds, 2, _bid(s, b"\x52"), height=1)
        pool = s.pool.EvidencePool(**tc.dev(s))
        ev = pool.add_duplicate_vote(a, b, state)
        log = [ev.encode(), ev.hash(), pool.size(),
               [e.encode() for e in pool.pending_evidence()]]
        pool.check_evidence([ev], state)
        for bad in ("sig", "same"):
            c = _vote(s, vals, seeds, 2, _bid(s, b"\x52"), height=1,
                      tamper=bad == "sig")
            if bad == "same":
                c = _vote(s, vals, seeds, 2, _bid(s, b"\x51"), height=1,
                          ts=5)
            try:
                ev2 = s.evidence.DuplicateVoteEvidence.from_conflict(
                    a, c, vals, state.last_block_time)
                s.pool.verify_duplicate_vote(ev2, state, vals)
                log.append("ok")
            except s.evidence.EvidenceError as e:
                log.append(str(e))
        pool.update(state, [ev])
        log.append(pool.size())
        out[name] = log
    assert out["port"] == out["jax"]
    assert out["port"][2] == 1 and out["port"][-1] == 0


def test_evidence_pool_needs_a_device_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present here")
    with pytest.raises(RuntimeError):
        P.pool.EvidencePool()


# --- consensus wire -------------------------------------------------------------

def _messages(s):
    seeds = _keys(4, seed=17)
    vals = _valset(s, seeds)
    x = _bid(s, b"\x61")
    prop = s.vote.Proposal(height=3, round=1, pol_round=0, block_id=x,
                           timestamp=s.proto.Timestamp(1_700_000_001, 5),
                           signature=b"\x09" * 64)
    part = s.block.Block(
        header=s.block.Header(chain_id=CHAIN, height=3),
        data=s.block.Data([b"tx"]), last_commit=s.block.Commit()
    ).make_part_set().parts[0]
    st = s.state
    return [st.ProposalMessage(prop), st.BlockPartMessage(3, 1, part),
            st.VoteMessage(_vote(s, vals, seeds, 1, x)),
            st.VoteSetMaj23Message(3, 1, 2, x)]


def test_consensus_messages_encode_identically():
    wire = {}
    for name, s in SIDES.items():
        wire[name] = [s.reactor.encode_consensus_msg(m)
                      for m in _messages(s)]
        rs = s.reactor.RoundStateMessage(3, 1, 4, True, (5, 0b10110),
                                         (130, (1 << 129) | 3), None)
        wire[name].append(rs.encode())
    assert wire["port"] == wire["jax"]
    for a, b in (("jax", "port"), ("port", "jax")):
        for (ch, raw), orig in zip(wire[a][:4], _messages(SIDES[b])):
            msg = SIDES[b].reactor.decode_consensus_msg(raw)
            assert type(msg).__name__ == type(orig).__name__
            assert SIDES[b].reactor.encode_consensus_msg(msg) == (ch, raw)
        rs = SIDES[b].reactor.RoundStateMessage.decode(wire[a][4])
        assert (rs.height, rs.round, rs.step, rs.has_proposal, rs.parts,
                rs.prevotes, rs.precommits) == \
            (3, 1, 4, True, (5, 0b10110), (130, (1 << 129) | 3), None)
    with pytest.raises(ValueError):
        P.reactor.decode_consensus_msg(b"\x09")
