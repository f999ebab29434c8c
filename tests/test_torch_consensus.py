"""The port's consensus held against the JAX package's, on the CPU: the
native host ed25519 (`csrc/host/ed25519.cc`), the state machine
(`consensus/state.py`) driven by a script, a cluster mixing both packages
over wire bytes, and catch-up through the port's consensus reactor.

Keys, messages and schedules come from seeds; every result is bytes, a
bool or a height, so the tolerance is none:
- the native signer gives the RFC 8032 vectors and `ref.sign`'s bytes;
  the native verify accepts exactly the strict cofactorless signatures
  (checked here against the oracle's own arithmetic), and
  `Ed25519PubKey.verify_signature` gives the JAX package's verdict on
  clean, tampered, non-canonical-s, small-order, mixed-order and ZIP-215
  edge inputs;
- four validators of each package, driven through `handle_msg` in one
  FIFO order under a step clock (`tests/_torch_consensus.py`), commit 3
  heights with the same block hashes, app hashes and WAL bytes, and a
  WAL cut mid-height replays to the same round state in either package;
- 2 port and 2 JAX validators exchanging wire bytes commit 3 heights with
  equal hashes;
- a port validator kept out of the first heights catches up through a
  port `ConsensusReactor`, and a laggard over a BLS aggregated chain
  adopts a height's seal on device="cpu" (the plain
  `bls_miller_finalexp`), while a forged seal bans the peer.
"""

import hashlib
import random
import shutil

import pytest
import torch

import _torch_consensus as tc
from cometbft_tpu_torch.crypto import keys as pkeys
from cometbft_tpu_torch.crypto import ref_ed25519 as ref

torch.set_num_threads(1)

J, P = tc.side("jax"), tc.side("port")
SIDES = {"jax": J, "port": P}
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="g++ builds the native ed25519")

# RFC 8032 section 7.1, tests 1-3 (seed, public key, message, signature)
RFC8032 = [
    ("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
     "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a", "",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
     "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"),
    ("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
     "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c", "72",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
     "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"),
    ("c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
     "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025",
     "af82",
     "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
     "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a"),
]


# --- the native ed25519 -----------------------------------------------------------

@needs_gxx
def test_native_rfc8032_vectors_and_sha512():
    for seed_h, pub_h, msg_h, sig_h in RFC8032:
        seed, pub = bytes.fromhex(seed_h), bytes.fromhex(pub_h)
        msg, sig = bytes.fromhex(msg_h), bytes.fromhex(sig_h)
        assert pkeys.native_pubkey(seed) == pub
        assert pkeys.native_sign(seed, pub, msg) == sig
        assert pkeys.Ed25519PrivKey(seed).sign(msg) == sig
        assert pkeys.native_verify(pub, msg, sig)
    import ctypes
    lib = pkeys.native_ed25519()
    rng = random.Random(2)
    for n in (0, 111, 112, 127, 128, 129, 240, 1000):
        m = bytes(rng.randrange(256) for _ in range(n))
        out = ctypes.create_string_buffer(64)
        lib.cbt_sha512(m, n, out)
        assert out.raw == hashlib.sha512(m).digest()


@needs_gxx
def test_native_sign_matches_ref_sign():
    rng = random.Random(31)
    for _ in range(12):
        seed = bytes(rng.randrange(256) for _ in range(32))
        msg = bytes(rng.randrange(256) for _ in range(rng.randrange(300)))
        key = pkeys.Ed25519PrivKey(seed)
        assert key.pub_key().bytes_() == ref.pubkey_from_seed(seed)
        assert key.sign(msg) == ref.sign(seed, msg)
        assert J.keys.Ed25519PrivKey(seed).sign(msg) == key.sign(msg)


def _strict_cofactorless(pub, msg, sig) -> bool:
    """RFC 8032 without the cofactor, on the oracle's arithmetic: s < L,
    A decoded strictly, and the encoding of [s]B - [k]A equals R's
    bytes."""
    if len(sig) != 64 or len(pub) != 32:
        return False
    s = int.from_bytes(sig[32:], "little")
    a = ref.pt_decompress(pub, zip215=False)
    if s >= ref.L or a is None:
        return False
    k = ref.sc_reduce(hashlib.sha512(sig[:32] + pub + msg).digest())
    r = ref.pt_add(ref.pt_mul(s, ref.BASE), ref.pt_neg(ref.pt_mul(k, a)))
    return ref.pt_compress(r) == sig[:32]


def _edge_cases():
    """(name, pub, msg, sig) on clean and edge inputs."""
    rng = random.Random(77)
    seed = bytes(rng.randrange(256) for _ in range(32))
    pub = ref.pubkey_from_seed(seed)
    a = ref.clamp(hashlib.sha512(seed).digest())
    prefix = hashlib.sha512(seed).digest()[32:]
    msg = b"consensus vote sign bytes"
    sig = ref.sign(seed, msg)
    out = [("clean", pub, msg, sig),
           ("tampered_r", pub, msg, bytes([sig[0] ^ 1]) + sig[1:]),
           ("tampered_s", pub, msg, sig[:40] + bytes([sig[40] ^ 4])
            + sig[41:]),
           ("tampered_msg", pub, msg + b"!", sig),
           ("short_sig", pub, msg, sig[:63])]
    s = int.from_bytes(sig[32:], "little") + ref.L
    out.append(("noncanonical_s", pub, msg,
                sig[:32] + s.to_bytes(32, "little")))
    ident = (1).to_bytes(32, "little")
    out.append(("small_order_a_and_r", ident, msg, ident + bytes(32)))
    ident_nc = (ref.P + 1).to_bytes(32, "little")
    out.append(("noncanonical_identity", ident_nc, msg,
                ident_nc + bytes(32)))
    # x = 0 with the sign bit set: the identity, encoded negatively
    neg_zero = ((1 << 255) | 1).to_bytes(32, "little")
    out.append(("negative_zero_a", neg_zero, msg, ident + bytes(32)))
    # a point of order 8 (one of the torsion encodings listed by
    # "Taming the many EdDSAs", Chalkias et al. 2020)
    t8 = ref.pt_decompress(bytes.fromhex(
        "c7176a703d4dd84fba3c0b760d10670f"
        "2a2053fa2c39ccc64ec7fd7792ac037a"))
    q = t8
    for _ in range(2):
        q = ref.pt_double(q)
    assert not ref.pt_is_identity(q)
    assert ref.pt_is_identity(ref.pt_double(q))
    # mixed-order R: R' = [r]B + T, s over k from R' (cofactored only)
    r = ref.sc_reduce(hashlib.sha512(prefix + msg).digest())
    rb = ref.pt_compress(ref.pt_add(ref.pt_mul(r, ref.BASE), t8))
    k = ref.sc_reduce(hashlib.sha512(rb + pub + msg).digest())
    out.append(("mixed_order_r", pub, msg,
                rb + ((r + k * a) % ref.L).to_bytes(32, "little")))
    # mixed-order A: A' = A + T, signed as if A' were the key
    pub2 = ref.pt_compress(ref.pt_add(ref.pt_mul(a, ref.BASE), t8))
    rb = ref.pt_compress(ref.pt_mul(r, ref.BASE))
    k = ref.sc_reduce(hashlib.sha512(rb + pub2 + msg).digest())
    out.append(("mixed_order_a", pub2, msg,
                rb + ((r + k * a) % ref.L).to_bytes(32, "little")))
    # a small-order key with a small-order R and s = 0
    t8e = ref.pt_compress(t8)
    out.append(("small_order_a_t8", t8e, msg, t8e + bytes(32)))
    return out


@needs_gxx
def test_native_verify_is_strict_and_verdicts_match_jax():
    seen = {}
    for name, pub, msg, sig in _edge_cases():
        native = pkeys.native_verify(pub, msg, sig)
        assert native == _strict_cofactorless(pub, msg, sig), name
        if native:   # every native accept is ZIP-215-valid
            assert ref.verify(pub, msg, sig, zip215=True), name
        port = pkeys.Ed25519PubKey(pub).verify_signature(msg, sig)
        jax = J.keys.Ed25519PubKey(pub).verify_signature(msg, sig)
        assert port == jax == ref.verify(pub, msg, sig, zip215=True), name
        seen[name] = (native, port)
    assert seen["clean"] == (True, True)
    assert seen["mixed_order_r"] == (False, True)
    assert seen["mixed_order_a"] == (False, True)
    assert seen["noncanonical_identity"] == (False, True)
    assert seen["noncanonical_s"] == (False, False)
    assert seen["tampered_msg"] == (False, False)


def test_native_build_failure_raises(monkeypatch):
    """No silent fallback: a library that does not build makes signing
    and verification raise, never drop back to the oracle."""
    from cometbft_tpu_torch.ops import _build

    def broken(name):
        raise RuntimeError(f"g++ failed for host/{name}.cc")
    monkeypatch.setattr(pkeys, "_NATIVE", None)
    monkeypatch.setattr(_build, "host_lib", broken)
    seed = b"\x03" * 32
    with pytest.raises(RuntimeError):
        pkeys.Ed25519PrivKey(seed).sign(b"m")
    with pytest.raises(RuntimeError):
        pkeys.Ed25519PubKey(ref.pubkey_from_seed(seed)).verify_signature(
            b"m", ref.sign(seed, b"m"))


# --- the state machine ------------------------------------------------------------

TXS = [b"alpha=1", b"beta=2", b"gamma=3"]


def _summary(cs):
    rs = cs.rs
    pv = rs.votes.prevotes(rs.round).bit_array().to_words()
    pc = rs.votes.precommits(rs.round).bit_array().to_words()
    return (rs.height, rs.round, rs.step, rs.proposal is not None,
            rs.proposal_block is not None, pv, pc)


def _scripted(name, tmp, height=3, extra_steps=0):
    clock = tc.StepClock()
    tc.install_clock(clock)
    try:
        nodes = tc.cluster(name, 4, tmp=str(tmp), txs=TXS)
        fab = tc.Fabric(nodes, clock)
        fab.run(height)
        for _ in range(extra_steps):
            fab.step()
        out = {"blocks": [[b.hash() for b, _c in n.commits] for n in nodes],
               "seen": [[c.encode() for _b, c in n.commits] for n in nodes],
               "app": [n.cs.state.app_hash for n in nodes],
               "rs": [_summary(n.cs) for n in nodes],
               "delivered": fab.delivered}
        for n in nodes:
            n.close()
        out["wal"] = [tc.wal_bytes(str(tmp / f"wal{i}" / "wal"))
                      for i in range(4)]
        out["nodes"] = nodes
        return out
    finally:
        tc.reset_clock()


def test_scripted_run_matches_jax(tmp_path):
    """3 heights of 4 validators: the same block hashes, seen commits,
    app hashes, deliveries and WAL bytes in both packages."""
    got = {name: _scripted(name, tmp_path / name) for name in SIDES}
    p, j = got["port"], got["jax"]
    for key in ("blocks", "seen", "app", "rs", "delivered", "wal"):
        assert p[key] == j[key], key
    assert all(len(b) == 3 for b in p["blocks"])
    assert len({tuple(b) for b in p["blocks"]}) == 1
    assert p["app"][0] not in (b"", None)
    assert all(len(w) > 0 for w in p["wal"])


def test_wal_replays_in_either_package(tmp_path):
    """Both packages stop 9 deliveries into height 3; each package's
    ConsensusState replays node 0's WAL (the JAX package's and its own,
    the same bytes) over that node's state and reaches the round state
    the node had."""
    got = {name: _scripted(name, tmp_path / name, height=2, extra_steps=9)
           for name in SIDES}
    assert got["port"]["wal"] == got["jax"]["wal"]
    want = got["jax"]["rs"][0]
    assert want[0] == 3 and want[2] > 1
    for name, s in SIDES.items():
        for writer in SIDES:
            node = got[name]["nodes"][0]
            wal = s.wal.WAL(str(tmp_path / writer / "wal0" / "wal"))
            cs = s.state.ConsensusState(
                tc.fast_config(s), node.cs.state, node.executor,
                node.block_store, priv_validator=None, wal=wal,
                ticker_cls=s.ticker.ManualTicker, **tc.dev(s))
            cs.catchup_replay()
            wal.close()
            assert _summary(cs) == want, (name, writer)


def test_mixed_cluster_commits_over_wire_bytes():
    """2 port and 2 JAX validators, every message carried as the sender's
    wire bytes and decoded by the receiver's package, commit 3 heights
    with equal block and app hashes."""
    clock = tc.StepClock()
    tc.install_clock(clock)
    try:
        nodes = tc.cluster("port", 4, names=["port", "jax", "port", "jax"],
                           txs=TXS)
        fab = tc.Fabric(nodes, clock, wire=True)
        fab.run(3)
    finally:
        tc.reset_clock()
    hashes = {tuple(b.hash() for b, _c in n.commits[:3]) for n in nodes}
    assert len(hashes) == 1 and len(next(iter(hashes))) == 3
    assert len({n.cs.state.app_hash for n in nodes}) == 1
    assert [n.s.name for n in nodes] == ["port", "jax", "port", "jax"]


class _Peer:
    id = "laggard"

    def __init__(self):
        self.sent = []

    def try_send(self, ch, raw):
        self.sent.append((ch, raw))
        return True


def test_port_laggard_catches_up_through_port_reactor():
    """Node 3 is down while nodes 0-2 commit 2 heights; a prevote of its
    for each missed height makes node 0's port reactor serve the decided
    commit's votes and the block's parts, and the laggard commits both
    heights with the others' hashes (tests/test_consensus.py
    ::test_laggard_catchup_via_reactor, scripted)."""
    clock = tc.StepClock()
    tc.install_clock(clock)
    try:
        nodes = tc.cluster("port", 4, txs=TXS)
        fab = tc.Fabric(nodes, clock, down=(3,))
        fab.run(2)
        lag = nodes[3].cs
        assert lag.state.last_block_height == 0
        reactor = P.reactor.ConsensusReactor(nodes[0].cs)
        for h in (1, 2):
            peer = _Peer()
            trigger = P.vote.Vote(
                type_=P.vote.PREVOTE_TYPE, height=h, round=0,
                timestamp=P.proto.Timestamp.now(),
                validator_address=b"\x00" * 20, validator_index=0,
                signature=b"\x01" * 64)
            _ch, raw = P.reactor.encode_consensus_msg(
                P.state.VoteMessage(trigger))
            reactor.receive(P.reactor.VOTE_CHANNEL, peer, raw)
            assert peer.sent
            for _ch, raw in peer.sent:
                clock.tick()
                lag.handle_msg(P.reactor.decode_consensus_msg(raw), "node0")
            assert lag.state.last_block_height == h
    finally:
        tc.reset_clock()
    assert [b.hash() for b, _c in nodes[3].commits] == \
        [b.hash() for b, _c in nodes[0].commits[:2]]
    assert nodes[0].cs.state.last_block_height == 2
    assert lag.state.app_hash == nodes[0].cs.state.app_hash


def test_decided_block_with_a_bad_last_commit_commits_nothing(tmp_path):
    """The laggard of the test above, with a WAL, commits height 1. Then
    nodes 0-2 precommit a height-2 block whose last commit carries a
    tampered signature. The laggard decides it, but its validation
    refuses the block before anything moves: the block store, the
    state, the state store and the app stay at height 1, and the WAL
    holds no EndHeight for 2."""
    from dataclasses import replace
    from cometbft_tpu_torch.types.validation import ErrWrongSignature
    clock = tc.StepClock()
    tc.install_clock(clock)
    try:
        nodes = tc.cluster("port", 4, tmp=str(tmp_path), txs=TXS)
        fab = tc.Fabric(nodes, clock, down=(3,))
        fab.run(2)
        lag = nodes[3]
        reactor = P.reactor.ConsensusReactor(nodes[0].cs)
        peer = _Peer()
        trigger = P.vote.Vote(
            type_=P.vote.PREVOTE_TYPE, height=1, round=0,
            timestamp=P.proto.Timestamp.now(),
            validator_address=b"\x00" * 20, validator_index=0,
            signature=b"\x01" * 64)
        reactor.receive(P.reactor.VOTE_CHANNEL, peer,
                        P.reactor.encode_consensus_msg(
                            P.state.VoteMessage(trigger))[1])
        for _ch, raw in peer.sent:
            clock.tick()
            lag.cs.handle_msg(P.reactor.decode_consensus_msg(raw), "node0")
        assert lag.cs.state.last_block_height == 1

        honest = nodes[0].block_store.load_block(2)
        last = honest.last_commit
        sigs = list(last.signatures)
        i = next(k for k, cs in enumerate(sigs) if cs.for_block())
        bad = bytearray(sigs[i].signature)
        bad[7] ^= 1
        sigs[i] = replace(sigs[i], signature=bytes(bad))
        tampered = P.block.Commit(last.height, last.round, last.block_id,
                                  sigs)
        state = lag.cs.state
        block = state.make_block(2, list(honest.data.txs), tampered,
                                 honest.header.proposer_address)
        parts = block.make_part_set()
        bid = P.block.BlockID(block.hash(), parts.header)
        for k in range(3):
            pv = nodes[k].cs.priv_validator
            vote = P.vote.Vote(
                type_=P.vote.PRECOMMIT_TYPE, height=2, round=0,
                block_id=bid, timestamp=P.proto.Timestamp.now(),
                validator_address=pv.get_pub_key().address(),
                validator_index=k)
            vote.signature = pv.priv_key.sign(vote.sign_bytes(tc.CHAIN_ID))
            clock.tick()
            lag.cs.handle_msg(P.state.VoteMessage(vote), f"node{k}")
        with pytest.raises(ErrWrongSignature):
            for part in parts.parts:
                clock.tick()
                lag.cs.handle_msg(P.state.BlockPartMessage(2, 0, part),
                                  "node0")
        assert lag.cs.rs.proposal_block.hash() == block.hash()
        assert lag.block_store.height() == 1
        assert lag.cs.state.last_block_height == 1
        assert lag.state_store.load().last_block_height == 1
        assert lag.app.info().last_block_height == 1
        ends = [m.height for m in lag.wal.iter_messages()
                if isinstance(m, P.wal.EndHeightMessage)]
        assert ends == [1]
        assert [b.hash() for b, _c in lag.commits] == \
            [nodes[0].commits[0][0].hash()]
    finally:
        for n in nodes:
            n.close()
        tc.reset_clock()


def test_bls_laggard_adopts_a_seal_and_bans_a_forger(monkeypatch):
    """Over a 2-block, 4-validator aggregated BLS chain (seed 7), a node
    at height 3 serves height 1 to a laggard at genesis: the seal goes
    through the laggard reactor's pairing on device="cpu" (the plain
    bls_miller_finalexp), the state machine adopts it and finalizes block
    1 from its parts. A forged seal (n-1 signatures under a full bitmap)
    fails the pairing and the serving peer is banned."""
    from cometbft_tpu_torch.aggsig import verify as aggv
    from cometbft_tpu_torch.engine import chain_gen as pcg
    from cometbft_tpu_torch.ops import bls12 as pb
    from cometbft_tpu_torch.types.agg_commit import AggregatedCommit
    chain = pcg.generate_chain(2, 4, chain_id="bls-chain", seed=7,
                               key_type="bls12_381", aggregate=True,
                               device="cpu")
    assert isinstance(chain.seen_commits[0], AggregatedCommit)

    def node(state, store):
        app = P.kvstore.KVStoreApplication()
        app.init_chain(chain.chain_id, 1, [], b"")
        ex = P.execution.BlockExecutor(app, block_store=store, device="cpu")
        return P.state.ConsensusState(
            tc.fast_config(P), state, ex, store,
            ticker_cls=P.ticker.ManualTicker, device="cpu")

    store = P.blockstore.BlockStore(P.kv.MemDB())
    for b, c in zip(chain.blocks, chain.seen_commits):
        store.save_block(b, b.make_part_set(), c)
    served = node(_state_at(chain, 2), store)
    assert served.rs.height == 3
    serving = P.reactor.ConsensusReactor(served)

    class Switch:
        banned = []

        def stop_peer(self, peer, reason, ban=False):
            self.banned.append((peer.id, reason, ban))

    calls = []
    plain = pb.bls_miller_finalexp_plain
    monkeypatch.setattr(pb, "bls_miller_finalexp_plain",
                        lambda *a: calls.append(1) or plain(*a))
    results = {}
    for case in ("clean", "forged"):
        P.cache.reset_shared_cache()
        aggv.reset_shared_finalexp()
        lag = node(P.sstate.State.from_genesis(chain.genesis),
                   P.blockstore.BlockStore(P.kv.MemDB()))
        lag_reactor = P.reactor.ConsensusReactor(lag)
        sw = Switch()
        sw.banned = []
        lag_reactor.attach(sw)
        peer = _Peer()
        serving._catchup_sent.clear()
        serving._serve_decided_height(peer, 1)
        if case == "forged":
            forged = pcg._forge_seal(chain, chain.seen_commits[0], "bitmap")
            body = (P.proto.f_varint(1, 1)
                    + P.proto.f_bytes(2, forged.encode()))
            peer.sent = [(P.reactor.VOTE_CHANNEL, bytes([6]) + body)]
        calls.clear()
        for ch, raw in peer.sent:
            lag_reactor.receive(ch, peer, raw)
        while not lag.inbox.empty():
            lag.handle_msg(*lag.inbox.get_nowait())
        results[case] = (lag.state.last_block_height, sw.banned,
                         len(calls))
    height, banned, n_calls = results["clean"]
    assert height == 1 and not banned
    assert n_calls == 1
    height, banned, _ = results["forged"]
    assert height == 0
    assert banned and banned[0][0] == "laggard" and banned[0][2] is True


def _state_at(chain, h):
    """The chain's state after applying blocks 1..h (replayed)."""
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    app = KVStoreApplication()
    app.init_chain(chain.chain_id, 1, [], b"")
    ex = P.execution.BlockExecutor(app, device="cpu")
    state = P.sstate.State.from_genesis(chain.genesis)
    for i in range(h):
        state, _ = ex.apply_block(state, chain.block_ids[i],
                                  chain.blocks[i], verified=True)
    return state
