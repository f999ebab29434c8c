"""The port's sr25519, secp256k1, key factories and mixed-curve batch
dispatch (cometbft_tpu_torch/crypto/{sr25519,secp256k1,keys,batch}.py)
held against the JAX package's, on the CPU.

Every result here is an integer, bytes or a verdict, so the tolerance is
none: equal bytes, equal verdicts, equal exception classes.

- sr25519: the cross-implementation vectors of tests/test_curves.py (the
  merlin transcript vector, schnorrkel's MiniSecretKey public key),
  Keccak-f[1600] states, ristretto encodings and decodings, signatures
  (deterministic: the nonce is a transcript witness) and verdicts on
  tampered inputs, all byte-equal with the JAX package's.
- secp256k1: RFC 6979 signatures, compressed keys, addresses and verdicts
  (tampered, high-s, malformed) equal the JAX package's; so do addresses
  of keys read by the factories, and secret 1's address is bitcoin's.
- The key factories by type string, `create_batch_verifier` and
  `supports_batch_verifier` answer as the JAX package does (bls12_381
  included), except where the port adds a private-key type
  (sr25519, secp256k1).
- `MixedBatchVerifier` gives the JAX package's verdicts, lane by lane in
  the original order, on the same 76 keys and messages, clean and with
  one tampered lane of each curve; its 70-lane ed25519 bucket runs the
  port's torch RLC path on the CPU (`ops.ed25519.STATS`) and, on the
  JAX side, the per-signature path (a bucket of more than 64 lanes is
  never jitted on the CPU). An empty batch fails on both sides.
- A mixed set survives the state JSON (`_valset_to_json`,
  `_state_to_json`) byte for byte with the JAX package's, in both
  directions.
"""

import random

import pytest
import torch

from cometbft_tpu.crypto import batch as jbatch
from cometbft_tpu.crypto import keys as jkeys
from cometbft_tpu.crypto import secp256k1 as jsecp
from cometbft_tpu.crypto import sr25519 as jsr
from cometbft_tpu.state import state as jstate

from cometbft_tpu_torch.crypto import batch as pbatch
from cometbft_tpu_torch.crypto import keys as pkeys
from cometbft_tpu_torch.crypto import ref_ed25519 as ref
from cometbft_tpu_torch.crypto import secp256k1 as psecp
from cometbft_tpu_torch.crypto import sr25519 as psr
from cometbft_tpu_torch.ops import ed25519 as ped
from cometbft_tpu_torch.state import state as pstate

import _torch_mixed as tm

MSG = b"mixed-curve validator set message " * 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Eager torch at 128 lanes is launch-bound on the CPU; one thread
    runs it several times faster than a contended pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flip(sig: bytes, i: int) -> bytes:
    return sig[:i] + bytes([sig[i] ^ 1]) + sig[i + 1:]


# --- sr25519 -----------------------------------------------------------------

def test_sr25519_cross_impl_vectors():
    """The merlin crate's transcript vector and schnorrkel's MiniSecretKey
    vector (tests/test_curves.py) through the port's stack."""
    t = psr.Transcript(b"test protocol")
    t.append_message(b"some label", b"some data")
    assert t.challenge_bytes(b"challenge", 32).hex() == \
        "d5a21972d0d5fe320c0d263fac7fffb8145aa640af6e9bca177c03c7efcf0615"
    pv = psr.Sr25519PrivKey.from_mini_secret(
        b"12345678901234567890123456789012")
    assert pv.pub_key().raw.hex() == \
        "741c08a06f41c596608f6774259bd9043304adfa5d3eea62760bd9be97634d63"
    jv = jsr.Sr25519PrivKey.from_mini_secret(
        b"12345678901234567890123456789012")
    assert pv.bytes_() == jv.key + jv.nonce
    assert pv.sign(MSG) == jv.sign(MSG)


def test_sr25519_primitives_match_jax():
    rng = random.Random(5)
    for _ in range(3):
        state = bytearray(rng.randrange(256) for _ in range(200))
        js, ps = bytearray(state), bytearray(state)
        jsr.keccak_f1600(js)
        psr.keccak_f1600(ps)
        assert ps == js
    labels = [(b"a", b"1"), (b"sign-bytes", bytes(range(200))), (b"", b"")]
    jt, pt = jsr.Transcript(b"proto"), psr.Transcript(b"proto")
    for label, msg in labels:
        jt.append_message(label, msg)
        pt.append_message(label, msg)
    assert pt.challenge_bytes(b"c", 64) == jt.challenge_bytes(b"c", 64)
    assert pt.witness_bytes(b"w", b"\x07" * 32) == \
        jt.witness_bytes(b"w", b"\x07" * 32)
    for k in (1, 2, 7, 12345, rng.randrange(1, ref.L)):
        enc = psr.ristretto_encode(ref.pt_mul(k, ref.BASE))
        assert enc == jsr.ristretto_encode(ref.pt_mul(k, ref.BASE))
        assert psr.ristretto_encode(psr.ristretto_decode(enc)) == enc
    # the 2-torsion point leaves the encoding as it was
    pt9 = ref.pt_mul(9, ref.BASE)
    assert psr.ristretto_encode(ref.pt_add(pt9, (0, ref.P - 1, 1, 0))) == \
        psr.ristretto_encode(pt9)
    for bad in (b"\xff" * 32, (1).to_bytes(32, "little"), b"\x00" * 31):
        assert psr.ristretto_decode(bad) is None
        assert jsr.ristretto_decode(bad) is None


def test_sr25519_sign_verify_match_jax():
    rng = random.Random(6)
    for _ in range(3):
        key, nonce = (bytes(rng.randrange(256) for _ in range(32))
                      for _ in range(2))
        pk, jk = psr.Sr25519PrivKey(key, nonce), jsr.Sr25519PrivKey(key, nonce)
        assert pk.pub_key().raw == jk.pub_key().raw
        sig = pk.sign(MSG)
        assert sig == jk.sign(MSG) and sig[63] & 0x80
        unmarked = sig[:63] + bytes([sig[63] & 0x7F])
        cases = [(MSG, sig), (MSG + b"!", sig), (MSG, _flip(sig, 10)),
                 (MSG, _flip(sig, 40)), (MSG, unmarked), (MSG, bytes(64)),
                 (MSG, sig[:63])]
        want = [True] + [False] * (len(cases) - 1)
        assert [pk.pub_key().verify_signature(m, s) for m, s in cases] == \
            [jk.pub_key().verify_signature(m, s) for m, s in cases] == want
        assert not pk.pub_key().verify_signature(MSG, sig, context=b"other")


def test_sr25519_batch_verifier_matches_jax():
    rng = random.Random(7)
    items = []
    for i in range(6):
        k = psr.Sr25519PrivKey.generate(rng)
        m = bytes([i]) * 20
        items.append((k, m, k.sign(m)))
    outs = []
    for mod in (psr, jsr):
        for bad in (None, 3):
            bv = mod.Sr25519BatchVerifier()
            for i, (k, m, s) in enumerate(items):
                bv.add(mod.Sr25519PubKey(k.pub_key().raw), m,
                       _flip(s, 40) if i == bad else s)
            outs.append(bv.verify())
    assert outs[0] == outs[2] == (True, [True] * 6)
    assert outs[1] == outs[3] == (False, [True, True, True, False, True,
                                          True])


# --- secp256k1 ---------------------------------------------------------------

def test_secp256k1_matches_jax():
    rng = random.Random(8)
    for _ in range(2):
        k = psecp.Secp256k1PrivKey.generate(rng)
        jk = jsecp.Secp256k1PrivKey(k.secret)
        pub, jpub = k.pub_key(), jk.pub_key()
        assert pub.raw == jpub.raw and len(pub.raw) == 33
        assert pub.address() == jpub.address() and len(pub.address()) == 20
        assert psecp._decompress(pub.raw) == jsecp._decompress(pub.raw)
        sig = k.sign(MSG)
        assert sig == jk.sign(MSG) == k.sign(MSG)   # RFC 6979
        s = int.from_bytes(sig[32:], "big")
        high_s = sig[:32] + (psecp.N - s).to_bytes(32, "big")
        cases = [(MSG, sig), (MSG + b"x", sig), (MSG, _flip(sig, 63)),
                 (MSG, high_s), (MSG, sig[:63]), (MSG, bytes(64))]
        want = [True] + [False] * (len(cases) - 1)
        assert [pub.verify_signature(m, x) for m, x in cases] == \
            [jpub.verify_signature(m, x) for m, x in cases] == want
    assert psecp._pt_mul(2, (psecp.GX, psecp.GY))[0] == int(
        "C6047F9441ED7D6D3045406E95C07CD85C778E4B8CEF3CA7ABAC09B95C709EE5",
        16)


def test_secp256k1_address_matches_jax():
    """RIPEMD160(SHA256(pubkey)): secret 1's key (the generator,
    compressed) has bitcoin's well-known hash160, and keys read by type
    through the factories have the JAX package's addresses."""
    one = psecp.Secp256k1PrivKey((1).to_bytes(32, "big")).pub_key()
    assert one.raw.hex() == "02" + format(psecp.GX, "064x")
    assert one.address().hex() == "751e76e8199196d454941c45d1b3a323f1433bd6"
    rng = random.Random(9)
    for _ in range(3):
        k = psecp.Secp256k1PrivKey.generate(rng)
        pub = pkeys.pubkey_from_type_bytes("secp256k1", k.pub_key().raw)
        jpub = jkeys.pubkey_from_type_bytes("secp256k1", k.pub_key().raw)
        assert pub.address() == jpub.address() == \
            psecp.address_from_pubkey(pub.raw)


# --- key factories and the seam ----------------------------------------------

KEYS = {"ed25519": b"\x11" * 32,
        "sr25519": b"\x22" * 32 + b"\x33" * 32,
        "secp256k1": b"\x44" * 32}


@pytest.mark.parametrize("key_type", sorted(KEYS))
def test_key_factories_match_jax(key_type):
    priv = tm.make_key("port", key_type, KEYS[key_type])
    raw_pub = priv.pub_key().bytes_()
    pub = pkeys.pubkey_from_type_bytes(key_type, raw_pub)
    jpub = jkeys.pubkey_from_type_bytes(key_type, raw_pub)
    assert pub.type_() == jpub.type_() == key_type
    assert pub.bytes_() == jpub.bytes_() and pub.address() == jpub.address()
    sig = priv.sign(MSG)
    assert pub.verify_signature(MSG, sig) and jpub.verify_signature(MSG, sig)
    # the port adds the private keys of both other types; the JAX
    # package reads ed25519 (and BLS) private keys only
    back = pkeys.privkey_from_type_bytes(key_type, priv.bytes_())
    assert back.pub_key().bytes_() == raw_pub and back.sign(MSG) == sig
    if key_type == "ed25519":
        assert jkeys.privkey_from_type_bytes(key_type, priv.bytes_()) \
            .sign(MSG) == sig
    else:
        with pytest.raises(ValueError):
            jkeys.privkey_from_type_bytes(key_type, priv.bytes_())


def test_key_factories_dispatch_on_type_not_length():
    raw = KEYS["ed25519"]
    ed = pkeys.pubkey_from_type_bytes("ed25519", raw)
    sr = pkeys.pubkey_from_type_bytes("sr25519", raw)
    assert (ed.type_(), sr.type_()) == ("ed25519", "sr25519")
    for mod in (pkeys, jkeys):
        with pytest.raises(ValueError):
            mod.pubkey_from_type_bytes("rsa", raw)
        with pytest.raises(ValueError):
            mod.pubkey_from_type_bytes("secp256k1", raw)   # not 33 bytes
    for mod in (pkeys, jkeys):
        # not a compressed G1 point; a zero scalar is out of range
        with pytest.raises(ValueError):
            mod.pubkey_from_type_bytes("bls12_381", b"\x00" * 48)
        with pytest.raises(ValueError):
            mod.privkey_from_type_bytes("bls12_381", b"\x00" * 32)
    bls = pkeys.privkey_from_type_bytes("bls12_381", b"\x11" * 32)
    assert bls.pub_key().bytes_() == jkeys.privkey_from_type_bytes(
        "bls12_381", b"\x11" * 32).pub_key().bytes_()
    with pytest.raises(ValueError):
        pkeys.privkey_from_type_bytes("sr25519", b"\x00" * 32)


class _BlsStub:
    """A BLS key: the batch verifier needs only its type."""

    def type_(self):
        return "bls12_381"


@pytest.mark.parametrize("key_type", sorted(KEYS) + ["bls12_381"])
def test_create_batch_verifier_matches_jax(key_type):
    if key_type == "bls12_381":
        assert pbatch.supports_batch_verifier(_BlsStub()) == \
            jbatch.supports_batch_verifier(_BlsStub()) is True
        # the host RLC multi-pairing, never (None, False): that would
        # send BLS lanes down the per-signature path
        bv, ok = pbatch.create_batch_verifier(_BlsStub(), device="cpu")
        jbv, jok = jbatch.create_batch_verifier(_BlsStub())
        assert ok == jok is True
        assert type(bv).__name__ == type(jbv).__name__ == "BlsBatchVerifier"
        return
    pub = tm.make_key("port", key_type, KEYS[key_type]).pub_key()
    jpub = jkeys.pubkey_from_type_bytes(key_type, pub.bytes_())
    assert pbatch.supports_batch_verifier(pub) == \
        jbatch.supports_batch_verifier(jpub) == (key_type != "secp256k1")
    bv, ok = pbatch.create_batch_verifier(pub, device="cpu")
    jbv, jok = jbatch.create_batch_verifier(jpub)
    assert ok == jok and type(bv).__name__ == type(jbv).__name__
    assert not pbatch.supports_batch_verifier(None)


# --- MixedBatchVerifier ------------------------------------------------------

@pytest.fixture(scope="module")
def lanes():
    """76 (type, raw key) specs in a seeded order, 70 of them ed25519,
    each with its message and signature."""
    specs = tm.key_specs(11, n_ed=70, n_sr=3, n_secp=3)
    privs = [tm.make_key("port", t, r) for t, r in specs]
    msgs = [b"lane %d " % i + MSG for i in range(len(specs))]
    return specs, msgs, [k.sign(m) for k, m in zip(privs, msgs)]


def _mixed_verify(side, specs, msgs, sigs):
    mod, keys = (pbatch, pkeys) if side == "port" else (jbatch, jkeys)
    mv = (mod.MixedBatchVerifier(device="cpu") if side == "port"
          else mod.MixedBatchVerifier())
    for (t, r), m, s in zip(specs, msgs, sigs):
        raw = tm.make_key(side, t, r).pub_key().bytes_()
        mv.add(keys.pubkey_from_type_bytes(t, raw), m, s)
    assert len(mv) == len(specs)
    return mv.verify()


@pytest.mark.parametrize("bad_types", [(), ("ed25519", "sr25519",
                                            "secp256k1")])
def test_mixed_batch_verifier_matches_jax(lanes, bad_types):
    specs, msgs, sigs = lanes
    first = tm.first_of_each(specs)
    bad = sorted(first[t] for t in bad_types)
    sigs = [_flip(s, 40) if i in bad else s for i, s in enumerate(sigs)]
    stats0 = dict(ped.STATS)
    ok, oks = _mixed_verify("port", specs, msgs, sigs)
    jok, joks = _mixed_verify("jax", specs, msgs, sigs)
    assert (ok, oks) == (jok, joks)
    assert [i for i, v in enumerate(oks) if not v] == bad
    assert ok == (not bad)
    # the ed25519 bucket ran the torch RLC path; a bad ed25519 lane sent
    # it through the per-lane verify
    moved = {k: ped.STATS[k] - stats0[k] for k in ("rlc_pass", "per_lane")}
    assert moved == ({"rlc_pass": 0, "per_lane": 1} if bad
                     else {"rlc_pass": 1, "per_lane": 0})


def test_mixed_batch_verifier_singles_only_and_empty():
    """No ed25519 or sr25519 lane: every lane verifies alone, nothing
    reaches a device. The empty batch fails, as in the reference."""
    specs = tm.key_specs(12, n_ed=0, n_sr=0, n_secp=2)
    privs = [tm.make_key("port", t, r) for t, r in specs]
    sigs = [privs[0].sign(MSG), _flip(privs[1].sign(MSG), 40)]
    got = _mixed_verify("port", specs, [MSG, MSG], sigs)
    assert got == _mixed_verify("jax", specs, [MSG, MSG], sigs) == \
        (False, [True, False])
    assert pbatch.MixedBatchVerifier(device="cpu").verify() == \
        jbatch.MixedBatchVerifier().verify() == (False, [])


# --- the state JSON ----------------------------------------------------------

def test_mixed_state_json_roundtrip(lanes):
    specs = [s for s in lanes[0] if s[0] == "ed25519"][:9] + \
        [s for s in lanes[0] if s[0] != "ed25519"]
    pvs, jvs = tm.valset("port", specs), tm.valset("jax", specs)
    raw = pstate._valset_to_json(pvs)
    assert raw == jstate._valset_to_json(jvs)
    back = pstate._valset_from_json(raw)
    assert pstate._valset_to_json(back) == raw
    assert [v.pub_key.type_() for v in back.validators] == \
        [v.pub_key.type_() for v in pvs.validators]
    assert back.get_proposer().address == pvs.get_proposer().address
    # a whole state with the mixed set, into the port and out of it
    gens = [mod.GenesisDoc(chain_id="mixed", validators=vs.validators)
            for mod, vs in ((pstate, pvs), (jstate, jvs))]
    pj = pstate._state_to_json(pstate.State.from_genesis(gens[0]))
    jj = jstate._state_to_json(jstate.State.from_genesis(gens[1]))
    assert pj == jj
    assert pstate._state_to_json(pstate._state_from_json(jj)) == jj
    assert jstate._state_to_json(jstate._state_from_json(pj)) == pj
