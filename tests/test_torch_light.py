"""The port's light client (cometbft_tpu_torch/light/, with
`engine/chain_gen.ChainLightProvider` and
`types/evidence.LightClientAttackEvidence.decode_body`) held against the
JAX package's, on the CPU.

Each case of tests/test_light.py runs on the same seeded chain built by
each package (byte-identical: tests/test_torch_blocksync.py), once with
each package's light client, and the two runs must give the same
trusted heights and hashes, the same provider fetches, the same exception
classes and the same evidence bytes. Everything compared is bytes,
integers or a class, so the tolerance is none. The attack evidence the
port builds also decodes in the JAX package and passes its
`evidence/pool.verify_light_client_attack`.

The 5-validator chain verifies per signature in both packages (commits
under `BATCH_VERIFY_THRESHOLD` = 64). One more chain of 96 validators
takes the port's light client to its torch RLC path (`ops.ed25519.STATS`):
its adjacent headers need 65 signatures for +2/3, a bucket the JAX
package verifies per signature on the CPU (64 lanes or fewer would jit
its RLC kernel). Non-adjacent jumps on that chain (a 1/3 trusting check,
33 lanes) run on the port side only and are held against the chain.
"""

import dataclasses
import random

import pytest
import torch

from cometbft_tpu import light as jlight
from cometbft_tpu.db.kv import MemDB as JMemDB
from cometbft_tpu.engine import chain_gen as jcg
from cometbft_tpu.evidence.pool import verify_light_client_attack
from cometbft_tpu.light import client as jclient
from cometbft_tpu.light import provider as jprovider
from cometbft_tpu.light import types as jtypes
from cometbft_tpu.light import verifier as jverifier
from cometbft_tpu.state.state import State as JState
from cometbft_tpu.types import block as jblock
from cometbft_tpu.types import evidence as jevidence
from cometbft_tpu.types.proto import Timestamp as JTimestamp

from cometbft_tpu_torch import light as plight
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey as PPriv
from cometbft_tpu_torch.db.kv import MemDB as PMemDB
from cometbft_tpu_torch.engine import chain_gen as pcg
from cometbft_tpu_torch.light import client as pclient
from cometbft_tpu_torch.light import provider as pprovider
from cometbft_tpu_torch.light import types as ptypes
from cometbft_tpu_torch.light import verifier as pverifier
from cometbft_tpu_torch.ops import ed25519 as ped
from cometbft_tpu_torch.rpc import codec as pcodec
from cometbft_tpu_torch.types import block as pblock
from cometbft_tpu_torch.types import evidence as pevidence
from cometbft_tpu_torch.types.proto import Timestamp as PTimestamp

from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv

CHAIN_LEN = 24
TRUST_PERIOD = 10**9
WIDE = 96         # validators: +2/3 of a commit is 65 signatures
WIDE_LEN = 4

SIDES = {
    "jax": dict(light=jlight, client=jclient, provider=jprovider,
                types=jtypes, verifier=jverifier, db=JMemDB, cg=jcg,
                block=jblock, evidence=jevidence, ts=JTimestamp, priv=JPriv,
                dev={}),
    "port": dict(light=plight, client=pclient, provider=pprovider,
                 types=ptypes, verifier=pverifier, db=PMemDB, cg=pcg,
                 block=pblock, evidence=pevidence, ts=PTimestamp,
                 priv=PPriv, dev={"device": "cpu"}),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Eager torch at 128 lanes is launch-bound on the CPU; one thread
    runs it several times faster than a contended pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def chains():
    """Per side: the 24-block, 5-validator chain of tests/test_light.py."""
    out = {"jax": jcg.generate_chain(CHAIN_LEN, n_validators=5,
                                     txs_per_block=1),
           "port": pcg.generate_chain(CHAIN_LEN, n_validators=5,
                                      txs_per_block=1, device="cpu")}
    assert out["port"].blocks[-1].hash() == out["jax"].blocks[-1].hash()
    return out


def _provider_cls(m):
    class ChainProvider(m["cg"].ChainLightProvider):
        """ChainLightProvider plus optional header tampering (a forged
        app hash with the original commit) and a log of fetches."""

        def __init__(self, chain, tamper_height=None):
            super().__init__(chain)
            self.tamper_height = tamper_height
            self.fetches = []
            self.reported = []

        def light_block(self, height):
            self.fetches.append(height)
            if height == 0:
                height = self.chain.max_height()
            lb = super().light_block(height)
            if height == self.tamper_height:
                hdr = dataclasses.replace(lb.signed_header.header,
                                          app_hash=b"\x66" * 32)
                lb = m["types"].LightBlock(
                    m["types"].SignedHeader(hdr, lb.signed_header.commit),
                    lb.validator_set)
            return lb

        def report_evidence(self, ev):
            self.reported.append(ev.encode())

    return ChainProvider


def _now(m, chain):
    return m["ts"](1_700_000_000 + chain.max_height() + 5, 0)


def _client(m, chain, sequential=False, witnesses=(), store=None,
            primary=None, period=TRUST_PERIOD, trust_hash=None):
    opts = m["light"].TrustOptions(
        period_seconds=period, height=1,
        hash=trust_hash or chain.blocks[0].hash())
    return m["light"].LightClient(
        chain.chain_id, opts, primary or _provider_cls(m)(chain),
        list(witnesses), store or m["light"].LightStore(m["db"]()),
        sequential=sequential, now_fn=lambda: _now(m, chain), **m["dev"])


def _trusted(lc, top):
    return [h for h in range(1, top + 1)
            if lc.trusted_light_block(h) is not None]


def _raises(fn):
    try:
        fn()
    except Exception as e:     # the class is what is compared
        return type(e).__name__
    return None


# --- the cases of tests/test_light.py, each run with either package ---------

def case_sequential(m, chain):
    lc = _client(m, chain, sequential=True)
    lb = lc.verify_light_block_at_height(chain.max_height())
    return lb.header.hash(), _trusted(lc, chain.max_height()), \
        lc.primary.fetches


def case_skipping(m, chain):
    lc = _client(m, chain)
    lc.primary.fetches.clear()
    lb = lc.verify_light_block_at_height(chain.max_height())
    return lb.header.hash(), lc.primary.fetches, \
        _trusted(lc, chain.max_height())


def case_backwards(m, chain):
    lc = _client(m, chain)
    lc.verify_light_block_at_height(chain.max_height())
    lb = lc.verify_light_block_at_height(1)
    return lb.header.hash(), lc.primary.fetches


def case_expired(m, chain):
    lc = _client(m, chain, period=1)
    return _raises(lambda: lc.verify_light_block_at_height(
        chain.max_height()))


def case_bad_trust_root(m, chain):
    return _raises(lambda: _client(m, chain, trust_hash=b"\x13" * 32))


def case_witness_divergence(m, chain):
    target = chain.max_height()
    witness = _provider_cls(m)(chain, tamper_height=target)
    lc = _client(m, chain, witnesses=[witness])
    try:
        lc.verify_light_block_at_height(target)
    except m["client"].ConflictingHeadersError as e:
        ev = e.evidence
        return (e.witness_index, lc.trusted_light_block(target) is None,
                lc.primary.reported, witness.reported,
                ev.encode() if ev is not None else None)
    raise AssertionError("no ConflictingHeadersError")


def case_witness_down(m, chain):
    class DownWitness:
        def light_block(self, height):
            raise m["provider"].ProviderError("connection refused")

    target = chain.max_height()
    lc = _client(m, chain, witnesses=[DownWitness(),
                                      _provider_cls(m)(chain)])
    lb = lc.verify_light_block_at_height(target)
    return lb.header.hash(), lc.trusted_light_block(target) is not None


def case_store_prune(m, chain):
    store = m["light"].LightStore(m["db"]())
    lc = _client(m, chain, sequential=True, store=store)
    lc.verify_light_block_at_height(chain.max_height())
    store.prune(3)
    return store.lowest().height, store.latest().height, \
        store.highest_below(chain.max_height()).header.hash()


def case_backwards_mismatch(m, chain):
    target = chain.max_height()
    bad_h = target - 2

    class TamperingPrimary(_provider_cls(m)):
        armed = False

        def light_block(self, height):
            lb = super().light_block(height)
            if self.armed and height == bad_h:
                hdr = dataclasses.replace(lb.header, app_hash=b"\x13" * 32)
                return m["types"].LightBlock(
                    m["types"].SignedHeader(hdr, lb.signed_header.commit),
                    lb.validator_set)
            return lb

    store = m["light"].LightStore(m["db"]())
    prov = TamperingPrimary(chain)
    lc = _client(m, chain, store=store, primary=prov)
    lc.verify_light_block_at_height(target)
    store.delete(bad_h)
    store.delete(bad_h + 1)
    prov.armed = True
    err = _raises(lambda: lc.verify_light_block_at_height(bad_h))
    stored = store.lowest_above(bad_h - 1)
    return err, None if stored is None else (stored.height,
                                             stored.header.hash())


def _forged_block(m, chain, height, app_hash, n_byz=2):
    """The chain's block at `height` with a forged app hash, its commit
    signed by the first `n_byz` validators only."""
    real = chain.blocks[height - 1]
    vals = chain.valsets[height - 1]
    hdr = dataclasses.replace(real.header, app_hash=app_hash)
    forged = dataclasses.replace(real, header=hdr)
    byz = vals.validators[:n_byz]
    fid = m["block"].BlockID(forged.hash(), forged.make_part_set().header)

    class _Subset:
        validators = byz

    commit = m["cg"].sign_commit(chain.chain_id, height, 0, fid, _Subset,
                                 {v.address: chain.keys[v.address]
                                  for v in byz})
    return m["types"].LightBlock(m["types"].SignedHeader(hdr, commit),
                                 vals.copy())


def case_attack_evidence(m, chain):
    """A lunatic fork signed by 2 of 5 validators, served by a witness:
    detected, packaged as LightClientAttackEvidence, reported."""
    target = chain.max_height()
    forged_lb = _forged_block(m, chain, target, b"\x66" * 32)

    class ForgingProvider(_provider_cls(m)):
        def light_block(self, height):
            if height in (0, target):
                return forged_lb
            return super().light_block(height)

    witness = ForgingProvider(chain)
    lc = _client(m, chain, witnesses=[witness])
    try:
        lc.verify_light_block_at_height(target)
    except m["client"].ConflictingHeadersError as e:
        ev = e.evidence
        back = m["evidence"].decode_evidence(ev.encode())
        assert back.hash() == ev.hash() and back.encode() == ev.encode()
        return (ev.encode(), ev.common_height,
                sorted(v.address for v in ev.byzantine_validators),
                lc.primary.reported, witness.reported)
    raise AssertionError("no ConflictingHeadersError")


def case_two_witness_fork(m, chain):
    """One honest witness, one serving a consistently signed fork from
    `target - 3`: the forked one is blamed and the evidence anchored
    below the divergence."""
    target = chain.max_height()
    fork_from = target - 3

    class ForkedWitness(_provider_cls(m)):
        cache = {}

        def light_block(self, height):
            if height == 0:
                height = self.chain.max_height()
            if height < fork_from:
                return super().light_block(height)
            if height not in self.cache:
                self.cache[height] = _forged_block(m, self.chain, height,
                                                   b"\x77" * 32)
            return self.cache[height]

    honest, forked = _provider_cls(m)(chain), ForkedWitness(chain)
    lc = _client(m, chain, witnesses=[honest, forked])
    try:
        lc.verify_light_block_at_height(target)
    except m["client"].ConflictingHeadersError as e:
        ev = e.evidence
        return (e.witness_index, ev.encode(), ev.common_height,
                ev.conflicting_block.height, lc.primary.reported,
                forked.reported, honest.reported)
    raise AssertionError("no ConflictingHeadersError")


CASES = {f.__name__[5:]: f for f in (
    case_sequential, case_skipping, case_backwards, case_expired,
    case_bad_trust_root, case_witness_divergence, case_witness_down,
    case_store_prune, case_backwards_mismatch, case_attack_evidence,
    case_two_witness_fork)}


def _fresh_caches():
    """Both packages' process-wide verified-signature caches emptied: the
    generators' commit checks filled them, and a client that finds every
    lane there verifies no signature."""
    from cometbft_tpu.pipeline.cache import reset_shared_cache as jreset
    from cometbft_tpu_torch.pipeline.cache import reset_shared_cache
    jreset()
    reset_shared_cache()


@pytest.mark.parametrize("name", sorted(CASES))
def test_light_case_matches_jax(chains, name):
    _fresh_caches()
    jout = CASES[name](SIDES["jax"], chains["jax"])
    _fresh_caches()
    pout = CASES[name](SIDES["port"], chains["port"])
    assert pout == jout
    top = chains["port"].max_height()
    tip = chains["port"].blocks[-1].hash()
    if name == "sequential":
        assert pout[0] == tip and pout[1] == list(range(1, top + 1))
    elif name == "skipping":
        # one non-adjacent jump: no intermediate fetch or header stored
        assert pout == (tip, [top], [1, top])
    elif name == "backwards":
        assert pout[0] == chains["port"].blocks[0].hash()
    elif name in ("expired", "bad_trust_root"):
        assert pout in ("ErrOldHeader", "LightClientError")
    elif name == "witness_divergence":
        assert pout[0] == 0 and pout[1] and pout[2] and pout[3]
    elif name == "witness_down":
        assert pout == (tip, True)
    elif name == "store_prune":
        assert pout[:2] == (top - 2, top)
    elif name == "backwards_mismatch":
        assert pout[0] in ("LightClientError", "LightBlockError")
        assert pout[1] is None or pout[1][0] != top - 2
    elif name == "attack_evidence":
        # cross-reported: the witness's fork to the primary, the
        # primary's header to the witness
        assert pout[1] < top and pout[3] and pout[4]
        assert pout[2] == sorted(
            v.address for v in chains["port"].valsets[-1].validators[:2])
    elif name == "two_witness_fork":
        assert pout[0] == 1 and 1 <= pout[2] < top - 3 <= pout[3]
        assert pout[4] and pout[5] and not pout[6]


def test_port_attack_evidence_verifies_in_jax(chains):
    """The port's evidence bytes decode in the JAX package and pass its
    full-node check against the common validator set; the port decodes
    its own bytes into an equal LightClientAttackEvidence."""
    ev_bytes = case_attack_evidence(SIDES["port"], chains["port"])[0]
    ev = jevidence.decode_evidence(ev_bytes)
    jchain = chains["jax"]
    verify_light_client_attack(
        ev, JState.from_genesis(jchain.genesis),
        jchain.valsets[ev.common_height - 1], jchain.blocks[-1].header)
    pev = pevidence.decode_evidence(ev_bytes)
    assert isinstance(pev.conflicting_block, ptypes.LightBlock)
    assert pev.encode() == ev_bytes and pev.hash() == ev.hash()
    assert pev.conflicting_block.validator_set.hash() == \
        chains["port"].valsets[-1].hash()


def test_bisection_across_valset_rotation():
    """Rotate the whole set mid-chain (6 validators join at heights 5-10,
    the original 4 leave at 11-14): the trusted set cannot vouch for the
    tip, so both clients bisect, through the same fetches."""
    outs = []
    for side in ("jax", "port"):
        m = SIDES[side]
        rng = random.Random(99)
        new_keys = [m["priv"](bytes(rng.randrange(256) for _ in range(32)))
                    for _ in range(6)]
        _, orig_keys = m["cg"].make_genesis(4, seed=1)
        val_txs = {}
        for i, k in enumerate(new_keys):
            val_txs[5 + i] = (b"val:" + k.pub_key().bytes_().hex().encode()
                              + b"!40")
        for i, k in enumerate(orig_keys.values()):
            val_txs[11 + i] = (b"val:" + k.pub_key().bytes_().hex().encode()
                               + b"!0")
        chain = m["cg"].generate_chain(20, n_validators=4,
                                       val_tx_heights=val_txs,
                                       extra_keys=new_keys, txs_per_block=1,
                                       **m["dev"])
        lc = _client(m, chain)
        lc.primary.fetches.clear()
        lb = lc.verify_light_block_at_height(chain.max_height())
        outs.append((lb.header.hash(), lc.primary.fetches,
                     _trusted(lc, chain.max_height())))
    assert outs[0] == outs[1]
    assert len(outs[1][1]) > 1, "rotation must force bisection"


def test_provider_retry_transient_matches_jax():
    """retry_transient: the same jittered backoff delays from the same
    seeded rng, the final transient failure re-raised, a non-transient
    error raised at once."""
    outs = []
    for side in ("jax", "port"):
        retry = SIDES[side]["provider"].retry_transient
        calls, delays = {"n": 0}, []

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise ConnectionRefusedError("refused")
            return "ok"

        def hard_fail():
            calls["n"] += 1
            raise ValueError("malformed")

        rng = random.Random("t")
        got = retry(flaky, rng, retries=2, base_s=0.01, sleep=delays.append)
        with pytest.raises(OSError):
            retry(lambda: (_ for _ in ()).throw(OSError("down")), rng,
                  retries=1, base_s=0.0, sleep=delays.append)
        calls["n"] = 0
        with pytest.raises(ValueError):
            retry(hard_fail, rng, retries=3, base_s=0.0, sleep=delays.append)
        outs.append((got, delays, calls["n"]))
    assert outs[0] == outs[1]
    assert outs[1][0] == "ok" and outs[1][2] == 1
    assert outs[1][1][1] > outs[1][1][0]


def test_http_provider_retries_flaky_fetch(chains, monkeypatch):
    """The port's HTTPProvider over a duck-typed client whose /commit
    fails twice, decoding the JSON the port's codec writes (equal to the
    JAX package's codec output)."""
    from cometbft_tpu.rpc import codec as jcodec
    chain = chains["port"]
    target = chain.max_height()
    blk = chain.blocks[target - 1]
    assert pcodec.header_json(blk.header) == \
        jcodec.header_json(chains["jax"].blocks[-1].header)

    class FlakyRPC:
        commit_calls = 0

        def commit(self, height=None):
            self.commit_calls += 1
            if self.commit_calls < 3:
                raise ConnectionResetError("flaky wire")
            return {"signed_header": {
                "header": pcodec.header_json(blk.header),
                "commit": pcodec.commit_json(chain.seen_commits[-1])}}

        def call(self, method, **kw):
            assert method == "validators"
            js = pcodec.validator_set_json(chain.valsets[-1])
            return {"block_height": target, "validators": js["validators"],
                    "proposer": js["proposer"],
                    "total": len(js["validators"])}

    monkeypatch.setenv(pprovider.ENV_RETRY_BASE, "0")
    rpc = FlakyRPC()
    lb = pprovider.HTTPProvider(chain.chain_id, rpc).light_block(target)
    assert rpc.commit_calls == 3
    assert lb.header.hash() == blk.hash()
    assert lb.validator_set.hash() == chain.valsets[-1].hash()
    lb.validate_basic(chain.chain_id)


# --- a chain wide enough for the port's torch RLC path -----------------------

@pytest.fixture(scope="module")
def wide():
    """Per side: a 4-block chain of 96 validators."""
    return {"jax": jcg.generate_chain(WIDE_LEN, n_validators=WIDE, seed=2,
                                      txs_per_block=1),
            "port": pcg.generate_chain(WIDE_LEN, n_validators=WIDE, seed=2,
                                       txs_per_block=1, device="cpu")}


def test_wide_chain_sequential_on_rlc_path(wide):
    """Sequential verification of every header, then a primary that
    serves a commit with one tampered signature: the port's flushes run
    the torch RLC path (and attribute the tampered one per lane), with
    the JAX package's results."""
    outs, moved = [], {}
    for side in ("jax", "port"):
        m, chain = SIDES[side], wide[side]
        _fresh_caches()
        stats0 = dict(ped.STATS)
        lc = _client(m, chain, sequential=True)
        lb = lc.verify_light_block_at_height(chain.max_height())

        class TamperedCommit(_provider_cls(m)):
            def light_block(self, height):
                lb = super().light_block(height)
                if lb.height == 1:
                    return lb       # the trust root stays clean
                sh = lb.signed_header
                sigs = list(sh.commit.signatures)
                s = sigs[5]
                sigs[5] = dataclasses.replace(
                    s, signature=s.signature[:40]
                    + bytes([s.signature[40] ^ 1]) + s.signature[41:])
                return m["types"].LightBlock(m["types"].SignedHeader(
                    sh.header, dataclasses.replace(sh.commit,
                                                   signatures=sigs)),
                    lb.validator_set)

        # a fresh cache: a tampered commit whose other lanes were all
        # cached would flush one lane, which the JAX package jits
        _fresh_caches()
        bad = _client(m, chain, sequential=True,
                      primary=TamperedCommit(chain))
        outs.append((lb.header.hash(), _trusted(lc, chain.max_height()),
                     _raises(lambda: bad.verify_light_block_at_height(2))))
        moved[side] = {k: ped.STATS[k] - stats0[k] for k in stats0}
    assert outs[0] == outs[1]
    assert outs[1][0] == wide["port"].blocks[-1].hash()
    assert outs[1][2] == "ErrInvalidHeader"
    # the trust root and 3 adjacent headers, then the tampered header's
    # root and its commit, attributed per lane
    assert moved["port"] == {"rlc_pass": WIDE_LEN + 1, "per_lane": 1}
    assert moved["jax"] == {"rlc_pass": 0, "per_lane": 0}


def test_wide_chain_skipping_port(wide):
    """The port's skipping client on the wide chain: one non-adjacent jump
    (a 1/3 trusting check of 33 lanes and a +2/3 check of 65) lands on the
    chain's tip hash."""
    _fresh_caches()
    m, chain = SIDES["port"], wide["port"]
    stats0 = dict(ped.STATS)
    lc = _client(m, chain)
    lc.primary.fetches.clear()
    lb = lc.verify_light_block_at_height(chain.max_height())
    assert lb.header.hash() == wide["jax"].blocks[-1].hash()
    assert lc.primary.fetches == [chain.max_height()]
    assert ped.STATS["rlc_pass"] - stats0["rlc_pass"] == 3


def test_chain_light_provider_matches_jax(chains):
    jp = jcg.ChainLightProvider(chains["jax"])
    pp = pcg.ChainLightProvider(chains["port"])
    assert pp.chain_id() == jp.chain_id()
    for h in (0, 1, CHAIN_LEN):
        a, b = jp.light_block(h), pp.light_block(h)
        assert b.header.hash() == a.header.hash()
        assert b.signed_header.commit.encode() == \
            a.signed_header.commit.encode()
        assert b.validator_set.hash() == a.validator_set.hash()
        b.validate_basic(pp.chain_id())
    for h in (-1, CHAIN_LEN + 1):
        with pytest.raises(pprovider.ErrLightBlockNotFound):
            pp.light_block(h)
    assert set(plight.__all__) == set(jlight.__all__)


def test_light_client_device_rules():
    """No card here: the default device raises at construction, as
    everywhere in the port."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present here")
    chain = pcg.generate_chain(2, n_validators=1, device="cpu")
    m = dict(SIDES["port"], dev={})
    with pytest.raises(RuntimeError):
        _client(m, chain)
