"""The port's light-client verification farm (cometbft_tpu_torch/farm/) held
against the JAX package's, on the CPU, on the same seeded ed25519 chains.

The main chain has 12 blocks of 20 validators (power 10): a light check of
one commit plans 14 lanes (`plan_commit_light` stops past 2/3), a trusting
check 7. A wave of 10 sessions subscribing at trusted heights 1-10 is one
flush of 140 unique lanes: at least FARM_KERNEL_MIN_LANES (128), so the
port's farm on `device="cpu"` sends it through `ops.ed25519.verify_batch`
at batch 256, where the RLC kernels' plain versions run ("kernel"). The
JAX package's farm takes its native per-signature route there (its compile
ledger is cold). The following verify wave (every session to the tip: one
commit's 14 lanes after dedup) is narrow, and both farms verify it per
signature on the host ("cpu").

Every result is a height, a hash, a count, a record or an exception
class, so the tolerance is none. Held: the accepted heights, the session
trust state and the decision records (which also pass
`tools/check_light_spec.check_decisions`), equal to a sequential
`LightClient`; the batch widths and dedup counts; the same rejection of a
forged signature (by the lane verdict) and of a forged header (host-side,
before any lane); the same sheds (`QueueFull`, the session cap) and the
released lane budget; a bisection across a valset rotation; a failing
backend failing its tickets; the `coalesce_wait` timing cases of
tests/test_farm.py:540-601. The port's rules: on its in-process route a
kernel error or a canary trip, injected through the plain versions,
propagates out of `flush()` and fails the tickets; only the device-server
route drains to the host, on a transport error or a canary mismatch in
the server's answer, counted in `fallbacks` and traced as
`farm.cpu_drain`, and `DeviceUnprocessable` and `DeviceFlushFailed`
raise.
"""

import dataclasses
import random
import threading
import time

import pytest
import torch

from cometbft_tpu.crypto.keys import Ed25519PrivKey as JKey
from cometbft_tpu.db.kv import MemDB as JMemDB
from cometbft_tpu.engine import chain_gen as jcg
from cometbft_tpu import farm as jfarm
from cometbft_tpu.farm import batcher as jfb
from cometbft_tpu.farm import planner as jplanner
from cometbft_tpu.farm import session as jsession
from cometbft_tpu.light import client as jlc
from cometbft_tpu.light.store import LightStore as JLightStore
from cometbft_tpu.light import types as jlt
from cometbft_tpu.pipeline.cache import SigCache as JCache
from cometbft_tpu.types import block as jblock
from cometbft_tpu.types.proto import Timestamp as JTimestamp

from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey as PKey
from cometbft_tpu_torch.crypto.keys import Ed25519PubKey as PPub
from cometbft_tpu_torch.db.kv import MemDB as PMemDB
from cometbft_tpu_torch.device import client as pclient
from cometbft_tpu_torch.device import health as phealth
from cometbft_tpu_torch.engine import chain_gen as pcg
from cometbft_tpu_torch import farm as pfarm
from cometbft_tpu_torch.farm import batcher as pfb
from cometbft_tpu_torch.farm import planner as pplanner
from cometbft_tpu_torch.farm import session as psession
from cometbft_tpu_torch.libs.metrics import Registry
from cometbft_tpu_torch.libs.metrics_gen import FarmMetrics
from cometbft_tpu_torch.light import client as plc
from cometbft_tpu_torch.light.store import LightStore as PLightStore
from cometbft_tpu_torch.light import types as plt
from cometbft_tpu_torch.ops import cuda_verify as cv
from cometbft_tpu_torch.ops import ed25519 as ped
from cometbft_tpu_torch import trace as ptrace
from cometbft_tpu_torch.pipeline.cache import SigCache as PCache
from cometbft_tpu_torch.types import block as pblock
from cometbft_tpu_torch.types.proto import Timestamp as PTimestamp
from tools.check_light_spec import check_decisions

SIDES = {
    "jax": dict(cg=jcg, farm=jfarm, fb=jfb, planner=jplanner,
                session=jsession, lc=jlc, LightStore=JLightStore, lt=jlt,
                blk=jblock, Cache=JCache, MemDB=JMemDB, Key=JKey,
                Timestamp=JTimestamp),
    "port": dict(cg=pcg, farm=pfarm, fb=pfb, planner=pplanner,
                 session=psession, lc=plc, LightStore=PLightStore, lt=plt,
                 blk=pblock, Cache=PCache, MemDB=PMemDB, Key=PKey,
                 Timestamp=PTimestamp),
}
CHAIN = dict(n_blocks=12, n_validators=20, txs_per_block=1,
             chain_id="farm-test", seed=3)
TRUST_PERIOD = 10 ** 9
WAVE_ROOTS = range(1, 11)   # 10 distinct roots x 14 lanes = 140 lanes


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def chains():
    return {"jax": jcg.generate_chain(**CHAIN),
            "port": pcg.generate_chain(**CHAIN, device="cpu")}


def _now(side, chain):
    return SIDES[side]["Timestamp"](
        1_700_000_000 + chain.max_height() + 5, 0)


def _farm(side, chain, provider=None, **kw):
    s = SIDES[side]
    cache = kw.pop("cache", None) or s["Cache"](65536)
    bkw = kw.pop("batcher_kw", {})
    if side == "port":
        bkw.setdefault("device", "cpu")
        kw.setdefault("device", "cpu")
    batcher = kw.pop("batcher", None) or s["fb"].FarmBatcher(
        cache=cache, coalesce_window_s=0.0, **bkw)
    return s["farm"].VerificationFarm(
        chain.chain_id, provider or s["cg"].ChainLightProvider(chain),
        cache=cache, batcher=batcher, now_fn=lambda: _now(side, chain),
        **kw)


def _tampering(side, chain):
    """The side's ChainLightProvider with an armable forgery per height
    (the JAX package's simnet TamperingProvider): "hash" serves a forged
    header with the original commit, "sig" the real header with signer
    0's signature bit-flipped."""
    s = SIDES[side]
    lt, blk = s["lt"], s["blk"]

    class Tampering(s["cg"].ChainLightProvider):
        armed: dict = {}

        def light_block(self, height):
            lb = super().light_block(height)
            mode = self.armed.get(height or self.chain.max_height())
            if mode == "hash":
                hdr = dataclasses.replace(lb.signed_header.header,
                                          app_hash=b"\x66" * 32)
                return lt.LightBlock(
                    lt.SignedHeader(hdr, lb.signed_header.commit),
                    lb.validator_set)
            if mode == "sig":
                c = lb.signed_header.commit
                sigs = list(c.signatures)
                x = sigs[0]
                sigs[0] = blk.CommitSig(x.block_id_flag,
                                        x.validator_address, x.timestamp,
                                        bytes([x.signature[0] ^ 1])
                                        + x.signature[1:])
                return lt.LightBlock(lt.SignedHeader(
                    lb.signed_header.header,
                    blk.Commit(c.height, c.round, c.block_id, sigs)),
                    lb.validator_set)
            return lb
    prov = Tampering(chain)
    prov.armed = {}
    return prov


def _waves(side, chain):
    """One subscribe wave (sessions at WAVE_ROOTS, one flush), then one
    verify wave (every session to the tip, one flush)."""
    farm = _farm(side, chain)
    pend = [farm.begin_subscribe(h, chain.blocks[h - 1].hash(),
                                 TRUST_PERIOD) for h in WAVE_ROOTS]
    widths = [farm.batcher.flush()]
    sessions = [farm.finish_subscribe(p) for p in pend]
    backends = [dict(farm.batcher.lanes_by_backend)]
    pv = [farm.begin_verify(s.session_id, chain.max_height())
          for s in sessions]
    widths.append(farm.batcher.flush())
    outs = [farm.finish_verify(p) for p in pv]
    backends.append(dict(farm.batcher.lanes_by_backend))
    return farm, sessions, widths, outs, backends


@pytest.fixture(scope="module")
def waves(chains):
    out = {}
    real = ped.verify_batch
    calls = []

    def spy(pubs, msgs, sigs, batch_size=None, **kw):
        calls.append((len(pubs), batch_size, str(kw.get("device"))))
        return real(pubs, msgs, sigs, batch_size=batch_size, **kw)
    ped.verify_batch = spy
    try:
        for side in SIDES:
            out[side] = _waves(side, chains[side])
    finally:
        ped.verify_batch = real
    return out, calls


def _heights(store, top):
    return [h for h in range(1, top + 1) if store.light_block(h)]


# --- the chain --------------------------------------------------------------------

def test_chains_match_jax(chains):
    for jb, pb_, jc, pc in zip(chains["jax"].blocks, chains["port"].blocks,
                               chains["jax"].seen_commits,
                               chains["port"].seen_commits):
        assert pb_.hash() == jb.hash()
        assert pc.hash() == jc.hash()


# --- the waves --------------------------------------------------------------------

def test_subscribe_wave_takes_the_kernel_route(waves):
    """140 unique lanes: the port's wave is one `verify_batch` call at
    batch 256 on the CPU (the plain RLC versions), labelled "kernel";
    the narrow verify wave (14 lanes) is per signature ("cpu") on both
    sides."""
    got, calls = waves
    assert calls == [(140, 256, "cpu")]
    assert got["port"][4] == [{"kernel": 140}, {"kernel": 140, "cpu": 14}]
    assert got["jax"][4] == [{"cpu": 140}, {"cpu": 154}]
    assert got["port"][2] == got["jax"][2] == [140, 14]


def test_waves_accept_like_jax(waves, chains):
    got, _ = waves
    top = chains["port"].max_height()
    for side in SIDES:
        farm, sessions, _w, outs, _b = got[side]
        assert [o["height"] for o in outs] == [top] * len(sessions)
    jsess, psess = got["jax"][1], got["port"][1]
    assert [s.status() for s in psess] == [s.status() for s in jsess]
    assert [_heights(s.store, top) for s in psess] == \
        [_heights(s.store, top) for s in jsess]
    assert [o for o in got["port"][3]] == [o for o in got["jax"][3]]


def test_decisions_match_jax_and_spec(waves):
    got, _ = waves
    precs = got["port"][0].drain_decisions()
    jrecs = got["jax"][0].drain_decisions()
    assert precs == jrecs and len(precs) == len(WAVE_ROOTS)
    assert check_decisions(precs) == []
    bad = dict(precs[0])
    bad["own_signed"] = bad["own_total"] * 2 // 3
    assert check_decisions([bad])


def test_status_matches_jax(waves):
    got, _ = waves
    pst, jst = got["port"][0].status(), got["jax"][0].status()
    assert pst.pop("fallbacks") == 0
    pl, jl = pst.pop("lanes_by_backend"), jst.pop("lanes_by_backend")
    assert pst == jst
    assert sum(pl.values()) == sum(jl.values())


def test_sessions_equal_sequential_light_client(waves, chains):
    """Every session ends trusted at the tip with the heights a
    sequential LightClient from its root trusts."""
    got, _ = waves
    chain = chains["port"]
    top = chain.max_height()
    for root, session in zip(WAVE_ROOTS, got["port"][1]):
        opts = plc.TrustOptions(period_seconds=TRUST_PERIOD, height=root,
                                hash=chain.blocks[root - 1].hash())
        lc = plc.LightClient(chain.chain_id, opts,
                             pcg.ChainLightProvider(chain), [],
                             PLightStore(PMemDB()), sequential=False,
                             now_fn=lambda: _now("port", chain),
                             device="cpu")
        lb = lc.verify_light_block_at_height(top)
        assert session.latest().header.hash() == lb.header.hash()
        assert _heights(session.store, top) == [
            h for h in range(1, top + 1) if lc.trusted_light_block(h)]


# --- coalescing, dedup, backpressure -------------------------------------------------

def test_cross_session_dedup_like_jax(chains):
    got = {}
    for side in SIDES:
        chain = chains[side]
        farm = _farm(side, chain)
        s1 = farm.subscribe(11, chain.blocks[10].hash(), TRUST_PERIOD)
        farm.verify(s1.session_id, chain.max_height())
        before = sum(farm.batcher.lanes_by_backend.values())
        s2 = farm.subscribe(11, chain.blocks[10].hash(), TRUST_PERIOD)
        farm.verify(s2.session_id, chain.max_height())
        got[side] = (before, sum(farm.batcher.lanes_by_backend.values()),
                     farm.batcher.batches, farm.batcher.dedup_batch_hits,
                     round(farm.cache.hit_rate("farm"), 6))
    assert got["port"] == got["jax"]
    assert got["port"][0] == got["port"][1]


def test_wave_dedup_counts_like_jax(chains):
    got = {}
    for side in SIDES:
        chain = chains[side]
        farm = _farm(side, chain)
        sessions = [farm.subscribe(11, chain.blocks[10].hash(),
                                   TRUST_PERIOD) for _ in range(3)]
        pend = [farm.begin_verify(s.session_id, 12) for s in sessions]
        width = farm.batcher.flush()
        outs = [farm.finish_verify(p)["height"] for p in pend]
        got[side] = (width, outs, farm.batcher.dedup_batch_hits,
                     farm.batcher.batches)
    assert got["port"] == got["jax"]
    assert got["port"][2] > 0


def test_lane_queue_shed_like_jax(chains):
    got = {}
    for side, s in SIDES.items():
        chain = chains[side]
        cache = s["Cache"](65536)
        farm = _farm(side, chain, cache=cache,
                     batcher_kw={"max_pending_lanes": 13})
        with pytest.raises(s["farm"].FarmOverloaded):
            farm.subscribe(1, chain.blocks[0].hash(), TRUST_PERIOD)
        got[side] = (farm.batcher.shed, len(farm.sessions))
    assert got["port"] == got["jax"] == (1, 0)


def test_shed_releases_queued_lane_budget_like_jax(chains):
    """Trusting (7 lanes) fits a 20-lane queue, own (14 more) sheds: the
    request withdraws its queued check, and the farm is not livelocked."""
    got = {}
    for side, s in SIDES.items():
        chain = chains[side]
        farm = _farm(side, chain, batcher_kw={"max_pending_lanes": 20})
        sess = farm.subscribe(1, chain.blocks[0].hash(), TRUST_PERIOD)
        with pytest.raises(s["farm"].FarmOverloaded):
            farm.begin_verify(sess.session_id, chain.max_height())
        pending = farm.batcher._pending_lanes
        s2 = farm.subscribe(2, chain.blocks[1].hash(), TRUST_PERIOD)
        got[side] = (pending, s2.latest().height, farm.batcher.shed)
    assert got["port"] == got["jax"] == (0, 2, 1)


def test_session_cap_and_unknown_session_like_jax(chains):
    got = {}
    for side, s in SIDES.items():
        chain = chains[side]
        farm = _farm(side, chain,
                     sessions=s["session"].SessionManager(max_sessions=1))
        farm.subscribe(11, chain.blocks[10].hash(), TRUST_PERIOD)
        with pytest.raises(s["farm"].FarmOverloaded):
            farm.subscribe(11, chain.blocks[10].hash(), TRUST_PERIOD)
        with pytest.raises(s["farm"].UnknownSession):
            farm.verify("s999", chain.max_height())
        got[side] = len(farm.sessions)
    assert got["port"] == got["jax"] == 1


@pytest.mark.parametrize("case", ["expired", "forward_only", "bad_root"])
def test_rejections_like_jax(chains, case):
    got = {}
    for side, s in SIDES.items():
        chain = chains[side]
        farm = _farm(side, chain)
        with pytest.raises(s["farm"].VerifyRejected) as ei:
            if case == "expired":
                sess = farm.subscribe(11, chain.blocks[10].hash(), 1)
                farm.verify(sess.session_id, chain.max_height())
            elif case == "forward_only":
                sess = farm.subscribe(11, chain.blocks[10].hash(),
                                      TRUST_PERIOD)
                farm.verify(sess.session_id, chain.max_height())
                assert farm.verify(sess.session_id,
                                   chain.max_height())["steps"] == 0
                farm.verify(sess.session_id, 3)
            else:
                farm.subscribe(1, b"\x13" * 32, TRUST_PERIOD)
        got[side] = (str(ei.value), farm.status()["requests_rejected"],
                     len(farm.sessions))
    assert got["port"] == got["jax"]


# --- forged inputs ----------------------------------------------------------------

def test_forged_signature_rejected_like_jax(chains):
    """The planner cannot see a flipped signature (tallies are by
    address); the lane verdict rejects it and the session stays put;
    disarmed, the same request is accepted."""
    got = {}
    for side, s in SIDES.items():
        chain = chains[side]
        prov = _tampering(side, chain)
        farm = _farm(side, chain, provider=prov)
        sess = farm.subscribe(11, chain.blocks[10].hash(), TRUST_PERIOD)
        prov.armed = {12: "sig"}
        with pytest.raises(s["farm"].VerifyRejected) as ei:
            farm.verify(sess.session_id, 12)
        held = sess.latest().height
        prov.armed = {}
        out = farm.verify(sess.session_id, 12)
        got[side] = (str(ei.value), held, out["height"], out["hash"])
    assert got["port"] == got["jax"]
    assert got["port"][1:3] == (11, 12)


def test_forged_header_rejected_host_side_like_jax(chains):
    got = {}
    for side, s in SIDES.items():
        chain = chains[side]
        prov = _tampering(side, chain)
        farm = _farm(side, chain, provider=prov)
        sess = farm.subscribe(1, chain.blocks[0].hash(), TRUST_PERIOD)
        before = farm.batcher.batches
        prov.armed = {12: "hash"}
        with pytest.raises(s["farm"].VerifyRejected) as ei:
            farm.verify(sess.session_id, 12)
        got[side] = (str(ei.value), farm.batcher.batches - before,
                     sess.latest().height)
    assert got["port"] == got["jax"]
    assert got["port"][1:] == (0, 1)


def test_bisection_across_valset_rotation_like_jax():
    """>2/3 of the power rotates mid-chain: both farms walk the pivot
    chain the LightClient's bisection walks and store the same
    intermediate headers."""
    got = {}
    for side, s in SIDES.items():
        rng = random.Random(99)
        new_keys = [s["Key"](bytes(rng.randrange(256) for _ in range(32)))
                    for _ in range(6)]
        _, orig = s["cg"].make_genesis(4, seed=1)
        val_txs = {}
        for i, k in enumerate(new_keys):
            val_txs[5 + i] = (b"val:" + k.pub_key().bytes_().hex().encode()
                              + b"!40")
        for i, k in enumerate(orig.values()):
            val_txs[11 + i] = (b"val:" + k.pub_key().bytes_().hex().encode()
                               + b"!0")
        kw = {"device": "cpu"} if side == "port" else {}
        rot = s["cg"].generate_chain(20, n_validators=4,
                                     val_tx_heights=val_txs,
                                     extra_keys=new_keys, txs_per_block=1,
                                     **kw)
        farm = _farm(side, rot)
        sess = farm.subscribe(1, rot.blocks[0].hash(), TRUST_PERIOD)
        out = farm.verify(sess.session_id, rot.max_height())
        got[side] = (out, _heights(sess.store, rot.max_height()),
                     farm.drain_decisions())
    assert got["port"] == got["jax"]
    assert got["port"][0]["steps"] > 1
    assert check_decisions(got["port"][2]) == []


# --- backends ---------------------------------------------------------------------

def test_backend_failure_fails_tickets(chains):
    """A backend answering the wrong lane count fails every waiting
    ticket and surfaces, on both sides."""
    got = {}
    for side, s in SIDES.items():
        chain = chains[side]
        cache = s["Cache"](65536)
        batcher = s["fb"].FarmBatcher(
            cache=cache, coalesce_window_s=0.0,
            verify_backend=lambda lanes: ([True], "device"),
            **({"device": "cpu"} if side == "port" else {}))
        farm = _farm(side, chain, cache=cache, batcher=batcher)
        pend = farm.begin_subscribe(11, chain.blocks[10].hash(),
                                    TRUST_PERIOD)
        with pytest.raises(RuntimeError, match="answered 1 lanes"):
            batcher.flush()
        got[side] = (pend.tickets[0].done(),
                     type(pend.tickets[0].error).__name__)
    assert got["port"] == got["jax"] == (True, "RuntimeError")


def _subscribe_wave(farm, chain):
    pend = [farm.begin_subscribe(h, chain.blocks[h - 1].hash(),
                                 TRUST_PERIOD) for h in WAVE_ROOTS]
    return [t for p in pend for t in p.tickets]


def test_kernel_error_fails_tickets_not_host(chains, monkeypatch):
    """A wide batch on the in-process route whose kernel raises (the
    plain window sums here): the error propagates out of flush() and
    fails the tickets; nothing is verified on the host."""
    def boom(*_a):
        raise RuntimeError("rlc_window_sums launch failed: cudaError 1")
    monkeypatch.setattr(cv, "rlc_window_sums_plain", boom)
    chain = chains["port"]
    farm = _farm("port", chain)
    tickets = _subscribe_wave(farm, chain)
    with pytest.raises(RuntimeError, match="launch failed"):
        farm.batcher.flush()
    assert all(t.done() and "launch failed" in str(t.error)
               for t in tickets)
    assert farm.batcher.lanes_by_backend == {}
    assert farm.batcher.fallbacks == 0


def test_canary_trip_fails_tickets_not_host(chains, monkeypatch):
    """The plain epilogue accepting everything: the RLC canary's
    known-invalid batch passes, KernelCanaryError propagates out of
    flush() and fails the tickets."""
    monkeypatch.setitem(ped._canary, "dispatches", 0)
    monkeypatch.setattr(cv, "rlc_epilogue_plain",
                        lambda *a: torch.tensor(True))
    chain = chains["port"]
    farm = _farm("port", chain)
    tickets = _subscribe_wave(farm, chain)
    with pytest.raises(ped.KernelCanaryError):
        farm.batcher.flush()
    assert all(isinstance(t.error, ped.KernelCanaryError) for t in tickets)
    assert farm.batcher.lanes_by_backend == {}


class _FakeClient:
    """A device-server client whose answer is scripted: an exception to
    raise from result(), or a function of the submitted lanes."""

    def __init__(self, answer):
        self.answer = answer
        self.submitted = []

    def submit(self, pubs, msgs, sigs, ctx=None):
        self.submitted.append(len(pubs))
        client = self

        class _Future:
            def result(self, timeout=None):
                if isinstance(client.answer, BaseException):
                    raise client.answer
                return client.answer(pubs, msgs, sigs)
        return _Future()


def _honest(pubs, msgs, sigs):
    """A server that answers with the host's verdicts."""
    oks = [PPub(p).verify_signature(m, s)
           for p, m, s in zip(pubs, msgs, sigs)]
    return all(oks), oks


@pytest.fixture
def device_server(monkeypatch):
    """Route the port's farm backend through a scripted device-server
    client, with a fresh shared supervisor and tracing on."""
    phealth.reset_shared_supervisor()
    holder = {}
    monkeypatch.setattr(pclient, "shared_client", lambda: holder["client"])
    _, recorder = ptrace.enable(seed=1)
    yield holder, recorder
    ptrace.disable()
    phealth.reset_shared_supervisor()


def _one_root_flush(chain, holder, answer):
    holder["client"] = _FakeClient(answer)
    farm = _farm("port", chain)
    pend = farm.begin_subscribe(11, chain.blocks[10].hash(), TRUST_PERIOD)
    return farm, pend


@pytest.mark.parametrize("fault", ["timeout", "connection", "oserror",
                                   "canary"])
def test_device_server_drain_counted_and_traced(chains, device_server,
                                                fault):
    """The device-server route drains to the host on a transport error
    or a wrong canary answer: the verdicts are the host's, `fallbacks`
    counts it, a `farm.cpu_drain` span records it."""
    holder, recorder = device_server
    answer = {"timeout": TimeoutError("no answer"),
              "connection": ConnectionError("link down"),
              "oserror": OSError("reset"),
              "canary": lambda p, m, s: (True, [True] * len(p))}[fault]
    chain = chains["port"]
    farm, pend = _one_root_flush(chain, holder, answer)
    farm.batcher.flush()
    session = farm.finish_subscribe(pend)
    assert session.latest().height == 11
    assert holder["client"].submitted == [14 + 2]     # + 2 canary lanes
    assert farm.batcher.fallbacks == 1
    assert farm.batcher.lanes_by_backend == {"cpu": 14}
    drains = [sp for sp in recorder.snapshot()
              if sp["name"] == "farm.cpu_drain"]
    assert len(drains) == 1 and drains[0]["attrs"]["lanes"] == 14


def test_device_server_honest_answer(chains, device_server):
    holder, _ = device_server
    chain = chains["port"]
    farm, pend = _one_root_flush(chain, holder, _honest)
    farm.batcher.flush()
    farm.finish_subscribe(pend)
    assert farm.batcher.lanes_by_backend == {"device": 14}
    assert farm.batcher.fallbacks == 0


@pytest.mark.parametrize("exc", [pclient.DeviceUnprocessable,
                                 pclient.DeviceFlushFailed])
def test_device_server_refusals_raise(chains, device_server, exc):
    """UNPROCESSABLE and FLUSH_FAILED answers raise out of the flush (the
    JAX package verifies natively): they are not transport faults."""
    holder, _ = device_server
    chain = chains["port"]
    farm, pend = _one_root_flush(chain, holder, exc("refused"))
    with pytest.raises(exc):
        farm.batcher.flush()
    assert pend.tickets[0].error is not None
    assert farm.batcher.fallbacks == 0


def test_mesh_switch(monkeypatch):
    assert pfb._mesh_verify([]) is None
    monkeypatch.setenv("COMETBFT_TPU_MESH_VERIFY", "1")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        pfb._mesh_verify([])


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda resolves")
    with pytest.raises(RuntimeError, match="cuda"):
        pfb.FarmBatcher()
    with pytest.raises(RuntimeError, match="cuda"):
        pfarm.VerificationFarm("c", None)


def test_farm_metrics(chains):
    chain = chains["port"]
    reg = Registry()
    metrics = FarmMetrics(reg)
    cache = PCache(65536)
    farm = pfarm.VerificationFarm(
        chain.chain_id, pcg.ChainLightProvider(chain), cache=cache,
        sessions=psession.SessionManager(max_sessions=2, metrics=metrics),
        batcher=pfb.FarmBatcher(cache=cache, coalesce_window_s=0.0,
                                metrics=metrics, device="cpu"),
        metrics=metrics, now_fn=lambda: _now("port", chain), device="cpu")
    s = farm.subscribe(10, chain.blocks[9].hash(), TRUST_PERIOD)
    farm.verify(s.session_id, chain.max_height())
    farm.subscribe(11, chain.blocks[10].hash(), TRUST_PERIOD)
    with pytest.raises(pfarm.FarmOverloaded):
        farm.subscribe(11, chain.blocks[10].hash(), TRUST_PERIOD)
    text = reg.expose()
    assert "cometbft_tpu_farm_sessions 2.0" in text
    assert "cometbft_tpu_farm_headers_accepted 1.0" in text
    assert 'cometbft_tpu_farm_lanes_verified{backend="cpu"}' in text
    assert 'cometbft_tpu_farm_dedup_hits{kind="batch"}' in text
    assert "cometbft_tpu_farm_shed_total 1.0" in text


# --- the adaptive coalescing window (tests/test_farm.py:540-601) --------------------

@pytest.mark.parametrize("side", ["jax", "port"])
def test_coalesce_wait_plateau_flushes_at_half_window(side):
    coalesce_wait = SIDES[side]["fb"].coalesce_wait
    polls = SIDES[side]["fb"].ADAPTIVE_POLLS
    window = 0.4
    ev = threading.Event()
    t0 = time.perf_counter()
    assert coalesce_wait(ev, window, lambda: 3, adaptive=True) is False
    plateau_dt = time.perf_counter() - t0
    assert window / polls * 0.5 <= plateau_dt < window * 0.9
    widths = iter(range(100))
    t0 = time.perf_counter()
    assert coalesce_wait(ev, window, lambda: next(widths),
                         adaptive=True) is False
    growing_dt = time.perf_counter() - t0
    assert growing_dt >= window * 0.95
    assert plateau_dt < growing_dt / 1.5
    t0 = time.perf_counter()
    assert coalesce_wait(ev, window, lambda: 3, adaptive=False) is False
    assert time.perf_counter() - t0 >= window * 0.95
    ev.set()
    assert coalesce_wait(ev, window, lambda: 3, adaptive=True) is True
    assert coalesce_wait(ev, 0.0, lambda: 3, adaptive=True) is True


def test_farm_wait_adaptive_early_flush(chains):
    chain = chains["port"]
    window = 0.4
    cache = PCache(65536)
    b = pfb.FarmBatcher(cache=cache, coalesce_window_s=window,
                        adaptive=True, device="cpu")
    commit = chain.seen_commits[-1]
    check = pplanner.plan_commit_light(
        chain.chain_id, chain.valsets[-1], commit.block_id,
        chain.max_height(), commit, cache)
    ticket = b.submit(check)
    t0 = time.perf_counter()
    b.wait([ticket])
    dt = time.perf_counter() - t0
    assert ticket.ok()
    assert dt < window * 0.9


def test_queue_full_direct(chains):
    chain = chains["port"]
    cache = PCache(65536)
    b = pfb.FarmBatcher(cache=cache, max_pending_lanes=2,
                        coalesce_window_s=0.0, device="cpu")
    commit = chain.seen_commits[-1]
    check = pplanner.plan_commit_light(
        chain.chain_id, chain.valsets[-1], commit.block_id,
        chain.max_height(), commit, cache)
    assert len(check.lanes) == 14
    with pytest.raises(pfb.QueueFull):
        b.submit(check)
