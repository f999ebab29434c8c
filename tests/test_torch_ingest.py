"""The port's batched tx admission (cometbft_tpu_torch/ingest/) and its
mempool (cometbft_tpu_torch/mempool/) held against the JAX package's, on
the CPU, on the same seeded tx mixes.

The mixes are built as tests/test_ingest.py:_mix builds them, from the
same four seeded ed25519 keys: clean signed, tampered signature, bare
valid and bare invalid txs in turn, then a duplicate of every clean tx.
The wide mix has 256 txs, so one flush of all of them holds 128 signature
lanes (the 64 clean and the 64 tampered envelopes): at least the farm
backend's FARM_KERNEL_MIN_LANES, so the port's pipeline on `device="cpu"`
sends them through `ops.ed25519.verify_batch` at batch 128, where the RLC
kernels' plain versions run, and the tampered lanes are attributed per
lane ("kernel"). The JAX package's pipeline runs `native_backend`. The
reference's 12-tx mix is narrow: the port verifies it per signature
("cpu").

Every result is a code, an exception class, bytes or a count, so the
tolerance is none. Held: the ticket codes (and the exceptions submit
raises), the app's CheckTx call sequence, the mempool's contents and FIFO
order, at flush depth 1, 5 and all; the sequential mode; recheck eviction
releasing the front filter; the two dedup layers; the shed and its
retry; the SigCache across submissions; coalescing waits, the background
flusher and concurrent submitters; the metrics; `make_signed_tx`
envelopes byte for byte; the mempool alone (reap budgets, update,
recheck, the LRU cache, the nop mempool). The port's rules: a kernel
error or a canary trip on the in-process route propagates out of
`flush()` and fails the tickets; a device-server drain is counted in
`fallbacks`.
"""

import random
import threading
import time

import pytest
import torch

from cometbft_tpu.crypto.keys import Ed25519PrivKey as JKey
from cometbft_tpu import ingest as jing
from cometbft_tpu.ingest.tx import MAGIC
from cometbft_tpu.mempool import mempool as jmp
from cometbft_tpu.pipeline.cache import SigCache as JCache

from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey as PKey
from cometbft_tpu_torch.device import client as pclient
from cometbft_tpu_torch.device import health as phealth
from cometbft_tpu_torch import ingest as ping
from cometbft_tpu_torch.libs.metrics import Registry
from cometbft_tpu_torch.libs.metrics_gen import IngestMetrics, MempoolMetrics
from cometbft_tpu_torch import mempool as pmp
from cometbft_tpu_torch.ops import cuda_verify as cv
from cometbft_tpu_torch.ops import ed25519 as ped
from cometbft_tpu_torch.pipeline.cache import SigCache as PCache

SIDES = {
    "jax": dict(ing=jing, mp=jmp, Cache=JCache, Key=JKey),
    "port": dict(ing=ping, mp=pmp, Cache=PCache, Key=PKey),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys(side):
    return [SIDES[side]["Key"].generate(random.Random(1000 + i))
            for i in range(4)]


def _app():
    """Recording app-CheckTx stub: code 0 for payloads containing '=',
    1 otherwise, 2 for payloads whose key is in `banned`."""
    calls = []
    banned = set()

    def check_fn(tx):
        calls.append(tx)
        payload = ping.unwrap_payload(tx)
        if b"=" not in payload:
            return 1, 0
        if payload.split(b"=", 1)[0] in banned:
            return 2, 0
        return 0, 1
    return check_fn, calls, banned


def _mk(side, batch=True, cache=None, backend="native", **kw):
    """A pipeline on a side: the JAX package's with `native_backend`;
    the port's with its default backend on the CPU (backend="default")
    or `native_backend`."""
    s = SIDES[side]
    check_fn, calls, banned = _app()
    mp = s["mp"].CListMempool(check_fn)
    if side == "port":
        kw["device"] = "cpu"
    if side == "jax" or backend == "native":
        kw["verify_backend"] = s["ing"].native_backend
    pipe = s["ing"].IngestPipeline(
        mp, cache=cache if cache is not None else s["Cache"](4096),
        batch=batch, coalesce_window_s=0.0, **kw)
    return pipe, mp, calls, banned


def _mix(side, n=12, seed=7):
    """tests/test_ingest.py:_mix on a side's keys."""
    ing = SIDES[side]["ing"]
    keys = _keys(side)
    rng = random.Random(seed)
    out = []
    for i in range(n):
        k = keys[i % len(keys)]
        kind = ("good", "badsig", "bare", "bareinvalid")[i % 4]
        if kind == "good":
            out.append(("good", ing.make_signed_tx(k, f"k{i}=v".encode())))
        elif kind == "badsig":
            tx = bytearray(ing.make_signed_tx(k, f"b{i}=v".encode()))
            tx[len(MAGIC) + 32] ^= 0x01  # first signature byte
            out.append(("badsig", bytes(tx)))
        elif kind == "bare":
            out.append(("bare", f"bare{i}=v".encode()))
        else:
            out.append(("bareinvalid", f"noeq{i}".encode()))
    dups = [("dup", tx) for kind, tx in out if kind == "good"]
    rng.shuffle(dups)
    return out + dups


@pytest.fixture(scope="module")
def mixes():
    return {side: {n: _mix(side, n) for n in (12, 256)} for side in SIDES}


def _drive(pipe, txs, depth):
    """Submit the mix, flushing every `depth` queued txs (the pipeline
    applies inline in sequential mode). Per-tx outcomes:
    ('code', n) | ('error', type) | ('raised', type)."""
    outcomes, pending, order = [], [], []
    for _kind, tx in txs:
        try:
            ticket = pipe.submit(tx)
        except ValueError as e:          # duplicate, malformed, shed
            outcomes.append(("raised", type(e).__name__))
            order.append(None)
            continue
        order.append(ticket)
        outcomes.append(None)
        if pipe.batch:
            pending.append(ticket)
            if len(pending) >= depth:
                pipe.flush()
                pending.clear()
    if pipe.batch:
        pipe.flush()
    for i, ticket in enumerate(order):
        if ticket is not None:
            assert ticket.done()
            outcomes[i] = (("error", type(ticket.error).__name__)
                           if ticket.error is not None
                           else ("code", ticket.code))
    return outcomes


def _keys_of(side, mp):
    return [SIDES[side]["mp"].tx_key(t) for t in mp.reap_max_txs(-1)]


# --- envelopes --------------------------------------------------------------------

def test_envelopes_match_jax(mixes):
    for n in (12, 256):
        assert [tx for _k, tx in mixes["port"][n]] == \
            [tx for _k, tx in mixes["jax"][n]]
    tx = mixes["port"][12][0][1]
    parsed = ping.parse_signed_tx(tx)
    assert parsed.pub == _keys("port")[0].pub_key().bytes_()
    assert ping.sign_bytes(parsed.payload) == jing.sign_bytes(parsed.payload)


# --- the wide mix: one flush on the kernel route ------------------------------------

@pytest.fixture(scope="module")
def wide(mixes):
    """The 256-tx mix through both pipelines, every tx submitted and one
    flush: side -> (outcomes, app calls, mempool keys, stats), and the
    port's verify_batch calls."""
    out = {}
    real = ped.verify_batch
    calls = []

    def spy(pubs, msgs, sigs, batch_size=None, **kw):
        calls.append((len(pubs), batch_size, str(kw.get("device"))))
        return real(pubs, msgs, sigs, batch_size=batch_size, **kw)
    ped.verify_batch = spy
    try:
        for side in SIDES:
            pipe, mp, app_calls, _ = _mk(side, backend="default")
            outcomes = _drive(pipe, mixes[side][256], depth=10 ** 6)
            out[side] = (outcomes, app_calls, _keys_of(side, mp),
                         pipe.stats())
    finally:
        ped.verify_batch = real
    return out, calls


def test_wide_flush_takes_the_kernel_route(wide):
    got, calls = wide
    assert calls == [(128, 128, "cpu")]
    assert got["port"][3]["lanes_by_backend"] == {"kernel": 128}
    assert got["jax"][3]["lanes_by_backend"] == {"cpu": 128}
    assert got["port"][3]["fallbacks"] == 0


def test_wide_mix_matches_jax(wide):
    got, _ = wide
    assert got["port"][0] == got["jax"][0]
    assert got["port"][1] == got["jax"][1]     # same app calls, same order
    assert got["port"][2] == got["jax"][2]     # same FIFO
    out = got["port"][0]
    assert out.count(("code", 0)) == 64 + 64   # clean signed and bare
    assert out.count(("code", ping.CODE_BAD_SIGNATURE)) == 64
    assert out.count(("code", 1)) == 64
    assert out.count(("raised", "ValueError")) == 64


def test_wide_stats_match_jax(wide):
    got, _ = wide
    ps, js = dict(got["port"][3]), dict(got["jax"][3])
    for st in (ps, js):
        for k in ("lanes_by_backend", "latency_p50_s", "latency_p90_s",
                  "fallbacks"):
            st.pop(k, None)
    assert ps == js
    assert ps["batches"] == 1 and ps["max_batch_width"] == 128


# --- the reference's narrow mix -------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 5, 100])
@pytest.mark.parametrize("backend", ["default", "native"])
def test_narrow_mix_matches_jax(mixes, depth, backend):
    """The 12-tx mix (and its duplicates) at each flush depth: the
    port's default backend takes the host route ("cpu"), as
    native_backend does."""
    got = {}
    for side in SIDES:
        pipe, mp, calls, _ = _mk(side, backend=backend)
        got[side] = (_drive(pipe, mixes[side][12], depth), calls,
                     _keys_of(side, mp),
                     dict(pipe.batcher.lanes_by_backend))
    assert got["port"] == got["jax"]
    assert set(got["port"][3]) == {"cpu"}
    classes = {o[0] for o in got["port"][0]}
    assert {"code", "raised"} <= classes


def test_sequential_mode_matches_jax(mixes):
    got = {}
    for side in SIDES:
        pipe, mp, calls, _ = _mk(side, batch=False)
        got[side] = (_drive(pipe, mixes[side][12], 0), calls,
                     _keys_of(side, mp))
    assert got["port"] == got["jax"]
    bpipe, bmp, bcalls, _ = _mk("port", backend="default")
    assert _drive(bpipe, mixes["port"][12], 5) == got["port"][0]
    assert bcalls == got["port"][1]


# --- the reference's admission cases ------------------------------------------------

@pytest.mark.parametrize("mode", ["batch", "seq"])
def test_recheck_evicted_matches_jax(mode):
    """Post-commit recheck evicts a now-invalid tx from the mempool AND
    the front filter; its resubmission re-admits through the SigCache
    with no new lane; committed txs stay replay-blocked."""
    got = {}
    for side in SIDES:
        ing = SIDES[side]["ing"]
        keys = _keys(side)
        pipe, mp, calls, banned = _mk(side, batch=(mode == "batch"),
                                      backend="default")
        txs = [ing.make_signed_tx(keys[i % 4], f"r{i}=v".encode())
               for i in range(6)]
        tickets = [pipe.submit(tx) for tx in txs]
        pipe.flush()
        codes = [t.code for t in tickets]
        banned.update({b"r2", b"r3"})
        mp.update(1, txs[:2])
        size = mp.size()
        banned.clear()
        batches = pipe.batcher.batches
        re_tickets = [pipe.submit(txs[2]), pipe.submit(txs[3])]
        pipe.flush()
        with pytest.raises(ValueError):
            pipe.submit(txs[0])
        got[side] = (codes, size, [t.code for t in re_tickets],
                     pipe.batcher.batches - batches, _keys_of(side, mp),
                     calls)
    assert got["port"] == got["jax"]
    assert got["port"][1] == 2 and got["port"][3] == 0


def test_shed_and_filter_release_matches_jax():
    got = {}
    for side, s in SIDES.items():
        pipe, mp, _, _ = _mk(side, max_pending=2)
        t1, t2 = pipe.submit(b"a=1"), pipe.submit(b"b=2")
        with pytest.raises(s["ing"].IngestShed):
            pipe.submit(b"c=3")
        pipe.flush()
        t3 = pipe.submit(b"c=3")
        pipe.flush()
        got[side] = (pipe.shed, t1.code, t2.code, t3.code, mp.size())
    assert got["port"] == got["jax"] == (1, 0, 0, 0, 3)


def test_duplicate_filter_layers_match_jax():
    got = {}
    for side in SIDES:
        pipe, mp, calls, _ = _mk(side, filter_size=1)
        t1 = pipe.submit(b"a=1")
        pipe.flush()
        with pytest.raises(ValueError):
            pipe.submit(b"a=1")            # the front filter
        pipe.submit(b"b=2")                # evicts a=1 from the filter
        t3 = pipe.submit(b"a=1")           # ... the mempool cache holds it
        pipe.flush()
        got[side] = (t1.code, str(t3.error), mp.size(), len(calls),
                     pipe.dup_hits)
    assert got["port"] == got["jax"]
    assert "cache" in got["port"][1]


def test_malformed_envelope_rejected_before_app():
    got = {}
    for side, s in SIDES.items():
        pipe, _, calls, _ = _mk(side)
        for _ in range(2):                 # released: not a duplicate
            with pytest.raises(s["ing"].MalformedTx):
                pipe.submit(MAGIC + b"\x00" * 10)
        pipe.flush()
        got[side] = calls
    assert got["port"] == got["jax"] == []


def test_bad_signature_never_reaches_app():
    got = {}
    for side, s in SIDES.items():
        pipe, mp, calls, _ = _mk(side, backend="default")
        tx = bytearray(s["ing"].make_signed_tx(_keys(side)[0], b"x=1"))
        tx[len(MAGIC) + 32] ^= 1
        codes = []
        for _ in range(2):                 # never cached: fails again
            t = pipe.submit(bytes(tx))
            pipe.flush()
            codes.append(t.code)
        got[side] = (codes, calls, mp.size())
    assert got["port"] == got["jax"]
    assert got["port"][0] == [ping.CODE_BAD_SIGNATURE] * 2


def test_sigcache_dedup_across_submissions():
    got = {}
    for side, s in SIDES.items():
        cache = s["Cache"](4096)
        pipe, mp, _, _ = _mk(side, cache=cache, backend="default")
        tx = s["ing"].make_signed_tx(_keys(side)[0], b"c=1")
        pipe.submit(tx)
        first = pipe.flush()
        mp.flush()                         # also resets the front filter
        pipe.submit(tx)
        got[side] = (first, pipe.flush(), cache.hits.get("ingest", 0))
    assert got["port"] == got["jax"] == (1, 0, 1)


def test_wait_coalesces_and_flushes():
    pipe, _, _, _ = _mk("port", backend="default")
    pipe.coalesce_window_s = 0.01
    t1 = pipe.submit(ping.make_signed_tx(_keys("port")[0], b"w1=1"))
    t2 = pipe.submit(b"w2=2")
    pipe.wait([t1])
    assert t1.code == 0 and t2.code == 0


def test_background_flusher_settles_nowait_intake():
    pipe, mp, _, _ = _mk("port", backend="default")
    pipe.coalesce_window_s = 0.002
    pipe.start()
    try:
        ticket = pipe.submit_nowait(ping.make_signed_tx(_keys("port")[1],
                                                        b"bg=1"))
        assert ticket is not None
        deadline = time.monotonic() + 5.0
        while not ticket.done() and time.monotonic() < deadline:
            time.sleep(0.002)
        assert ticket.done() and ticket.code == 0 and mp.size() == 1
        assert pipe.submit_nowait(MAGIC + b"\x00") is None
    finally:
        pipe.stop()


def test_concurrent_submitters_coalesce():
    pipe, mp, _, _ = _mk("port", backend="default")
    pipe.coalesce_window_s = 0.005
    keys = _keys("port")
    txs = [ping.make_signed_tx(keys[i % 4], f"t{i}=v".encode())
           for i in range(16)]
    errs = []

    def client(i):
        try:
            t = pipe.submit(txs[i])
            pipe.wait([t])
            assert t.code == 0
        except Exception as e:  # noqa: BLE001 — collected for the assert
            errs.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(16)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(30.0)
    assert not errs and mp.size() == 16
    assert pipe.batcher.batches < 16


def test_metrics_surface():
    reg = Registry()
    m = IngestMetrics(reg)
    check_fn, _, _ = _app()
    mp = pmp.CListMempool(check_fn)
    pipe = ping.IngestPipeline(mp, cache=PCache(64), batch=True,
                               coalesce_window_s=0.0, max_pending=2,
                               metrics=m, device="cpu")
    pipe.submit(ping.make_signed_tx(_keys("port")[0], b"m=1"))
    pipe.submit(b"noequals")
    with pytest.raises(ping.IngestShed):
        pipe.submit(b"m2=2")
    pipe.flush()
    with pytest.raises(ValueError):
        pipe.submit(ping.make_signed_tx(_keys("port")[0], b"m=1"))
    assert m.admitted.value() == 1
    assert m.rejected.value(reason="app") == 1
    assert m.shed.value() == 1
    assert m.dedup_hits.value(kind="txhash") == 1
    assert m.lanes.value(backend="cpu") == 1
    assert m.queue_depth.value() == 0
    assert "ingest_admission_latency_seconds" in reg.expose()


def test_query_cached_matches_jax():
    got = {}
    for side, s in SIDES.items():
        pipe, _, _, _ = _mk(side, backend="default")
        tx = s["ing"].make_signed_tx(_keys(side)[1], b"q=1")
        r = [pipe.query_cached(tx), pipe.query_cached(tx)]
        pipe.submit(tx)
        pipe.flush()
        r.append(pipe.query_cached(tx))
        bad = bytearray(tx)
        bad[len(MAGIC) + 32] ^= 1
        r += [pipe.query_cached(bytes(bad)), pipe.query_cached(b"bare=1"),
              pipe.query_cached(MAGIC + b"\x00")]
        got[side] = r
    assert got["port"] == got["jax"]


# --- the port's device rules ------------------------------------------------------------

def _wide_pipe(mixes):
    pipe, mp, calls, _ = _mk("port", backend="default")
    tickets = [pipe.submit(tx) for kind, tx in mixes["port"][256]
               if kind in ("good", "badsig")]
    return pipe, mp, calls, tickets


def test_kernel_error_fails_tickets_not_host(mixes, monkeypatch):
    def boom(*_a):
        raise RuntimeError("pt_decompress_tiled launch failed: cudaError 1")
    monkeypatch.setattr(cv, "pt_decompress_plain", boom)
    pipe, mp, calls, tickets = _wide_pipe(mixes)
    with pytest.raises(RuntimeError, match="launch failed"):
        pipe.flush()
    assert all(t.done() and "launch failed" in str(t.error)
               for t in tickets)
    assert calls == [] and mp.size() == 0
    assert pipe.batcher.fallbacks == 0


def test_canary_trip_fails_tickets_not_host(mixes, monkeypatch):
    monkeypatch.setitem(ped._canary, "dispatches", 0)
    monkeypatch.setattr(cv, "rlc_epilogue_plain",
                        lambda *a: torch.tensor(True))
    pipe, mp, calls, tickets = _wide_pipe(mixes)
    with pytest.raises(ped.KernelCanaryError):
        pipe.flush()
    assert all(isinstance(t.error, ped.KernelCanaryError) for t in tickets)
    assert calls == [] and mp.size() == 0


def test_device_server_drain_counted(monkeypatch):
    """A dead device-server link: the batch is re-verified on the host
    and counted in `fallbacks`; the verdicts are the host's."""
    class Dead:
        def submit(self, *a, **kw):
            class F:
                def result(self, timeout=None):
                    raise ConnectionError("link down")
            return F()
    phealth.reset_shared_supervisor()
    monkeypatch.setattr(pclient, "shared_client", lambda: Dead())
    try:
        pipe, mp, _, _ = _mk("port", backend="default")
        good = ping.make_signed_tx(_keys("port")[0], b"d=1")
        bad = bytearray(ping.make_signed_tx(_keys("port")[1], b"e=1"))
        bad[len(MAGIC) + 32] ^= 1
        t1, t2 = pipe.submit(good), pipe.submit(bytes(bad))
        pipe.flush()
        assert (t1.code, t2.code) == (0, ping.CODE_BAD_SIGNATURE)
        assert pipe.stats()["fallbacks"] == 1
        assert pipe.batcher.lanes_by_backend == {"cpu": 2}
    finally:
        phealth.reset_shared_supervisor()


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda resolves")
    mp = pmp.CListMempool(lambda tx: (0, 0))
    with pytest.raises(RuntimeError, match="cuda"):
        ping.IngestPipeline(mp)
    with pytest.raises(RuntimeError, match="cuda"):
        ping.IngestBatcher(PCache(4))


# --- the mempool alone ------------------------------------------------------------------

def _mempool_run(side, **kw):
    s = SIDES[side]
    check_fn, calls, banned = _app()
    mp = s["mp"].CListMempool(check_fn, **kw)
    evicted = []
    mp.on_tx_evicted(evicted.append)
    out = []
    for tx in [f"k{i}=v{'x' * i}".encode() for i in range(8)] + [
            b"noeq", b"k1=vx", b"y" * 300]:
        try:
            out.append(mp.check_tx(tx))
        except ValueError as e:    # too large, full, or a duplicate
            out.append(str(e))
    out += [mp.reap_max_bytes_max_gas(20, -1),
            mp.reap_max_bytes_max_gas(-1, 3), mp.reap_max_txs(2),
            mp.txs_after(5), mp.size(), mp.size_bytes()]
    banned.add(b"k3")
    mp.update(1, [b"k0=v", b"k1=vx"])
    out += [mp.reap_max_txs(-1), mp.size(), mp.size_bytes(),
            mp.contains(s["mp"].tx_key(b"k2=vxx")), evicted, calls]
    mp.flush()
    out += [mp.is_empty(), evicted[-1], len(mp.cache)]
    return out


@pytest.mark.parametrize("kw", [{}, {"size": 5}, {"keep_invalid_in_cache":
                                                  True},
                                {"recheck": False}, {"max_tx_bytes": 200}])
def test_mempool_matches_jax(kw):
    assert _mempool_run("port", **kw) == _mempool_run("jax", **kw)


def test_tx_cache_and_nop_mempool_match_jax():
    got = {}
    for side, s in SIDES.items():
        c = s["mp"].TxCache(2)
        r = [c.push(b"a"), c.push(b"b"), c.push(b"a"), c.push(b"c"),
             b"b" in c, b"a" in c, len(c)]
        c.remove(b"a")
        c.reset()
        r.append(len(c))
        nop = s["mp"].NopMempool()
        with pytest.raises(ValueError):
            nop.check_tx(b"x")
        r += [nop.reap_max_txs(-1), nop.reap_max_bytes_max_gas(1, 1),
              nop.size(), nop.size_bytes(), s["mp"].tx_key(b"x"),
              s["mp"].CODE_TYPE_OK]
        got[side] = r
    assert got["port"] == got["jax"]


def test_mempool_metrics():
    reg = Registry()
    m = MempoolMetrics(reg)
    check_fn, _, banned = _app()
    mp = pmp.CListMempool(check_fn)
    mp.metrics = m
    mp.check_tx(b"a=1")
    mp.check_tx(b"b=2")
    mp.check_tx(b"bad")
    banned.add(b"b")
    mp.update(1, [b"a=1"])
    assert (m.size.value(), m.failed_txs.value(), m.evicted_txs.value(),
            m.recheck_times.value(), m.size_bytes.value()) == \
        (0, 1, 1, 1, 0)
