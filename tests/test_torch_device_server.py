"""The port's verify device server (cometbft_tpu_torch/device/{protocol,
client,server}.py) held against the JAX package's, on the CPU: the server
runs with `device="cpu"` and a 64-lane bucket, so every flush is the torch
RLC path's plain version.

- The wire: the port's `encode_*`/`decode_*` give the JAX package's bytes
  on the same inputs, trace and shard trailers included.
- The JAX package's `DeviceClient` (host-only code) talks to the port's
  `DeviceServer` and gets the oracle's verdicts; so does the port's client.
- Two concurrent clients coalesce into one flush, each answered with its
  own verdicts.
- An oversized message answers UNPROCESSABLE and `RemoteBatchVerifier`
  verifies locally; a dead server means a local verify with the
  supervisor tripped.
- A flush that raises is counted in `stats["flush_failures"]` and
  answered FLUSH_FAILED, a status of its own: the port's client and its
  `RemoteBatchVerifier` raise `DeviceFlushFailed` (the JAX package's
  client reads a zero-lane answer, UNPROCESSABLE, and verifies locally).
- `create_batch_verifier` honours COMETBFT_TPU_DEVICE_SERVER.
- A pipelined sync through `DeviceClientBackend` (canaries on) reaches the
  JAX package's state with nothing drained; a failed flush, or a tile the
  server refuses as UNPROCESSABLE, raises out of `sync` with nothing
  drained.
Every server and socket is closed by its fixture's finalizer.
"""

import dataclasses
import random
import threading

import pytest
import torch

from cometbft_tpu.device import client as jclient
from cometbft_tpu.device import health as jhealth
from cometbft_tpu.device import protocol as jproto
from cometbft_tpu.abci.kvstore import KVStoreApplication as JApp
from cometbft_tpu.db.kv import MemDB as JMemDB
from cometbft_tpu.engine import blocksync as jbs
from cometbft_tpu.engine import chain_gen as jcg
from cometbft_tpu.state.execution import BlockExecutor as JExec
from cometbft_tpu.state.state import State as JState
from cometbft_tpu.store.blockstore import BlockStore as JStore

from cometbft_tpu_torch.abci.kvstore import KVStoreApplication as PApp
from cometbft_tpu_torch.crypto import batch as pbatch
from cometbft_tpu_torch.crypto import ref_ed25519 as ref
from cometbft_tpu_torch.crypto.keys import Ed25519PubKey
from cometbft_tpu_torch.db.kv import MemDB as PMemDB
from cometbft_tpu_torch.device import client as pclient
from cometbft_tpu_torch.device import health as phealth
from cometbft_tpu_torch.device import protocol as pproto
from cometbft_tpu_torch.device import server as pserver
from cometbft_tpu_torch.engine import blocksync as pbs
from cometbft_tpu_torch.engine import chain_gen as pcg
from cometbft_tpu_torch.pipeline import scheduler as psched
from cometbft_tpu_torch.pipeline import watchdog as pwd
from cometbft_tpu_torch.state.execution import BlockExecutor as PExec
from cometbft_tpu_torch.state.state import State as PState
from cometbft_tpu_torch.store.blockstore import BlockStore as PStore

BUCKET = 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Eager torch at 64 lanes is launch-bound on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_shared_state(monkeypatch):
    """shared_client()/RemoteBatchVerifier consult process-wide state:
    start and end each test without a shared client or supervisor."""
    for mod in (jhealth, phealth):
        mod.reset_shared_supervisor()
    for mod in (jclient, pclient):
        monkeypatch.setattr(mod, "_shared", None)
    yield
    for mod in (jclient, pclient):
        if mod._shared is not None:
            mod._shared.close()
    for mod in (jhealth, phealth):
        mod.reset_shared_supervisor()


@pytest.fixture(scope="module")
def server():
    # a wide coalescing window: requests sent together share one flush
    srv = pserver.DeviceServer(bucket=BUCKET, flush_us=300_000,
                               device="cpu")
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture
def clients(server):
    """Connect clients of either package to the server; each is closed
    when the test ends."""
    made = []

    def connect(mod=pclient):
        c = mod.DeviceClient(*server.addr)
        made.append(c)
        return c
    yield connect
    for c in made:
        c.close()


def _sigs(n, seed=9, msg_len=40):
    rng = random.Random(seed)
    pubs, msgs, sigs = [], [], []
    for _ in range(n):
        sd = bytes(rng.randrange(256) for _ in range(32))
        m = bytes(rng.randrange(256) for _ in range(msg_len))
        pubs.append(ref.pubkey_from_seed(sd))
        msgs.append(m)
        sigs.append(ref.sign(sd, m))
    return pubs, msgs, sigs


def _tamper(sig: bytes, i: int = 5) -> bytes:
    return sig[:i] + bytes([sig[i] ^ 0xFF]) + sig[i + 1:]


def _oracle(pubs, msgs, sigs):
    return [ref.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]


# --- the wire -----------------------------------------------------------------

def test_protocol_bytes_match_jax():
    pubs, msgs, sigs = _sigs(3)
    msgs[1] = b""
    trace = bytes(range(16))
    for kw in ({}, {"trace": trace}):
        req = pproto.encode_request(7, pubs, msgs, sigs, **kw)
        assert req == jproto.encode_request(7, pubs, msgs, sigs, **kw)
        assert pproto.decode_request(req) == jproto.decode_request(req)
        assert pproto.decode_request_trace(req) == \
            jproto.decode_request_trace(req)
    assert pproto.decode_request_trace(
        pproto.encode_request(1, pubs, msgs, sigs, trace=trace)) == (
        int.from_bytes(trace[:8], "little"),
        int.from_bytes(trace[8:], "little"))
    oks = [True, False, True]
    for shards in (None, [0, 1, pproto.CPU_SHARD]):
        resp = pproto.encode_response(9, False, oks, shards=shards)
        assert resp == jproto.encode_response(9, False, oks, shards=shards)
        assert pproto.decode_response(resp) == (9, False, oks)
        assert pproto.decode_response_shards(resp) == \
            jproto.decode_response_shards(resp) == shards
    assert pproto.encode_response(3, False, []) == \
        jproto.encode_response(3, False, [])
    for bad in (b"\x01" * 5, pproto.encode_request(1, pubs, msgs, sigs)[:-3]):
        with pytest.raises(ValueError):
            pproto.decode_request(bad)
        with pytest.raises(ValueError):
            jproto.decode_request(bad)


# --- the server against both packages' clients --------------------------------

@pytest.mark.parametrize("mod", [jclient, pclient], ids=["jax", "port"])
def test_client_gets_oracle_verdicts(server, clients, mod):
    pubs, msgs, sigs = _sigs(8)
    sigs[3] = _tamper(sigs[3])
    batch_ok, oks = clients(mod).verify(pubs, msgs, sigs)
    assert oks == _oracle(pubs, msgs, sigs) == \
        [True] * 3 + [False] + [True] * 4
    assert batch_ok is False


def test_concurrent_clients_coalesce(server, clients):
    pubs, msgs, sigs = _sigs(6, seed=21)
    sigs[4] = _tamper(sigs[4], 40)
    a, b = clients(jclient), clients(pclient)
    flushes0 = server.stats["flushes"]
    results = {}
    start = threading.Barrier(2)

    def go(name, c, lo, hi):
        start.wait(5.0)
        results[name] = c.verify(pubs[lo:hi], msgs[lo:hi], sigs[lo:hi])

    ts = [threading.Thread(target=go, args=("a", a, 0, 3)),
          threading.Thread(target=go, args=("b", b, 3, 6))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60.0)
    assert not any(t.is_alive() for t in ts)
    assert results["a"] == (True, [True] * 3)
    assert results["b"] == (False, [True, False, True])
    assert server.stats["flushes"] - flushes0 == 1


def test_oversized_message_unprocessable_falls_back(server, clients):
    pubs, msgs, sigs = _sigs(2, seed=33)
    seed = b"\x21" * 32
    msgs[1] = b"\x01" * 1000        # beyond the server's max_msg_len
    pubs[1] = ref.pubkey_from_seed(seed)
    sigs[1] = ref.sign(seed, msgs[1])
    client = clients()
    with pytest.raises(pclient.DeviceUnprocessable):
        client.verify(pubs, msgs, sigs)
    sup = phealth.DeviceSupervisor(clock=lambda: 0.0)
    rbv = pclient.RemoteBatchVerifier(client, supervisor=sup, device="cpu")
    for p, m, s in zip(pubs, msgs, sigs):
        rbv.add(Ed25519PubKey(p), m, s)
    assert rbv.verify() == (True, [True, True])   # verified locally
    assert sup.state == phealth.HEALTHY           # not a health signal


def _failing_flushes(monkeypatch):
    """Make the server's flushes raise, as a kernel launch error would,
    until the returned switch is cleared."""
    failing = [True]
    verify_batch = pserver.verify_batch

    def launch_error(*a, **k):
        if failing[0]:
            raise RuntimeError("kernel launch failed")
        return verify_batch(*a, **k)
    monkeypatch.setattr(pserver, "verify_batch", launch_error)
    return failing


def test_flush_failed_status_is_its_own():
    failed = pproto.encode_flush_failed(5)
    unprocessable = pproto.encode_response(5, False, [])
    assert pproto.is_flush_failed(failed)
    assert not pproto.is_flush_failed(unprocessable)
    assert not pproto.is_flush_failed(pproto.encode_response(5, True, [True]))
    # the JAX package's decoder reads a zero-lane answer, as UNPROCESSABLE
    assert jproto.decode_response(failed) == (5, True, [])


def test_failed_flush_counted_and_verified_locally(server, clients,
                                                   monkeypatch):
    """A failed flush is counted; the port's client and
    RemoteBatchVerifier raise it (no local verify hides it), while the
    JAX package's client, which knows no FLUSH_FAILED, reads it as
    UNPROCESSABLE, the answer it verifies locally."""
    failing = _failing_flushes(monkeypatch)
    failures0 = server.stats["flush_failures"]
    pubs, msgs, sigs = _sigs(3, seed=44)
    sigs[0] = _tamper(sigs[0])
    client = clients()
    with pytest.raises(pclient.DeviceFlushFailed):
        client.verify(pubs, msgs, sigs)
    assert server.stats["flush_failures"] == failures0 + 1
    sup = phealth.DeviceSupervisor(clock=lambda: 0.0)
    rbv = pclient.RemoteBatchVerifier(client, supervisor=sup, device="cpu")
    for p, m, s in zip(pubs, msgs, sigs):
        rbv.add(Ed25519PubKey(p), m, s)
    with pytest.raises(pclient.DeviceFlushFailed):
        rbv.verify()
    assert server.stats["flush_failures"] == failures0 + 2
    assert sup.state == phealth.HEALTHY and sup.trips == 0
    with pytest.raises(jclient.DeviceUnprocessable):
        clients(jclient).verify(pubs, msgs, sigs)
    assert server.stats["flush_failures"] == failures0 + 3
    failing[0] = False
    assert clients().verify(pubs, msgs, sigs) == (False, [False, True, True])
    assert rbv.verify() == (False, [False, True, True])


def test_bucket_cap_grants_canary_headroom():
    srv = pserver.DeviceServer(bucket=8, device="cpu")
    try:
        pubs = [b"\x01" * 32] * srv.bucket
        msgs = [b"m" * 31] * srv.bucket
        sigs = [b"\x02" * 64] * srv.bucket
        d_pubs, d_msgs, _ = phealth.splice_canaries(pubs, msgs, sigs)
        assert not srv._unprocessable(d_pubs, d_msgs)
        assert srv._unprocessable(d_pubs + pubs[:1], d_msgs + msgs[:1])
        assert srv._unprocessable(pubs, [b"\x01" * 257] + msgs[1:])
    finally:
        srv.stop()


def test_dead_server_verifies_locally_with_supervisor_tripped(server,
                                                              monkeypatch):
    pubs, msgs, sigs = _sigs(3, seed=70)
    monkeypatch.setenv(pclient.ENV_VAR, "127.0.0.1:1")   # nothing listens
    bv, ok = pbatch.create_batch_verifier(Ed25519PubKey(pubs[0]),
                                          device="cpu")
    assert ok and not isinstance(bv, pclient.RemoteBatchVerifier)
    assert phealth.shared_supervisor().state == phealth.SUSPECT
    assert phealth.shared_supervisor().trips == 1
    for p, m, s in zip(pubs, msgs, sigs):
        bv.add(Ed25519PubKey(p), m, s)
    assert bv.verify() == (True, [True] * 3)

    # a link that dies under a RemoteBatchVerifier: local verify
    client = pclient.DeviceClient(*server.addr)
    client.close()
    sup = phealth.DeviceSupervisor(clock=lambda: 0.0)
    rbv = pclient.RemoteBatchVerifier(client, supervisor=sup, device="cpu")
    for p, m, s in zip(pubs, msgs, sigs):
        rbv.add(Ed25519PubKey(p), m, s)
    assert rbv.verify() == (True, [True] * 3)
    assert sup.state == phealth.SUSPECT and sup.trips >= 1


def test_create_batch_verifier_honours_env(server, monkeypatch):
    monkeypatch.setenv(pclient.ENV_VAR, f"127.0.0.1:{server.addr[1]}")
    pubs, msgs, sigs = _sigs(4, seed=40)
    sigs[2] = _tamper(sigs[2])
    flushes0 = server.stats["flushes"]
    bv, ok = pbatch.create_batch_verifier(Ed25519PubKey(pubs[0]),
                                          device="cpu")
    assert ok and isinstance(bv, pclient.RemoteBatchVerifier)
    for p, m, s in zip(pubs, msgs, sigs):
        bv.add(Ed25519PubKey(p), m, s)
    assert bv.verify() == (False, [True, True, False, True])
    assert server.stats["flushes"] == flushes0 + 1
    assert phealth.shared_supervisor().state == phealth.HEALTHY


def test_server_rules():
    with pytest.raises(NotImplementedError):
        pserver.DeviceServer(mesh=True, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            pserver.DeviceServer()


# --- the pipeline through the device server -----------------------------------

@pytest.fixture(scope="module")
def pchain():
    return pcg.generate_chain(n_blocks=12, n_validators=8, seed=1,
                              device="cpu")


def _node(app_cls, exec_cls, store_cls, db_cls, chain, **kw):
    app = app_cls()
    app.init_chain(chain.chain_id, 1, [], b"")
    return app, exec_cls(app, **kw), store_cls(db_cls())


def test_pipelined_sync_through_device_server_matches_jax(server, clients,
                                                          pchain):
    jchain = jcg.generate_chain(n_blocks=12, n_validators=8, seed=1)
    japp, jexec, jstore = _node(JApp, JExec, JStore, JMemDB, jchain)
    jsrc = jcg.LocalChainSource(jchain)
    jr = jbs.BlocksyncReactor(jexec, jstore, jsrc, jchain.chain_id,
                              tile_size=8, batch_size=0, pipeline_depth=2)
    jst = jr.sync(JState.from_genesis(jchain.genesis))

    papp, pexec, pstore = _node(PApp, PExec, PStore, PMemDB, pchain,
                                device="cpu")
    psrc = pcg.LocalChainSource(pchain)
    sup = phealth.DeviceSupervisor(clock=lambda: 0.0)
    wd = pwd.DeviceWatchdog(supervisor=sup)
    flushes0 = server.stats["flushes"]
    failures0 = server.stats["flush_failures"]
    pr = pbs.BlocksyncReactor(
        pexec, pstore, psrc, pchain.chain_id, tile_size=8, batch_size=0,
        pipeline_depth=2, backend=psched.DeviceClientBackend(clients()),
        watchdog=wd, supervisor=sup, device="cpu")
    pst = pr.sync(PState.from_genesis(pchain.genesis))

    assert pst.last_block_height == jst.last_block_height == 12
    assert pst.app_hash == jst.app_hash
    assert pst.validators.hash() == jst.validators.hash()
    assert pst.last_block_id.encode() == jst.last_block_id.encode()
    assert papp.state == japp.state
    assert dataclasses.asdict(pr.stats) == dataclasses.asdict(jr.stats)
    assert psrc.banned == jsrc.banned == []
    # two tiles (64 + 2 canary lanes, then 32 + 2), each one flush
    assert server.stats["flushes"] - flushes0 == 2
    assert (wd.trips, wd.fallbacks, sup.canary_failures) == (0, 0, 0)
    assert sup.state == phealth.HEALTHY
    assert server.stats["flush_failures"] == failures0


@pytest.mark.parametrize("fault", ["flush", "unprocessable"])
def test_server_fault_raises_out_of_pipelined_sync(server, clients, pchain,
                                                   monkeypatch, fault):
    """Through `DeviceClientBackend`, a flush that fails on the server
    (its kernels raised) and a tile the server refuses (74 lanes with the
    canaries, past its 64 + 2) raise out of `BlocksyncReactor.sync`:
    neither is drained to the CPU, tripped or counted as a fallback."""
    if fault == "flush":
        _failing_flushes(monkeypatch)
        tile, raises = 8, pclient.DeviceFlushFailed
    else:
        tile, raises = 9, pclient.DeviceUnprocessable
    _app, pexec, pstore = _node(PApp, PExec, PStore, PMemDB, pchain,
                                device="cpu")
    sup = phealth.DeviceSupervisor(clock=lambda: 0.0)
    wd = pwd.DeviceWatchdog(supervisor=sup)
    failures0 = server.stats["flush_failures"]
    pr = pbs.BlocksyncReactor(
        pexec, pstore, pcg.LocalChainSource(pchain), pchain.chain_id,
        tile_size=tile, batch_size=0, pipeline_depth=2,
        backend=psched.DeviceClientBackend(clients()), watchdog=wd,
        supervisor=sup, device="cpu")
    with pytest.raises(raises):
        pr.sync(PState.from_genesis(pchain.genesis))
    assert (wd.trips, wd.fallbacks, sup.canary_failures) == (0, 0, 0)
    assert sup.state == phealth.HEALTHY
    assert pr.stats.blocks_applied == 0
    failed = server.stats["flush_failures"] - failures0
    assert failed >= 1 if fault == "flush" else failed == 0


def test_probe_surfaces_a_device_fault():
    """A half-open probe that reaches a server whose flush fails raises
    that fault instead of counting it as one more unreachable try."""
    sup = phealth.DeviceSupervisor(clock=lambda: 0.0)
    sup.report_trip(ConnectionError("blip"))

    def failed_flush(pubs, msgs, sigs):
        raise pclient.DeviceFlushFailed("the flush failed")
    with pytest.raises(pclient.DeviceFlushFailed):
        sup.probe(failed_flush)
    assert sup.state == phealth.SUSPECT
    assert (sup.trips, sup.probes) == (1, 1)
