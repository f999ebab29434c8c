"""The port's pipelined blocksync (cometbft_tpu_torch/pipeline/scheduler.py,
pipeline/watchdog.py and device/health.py) held against the JAX package's,
on the CPU.

- `BlocksyncReactor(pipeline_depth=K)` reaches the same final state on
  both sides (height, app hash, validators hash, last block id, the
  kvstore's contents), with the same `stats` and the same bans: depth 4 on
  a clean chain, a tampered signature, tampered data and a validator-set
  change; a source that keeps serving a corrupt block exhausts the retries
  on both; depth 1 of `PipelinedBlocksync` equals the synchronous loop; a
  stall raises SyncStalled with the same message.
- The JAX side runs `batch_size=0` (nothing jitted). The clean and
  tampered-signature cases run the port with tiles of 9 heights x 8
  validators and `batch_size=64`, so the torch RLC path runs inside the
  pipeline's worker thread (`ops.ed25519.STATS` shows it); the other cases
  run the port's host path too.
- The liveness paths equal the JAX package's: a wedge through
  `HangingBackend` drains to the CPU (counted), the flap (`FlakyBackend`)
  recovers through the supervisor's probe, and `CorruptBackend` with
  canaries is quarantined and re-verified on the CPU.
- The port's stated divergence: an exception from the in-process backend,
  a canary mismatch there and a deadline miss there raise out of `sync`
  (`DispatchDeadlineExceeded` for the miss), where the JAX package drains
  to the CPU. Only a backend that declares `drain_on` (the device link
  and the stubs that model one) drains.
- The watchdog's deadlines and counters, and the supervisor's state
  sequence under a fixed `libs/timesource` clock, are compared step by
  step with the JAX package's.
- A chain over a mixed-curve set (65 ed25519 and 2 secp256k1 keys, built
  by hand: neither chain generator makes one) syncs like the JAX
  package's at depth 1 and 2, clean and with a tampered signature: each
  commit is verified whole at marshal (`validation.verify_commit`, its
  ed25519 bucket on the torch RLC path here) and settles as decided.
"""

import dataclasses
import threading

import pytest
import torch

from cometbft_tpu.abci.kvstore import KVStoreApplication as JApp
from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
from cometbft_tpu.db.kv import MemDB as JMemDB
from cometbft_tpu.device import health as jhealth
from cometbft_tpu.engine import blocksync as jbs
from cometbft_tpu.engine import chain_gen as jcg
from cometbft_tpu.libs import metrics as jmetrics
from cometbft_tpu.libs import metrics_gen as jmetrics_gen
from cometbft_tpu.libs import timesource as jtime
from cometbft_tpu.pipeline import cache as jcache
from cometbft_tpu.pipeline import scheduler as jsched
from cometbft_tpu.pipeline import watchdog as jwd
from cometbft_tpu.state.execution import BlockExecutor as JExec
from cometbft_tpu.state.execution import BlockValidationError as JBVE
from cometbft_tpu.state.state import State as JState
from cometbft_tpu.store.blockstore import BlockStore as JStore
from cometbft_tpu.types.block import CommitSig as JCommitSig

from cometbft_tpu_torch.abci.kvstore import KVStoreApplication as PApp
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey as PPriv
from cometbft_tpu_torch.db.kv import MemDB as PMemDB
from cometbft_tpu_torch.device import health as phealth
from cometbft_tpu_torch.engine import blocksync as pbs
from cometbft_tpu_torch.engine import chain_gen as pcg
from cometbft_tpu_torch.libs import metrics as pmetrics
from cometbft_tpu_torch.libs import metrics_gen as pmetrics_gen
from cometbft_tpu_torch.libs import timesource as ptime
from cometbft_tpu_torch.ops import ed25519 as ped
from cometbft_tpu_torch.pipeline import cache as pcache
from cometbft_tpu_torch.pipeline import scheduler as psched
from cometbft_tpu_torch.pipeline import watchdog as pwd
from cometbft_tpu_torch.state.execution import BlockExecutor as PExec
from cometbft_tpu_torch.state.execution import BlockValidationError as PBVE
from cometbft_tpu_torch.state.state import State as PState
from cometbft_tpu_torch.store.blockstore import BlockStore as PStore
from cometbft_tpu_torch.types.block import CommitSig as PCommitSig

import _torch_mixed as tm

TILE = 9          # 9 heights x 8 validators: one corrupt commit leaves 64
BATCH = 64        # the port's RLC bucket on the CPU

SIDES = {
    "jax": dict(app=JApp, exec=JExec, store=JStore, db=JMemDB,
                state=JState, bs=jbs, cg=jcg, sched=jsched, wd=jwd,
                health=jhealth, metrics=jmetrics, gen=jmetrics_gen,
                time=jtime, bve=JBVE),
    "port": dict(app=PApp, exec=PExec, store=PStore, db=PMemDB,
                 state=PState, bs=pbs, cg=pcg, sched=psched, wd=pwd,
                 health=phealth, metrics=pmetrics, gen=pmetrics_gen,
                 time=ptime, bve=PBVE),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Eager torch at 64 lanes is launch-bound on the CPU; one thread
    runs it several times faster than a contended pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_shared_supervisors():
    """The shared supervisors are process-wide; keep a test's state out
    of the next one."""
    jhealth.reset_shared_supervisor()
    phealth.reset_shared_supervisor()
    yield
    jhealth.reset_shared_supervisor()
    phealth.reset_shared_supervisor()


def _val_tx(pub: bytes) -> bytes:
    return b"val:" + pub.hex().encode() + b"!15"


@pytest.fixture(scope="module")
def chains():
    """(jax, port) chain pairs, each built once: "main" is 12 blocks of 8
    validators, "valset" the 4-validator chain of tests/test_pipeline.py
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


def _node(side, chain):
    m = SIDES[side]
    app = m["app"]()
    app.init_chain(chain.chain_id, 1, [], b"")
    kw = {} if side == "jax" else {"device": "cpu"}
    return app, m["exec"](app, **kw), m["store"](m["db"]())


def _reactor(side, chain, src, depth, tile=TILE, batch=0, **kw):
    app, executor, store = _node(side, chain)
    if side == "port":
        kw["device"] = "cpu"
    else:
        batch = 0
    reactor = SIDES[side]["bs"].BlocksyncReactor(
        executor, store, src, chain.chain_id, tile_size=tile,
        batch_size=batch, pipeline_depth=depth, **kw)
    return app, reactor


def _sync(side, chain, depth, corrupt=None, source_cls=None, **kw):
    """One fresh node synced from genesis. -> (state, reactor, src, app)."""
    src = (source_cls or SIDES[side]["cg"].LocalChainSource)(
        chain, dict(corrupt or {}))
    app, reactor = _reactor(side, chain, src, depth, **kw)
    state = reactor.sync(SIDES[side]["state"].from_genesis(chain.genesis))
    return state, reactor, src, app


def _assert_same(j, p):
    (jst, jr, jsrc, japp), (pst, pr, psrc, papp) = j, p
    assert pst.last_block_height == jst.last_block_height
    assert pst.app_hash == jst.app_hash
    assert pst.validators.hash() == jst.validators.hash()
    assert pst.last_block_id.encode() == jst.last_block_id.encode()
    assert papp.state == japp.state
    assert dataclasses.asdict(pr.stats) == dataclasses.asdict(jr.stats)
    assert psrc.banned == jsrc.banned


# --- the scheduler: catch-up against the JAX package --------------------------

@pytest.mark.parametrize("name,corrupt,batch,tile", [
    ("main", None, BATCH, TILE), ("main", {7: "sig"}, BATCH, TILE),
    ("main", {5: "data"}, 0, TILE), ("valset", None, 0, 8)])
def test_pipeline_matches_jax(chains, name, corrupt, batch, tile):
    jchain, pchain = chains[name]
    stats0 = dict(ped.STATS)
    j = _sync("jax", jchain, 4, corrupt, tile=tile)
    p = _sync("port", pchain, 4, corrupt, tile=tile, batch=batch)
    _assert_same(j, p)
    pst, pr, psrc, _ = p
    assert pst.last_block_height == pchain.max_height()
    if corrupt == {7: "sig"}:
        assert psrc.banned and psrc.banned[0] in (6, 7)
        # the first tile fails its RLC equation in the worker thread and
        # is attributed per lane there
        assert ped.STATS["per_lane"] > stats0["per_lane"]
    elif corrupt == {5: "data"}:
        assert psrc.banned == [5]
    else:
        assert psrc.banned == []
    if name == "valset":
        assert pr.stats.respeculations >= 1
    elif batch and not corrupt:
        assert ped.STATS["rlc_pass"] > stats0["rlc_pass"]


@pytest.fixture(scope="module")
def mixed_chains():
    """(jax, port) chains of 3 blocks over a 67-key set of 65 ed25519 and
    2 secp256k1 keys."""
    specs = tm.key_specs(31, n_ed=65, n_sr=0, n_secp=2)
    return tuple(tm.mixed_chain(side, 3, specs, device="cpu")[0]
                 for side in ("jax", "port"))


def _secp_tampering_source(side):
    """A LocalChainSource whose corrupt heights carry a last commit with
    its first secp256k1 signature tampered (a bit of s flipped), until a
    ban. The JAX side must not retry a tampered ed25519 lane: the retry
    finds every other ed25519 lane in the verified-signature cache, and
    a bucket of one lane would jit the JAX package's RLC kernel on the
    CPU."""
    base = SIDES[side]["cg"].LocalChainSource
    sig_cls = JCommitSig if side == "jax" else PCommitSig

    class SecpTamper(base):
        def __init__(self, chain, corrupt=None):
            super().__init__(chain)
            self.heights = set(corrupt or ())

        def fetch(self, height):
            got = super().fetch(height)
            if got is None or height not in self.heights:
                return got
            block, bid = got
            vals = self.chain.valsets[height - 2]
            idx = next(i for i, v in enumerate(vals.validators)
                       if v.pub_key.type_() == "secp256k1")
            lc = tm.tamper(sig_cls, block.last_commit, [idx])
            return dataclasses.replace(block, last_commit=lc), bid

        def ban(self, height):
            super().ban(height)
            self.heights.clear()

    return SecpTamper


@pytest.mark.parametrize("depth,corrupt", [(1, None), (2, None),
                                           (2, {3: "secp"})])
def test_mixed_chain_sync_matches_jax(mixed_chains, depth, corrupt):
    jchain, pchain = mixed_chains
    # the generators' commit checks filled the process-wide caches
    jcache.reset_shared_cache()
    pcache.reset_shared_cache()
    stats0 = dict(ped.STATS)
    j = _sync("jax", jchain, depth, corrupt, _secp_tampering_source("jax"))
    p = _sync("port", pchain, depth, corrupt,
              _secp_tampering_source("port"), batch=BATCH)
    _assert_same(j, p)
    pst, pr, psrc, _ = p
    assert pst.last_block_height == pchain.max_height()
    assert psrc.banned == ([2] if corrupt else [])
    # every commit verified at marshal: no lane reached the tile's flush,
    # each commit's ed25519 bucket ran the torch RLC path
    assert pr.stats.tiles_flushed >= 1
    assert ped.STATS["rlc_pass"] - stats0["rlc_pass"] >= 3


def test_pipeline_exhausts_retries_like_jax(chains):
    for side, chain in zip(("jax", "port"), chains["main"]):
        cg = SIDES[side]["cg"]

        class Stubborn(cg.LocalChainSource):
            def ban(self, height):
                self.banned.append(height)   # keeps serving corrupt data

        with pytest.raises(SIDES[side]["bve"]):
            _sync(side, chain, 4, {3: "sig"}, Stubborn, max_retries=2)


def test_depth1_is_synchronous_degenerate_case(chains):
    """PipelinedBlocksync at depth=1 gives the synchronous loop's results,
    and both give the JAX package's."""
    outs = {}
    for side, chain in zip(("jax", "port"), chains["main"]):
        m = SIDES[side]
        src = m["cg"].LocalChainSource(chain)
        app, reactor = _reactor(side, chain, src, 1, tile=5)
        state = m["state"].from_genesis(chain.genesis)
        pipe = m["sched"].PipelinedBlocksync(reactor, depth=1)
        try:
            while state.last_block_height < 12:
                state = pipe.run(state, 12)
        finally:
            pipe.close()
        outs[side] = (state, reactor, src, app)
        sync = _sync(side, chain, 1, tile=5)
        _assert_same(sync, outs[side])
    _assert_same(outs["jax"], outs["port"])


def test_pipeline_stall_propagates(chains):
    class EmptySource:
        def max_height(self):
            return 9

        def fetch(self, height):
            return None

        def ban(self, height):
            pass

        def pending_fetches(self):
            return 7

    msgs = []
    for side, chain in zip(("jax", "port"), chains["main"]):
        _app, reactor = _reactor(side, chain, EmptySource(), 2, tile=4,
                                 max_retries=1)
        with pytest.raises(SIDES[side]["bs"].SyncStalled) as ei:
            reactor.sync(SIDES[side]["state"].from_genesis(chain.genesis))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    assert "height 1" in msgs[1] and "7 fetches pending" in msgs[1]


# --- liveness: wedge, flap, corruption ----------------------------------------

@pytest.mark.parametrize("corrupt,depth", [(None, 2), ({7: "sig"}, 3)])
def test_wedge_drains_to_cpu_like_jax(chains, corrupt, depth):
    outs, counts = {}, {}
    for side, chain in zip(("jax", "port"), chains["main"]):
        m = SIDES[side]
        reg = m["metrics"].Registry()
        metrics = m["gen"].PipelineMetrics(reg)
        wd = m["wd"].DeviceWatchdog(base_deadline_s=0.05, per_sig_s=0.0,
                                    metrics=metrics)
        outs[side] = _sync(side, chain, depth, corrupt,
                           backend=m["sched"].HangingBackend(), watchdog=wd)
        assert wd.wedged and wd.trips == 1 and wd.fallbacks >= 1
        assert metrics.wedge_fallbacks.value() == wd.fallbacks
        assert "pipeline_wedge_fallbacks" in reg.expose()
        counts[side] = (wd.trips, wd.fallbacks)
    _assert_same(outs["jax"], outs["port"])
    assert counts["port"] == counts["jax"]
    assert bool(outs["port"][2].banned) == bool(corrupt)


def test_flap_recovers_through_supervisor_like_jax(chains):
    """FlakyBackend fails its first dispatch: the tile drains to the CPU,
    the supervisor probes, and device dispatch resumes."""
    outs, counts = {}, {}
    for side, chain in zip(("jax", "port"), chains["main"]):
        m = SIDES[side]
        sup = m["health"].DeviceSupervisor(backoff_base_s=1e-6,
                                           backoff_cap_s=0.001,
                                           probe_deadline_s=0.5)
        backend = m["sched"].FlakyBackend(fail_dispatches=1)
        wd = m["wd"].DeviceWatchdog(base_deadline_s=0.5, per_sig_s=0.0,
                                    supervisor=sup)
        outs[side] = _sync(side, chain, 2, backend=backend, watchdog=wd,
                           supervisor=sup, tile=1)
        assert sup.state == m["health"].HEALTHY and not wd.wedged
        counts[side] = (sup.trips, sup.probes, wd.trips, wd.fallbacks,
                        backend.dispatches, backend.served)
    _assert_same(outs["jax"], outs["port"])
    assert counts["port"] == counts["jax"]
    assert counts["port"][1] >= 1 and counts["port"][5] >= 2


@pytest.mark.parametrize("corrupt", [None, {5: "sig"}])
def test_corrupt_backend_quarantines_like_jax(chains, corrupt):
    outs, counts = {}, {}
    for side, chain in zip(("jax", "port"), chains["main"]):
        m = SIDES[side]
        sup = m["health"].DeviceSupervisor(backoff_base_s=1.0,
                                           backoff_cap_s=8.0,
                                           probe_deadline_s=0.5,
                                           clock=lambda: 0.0)
        wd = m["wd"].DeviceWatchdog(base_deadline_s=0.5, per_sig_s=0.0,
                                    supervisor=sup)
        outs[side] = _sync(side, chain, 2, corrupt,
                           backend=m["sched"].CorruptBackend(), watchdog=wd,
                           supervisor=sup, tile=4)
        assert sup.state == m["health"].QUARANTINED
        counts[side] = (sup.quarantines, sup.canary_failures, wd.trips,
                        wd.fallbacks)
    _assert_same(outs["jax"], outs["port"])
    assert counts["port"] == counts["jax"]
    assert counts["port"][:2] == (1, 1)
    assert bool(outs["port"][2].banned) == bool(corrupt)


def test_canary_lanes_ride_every_batch_like_jax(chains):
    """A verdict-computing backend sees every tile with CANARY_LANES more
    lanes; the verdicts are stripped and the supervisor stays HEALTHY."""
    seen = {}
    for side, chain in zip(("jax", "port"), chains["main"]):
        m = SIDES[side]
        lanes = seen[side] = []

        class Recording:
            def submit(self, p, ms, s, _m=m, _lanes=lanes):
                _lanes.append(len(p))
                fut = _m["sched"].VerifyFuture()
                fut.set_result(_m["bs"].verify_lanes(p, ms, s, 0))
                return fut

            def close(self):
                pass

        sup = m["health"].DeviceSupervisor(clock=lambda: 0.0)
        wd = m["wd"].DeviceWatchdog(base_deadline_s=0.5, per_sig_s=0.0,
                                    supervisor=sup)
        _sync(side, chain, 2, backend=Recording(), watchdog=wd,
              supervisor=sup, tile=4)
        assert sup.state == m["health"].HEALTHY and sup.quarantines == 0
    assert seen["port"] == seen["jax"]
    assert seen["port"] == [4 * 8 + phealth.CANARY_LANES] * 3


# --- the port's divergence: no fallback hides a kernel fault ------------------

def test_in_process_backend_exception_propagates(chains, monkeypatch):
    """The JAX package drains a crashing in-process backend to the CPU;
    the port raises out of sync, with nothing counted as a drain."""
    jchain, pchain = chains["main"]
    jwdog = jwd.DeviceWatchdog(base_deadline_s=5.0, per_sig_s=0.0)
    crashing = jsched.LocalAsyncBackend(lambda p, m, s: 1 / 0)
    try:
        j = _sync("jax", jchain, 2, watchdog=jwdog, backend=crashing)
    finally:
        crashing.close()
    assert j[0].last_block_height == 12 and jwdog.fallbacks >= 1

    crashing = psched.LocalAsyncBackend(lambda p, m, s: 1 / 0)
    pwdog = pwd.DeviceWatchdog(base_deadline_s=5.0, per_sig_s=0.0)
    try:
        with pytest.raises(ZeroDivisionError):
            _sync("port", pchain, 2, watchdog=pwdog, backend=crashing)
    finally:
        crashing.close()
    assert pwdog.trips == 0 and pwdog.fallbacks == 0

    # the reactor's own backend: a launch error in verify_lanes surfaces
    def launch_error(*a, **k):
        raise RuntimeError("kernel launch failed")
    monkeypatch.setattr(psched, "verify_lanes", launch_error)
    pwdog = pwd.DeviceWatchdog(base_deadline_s=5.0, per_sig_s=0.0)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        _sync("port", pchain, 2, watchdog=pwdog, batch=BATCH)
    assert pwdog.trips == 0 and pwdog.fallbacks == 0


def test_in_process_canary_mismatch_raises(chains):
    """An in-process backend that fails the canary lanes is a kernel
    fault: KernelCanaryError, not quarantine and a quiet CPU re-verify."""
    _, pchain = chains["main"]

    class LyingInProcess(psched.CorruptBackend):
        drain_on = ()   # not a device link: drains nothing

    sup = phealth.DeviceSupervisor(clock=lambda: 0.0)
    wd = pwd.DeviceWatchdog(base_deadline_s=0.5, per_sig_s=0.0,
                            supervisor=sup)
    with pytest.raises(ped.KernelCanaryError):
        _sync("port", pchain, 2, backend=LyingInProcess(), watchdog=wd,
              supervisor=sup, tile=4)
    assert sup.state == phealth.QUARANTINED and wd.fallbacks == 0


def test_in_process_deadline_miss_raises(chains, monkeypatch):
    """A verify that outlives the watchdog's deadline: the JAX package
    drains the tile to the CPU; the port raises DispatchDeadlineExceeded
    out of sync and drains, trips and counts nothing."""
    jchain, pchain = chains["main"]
    release = threading.Event()

    def stuck(side):
        def verify(p, m, s):
            release.wait(1.0)
            return SIDES[side]["bs"].verify_lanes(p, m, s, 0)
        return verify

    jwdog = jwd.DeviceWatchdog(base_deadline_s=0.05, per_sig_s=0.0)
    slow = jsched.LocalAsyncBackend(stuck("jax"))
    try:
        j = _sync("jax", jchain, 2, watchdog=jwdog, backend=slow)
    finally:
        release.set()
        slow.close()
    assert j[0].last_block_height == 12 and jwdog.fallbacks >= 1

    release.clear()
    slow = psched.LocalAsyncBackend(stuck("port"))
    pwdog = pwd.DeviceWatchdog(base_deadline_s=0.05, per_sig_s=0.0)
    try:
        with pytest.raises(psched.DispatchDeadlineExceeded):
            _sync("port", pchain, 2, watchdog=pwdog, backend=slow)
    finally:
        release.set()
        slow.close()
    assert pwdog.trips == 0 and pwdog.fallbacks == 0 and not pwdog.wedged

    # the reactor's own backend, with a supervisor: still a raise
    release.clear()
    monkeypatch.setattr(psched, "verify_lanes",
                        lambda p, m, s, *a: stuck("port")(p, m, s))
    sup = phealth.DeviceSupervisor(clock=lambda: 0.0)
    pwdog = pwd.DeviceWatchdog(base_deadline_s=0.05, per_sig_s=0.0,
                               supervisor=sup)
    try:
        with pytest.raises(psched.DispatchDeadlineExceeded):
            _sync("port", pchain, 2, watchdog=pwdog, supervisor=sup)
    finally:
        release.set()
    assert pwdog.trips == pwdog.fallbacks == 0
    assert sup.state == phealth.HEALTHY


# --- the watchdog and the supervisor, step by step ----------------------------

def test_watchdog_matches_jax():
    trace = {}
    for side in ("jax", "port"):
        m = SIDES[side]
        steps = trace[side] = []
        wd = m["wd"].DeviceWatchdog(base_deadline_s=2.0, per_sig_s=0.01)
        steps.append((wd.deadline_for(0), wd.deadline_for(4096)))
        hang = m["sched"].HangingBackend()
        quick = m["wd"].DeviceWatchdog(base_deadline_s=0.01, per_sig_s=0.0)
        steps.append(quick.result(hang.submit([b"x"], [b"y"], [b"z"]), 1))
        steps.append((quick.wedged, quick.trips, quick.fallbacks))
        # sticky: a healthy future is not consulted afterwards
        done = m["sched"].FixedLatencyBackend(0.0).submit([b"x"], [b"y"],
                                                          [b"z"])
        steps.append(quick.result(done, 1))
        steps.append((quick.wedged, quick.trips, quick.fallbacks))
        hang.close()
        healthy = m["wd"].DeviceWatchdog(base_deadline_s=5.0)
        fut = m["sched"].FixedLatencyBackend(0.0).submit([b"x"], [b"y"],
                                                         [b"z"])
        steps.append(list(healthy.result(fut, 1)))
        steps.append((healthy.wedged, healthy.trips, healthy.fallbacks))
    assert trace["port"] == trace["jax"]
    assert trace["port"][0] == (pytest.approx(2.0), pytest.approx(42.96))

    # a backend exception: the JAX watchdog drains it, the port's raises
    jdog = jwd.DeviceWatchdog(base_deadline_s=2.0)
    backend = jsched.LocalAsyncBackend(lambda p, m, s: 1 / 0)
    assert jdog.result(backend.submit([b"x"], [b"y"], [b"z"]), 1) is None
    assert jdog.wedged
    backend.close()
    pdog = pwd.DeviceWatchdog(base_deadline_s=2.0)
    backend = psched.LocalAsyncBackend(lambda p, m, s: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        pdog.result(backend.submit([b"x"], [b"y"], [b"z"]), 1)
    assert not pdog.wedged and pdog.trips == pdog.fallbacks == 0
    backend.close()


def _supervisor_steps(side):
    m = SIDES[side]
    now = {"ns": 10**9}
    m["time"].install(lambda: now["ns"])
    try:
        h = m["health"]
        sup = h.DeviceSupervisor(backoff_base_s=1.0, backoff_cap_s=4.0,
                                 probe_deadline_s=0.5)
        steps = []

        def snap(tag):
            steps.append((tag, sup.state_name(), sup.trips, sup.probes,
                          sup.quarantines, sup.canary_failures,
                          round(sup._next_probe_at - now["ns"] / 1e9, 9)))

        def cpu(p, ms, s):
            return m["bs"].verify_lanes(p, ms, s, 0)

        def down(p, ms, s):
            raise TimeoutError("still wedged")

        snap("start")
        sup.report_trip(ConnectionError("stall"))
        snap("trip")
        steps.append(("due", sup.probe_due(), sup.allow_connect()))
        steps.append(("probe", sup.probe(cpu)))
        snap("recovered")
        for i in range(4):
            sup.report_trip(ConnectionError(str(i)))
            snap(f"trip{i}")
        steps.append(("due", sup.probe_due(), sup.allow_connect()))
        now["ns"] += 6 * 10**9
        steps.append(("due", sup.probe_due()))
        steps.append(("probe", sup.probe(down)))
        snap("probe failed")
        now["ns"] += 10 * 10**9
        steps.append(("probe", sup.probe(cpu)))
        snap("healthy")
        sup.report_corruption("canary mismatch")
        snap("corrupt")
        sup.report_trip(ConnectionError("after"))
        steps.append(("probe", sup.probe(cpu), sup.allow_connect()))
        snap("terminal")
        return steps
    finally:
        m["time"].reset()


def test_supervisor_sequence_matches_jax():
    jsteps, psteps = _supervisor_steps("jax"), _supervisor_steps("port")
    assert psteps == jsteps
    names = [s[1] for s in psteps if len(s) == 7]
    assert names[:3] == ["healthy", "suspect", "healthy"]
    assert names[-2:] == ["quarantined", "quarantined"]


def test_pipeline_metrics_match_jax(chains):
    got = {}
    for side, chain in zip(("jax", "port"), chains["main"]):
        m = SIDES[side]
        metrics = m["gen"].PipelineMetrics(m["metrics"].Registry())
        state, *_ = _sync(side, chain, 3, metrics=metrics, tile=4,
                          backend=m["sched"].FixedLatencyBackend(0.001))
        got[side] = (state.last_block_height,
                     metrics.tiles_dispatched.value(),
                     metrics.tiles_in_flight.value())
    assert got["port"] == got["jax"] == (12, 3.0, 0.0)


def test_launch_counter_exact_across_threads():
    """The pipeline's worker and the device server's flush thread count
    kernel launches beside the main thread: no count may be lost."""
    import sys
    import threading
    from cometbft_tpu_torch.ops import cuda_verify as cv
    saved = dict(cv.LAUNCHES)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        cv.reset_launches()

        def launch():
            for _ in range(2000):
                cv._count("rlc_window_sums", 2)
        ts = [threading.Thread(target=launch) for _ in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60.0)
        assert not any(t.is_alive() for t in ts)
        assert cv.LAUNCHES["rlc_window_sums"] == 16 * 2000 * 2
    finally:
        sys.setswitchinterval(interval)
        cv.LAUNCHES.update(saved)
