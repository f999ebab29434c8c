"""The port's durable storage (cometbft_tpu_torch/db, libs/faultio,
consensus/wal, store/recovery) held against the JAX package's, on the CPU.

Inputs come from a numpy seed. Every result is bytes, a key set, a report
or an exception class, so the tolerance is none:
- the same sets, deletes and batches give byte-identical FileDB logs in
  both packages, each package opens the other's log (v1 records as the
  native DB writes them, v2 records, both mixed), and `compact` leaves the
  same live set and the same bytes;
- a write_batch torn at every byte offset replays to the pre-batch state
  in both (tests/test_storage_recovery.py:58 for the JAX package alone);
- the port's NativeDB (csrc/host/kvlog.cc, built by g++ into build/)
  opens FileDB logs and FileDB opens its logs;
- faultio plans (torn write, ENOSPC, fsync lie, bit flip) act the same in
  both packages on the same seed: the same events and the same file bytes;
- a WAL written by either package reads in the other: the same records and
  the same #ENDHEIGHT markers, across rotated files;
- `run_doctor` over the same damaged FileDB stores (written by the JAX
  package) gives the same RecoveryReport or the same RecoveryError.
"""

import os
import shutil
import struct

import numpy as np
import pytest

from cometbft_tpu.consensus import wal as jwal
from cometbft_tpu.db import kv as jkv
from cometbft_tpu.libs import fail as jfail
from cometbft_tpu.libs import faultio as jfio
from cometbft_tpu.store import recovery as jrec

from cometbft_tpu_torch.consensus import wal as pwal
from cometbft_tpu_torch.db import kv as pkv
from cometbft_tpu_torch.db.native import NativeDB
from cometbft_tpu_torch.libs import fail as pfail
from cometbft_tpu_torch.libs import faultio as pfio
from cometbft_tpu_torch.store import recovery as prec

SEED = 11


@pytest.fixture(autouse=True)
def _clean_seams():
    for m in (jfio, pfio):
        m.reset()
    for m in (jfail, pfail):
        m.clear_fail_hook()
    yield
    for m in (jfio, pfio):
        m.reset()
    for m in (jfail, pfail):
        m.clear_fail_hook()


def _ops(seed: int, n: int = 60):
    """A seeded sequence of set / delete / batch operations over a small
    key space (so deletes and overwrites hit live keys)."""
    rng = np.random.default_rng(seed)
    keys = [b"k%02d" % i for i in range(12)]

    def val():
        return rng.bytes(int(rng.integers(0, 40)))
    ops = []
    for _ in range(n):
        r = rng.random()
        k = keys[int(rng.integers(len(keys)))]
        if r < 0.5:
            ops.append(("set", k, val()))
        elif r < 0.7:
            ops.append(("delete", k))
        else:
            sets = [(keys[int(rng.integers(len(keys)))], val())
                    for _ in range(int(rng.integers(0, 4)))]
            dels = [keys[int(rng.integers(len(keys)))]
                    for _ in range(int(rng.integers(0, 3)))]
            ops.append(("batch", sets, dels))
    return ops


def _apply(db, ops):
    for op in ops:
        if op[0] == "set":
            db.set(op[1], op[2])
        elif op[0] == "delete":
            db.delete(op[1])
        else:
            db.write_batch(op[1], op[2])


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _live(db):
    return list(db.iterate())


def test_filedb_logs_byte_identical_and_cross_open(tmp_path):
    ops = _ops(SEED)
    pj, pp = str(tmp_path / "j.db"), str(tmp_path / "p.db")
    dj, dp = jkv.FileDB(pj), pkv.FileDB(pp)
    _apply(dj, ops)
    _apply(dp, ops)
    want = _live(dj)
    assert _live(dp) == want and want
    dj.close()
    dp.close()
    assert _read(pj) == _read(pp)
    # each package replays the other's log
    assert _live(pkv.FileDB(pj)) == want
    assert _live(jkv.FileDB(pp)) == want
    # compact: the same live set, the same bytes, still cross-readable
    for path, cls in ((pj, jkv.FileDB), (pp, pkv.FileDB)):
        db = cls(path)
        db.compact()
        db.close()
    assert _read(pj) == _read(pp)
    assert _live(jkv.FileDB(pp)) == _live(pkv.FileDB(pj)) == want


def _v1(op, key, value=b""):
    return struct.pack("<BII", op, len(key), len(value)) + key + value


@pytest.mark.parametrize("layout", ["v1", "v2", "mixed"])
def test_each_package_opens_v1_v2_and_mixed_logs(tmp_path, layout):
    rng = np.random.default_rng(SEED + 1)
    recs = [(b"a%d" % i, rng.bytes(8)) for i in range(6)]
    p = str(tmp_path / "x.db")
    raw = b""
    if layout in ("v1", "mixed"):
        raw += b"".join(_v1(0, k, v) for k, v in recs[:3])
        raw += _v1(1, recs[0][0])
    if layout in ("v2", "mixed"):
        # the v2 batch as FileDB.write_batch frames it
        raw += b"".join(pkv._enc2(pkv._REC_SET2, k, v) for k, v in recs[3:])
        raw += pkv._enc2(pkv._REC_DEL2, recs[4][0])
        raw += pkv._enc2(pkv._REC_COMMIT, b"", pkv._U32.pack(4))
    with open(p, "wb") as f:
        f.write(raw)
    dj, dp = jkv.FileDB(p), pkv.FileDB(p)
    assert _live(dj) == _live(dp) and _live(dp)
    assert dj.needs_upgrade == dp.needs_upgrade == (layout != "v2")
    dj.close()
    dp.close()
    assert _read(p) == raw          # both replays left it whole


_BATCH_SETS = [(b"k1", b"v1v1"), (b"k2", b"second-value")]
_BATCH_DELS = [b"k0"]
_BATCH_LEN = len(b"".join(
    [pkv._enc2(pkv._REC_SET2, k, v) for k, v in _BATCH_SETS]
    + [pkv._enc2(pkv._REC_DEL2, k) for k in _BATCH_DELS]
    + [pkv._enc2(pkv._REC_COMMIT, b"", pkv._U32.pack(3))]))


def _torn_replay(kv, fio, path, keep):
    db = kv.FileDB(path)
    db.write_batch([(b"k0", b"base"), (b"pre", b"kept")])
    db.close()
    size0 = os.path.getsize(path)
    fio.install(fio.FaultPlan().torn_write("db:log", nth=1, keep=keep))
    db = kv.FileDB(path)
    with pytest.raises(fio.InjectedCrash):
        db.write_batch(_BATCH_SETS, _BATCH_DELS)
    fio.reset()
    torn = _read(path)
    db = kv.FileDB(path)
    out = (_live(db), os.path.getsize(path) == size0, torn)
    db.close()
    return out


def test_torn_batch_at_every_offset_replays_to_pre_batch_state(tmp_path):
    """One write_batch torn at each of its byte offsets (the JAX
    package's test parametrises the offsets; here one test walks them
    all in both packages)."""
    pre = [(b"k0", b"base"), (b"pre", b"kept")]
    for keep in range(_BATCH_LEN):
        got = []
        for tag, kv, fio in (("j", jkv, jfio), ("p", pkv, pfio)):
            path = str(tmp_path / f"{tag}{keep}.db")
            got.append(_torn_replay(kv, fio, path, keep))
        (lj, okj, tj), (lp, okp, tp) = got
        assert lj == lp == pre, keep
        assert okj and okp, keep
        assert tj == tp, keep       # the same torn bytes on disk
        # the other package replays the port's torn log the same way
        path = str(tmp_path / f"x{keep}.db")
        with open(path, "wb") as f:
            f.write(tp)
        db = jkv.FileDB(path)
        assert _live(db) == pre
        db.close()


def test_native_db_and_filedb_open_each_other(tmp_path):
    ops = _ops(SEED + 2)
    pf, pn = str(tmp_path / "f.db"), str(tmp_path / "n.db")
    df, dn = pkv.FileDB(pf), NativeDB(pn)
    _apply(df, ops)
    _apply(dn, ops)
    want = _live(df)
    assert _live(dn) == want and len(dn) == len(want)
    df.close()
    dn.close()
    # NativeDB reads FileDB's v2 log; FileDB (both packages) NativeDB's v1
    assert _live(NativeDB(pf)) == want
    assert _live(pkv.FileDB(pn)) == want
    assert _live(jkv.FileDB(pn)) == want
    # a mixed log: FileDB appends v2 batches onto the native v1 log
    df = pkv.FileDB(pn)
    df.write_batch([(b"zz", b"after")], [want[0][0]])
    df.close()
    dn = NativeDB(pn)
    assert _live(dn) == _live(jkv.FileDB(pn)) == want[1:] + [(b"zz",
                                                              b"after")]
    dn.compact()
    dn.close()
    assert _live(pkv.FileDB(pn)) == want[1:] + [(b"zz", b"after")]
    # open_db's native backend is this library, built under build/
    db = pkv.open_db("native", "o", str(tmp_path))
    db.set(b"k", b"v")
    db.close()
    assert _live(pkv.open_db("filedb", "o", str(tmp_path))) == [(b"k",
                                                                b"v")]
    assert isinstance(pkv.open_db("memdb", "m", str(tmp_path)), pkv.MemDB)
    with pytest.raises(ValueError):
        pkv.open_db("leveldb", "m", str(tmp_path))


def _faultio_run(fio, d, kind, seed):
    """One fault plan over one workload; returns what it left."""
    p = os.path.join(d, "f")
    plan = fio.FaultPlan(seed=seed)
    if kind == "torn":
        plan.torn_write("db:log", nth=2)
    elif kind == "enospc":
        plan.enospc("db:log", nth=2)
    elif kind == "fsynclie":
        plan.fsync_lie("db:log")
    else:
        plan.bit_flip("db:log", nth=2)
    fio.install(plan)
    seen = []
    f = fio.open_file(p, "wb", label="db:log")
    for i, chunk in enumerate((b"a" * 37, b"b" * 51, b"c" * 23)):
        try:
            f.write(chunk)
            seen.append("ok")
        except (fio.InjectedCrash, fio.InjectedFault) as e:
            seen.append(type(e).__name__)
        if i == 0:
            fio.fsync(f)
    f.close()
    if kind == "bitflip":
        with open(p, "wb") as g:
            g.write(bytes(range(64)))
        f = fio.open_file(p, "rb", label="db:log")
        seen += [f.read(16).hex() for _ in range(3)]
        f.close()
    crash = plan.apply_crash()
    fio.reset()
    return (seen, [e[1:4] + (e[4],) for e in plan.events], _read(p),
            [n for _p, n in crash])


@pytest.mark.parametrize("kind", ["torn", "enospc", "fsynclie", "bitflip"])
def test_faultio_plans_act_the_same(tmp_path, kind):
    seed = int(np.random.default_rng(SEED).integers(1 << 30))
    dj, dp = tmp_path / "j", tmp_path / "p"
    dj.mkdir()
    dp.mkdir()
    rj = _faultio_run(jfio, str(dj), kind, seed)
    rp = _faultio_run(pfio, str(dp), kind, seed)
    strip = (lambda r: (r[0], [(k, lab, det) for k, lab, _path, det in r[1]],
                        r[2], r[3]))
    assert strip(rj) == strip(rp)
    assert rp[1], "the plan fired nothing"
    # no plan installed: the raw file, in both
    f = pfio.open_file(str(dp / "g"), "wb", label="db:log")
    assert not isinstance(f, pfio.FaultFile)
    f.close()


def _wal_msgs(w, seed):
    from cometbft_tpu_torch.types.block import BlockID, PartSetHeader
    from cometbft_tpu_torch.types.proto import Timestamp
    from cometbft_tpu_torch.types.vote import Proposal, Vote
    rng = np.random.default_rng(seed)
    msgs = [w.EndHeightMessage(0)]
    for h in range(1, 5):
        bid = BlockID(rng.bytes(32), PartSetHeader(1, rng.bytes(32)))
        ts = Timestamp(1_700_000_000 + h, int(rng.integers(10 ** 9)))
        msgs.append(w.WALProposal(Proposal(height=h, round=0, pol_round=-1,
                                           block_id=bid, timestamp=ts,
                                           signature=rng.bytes(64))))
        msgs.append(w.WALBlockPart(h, 0, 0, rng.bytes(int(rng.integers(
            1, 300)))))
        for i in range(3):
            msgs.append(w.WALVote(Vote(
                type_=2, height=h, round=0, block_id=bid, timestamp=ts,
                validator_address=rng.bytes(20), validator_index=i,
                signature=rng.bytes(64))))
        msgs.append(w.WALTimeout(h, 0, 3, int(rng.integers(1, 2000))))
        msgs.append(w.EndHeightMessage(h))
    return msgs


def _as_port(msgs):
    return [pwal.encode_message(m) for m in msgs]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_wal_written_by_either_package_reads_in_the_other(tmp_path, writer):
    ww, rw = (jwal, pwal) if writer == "jax" else (pwal, jwal)
    msgs = _wal_msgs(pwal, SEED + 3)
    path = str(tmp_path / "wal")
    w = ww.WAL(path, head_size_limit=600)      # several rotated files
    for m in msgs:
        enc = pwal.encode_message(m)
        m2 = ww.decode_message(enc)
        (w.write_sync if isinstance(m2, ww.EndHeightMessage)
         else w.write)(m2)
    w.close()
    assert len(w._rotated()) >= 2
    r = rw.WAL(path, head_size_limit=600)
    got = list(r.iter_messages())
    assert [type(g).__name__ for g in got] == \
        [type(m).__name__ for m in msgs]
    enc = (rw.encode_message if rw is pwal else jwal.encode_message)
    assert [enc(g) for g in got] == _as_port(msgs)
    ends = [g.height for g in got if isinstance(g, rw.EndHeightMessage)]
    assert ends == [0, 1, 2, 3, 4]
    assert [enc(g) for g in r.replay_messages(3)] == _as_port(msgs[-7:])
    r.close()
    assert jrec.scan_wal_end_height(jwal.WAL(path)) == \
        prec.scan_wal_end_height(pwal.WAL(path)) == 4


def _jax_stores(d, n=5, apply_upto=None):
    """n blocks of a 4-validator chain in FileDB stores under d, written
    by the JAX package; the first apply_upto applied."""
    from cometbft_tpu.abci.kvstore import KVStoreApplication
    from cometbft_tpu.engine.chain_gen import generate_chain
    from cometbft_tpu.state.execution import BlockExecutor
    from cometbft_tpu.state.state import State, StateStore
    from cometbft_tpu.store.blockstore import BlockStore
    apply_upto = n if apply_upto is None else apply_upto
    chain = generate_chain(n, n_validators=4, txs_per_block=1, seed=SEED)
    app = KVStoreApplication()
    app.init_chain(chain.chain_id, 1, [], b"")
    bdb = jkv.open_db("filedb", "blockstore", d)
    sdb = jkv.open_db("filedb", "state", d)
    bs, ss = BlockStore(bdb), StateStore(sdb)
    ex = BlockExecutor(app, state_store=ss, block_store=bs)
    st = State.from_genesis(chain.genesis)
    ss.save(st)
    for h in range(1, n + 1):
        bs.save_block(chain.blocks[h - 1],
                      chain.blocks[h - 1].make_part_set(),
                      chain.seen_commits[h - 1])
        if h <= apply_upto:
            st, _ = ex.apply_block(st, chain.block_ids[h - 1],
                                   chain.blocks[h - 1], verified=True)
    bdb.close()
    sdb.close()
    return chain


def _damage(d, case, chain):
    """The same damage, through the JAX package, to a copy of the
    stores; returns the extra doctor arguments."""
    from cometbft_tpu.state.state import State, StateStore
    from cometbft_tpu.store.blockstore import BlockStore
    kw = {}
    if case == "meta-without-parts":
        db = jkv.FileDB(os.path.join(d, "blockstore.db"))
        torn = [k for k, _ in db.iterate(b"P:", b"P;")
                if int.from_bytes(k[2:10], "big") == 5]
        db.write_batch([], torn)
        db.close()
    elif case == "orphaned-adopted-seal":
        db = jkv.FileDB(os.path.join(d, "blockstore.db"))
        BlockStore(db).save_adopted_seal(
            5, chain.block_ids[4], chain.blocks[4].header,
            chain.seen_commits[4])
        db.close()
    elif case == "state-behind":
        db = jkv.FileDB(os.path.join(d, "state.db"))
        StateStore(db).save(State.from_genesis(chain.genesis))
        db.close()
    elif case == "litter":
        open(os.path.join(d, "blockstore.db.x.compact"), "wb").close()
        open(os.path.join(d, "pv_state.json.tmp"), "wb").close()
        kw["pv_state_path"] = os.path.join(d, "pv_state.json")
    elif case == "wal-ahead":
        w = jwal.WAL(os.path.join(d, "wal", "wal"))
        w.write_sync(jwal.EndHeightMessage(9))
        w.close()
    elif case == "torn-tail":
        with open(os.path.join(d, "blockstore.db"), "ab") as f:
            f.write(jkv._enc2(jkv._REC_SET2, b"lost", b"batch"))
    return kw


def _doctor(pkg, d, kw):
    if pkg == "jax":
        from cometbft_tpu.state.state import StateStore
        from cometbft_tpu.store.blockstore import BlockStore
        kv, wal, rec = jkv, jwal, jrec
    else:
        from cometbft_tpu_torch.state.state import StateStore
        from cometbft_tpu_torch.store.blockstore import BlockStore
        kv, wal, rec = pkv, pwal, prec
    d2 = d + "-" + pkg
    shutil.copytree(d, d2)
    kw = {k: v.replace(d, d2) for k, v in kw.items()}
    bdb = kv.open_db("filedb", "blockstore", d2)
    sdb = kv.open_db("filedb", "state", d2)
    w = wal.WAL(os.path.join(d2, "wal", "wal"))
    try:
        rep = rec.run_doctor(block_store=BlockStore(bdb),
                             state_store=StateStore(sdb), wal=w,
                             db_dir=d2, **kw)
        out = ("report", rep.repairs, rep.wal_end_height,
               rep.block_height, rep.state_height)
    except rec.RecoveryError as e:
        out = ("error", str(e))
    finally:
        w.close()
        bdb.close()
        sdb.close()
    return out, sorted(os.listdir(d2))


@pytest.fixture(scope="module")
def jax_stores(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("stores") / "clean")
    chain = _jax_stores(d, apply_upto=4)
    return d, chain


@pytest.mark.parametrize("case", [
    "clean", "meta-without-parts", "orphaned-adopted-seal", "state-behind",
    "litter", "wal-ahead", "torn-tail"])
def test_doctor_same_report_on_same_damaged_stores(tmp_path, jax_stores,
                                                    case):
    src, chain = jax_stores
    d = str(tmp_path / case)
    shutil.copytree(src, d)
    kw = _damage(d, case, chain)
    rj, filesj = _doctor("jax", d, kw)
    rp, filesp = _doctor("port", d, kw)
    assert rj == rp
    assert filesj == filesp
    want = {"clean": "report", "meta-without-parts": "report",
            "orphaned-adopted-seal": "report", "state-behind": "error",
            "litter": "report", "wal-ahead": "error",
            "torn-tail": "report"}[case]
    assert rp[0] == want, rp
    if case in ("meta-without-parts", "orphaned-adopted-seal"):
        assert [k for k, _ in rp[1]] == [case]
    if case == "litter":
        assert sorted(k for k, _ in rp[1]) == ["stale-compact",
                                               "stale-pv-tmp"]


def test_storage_metrics_latch_counts_in_the_port(tmp_path):
    from cometbft_tpu_torch.libs.metrics import Registry
    from cometbft_tpu_torch.libs.metrics_gen import StorageMetrics
    old = prec.metrics()
    m = StorageMetrics(Registry())
    prec.set_metrics(m)
    try:
        p = str(tmp_path / "x.db")
        db = pkv.FileDB(p)
        db.write_batch([(b"good", b"data")])
        db.close()
        with open(p, "ab") as f:
            f.write(pkv._enc2(pkv._REC_SET2, b"lost", b"batch"))
        pkv.FileDB(p).close()
        raw = bytearray(_read(p))
        raw[pkv._V2_HDR.size + 2] ^= 0x10
        with open(p, "wb") as f:
            f.write(raw)
        pkv.FileDB(p).close()
        prec.run_doctor(db_dir=str(tmp_path))
        # the uncommitted tail, then the CRC-bad record (which ends the
        # replay before any record is pending)
        assert m.torn_batches.value() == 1
        assert m.crc_failures.value() == 1
        assert m.doctor_runs.value() == 1
    finally:
        prec.set_metrics(old)
