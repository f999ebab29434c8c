"""The port's event query language, pubsub, event bus, kv indexers and
pruner (`cometbft_tpu_torch/{pubsub,indexer,state/pruner.py}`), held
against the JAX package on the CPU:

- every query of a corpus, valid or not, parses to the same conditions
  or fails with the same message, and each valid one gives the same
  match verdicts on a corpus of event sets;
- a 6-block, 4-validator chain with txs (the port's `generate_chain`),
  applied through each package's `BlockExecutor` with an `EventBus`,
  publishes the same events (kinds and attributes, in order);
- the live `IndexerService` of each package leaves identical MemDB
  key/value items, and so does each package's `reindex_block` over the
  saved responses (a subset of the live items), and `tx_search` / `block_search` (the RPC routes over
  those indexes) give the same answers and pages;
- the pruner leaves the same bases, stores and index items on each
  package's copy of the same stores.

Results are parse trees, verdicts, bytes and JSON: no tolerance.
"""

import pytest

from _torch_node import mod, port_chain

SIDES = ("jax", "port")

QUERIES = [
    "tm.event = 'NewBlock'",
    "tm.event = 'Tx' AND tx.height > 5",
    "tx.height >= 2 AND tx.height <= 4",
    "tx.height < 3",
    "tx.hash = 'ABCDEF'",
    "app.key CONTAINS 'k3'",
    "app.key EXISTS",
    "block.height = 3",
    "a.b = 'it\\'s'",
    "x.y = 1.5 AND x.z = -2",
    "x.y = 2023-01-01",
    "  tm.event='Vote'  ",
    "tx.height>1 AND tx.height<10 AND app.key EXISTS",
    # invalid
    "",
    "   ",
    "tm.event",
    "tm.event =",
    "= 'x'",
    "tm.event = 'a' OR tm.event = 'b'",
    "tm.event = 'a' AND",
    "tm.event == 'a'",
    "tm.event = 'unterminated",
    "tx.height > 5 tx.height < 9",
    "AND tx.height > 1",
    "tx.height EXISTS 5",
    "tm.event ! 'x'",
]

EVENT_SETS = [
    {"tm.event": ["NewBlock"], "block.height": ["3"]},
    {"tm.event": ["Tx"], "tx.height": ["6"], "tx.hash": ["ABCDEF"],
     "app.key": ["k3-1"]},
    {"tm.event": ["Tx"], "tx.height": ["2"], "app.key": ["k2-0", "k3"]},
    {"tm.event": ["Vote"]},
    {"a.b": ["it's"], "x.y": ["1.5"], "x.z": ["-2"]},
    {"x.y": ["2023-01-01"], "tx.height": ["9"]},
    {},
]


def _parse(side: str, text: str):
    query = mod(side, "pubsub.query")
    try:
        q = query.Query(text)
    except query.QueryError as e:
        return ("error", str(e))
    return ("ok", [(c.tag, c.op, c.operand) for c in q.conditions])


@pytest.mark.parametrize("text", QUERIES)
def test_query_parse_parity(text):
    assert _parse("jax", text) == _parse("port", text)


@pytest.mark.parametrize("text", [q for q in QUERIES
                                  if _parse("jax", q)[0] == "ok"])
def test_query_match_parity(text):
    verdicts = {side: [mod(side, "pubsub.query").Query(text).matches(ev)
                       for ev in EVENT_SETS] for side in SIDES}
    assert verdicts["jax"] == verdicts["port"]


def test_pubsub_subscription_semantics():
    """Subscribe, drop-oldest on a full buffer, unsubscribe: the same
    deliveries and the same drop counts in both packages."""
    out = {}
    for side in SIDES:
        ps = mod(side, "pubsub.pubsub")
        q = mod(side, "pubsub.query").Query("tm.event = 'Tx'")
        srv = ps.PubSubServer()
        sub = srv.subscribe("s", q, 2)
        for i in range(4):
            srv.publish(i, {"tm.event": ["Tx"]})
        srv.publish(9, {"tm.event": ["NewBlock"]})
        got = []
        while True:
            m = sub.next(timeout=0)
            if m is None:
                break
            got.append(m)
        srv.unsubscribe_all("s")
        srv.publish(5, {"tm.event": ["Tx"]})
        out[side] = (got, getattr(sub, "dropped", None),
                     srv.num_subscriptions(), sub.next(timeout=0))
    assert out["jax"] == out["port"]


@pytest.fixture(scope="module")
def chain():
    return port_chain(6, n_validators=4, seed=3, txs_per_block=3)


def _run(side: str, chain, live_index: bool = True):
    """Applies the chain through `side`'s executor with an EventBus, a
    live IndexerService and a subscription to every event -> dict of the
    stores, indexers, events and reindexed items."""
    kv = mod(side, "db.kv")
    sstate = mod(side, "state.state")
    blockstore = mod(side, "store.blockstore")
    execution = mod(side, "state.execution")
    kvstore = mod(side, "abci.kvstore")
    events = mod(side, "pubsub.events")
    indexer = mod(side, "indexer.kv")
    query = mod(side, "pubsub.query")
    block = mod(side, "types.block")
    app_mod = mod(side, "abci.application")
    bus = events.EventBus()
    sub = bus.subscribe("all", query.Query("tm.event EXISTS"), 10_000)
    idx_db = kv.MemDB()
    txi, bli = indexer.TxIndexer(idx_db), indexer.BlockIndexer(idx_db)
    service = indexer.IndexerService(txi, bli, bus)
    if live_index:
        service.start()
    bs = blockstore.BlockStore(kv.MemDB())
    ss = sstate.StateStore(kv.MemDB())
    app = kvstore.KVStoreApplication()
    app.init_chain(chain.chain_id, 1, [], b"")
    ex = execution.BlockExecutor(app, state_store=ss, block_store=bs,
                                 event_bus=bus,
                                 **({"device": "cpu"} if side == "port"
                                    else {}))
    state = sstate.State.from_genesis(_genesis(side, chain))
    ss.save(state)
    for h in range(1, chain.max_height() + 1):
        b = block.Block.decode(chain.blocks[h - 1].encode())
        parts = b.make_part_set()
        bs.save_block(b, parts, block.Commit.decode(
            chain.seen_commits[h - 1].encode()))
        state, _ = ex.apply_block(state, block.BlockID(b.hash(),
                                                       parts.header),
                                  b, verified=True)
    seen = []
    while True:
        got = sub.next(timeout=0)
        if got is None:
            break
        ev, attrs = got
        seen.append((ev.kind, attrs))
    if live_index:
        # the service's threads index from their own subscriptions
        import time
        want = sum(len(b.data.txs) for b in chain.blocks)
        deadline = time.monotonic() + 30
        while len(list(idx_db.iterate(b"", None))) < want \
                or not bli.search(query.Query(
                    f"block.height = {chain.max_height()}")):
            assert time.monotonic() < deadline, "indexer never caught up"
            time.sleep(0.02)
        time.sleep(0.1)
        service.stop()
    re_db = kv.MemDB()
    rtx, rbl = indexer.TxIndexer(re_db), indexer.BlockIndexer(re_db)
    for h in range(1, chain.max_height() + 1):
        indexer.reindex_block(rtx, rbl, bs.load_block(h),
                              app_mod.ResponseFinalizeBlock.decode(
                                  ss.load_finalize_block_response(h)))
    return dict(bs=bs, ss=ss, txi=txi, bli=bli, idx_db=idx_db,
                events=seen, reindexed=list(re_db.iterate(b"", None)),
                state=state)


def _genesis(side: str, chain):
    keys = mod(side, "crypto.keys")
    validator = mod(side, "types.validator")
    return mod(side, "state.state").GenesisDoc(
        chain_id=chain.genesis.chain_id,
        genesis_time=chain.genesis.genesis_time,
        validators=[validator.Validator(keys.pubkey_from_type_bytes(
            v.pub_key.type_(), v.pub_key.bytes_()), v.voting_power)
            for v in chain.genesis.validators])


@pytest.fixture(scope="module")
def runs(chain):
    return {side: _run(side, chain) for side in SIDES}


def test_event_bus_events_match(runs, chain):
    assert runs["jax"]["events"] == runs["port"]["events"]
    kinds = [k for k, _ in runs["port"]["events"]]
    assert kinds.count("NewBlock") == chain.max_height()
    assert kinds.count("Tx") == sum(len(b.data.txs) for b in chain.blocks)


def test_indexer_items_match_and_equal_the_reindex(runs):
    live = {side: list(runs[side]["idx_db"].iterate(b"", None))
            for side in SIDES}
    assert live["jax"] == live["port"]
    assert runs["jax"]["reindexed"] == runs["port"]["reindexed"]
    # the live block postings also carry tm.event; every reindexed item
    # is a live one
    assert set(runs["port"]["reindexed"]) <= set(live["port"])
    assert runs["jax"]["state"].app_hash == runs["port"]["state"].app_hash


SEARCHES = [
    ("tx_search", {"query": "tx.height > 2"}),
    ("tx_search", {"query": "tx.height >= 2 AND tx.height <= 4",
                   "per_page": 2, "page": 2}),
    ("tx_search", {"query": "tx.height > 0", "order_by": "desc",
                   "per_page": 4, "page": 3}),
    ("tx_search", {"query": "tx.height > 0", "per_page": 5, "page": 9}),
    ("tx_search", {"query": "app.key EXISTS", "prove": True,
                   "per_page": 3}),
    ("tx_search", {"query": "tx.height = 99"}),
    ("tx_search", {"query": "tx.height >"}),
    ("block_search", {"query": "block.height > 3"}),
    ("block_search", {"query": "block.height >= 1", "per_page": 2,
                      "page": 2, "order_by": "desc"}),
    ("block_search", {"query": "block.height = 7"}),
]


def _answer(side: str, run, route: str, params: dict):
    server = mod(side, "rpc.server")
    env = server.RPCEnvironment(chain_id="c", block_store=run["bs"],
                                state_store=run["ss"],
                                tx_indexer=run["txi"],
                                block_indexer=run["bli"])
    try:
        return ("ok", getattr(server.Routes(env), route)(**params))
    except server.RPCError as e:
        return ("error", e.code, e.message)
    except Exception as e:  # noqa: BLE001 — compared across packages
        return ("raised", type(e).__name__, str(e))


@pytest.mark.parametrize("case", range(len(SEARCHES)))
def test_search_answers_and_pages_match(runs, case):
    route, params = SEARCHES[case]
    assert _answer("jax", runs["jax"], route, params) == \
        _answer("port", runs["port"], route, params)


PRUNES = {
    "app_retain_4": {"retain": 4},
    "companion_3_results_5": {"companion": 3, "results": 5},
    "indexers_3_and_5": {"tx_index": 3, "block_index": 5},
    "all": {"retain": 2, "companion": 5, "results": 4, "tx_index": 6,
            "block_index": 2},
}


@pytest.mark.parametrize("case", sorted(PRUNES))
def test_pruner_leaves_the_same_bases(chain, case):
    out = {}
    for side in SIDES:
        run = _run(side, chain, live_index=False)
        # the reindexed items become the live index of this copy
        idx = mod(side, "db.kv").MemDB()
        idx.write_batch(run["reindexed"])
        indexer = mod(side, "indexer.kv")
        txi, bli = indexer.TxIndexer(idx), indexer.BlockIndexer(idx)
        pruner = mod(side, "state.pruner").Pruner(
            run["bs"], run["ss"], tx_indexer=txi, block_indexer=bli)
        p = PRUNES[case]
        if "retain" in p:
            pruner.set_retain_height(p["retain"])
        if "companion" in p:
            pruner.set_companion_block_retain_height(p["companion"])
        if "results" in p:
            pruner.set_block_results_retain_height(p["results"])
        if "tx_index" in p:
            pruner.set_tx_indexer_retain_height(p["tx_index"])
        if "block_index" in p:
            pruner.set_block_indexer_retain_height(p["block_index"])
        pruned = pruner.prune_now()
        out[side] = (pruned, run["bs"].base(), run["bs"].height(),
                     pruner.retain_heights(),
                     list(run["bs"]._db.iterate(b"", None)),
                     list(run["ss"]._db.iterate(b"", None)),
                     list(idx.iterate(b"", None)))
    assert out["jax"] == out["port"]
