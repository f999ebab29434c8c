"""Scripted consensus for the port's tests, built the same way with either
package: seeded FilePVs and a genesis over them, in-memory nodes (kvstore
app, stores, mempool, evidence pool, executor, `ConsensusState` on a
`ManualTicker`), and a fabric that delivers every message in one FIFO order
through `handle_msg`, on one thread.

Time is a step clock installed in both packages' `libs/timesource`: it
moves 1 ms for each delivery and stands still inside one, so two runs that
deliver the same messages in the same order stamp the same times. When the
queue and the inboxes are empty, every node's pending timeout fires, in
node order. With `wire=True` a message travels as the sender's
`encode_consensus_msg` bytes and the receiver decodes it with its own
package (a cluster that mixes the packages).
"""

import importlib
import os
import random
from collections import deque
from types import SimpleNamespace

PKGS = {"jax": "cometbft_tpu", "port": "cometbft_tpu_torch"}
MODULES = ("abci.kvstore", "consensus.state", "consensus.ticker",
           "consensus.reactor", "consensus.wal", "db.kv", "evidence.pool",
           "mempool.mempool", "privval.file", "state.execution",
           "state.state", "store.blockstore", "types.validator",
           "types.proto", "types.vote", "types.block", "libs.timesource",
           "crypto.keys", "pipeline.cache", "types.vote_set", "libs.bits",
           "types.evidence", "types.extended_commit")
CHAIN_ID = "tpu-cluster"
BASE_NS = 1_700_000_000 * 10**9


def side(name: str) -> SimpleNamespace:
    """The package's modules by their last name (`s.state` is
    consensus.state, `s.sstate` is state.state)."""
    ns = SimpleNamespace(name=name)
    for mod in MODULES:
        m = importlib.import_module(f"{PKGS[name]}.{mod}")
        key = mod.split(".")[-1]
        if mod == "state.state":
            key = "sstate"
        setattr(ns, key, m)
    return ns


def dev(s) -> dict:
    """The port's entry points run on the card unless told the CPU."""
    return {"device": "cpu"} if s.name == "port" else {}


class StepClock:
    def __init__(self, ns: int = BASE_NS):
        self.ns = ns

    def __call__(self) -> int:
        return self.ns

    def tick(self) -> None:
        self.ns += 1_000_000


def install_clock(clock) -> None:
    for name in PKGS:
        side(name).timesource.install(clock)


def reset_clock() -> None:
    for name in PKGS:
        side(name).timesource.reset()


def make_genesis(s, n_vals: int, seed: int = 42, power: int = 10):
    """n FilePVs + a GenesisDoc giving each equal power, sorted by
    address (tests/cluster.py's, for either package)."""
    rng = random.Random(seed)
    pvs = [s.file.FilePV.generate(None, rng) for _ in range(n_vals)]
    vals = [s.validator.Validator(pv.get_pub_key(), power) for pv in pvs]
    order = sorted(range(n_vals), key=lambda i: vals[i].address)
    gen = s.sstate.GenesisDoc(chain_id=CHAIN_ID,
                              genesis_time=s.proto.Timestamp.now(),
                              validators=[vals[i] for i in order])
    return [pvs[i] for i in order], gen


def fast_config(s):
    return s.state.ConsensusConfig(
        timeout_propose=400, timeout_propose_delta=200,
        timeout_prevote=200, timeout_prevote_delta=100,
        timeout_precommit=200, timeout_precommit_delta=100,
        timeout_commit=40)


class Node:
    def __init__(self, s, gen, pv, wal_path=None, name="", txs=()):
        self.s = s
        self.app = s.kvstore.KVStoreApplication()
        self.app.init_chain(gen.chain_id, gen.initial_height,
                            gen.validators, gen.app_state)
        self.block_store = s.blockstore.BlockStore(s.kv.MemDB())
        self.state_store = s.sstate.StateStore(s.kv.MemDB())
        self.mempool = s.mempool.CListMempool(
            lambda tx: (self.app.check_tx(tx).code, 0))
        for tx in txs:
            self.mempool.check_tx(tx)
        self.evidence_pool = s.pool.EvidencePool(
            state_store=self.state_store, block_store=self.block_store,
            **dev(s))
        state = s.sstate.State.from_genesis(gen)
        self.state_store.save(state)
        self.executor = s.execution.BlockExecutor(
            self.app, state_store=self.state_store,
            block_store=self.block_store, mempool=self.mempool,
            evidence_pool=self.evidence_pool, **dev(s))
        self.wal = s.wal.WAL(wal_path) if wal_path else None
        self.cs = s.state.ConsensusState(
            fast_config(s), state, self.executor, self.block_store,
            priv_validator=pv, wal=self.wal,
            ticker_cls=s.ticker.ManualTicker, name=name, **dev(s))
        self.cs.evidence_pool = self.evidence_pool
        self.commits = []
        self.cs.on_commit = lambda b, c: self.commits.append((b, c))

    def begin(self) -> None:
        """`ConsensusState.start` without its thread: WAL replay, then
        the first height's NewHeight timeout."""
        cs = self.cs
        cs.catchup_replay()
        cs.ticker.schedule(self.s.ticker.TimeoutInfo(
            0, cs.rs.height, 0, self.s.state.STEP_NEW_HEIGHT))

    def drain_inbox(self, clock) -> bool:
        moved = False
        while not self.cs.inbox.empty():
            item = self.cs.inbox.get_nowait()
            clock.tick()
            if isinstance(item, tuple):
                self.cs.handle_msg(*item)
            else:
                self.cs.handle_msg(item)
            moved = True
        return moved

    def close(self) -> None:
        if self.wal is not None:
            self.wal.close()


class Fabric:
    """One FIFO of (dst, src, message) over `nodes`; `down` nodes send,
    receive and time out nothing."""

    def __init__(self, nodes, clock, wire=False, down=()):
        self.nodes, self.clock, self.wire = nodes, clock, wire
        self.down = set(down)
        self.q = deque()
        self.delivered = 0
        for i, n in enumerate(nodes):
            n.cs.broadcast = self._broadcaster(i)

    def _broadcaster(self, src):
        def broadcast(msg):
            if src in self.down:
                return
            item = msg
            if self.wire:
                _ch, item = self.nodes[src].s.reactor.encode_consensus_msg(
                    msg)
            for j in range(len(self.nodes)):
                if j != src and j not in self.down:
                    self.q.append((j, src, item))
        return broadcast

    def step(self) -> bool:
        if self.q:
            j, src, item = self.q.popleft()
            node = self.nodes[j]
            msg = node.s.reactor.decode_consensus_msg(item) \
                if self.wire else item
            self.clock.tick()
            self.delivered += 1
            node.cs.handle_msg(msg, f"node{src}")
            return True
        live = [n for i, n in enumerate(self.nodes) if i not in self.down]
        if any([n.drain_inbox(self.clock) for n in live]):
            return True
        fired = False
        for n in live:
            if n.cs.ticker.has_pending():
                self.clock.tick()
                n.cs.ticker.fire_pending()
                fired = True
        return fired

    def run(self, height: int, max_steps: int = 20000) -> None:
        """Until every live node has committed `height`."""
        for i, n in enumerate(self.nodes):
            if i not in self.down:
                n.begin()
        for _ in range(max_steps):
            if all(n.cs.state.last_block_height >= height
                   for i, n in enumerate(self.nodes) if i not in self.down):
                return
            if not self.step():
                break
        raise AssertionError(
            "scripted run stuck at "
            f"{[n.cs.state.last_block_height for n in self.nodes]}")


def cluster(name: str, n_vals: int, tmp=None, txs=(), seed: int = 42,
            names=None):
    """n nodes over one genesis; `names` picks each node's package
    (default all `name`); `tmp` gives each a WAL under it."""
    s = side(name)
    pvs, gen = make_genesis(s, n_vals, seed)
    nodes = []
    for i, pv in enumerate(pvs):
        ns = side(names[i]) if names else s
        if ns.name != s.name:
            # the same validator keys and genesis, in the node's package
            pv = ns.file.FilePV(ns.keys.Ed25519PrivKey(pv.priv_key.seed),
                                None)
            ngen = ns.sstate.GenesisDoc(
                chain_id=gen.chain_id, genesis_time=ns.proto.Timestamp(
                    gen.genesis_time.seconds, gen.genesis_time.nanos),
                validators=[ns.validator.Validator(
                    ns.keys.Ed25519PubKey(v.pub_key.bytes_()),
                    v.voting_power) for v in gen.validators])
        else:
            ngen = gen
        wal = os.path.join(tmp, f"wal{i}", "wal") if tmp else None
        if wal:
            os.makedirs(os.path.dirname(wal), exist_ok=True)
        nodes.append(Node(ns, ngen, pv, wal, name=str(i), txs=txs))
    return nodes


def wal_bytes(path: str) -> bytes:
    """Every file of a WAL group, in name order, concatenated."""
    d = os.path.dirname(path)
    out = b""
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f), "rb") as fh:
            out += fh.read()
    return out
