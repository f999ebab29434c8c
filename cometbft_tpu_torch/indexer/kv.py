"""KV tx/block indexers + the indexer service
(reference state/txindex/kv/kv.go, state/indexer/block/kv/,
state/txindex/indexer_service.go).

TxIndexer: primary record under tx hash + secondary postings per event
attribute (composite-key = value @ height) supporting the pubsub query
language over historical txs. BlockIndexer: postings for block events by
height. IndexerService subscribes both to the event bus.

Copy of `cometbft_tpu/indexer/kv.py` in the port.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

from ..pubsub.events import EventBus, QUERY_NEW_BLOCK, QUERY_TX
from ..pubsub.query import Query
from ..types import proto

_PK = b"tx:"          # tx hash -> record
_POST = b"post:"      # composite-key posting list
_BLK = b"bpost:"      # block-event postings


def _posting_key(tag: bytes, value: bytes, height: int,
                 suffix: bytes) -> bytes:
    # value is hex-encoded: app-controlled attribute values may contain
    # the NUL separator themselves
    return (_POST + tag + b"\x00" + value.hex().encode() + b"\x00"
            + height.to_bytes(8, "big") + b"\x00" + suffix)


def _posting_height(key: bytes, prefix: bytes) -> int:
    """Height embedded in a posting key: tag \\0 value_hex \\0 height8
    \\0 suffix after `prefix`. Tag and the hex value contain no NULs;
    the 8-byte big-endian height may, so it is parsed positionally."""
    rest = key[len(prefix):]
    _tag, _, rest = rest.partition(b"\x00")
    _val, _, tail = rest.partition(b"\x00")
    return int.from_bytes(tail[:8], "big")


class TxIndexer:
    """reference state/txindex/kv/kv.go TxIndex."""

    def __init__(self, db):
        self._db = db
        self._lock = threading.Lock()

    def index(self, height: int, index: int, tx: bytes, result,
              events: Dict[str, List[str]]) -> None:
        from ..types.block import tx_hash
        txh = tx_hash(tx)
        rec = (proto.f_varint(1, height)
               + proto.f_varint(2, index)
               + proto.f_bytes(3, tx)
               + proto.f_varint(4, getattr(result, "code", 0)))
        sets = [(_PK + txh, rec)]
        for tag, values in events.items():
            for v in values:
                sets.append((_posting_key(tag.encode(),
                                          str(v).encode(),
                                          height, txh), b""))
        with self._lock:
            self._db.write_batch(sets)

    def get(self, tx_hash: bytes) -> Optional[Tuple[int, int, bytes, int]]:
        raw = self._db.get(_PK + tx_hash)
        if raw is None:
            return None
        f = proto.parse_fields(raw)
        return (proto.field_int(f, 1, 0), proto.field_int(f, 2, 0),
                proto.field_bytes(f, 3, b""), proto.field_int(f, 4, 0))

    def search(self, query: Query, limit: int = 100) -> List[bytes]:
        """Return tx hashes matching ALL conditions (intersection over
        posting scans — the reference's kv.go Search shape), in
        deterministic (height, idx) chain order: which hashes survive
        `limit` must not depend on set iteration order."""
        result: Optional[set] = None
        for cond in query.conditions:
            matches = self._scan_condition(cond)
            result = matches if result is None else (result & matches)
            if not result:
                return []
        if not result:
            return []

        def chain_pos(txh: bytes):
            rec = self.get(txh)
            if rec is None:
                return (1 << 62, 0, txh)
            return (rec[0], rec[1], txh)
        return sorted(result, key=chain_pos)[:limit]

    def prune(self, retain_height: int) -> int:
        """Delete tx records and postings below retain_height
        (reference state/txindex/kv Prune, driven by the pruning
        companion API). Heights sit mid-key in postings, so this is a
        full scan — it runs from the privileged pruning service, not a
        hot path."""
        deletes = []
        for k, v in self._db.iterate(_PK, _PK + b"\xff" * 32):
            f = proto.parse_fields(v)
            if proto.field_int(f, 1, 0) < retain_height:
                deletes.append(k)
        for k, _v in self._db.iterate(_POST, _POST + b"\xff" * 8):
            if _posting_height(k, _POST) < retain_height:
                deletes.append(k)
        with self._lock:
            if deletes:
                self._db.write_batch([], deletes)
        return len(deletes)

    def _scan_condition(self, cond) -> set:
        tag = cond.tag.encode()
        out = set()
        prefix = _POST + tag + b"\x00"
        for k, _v in self._db.iterate(prefix, prefix + b"\xff" * 8):
            rest = k[len(prefix):]
            value_hex, _, tail = rest.partition(b"\x00")
            height = int.from_bytes(tail[:8], "big")
            txh = tail[9:]
            value = bytes.fromhex(value_hex.decode())
            ev = {cond.tag: [value.decode(errors="replace")],
                  "tx.height": [str(height)]}
            if Query._match_one(cond, ev):
                out.add(txh)
        return out


class BlockIndexer:
    """reference state/indexer/block/kv: block-level event postings."""

    def __init__(self, db):
        self._db = db

    def index(self, height: int, events: Dict[str, List[str]]) -> None:
        sets = []
        for tag, values in events.items():
            for v in values:
                sets.append((_BLK + tag.encode() + b"\x00"
                             + str(v).encode().hex().encode()
                             + b"\x00" + height.to_bytes(8, "big"), b""))
        self._db.write_batch(sets)

    def prune(self, retain_height: int) -> int:
        """Delete block-event postings below retain_height (reference
        state/indexer/block/kv Prune)."""
        deletes = []
        for k, _v in self._db.iterate(_BLK, _BLK + b"\xff" * 8):
            if _posting_height(k, _BLK) < retain_height:
                deletes.append(k)
        if deletes:
            self._db.write_batch([], deletes)
        return len(deletes)

    def search(self, query: Query, limit: int = 100) -> List[int]:
        result: Optional[set] = None
        for cond in query.conditions:
            tag = cond.tag.encode()
            prefix = _BLK + tag + b"\x00"
            matches = set()
            for k, _v in self._db.iterate(prefix, prefix + b"\xff" * 8):
                rest = k[len(prefix):]
                value_hex, _, tail = rest.partition(b"\x00")
                height = int.from_bytes(tail[:8], "big")
                value = bytes.fromhex(value_hex.decode())
                ev = {cond.tag: [value.decode(errors="replace")]}
                if Query._match_one(cond, ev):
                    matches.add(height)
            result = matches if result is None else (result & matches)
            if not result:
                return []
        return sorted(result)[:limit] if result else []


def reindex_block(tx_indexer: "TxIndexer",
                  block_indexer: "BlockIndexer", block, resp) -> int:
    """Re-derive index postings for one stored block from its saved
    FinalizeBlockResponse (reference cmd reindex_event.go) — the same
    composite-key attrs the live bus path produces
    (pubsub/events.py publish_tx / publish_new_block). Returns the
    number of txs indexed."""
    from ..pubsub.events import tx_event_attrs
    height = block.header.height
    block_indexer.index(height, {"block.height": [str(height)]})
    for i, tx in enumerate(block.data.txs):
        result = resp.tx_results[i]
        tx_indexer.index(height, i, tx, result,
                         tx_event_attrs(height, tx, result))
    return len(block.data.txs)


class IndexerService:
    """reference state/txindex/indexer_service.go: subscribes to the
    event bus and indexes everything as it commits."""

    def __init__(self, tx_indexer: TxIndexer, block_indexer: BlockIndexer,
                 event_bus: EventBus):
        self.tx_indexer = tx_indexer
        self.block_indexer = block_indexer
        self.bus = event_bus
        self._threads = []
        self._stop = threading.Event()

    def start(self) -> None:
        # deep buffers: these events are not retried — a blocksync burst
        # must not evict unindexed txs (pubsub drops oldest when full)
        tx_sub = self.bus.server.subscribe("indexer", QUERY_TX,
                                           buffer=100_000)
        blk_sub = self.bus.server.subscribe("indexer", QUERY_NEW_BLOCK,
                                            buffer=10_000)

        def tx_loop():
            while not self._stop.is_set():
                got = tx_sub.next(timeout=0.2)
                if got is None:
                    continue
                try:
                    event, attrs = got
                    height, index, tx, result = event.data
                    self.tx_indexer.index(height, index, tx, result, attrs)
                except Exception:  # noqa: BLE001 — one bad event must
                    # not kill indexing for the node's lifetime
                    import traceback
                    traceback.print_exc()

        def blk_loop():
            while not self._stop.is_set():
                got = blk_sub.next(timeout=0.2)
                if got is None:
                    continue
                try:
                    event, attrs = got
                    block, _res = event.data
                    self.block_indexer.index(block.header.height, attrs)
                except Exception:  # noqa: BLE001
                    import traceback
                    traceback.print_exc()

        for fn, name in ((tx_loop, "tx"), (blk_loop, "blk")):
            t = threading.Thread(target=fn, name=f"indexer-{name}",
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        self.bus.unsubscribe_all("indexer")
        for t in self._threads:
            t.join(timeout=5)
        self._threads.clear()
