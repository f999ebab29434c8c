"""SQLite indexer sink — the second sink behind the indexer interface
(reference state/indexer/sink/psql/psql.go: the psql sink alongside kv;
this environment has no postgres server, so the relational sink rides
the stdlib sqlite3 with the same schema spirit: a tx_results row per tx
plus one attributes row per event attribute, block events likewise).

Drop-in interface-compatible with indexer/kv.TxIndexer/BlockIndexer
(index / get / search / prune), selected by `[tx_index] indexer =
"sqlite"` (config.py) and exercised by the e2e generator's indexer
knob. Query matching reuses pubsub.query.Query._match_one so both
sinks answer every operator of the query grammar identically — the
rows are filtered per-tag in SQL, the operator semantics stay in one
place.

Copy of `cometbft_tpu/indexer/sqlite.py` in the port: the same schema,
rows and search order. The port's `Node.stop()` closes the connections.
"""

from __future__ import annotations

import os
import sqlite3
import threading
from typing import Dict, List, Optional, Tuple

from ..pubsub.query import Query

_SCHEMA = """
CREATE TABLE IF NOT EXISTS tx_results (
    hash   BLOB PRIMARY KEY,
    height INTEGER NOT NULL,
    idx    INTEGER NOT NULL,
    tx     BLOB NOT NULL,
    code   INTEGER NOT NULL
);
CREATE INDEX IF NOT EXISTS tx_results_height ON tx_results(height);
CREATE TABLE IF NOT EXISTS tx_attributes (
    tag    TEXT NOT NULL,
    value  TEXT NOT NULL,
    height INTEGER NOT NULL,
    hash   BLOB NOT NULL
);
CREATE INDEX IF NOT EXISTS tx_attributes_tag ON tx_attributes(tag);
CREATE INDEX IF NOT EXISTS tx_attributes_height ON tx_attributes(height);
CREATE TABLE IF NOT EXISTS block_attributes (
    tag    TEXT NOT NULL,
    value  TEXT NOT NULL,
    height INTEGER NOT NULL
);
CREATE INDEX IF NOT EXISTS block_attributes_tag ON block_attributes(tag);
"""


class _SqliteBase:
    """One connection per sink pair, serialized by a lock (the indexer
    service writes from its own threads; RPC searches from others)."""

    def __init__(self, path: str = ":memory:"):
        if path != ":memory:":
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # timeout: the tx and block sinks share one file from separate
        # connections; a busy writer waits instead of raising
        self._conn = sqlite3.connect(path, check_same_thread=False,
                                     timeout=30.0)
        self._lock = threading.Lock()
        with self._lock:
            self._conn.executescript(_SCHEMA)
            self._conn.commit()

    def close(self) -> None:
        with self._lock:
            self._conn.close()


class SqliteTxIndexer(_SqliteBase):
    """reference state/indexer/sink/psql IndexTxEvents + the txindex
    Get/Search surface."""

    def index(self, height: int, index: int, tx: bytes, result,
              events: Dict[str, List[str]]) -> None:
        from ..types.block import tx_hash
        txh = tx_hash(tx)
        code = getattr(result, "code", 0)
        with self._lock:
            cur = self._conn.cursor()
            cur.execute(
                "INSERT OR REPLACE INTO tx_results VALUES (?,?,?,?,?)",
                (txh, height, index, tx, code))
            # re-indexing the same tx (reindex_block, crash-replay)
            # must not accumulate duplicate attribute rows: attributes
            # have no uniqueness constraint, so drop the old ones first
            cur.execute("DELETE FROM tx_attributes WHERE hash = ?",
                        (txh,))
            cur.executemany(
                "INSERT INTO tx_attributes VALUES (?,?,?,?)",
                [(tag, str(v), height, txh)
                 for tag, values in events.items() for v in values])
            self._conn.commit()

    def get(self, tx_hash: bytes) -> Optional[Tuple[int, int, bytes, int]]:
        with self._lock:
            row = self._conn.execute(
                "SELECT height, idx, tx, code FROM tx_results "
                "WHERE hash = ?", (tx_hash,)).fetchone()
        if row is None:
            return None
        return (row[0], row[1], bytes(row[2]), row[3])

    def search(self, query: Query, limit: int = 100) -> List[bytes]:
        result: Optional[set] = None
        for cond in query.conditions:
            with self._lock:
                rows = self._conn.execute(
                    "SELECT value, height, hash FROM tx_attributes "
                    "WHERE tag = ?", (cond.tag,)).fetchall()
            matches = set()
            for value, height, txh in rows:
                ev = {cond.tag: [value], "tx.height": [str(height)]}
                if Query._match_one(cond, ev):
                    matches.add(bytes(txh))
            result = matches if result is None else (result & matches)
            if not result:
                return []
        if not result:
            return []
        # deterministic chain order BEFORE truncating: which hashes
        # survive `limit` must not depend on set iteration order. Only
        # the matched hashes are positioned (chunked under SQLite's
        # bound-parameter limit), never the whole table.
        pos = {}
        hashes = list(result)
        with self._lock:
            for i in range(0, len(hashes), 500):
                chunk = hashes[i:i + 500]
                rows = self._conn.execute(
                    "SELECT hash, height, idx FROM tx_results "
                    f"WHERE hash IN ({','.join('?' * len(chunk))})",
                    chunk).fetchall()
                pos.update({bytes(h): (ht, ix) for h, ht, ix in rows})
        ordered = sorted(result,
                         key=lambda h: pos.get(h, (1 << 62, 0)) + (h,))
        return ordered[:limit]

    def prune(self, retain_height: int) -> int:
        with self._lock:
            cur = self._conn.cursor()
            cur.execute("DELETE FROM tx_results WHERE height < ?",
                        (retain_height,))
            n = cur.rowcount
            cur.execute("DELETE FROM tx_attributes WHERE height < ?",
                        (retain_height,))
            n += cur.rowcount
            self._conn.commit()
        return n


class SqliteBlockIndexer(_SqliteBase):
    """reference state/indexer/sink/psql IndexBlockEvents."""

    def index(self, height: int, events: Dict[str, List[str]]) -> None:
        with self._lock:
            self._conn.executemany(
                "INSERT INTO block_attributes VALUES (?,?,?)",
                [(tag, str(v), height)
                 for tag, values in events.items() for v in values])
            self._conn.commit()

    def search(self, query: Query, limit: int = 100) -> List[int]:
        result: Optional[set] = None
        for cond in query.conditions:
            with self._lock:
                rows = self._conn.execute(
                    "SELECT value, height FROM block_attributes "
                    "WHERE tag = ?", (cond.tag,)).fetchall()
            matches = set()
            for value, height in rows:
                if Query._match_one(cond, {cond.tag: [value]}):
                    matches.add(height)
            result = matches if result is None else (result & matches)
            if not result:
                return []
        return sorted(result)[:limit] if result else []

    def prune(self, retain_height: int) -> int:
        with self._lock:
            cur = self._conn.cursor()
            cur.execute("DELETE FROM block_attributes WHERE height < ?",
                        (retain_height,))
            n = cur.rowcount
            self._conn.commit()
        return n


def open_sqlite_indexers(data_dir: str
                         ) -> Tuple[SqliteTxIndexer, SqliteBlockIndexer]:
    """Both sinks over one database file (<data_dir>/indexer.sqlite)."""
    path = os.path.join(data_dir, "indexer.sqlite")
    return SqliteTxIndexer(path), SqliteBlockIndexer(path)
