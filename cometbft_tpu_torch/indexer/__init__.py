"""Copy of `cometbft_tpu/indexer/__init__.py` in the port (the kv
indexer; `indexer/sqlite.py` is not ported yet: ROADMAP.md Queue 1 item
11.3)."""

from .kv import TxIndexer, BlockIndexer, IndexerService

__all__ = ["TxIndexer", "BlockIndexer", "IndexerService"]
