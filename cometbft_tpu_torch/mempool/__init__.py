"""mempool/ — the CheckTx-admission FIFO mempool and its p2p gossip
reactor (port of `cometbft_tpu/mempool/`)."""

from .mempool import (CODE_TYPE_OK, CListMempool, Mempool, NopMempool,
                      TxCache, tx_key)

__all__ = ["CODE_TYPE_OK", "CListMempool", "Mempool", "NopMempool",
           "TxCache", "tx_key"]
