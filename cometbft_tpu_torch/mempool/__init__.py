"""mempool/ — the CheckTx-admission FIFO mempool (port of
`cometbft_tpu/mempool/`; its p2p reactor is not ported yet)."""

from .mempool import (CODE_TYPE_OK, CListMempool, Mempool, NopMempool,
                      TxCache, tx_key)

__all__ = ["CODE_TYPE_OK", "CListMempool", "Mempool", "NopMempool",
           "TxCache", "tx_key"]
