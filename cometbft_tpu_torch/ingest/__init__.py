"""ingest/ — batched CheckTx admission pipeline (port of
`cometbft_tpu/ingest/`).

Coalesces concurrent txs into shared signature-verification batches
over the SigCache and the farm's verify backend (the RLC kernels on the
pipeline's device for a wide batch), with explicit backpressure
(bounded queue, IngestShed) and verdict application that is a
byte-for-byte drop-in for sequential `mempool.check_tx`.

  tx.py          signed-tx envelope (magic | pub | sig | payload)
  admission.py   bounded intake queue, two-layer dedup, coalescing
  batcher.py     unique-lane dedup + device dispatch
  dispatcher.py  in-order verdict application into mempool semantics
"""

from .admission import (CACHE_PATH, IngestPipeline, IngestShed,  # noqa: F401
                        TxFilter, TxTicket)
from .batcher import IngestBatcher, SigLane, native_backend  # noqa: F401
from .dispatcher import CODE_BAD_SIGNATURE, VerdictDispatcher  # noqa: F401
from .tx import (MalformedTx, SignedTx, make_signed_tx,  # noqa: F401
                 parse_signed_tx, sign_bytes, unwrap_payload)
