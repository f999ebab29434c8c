"""ingest/ — the signed-tx envelope (`tx.py`), which the kvstore app
unwraps. The batched admission pipeline of the JAX package's ingest/ is
not ported yet (ROADMAP.md Queue 1: node boot)."""

from .tx import (MalformedTx, SignedTx, make_signed_tx,  # noqa: F401
                 parse_signed_tx, sign_bytes, unwrap_payload)
