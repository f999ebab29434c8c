"""Copy of `cometbft_tpu/evidence/__init__.py` in the port (the pool;
the gossip reactor is `evidence/reactor.py`)."""

from .pool import EvidencePool, verify_duplicate_vote

__all__ = ["EvidencePool", "verify_duplicate_vote"]
