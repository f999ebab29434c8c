"""Copy of `cometbft_tpu/evidence/__init__.py` in the port (the pool;
the gossip reactor comes with node boot)."""

from .pool import EvidencePool, verify_duplicate_vote

__all__ = ["EvidencePool", "verify_duplicate_vote"]
