"""Batch-verifier dispatch by key type: the seam where the port's data
plane slots into every verification call site (reference
crypto/batch/batch.go:11-35). This slice carries ed25519 only; the other
key types and MixedBatchVerifier are queued in ROADMAP.md."""

from __future__ import annotations

from typing import Optional, Tuple

from .keys import BatchVerifier, Ed25519BatchVerifier, PubKey, ED25519_KEY_TYPE


def create_batch_verifier(pk: PubKey, batch_size: Optional[int] = None,
                          device=None
                          ) -> Tuple[Optional[BatchVerifier], bool]:
    """(verifier, supported) for the given key type (reference
    crypto/batch/batch.go:11-21).

    With COMETBFT_TPU_DEVICE_SERVER=host:port set, ed25519 batches are
    shipped to the host's device server (`device/server.py`) instead of
    verifying in-process, as in the JAX package (`crypto/batch.py:20-25`).
    `batch_size` and `device` (default cuda) are those of the in-process
    verifier, which also serves as the remote one's local fallback."""
    if pk.type_() == ED25519_KEY_TYPE:
        from ..device.client import RemoteBatchVerifier, shared_client
        client = shared_client()
        if client is not None:
            return RemoteBatchVerifier(client, batch_size=batch_size,
                                       device=device), True
        return Ed25519BatchVerifier(batch_size=batch_size, device=device), True
    return None, False


def supports_batch_verifier(pk: PubKey) -> bool:
    """reference crypto/batch/batch.go:25-35."""
    return pk is not None and pk.type_() == ED25519_KEY_TYPE
