"""Batch-verifier dispatch by key type: the seam where the port's data
plane slots into every verification call site (reference
crypto/batch/batch.go:11-35). Port of `cometbft_tpu/crypto/batch.py`.

ed25519 batches run on the port's kernels (on `device`, default cuda),
sr25519 batches on the host (`crypto/sr25519.py`), and secp256k1 has no
batch form, in the reference or here. `MixedBatchVerifier` buckets a
mixed-curve set by key type and hands `batch_size` and `device` to its
ed25519 bucket. BLS (`bls12_381`) batches run on the host
(`aggsig/aggregate.BlsBatchVerifier`: one random-linear-combination
multi-pairing, per-signature attribution when it fails), as in the JAX
package.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

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
    if pk.type_() == "sr25519":
        from .sr25519 import Sr25519BatchVerifier
        return Sr25519BatchVerifier(), True
    if pk.type_() == "bls12_381":
        # one multi-pairing (random-linear-combination) over the whole
        # batch with a single shared final exponentiation, per-sig
        # fallback for attribution — so MixedBatchVerifier handles
        # mixed-curve vote sets instead of silently going per-sig
        from ..aggsig.aggregate import BlsBatchVerifier
        return BlsBatchVerifier(), True
    return None, False


def supports_batch_verifier(pk: PubKey) -> bool:
    """reference crypto/batch/batch.go:25-35 (secp256k1 has no batch
    form, exactly like the reference: callers fall back to per-sig)."""
    return pk is not None and pk.type_() in (ED25519_KEY_TYPE, "sr25519",
                                             "bls12_381")


class MixedBatchVerifier:
    """The BASELINE mixed-curve config: one verifier accepting
    ed25519 + sr25519 + secp256k1 keys, dispatching each signature to
    its curve's verifier (batched where the curve supports it, per-sig
    fallback where it doesn't), with per-signature attribution in the
    original order. `batch_size` and `device` (default cuda) go to the
    ed25519 bucket."""

    def __init__(self, batch_size: Optional[int] = None, device=None):
        self._order: List[Tuple[str, int]] = []   # (kind, idx in bucket)
        self._buckets = {}
        self._singles: List[Tuple[PubKey, bytes, bytes]] = []
        self._batch_size = batch_size
        self._device = device

    def __len__(self) -> int:
        return len(self._order)

    def add(self, pk: PubKey, msg: bytes, sig: bytes) -> None:
        kind = pk.type_()
        bucket = self._buckets.get(kind)
        if bucket is None and supports_batch_verifier(pk):
            bucket, _ = create_batch_verifier(pk, batch_size=self._batch_size,
                                              device=self._device)
            self._buckets[kind] = bucket
        if bucket is not None:
            self._order.append((kind, len(bucket)))
            bucket.add(pk, msg, sig)
        else:
            self._order.append(("single", len(self._singles)))
            self._singles.append((pk, msg, sig))

    def verify(self) -> Tuple[bool, List[bool]]:
        if not self._order:
            # match the single-curve verifiers (and the reference):
            # an empty batch is a failure, not vacuous success
            return False, []
        results = {}
        for kind, bucket in self._buckets.items():
            _, oks = bucket.verify()
            results[kind] = oks
        single_oks = [pk.verify_signature(msg, sig)
                      for pk, msg, sig in self._singles]
        out = []
        for kind, idx in self._order:
            out.append(single_oks[idx] if kind == "single"
                       else results[kind][idx])
        return all(out), out
