"""RFC-6962 Merkle tree over SHA-256 (reference crypto/merkle/tree.go,
hash.go: leaf prefix 0x00, inner prefix 0x01, empty hash = sha256("")).

Host-side hashlib implementation — header/validator-set hashing is a
control-plane operation over dozens of items; the TPU data plane is for
signatures. Proofs follow crypto/merkle/proof.go semantics.

Copy of `cometbft_tpu/crypto/merkle.py` (the port keeps its own).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Optional, Sequence

_LEAF = b"\x00"
_INNER = b"\x01"


def _sha256(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def leaf_hash(leaf: bytes) -> bytes:
    return _sha256(_LEAF + leaf)


def inner_hash(left: bytes, right: bytes) -> bytes:
    return _sha256(_INNER + left + right)


def empty_hash() -> bytes:
    return _sha256(b"")


def _split_point(n: int) -> int:
    """Largest power of two strictly less than n."""
    assert n > 1
    k = 1 << (n.bit_length() - 1)
    return k >> 1 if k == n else k


def hash_from_byte_slices(items: Sequence[bytes]) -> bytes:
    n = len(items)
    if n == 0:
        return empty_hash()
    if n == 1:
        return leaf_hash(items[0])
    k = _split_point(n)
    return inner_hash(hash_from_byte_slices(items[:k]),
                      hash_from_byte_slices(items[k:]))


@dataclass
class Proof:
    """Merkle inclusion proof (reference crypto/merkle/proof.go:28-48)."""
    total: int
    index: int
    leaf_hash: bytes
    aunts: List[bytes]

    def compute_root(self) -> bytes:
        """Raises ValueError on malformed index/total/aunt shapes."""
        return _compute_from_aunts(self.index, self.total, self.leaf_hash,
                                   self.aunts)

    def verify(self, root: bytes, leaf: bytes) -> bool:
        """False (never raises) on attacker-controlled malformed proofs —
        this sits on the gossip ingest path (PartSet.add_part)."""
        if self.leaf_hash != leaf_hash(leaf):
            return False
        try:
            return self.compute_root() == root
        except ValueError:
            return False


@dataclass
class AbsenceProof:
    """Proof that no leaf exists between two ADJACENT tree positions:
    inclusion proofs for the left neighbor and (unless the left neighbor
    is the last leaf) the right neighbor, carried with their raw leaf
    bytes so the verifier can check the neighbors bracket the missing
    item under the application's leaf ordering.

    The reference verifies absence through its ProofRuntime op set
    (light/rpc/client.go:149,182 VerifyAbsence over iavl range proofs);
    this is the same guarantee re-based on the RFC-6962 tree: adjacency
    of indices in a sorted-leaf tree means nothing lies between."""
    left: Proof
    left_leaf: bytes
    right: Optional[Proof]
    right_leaf: Optional[bytes]

    def verify_adjacent(self, root: bytes) -> bool:
        """Structural check only: both neighbors are in the tree under
        `root` and are index-adjacent (or left is the final leaf). The
        caller must separately check the leaf CONTENTS bracket the
        missing key — ordering is an application-level contract."""
        if not self.left.verify(root, self.left_leaf):
            return False
        if self.right is None:
            return self.right_leaf is None and \
                self.left.index == self.left.total - 1
        if self.right_leaf is None:
            return False
        if not self.right.verify(root, self.right_leaf):
            return False
        return (self.right.total == self.left.total
                and self.right.index == self.left.index + 1)


def _compute_from_aunts(index: int, total: int, lh: bytes,
                        aunts: List[bytes]) -> bytes:
    if not (0 <= index < total):
        raise ValueError(f"proof index {index} out of range for {total}")
    if total == 1:
        if aunts:
            raise ValueError("unexpected aunts for single-leaf tree")
        return lh
    if not aunts:
        raise ValueError("missing aunts")
    k = _split_point(total)
    if index < k:
        left = _compute_from_aunts(index, k, lh, aunts[:-1])
        return inner_hash(left, aunts[-1])
    right = _compute_from_aunts(index - k, total - k, lh, aunts[:-1])
    return inner_hash(aunts[-1], right)


def proofs_from_byte_slices(items: Sequence[bytes]
                            ) -> tuple[bytes, List[Proof]]:
    """Root hash + one inclusion proof per item
    (reference crypto/merkle/proof.go ProofsFromByteSlices)."""
    n = len(items)
    leaves = [leaf_hash(it) for it in items]

    def build(lo: int, hi: int) -> tuple[bytes, dict]:
        if hi - lo == 1:
            return leaves[lo], {lo: []}
        k = _split_point(hi - lo)
        lroot, lp = build(lo, lo + k)
        rroot, rp = build(lo + k, hi)
        proofs = {}
        for i, aunts in lp.items():
            proofs[i] = aunts + [rroot]
        for i, aunts in rp.items():
            proofs[i] = aunts + [lroot]
        return inner_hash(lroot, rroot), proofs

    if n == 0:
        return empty_hash(), []
    root, pmap = build(0, n)
    return root, [Proof(n, i, leaves[i], pmap[i]) for i in range(n)]
