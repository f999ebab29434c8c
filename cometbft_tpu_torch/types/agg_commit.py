"""AggregatedCommit — the BLS aggregate-commit seal (aggsig tentpole).

A Commit whose for-block precommit signatures are folded into ONE
96-byte aggregate G2 signature plus a signer bitmap: n x 96B per-lane
signatures become 96B + ceil(n/8)B on the wire, and verification is a
single multi-pairing check (aggsig/verify.py) instead of n pairings.

Structure rules (validate_basic):
  * bitmap bit i is set  IFF  signatures[i].block_id_flag == COMMIT —
    the bitmap is the signer set AND an integrity cross-check (a
    forged bit without a matching flag fails structure validation);
  * covered entries carry EMPTY signature bytes (their signature lives
    only in the aggregate); timestamps/addresses stay per-entry, so
    vote_sign_bytes / median_time / evidence handling are unchanged;
  * nil-vote entries keep their individual signature and are verified
    per-signature (they never join the aggregate);
  * agg_sig is a compressed G2 point, subgroup-checked on decompress.

Wire format: the plain Commit fields (height=1, round=2, block_id=3,
signatures=4 repeated) plus bitmap=5 and agg_sig=6. Commit.decode
dispatches here when field 6 is present, so every existing decode path
(blockstore, p2p block parts, WAL) round-trips the seal transparently.
Commit.hash() gains one extra merkle leaf encoding the seal — the
last_commit_hash in the header above binds it.

Producing the seal is gated on the validator set: make_commit
aggregates only when the set is uniformly BLS and every key has a
registered proof of possession (types/vote_set.py -> maybe_aggregate);
ed25519 valsets are byte-for-byte unaffected. The gate makes the
format choice a deterministic function of consensus-visible data, and
verifiers accept either form for BLS valsets, so a mid-chain key-type
migration cannot split the network on commit format
(docs/AGGSIG.md).

Copy of `cometbft_tpu/types/agg_commit.py` (the port keeps its own).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field as dc_field
from typing import List, Optional

from ..crypto import merkle
from . import proto
from .block import (BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_COMMIT, BlockID,
                    Commit, CommitSig)

AGG_SIG_SIZE = 96  # compressed G2 (crypto/bls12381.SIGNATURE_LENGTH)


@dataclass
class AggregatedCommit(Commit):
    bitmap: bytes = b""
    agg_sig: bytes = b""

    # --- structure ---------------------------------------------------------

    def covered_indices(self) -> List[int]:
        """Validator indices whose signature the aggregate covers;
        raises ValueError on a malformed bitmap."""
        from ..aggsig.aggregate import bitmap_decode
        bits = bitmap_decode(self.bitmap, len(self.signatures))
        return [i for i, b in enumerate(bits) if b]

    def validate_basic(self) -> None:
        if self.height < 0 or self.round < 0:
            raise ValueError("negative height/round")
        if self.height < 1:
            raise ValueError("aggregated commit below height 1")
        if self.block_id.is_nil():
            raise ValueError("commit for nil block")
        if not self.signatures:
            raise ValueError("no signatures in commit")
        if len(self.agg_sig) != AGG_SIG_SIZE:
            raise ValueError("bad aggregate signature length")
        covered = set(self.covered_indices())  # validates bitmap shape
        if not covered:
            raise ValueError("aggregated commit covers no signer")
        for idx, cs in enumerate(self.signatures):
            if idx in covered:
                if cs.block_id_flag != BLOCK_ID_FLAG_COMMIT:
                    raise ValueError(
                        f"bitmap bit {idx} set but flag is not COMMIT")
                if cs.signature:
                    raise ValueError(
                        f"covered entry {idx} carries a per-lane signature")
                if len(cs.validator_address) != 20:
                    raise ValueError("validator address must be 20 bytes")
            else:
                if cs.block_id_flag == BLOCK_ID_FLAG_COMMIT:
                    raise ValueError(
                        f"for-block entry {idx} missing from bitmap")
                cs.validate_basic()

    # --- hashing / wire ----------------------------------------------------

    def _seal_encode(self) -> bytes:
        return (proto.f_bytes(1, self.bitmap)
                + proto.f_bytes(2, self.agg_sig))

    def hash(self) -> bytes:
        """Plain-commit leaves plus one seal leaf: the header's
        last_commit_hash binds bitmap and aggregate signature exactly
        like it binds per-lane signatures."""
        return merkle.hash_from_byte_slices(
            [cs.encode() for cs in self.signatures]
            + [self._seal_encode()])

    def seal_digest(self, chain_id: str, valset_hash: bytes) -> bytes:
        """Digest keying the WHOLE aggregate verdict in the SigCache:
        covers the chain, the verifying valset, and every byte of the
        commit (flags, timestamps, bitmap, aggregate)."""
        h = hashlib.sha256()
        for part in (chain_id.encode(), valset_hash, self.encode()):
            h.update(len(part).to_bytes(4, "big"))
            h.update(part)
        return h.digest()

    def encode(self) -> bytes:
        return (super().encode()
                + proto.f_bytes(5, self.bitmap)
                + proto.f_bytes(6, self.agg_sig))

    @classmethod
    def decode(cls, buf: bytes) -> "AggregatedCommit":
        f = proto.parse_fields(buf)
        bid = proto.field_bytes(f, 3, None)
        return cls(
            height=proto.to_int64(proto.field_int(f, 1, 0)),
            round=proto.to_int64(proto.field_int(f, 2, 0)),
            block_id=BlockID.decode(bid) if bid is not None else BlockID(),
            signatures=[CommitSig.decode(b)
                        for b in proto.field_all_bytes(f, 4)],
            bitmap=proto.field_bytes(f, 5, b""),
            agg_sig=proto.field_bytes(f, 6, b""))


# --- assembly -----------------------------------------------------------------

def from_commit(commit: Commit) -> AggregatedCommit:
    """Fold a plain commit's for-block signatures into the aggregate
    seal. Raises ValueError when any for-block signature is not a
    valid G2 point (callers gate on a uniformly-BLS valset, so this
    only trips on corrupt input)."""
    from ..aggsig.aggregate import aggregate_signatures, bitmap_encode
    bits = [cs.block_id_flag == BLOCK_ID_FLAG_COMMIT
            for cs in commit.signatures]
    covered_sigs = [cs.signature
                    for cs in commit.signatures if cs.for_block()]
    if not covered_sigs:
        raise ValueError("no for-block signatures to aggregate")
    agg = aggregate_signatures(covered_sigs)
    sigs = [CommitSig(cs.block_id_flag, cs.validator_address,
                      cs.timestamp, b"") if cs.for_block() else cs
            for cs in commit.signatures]
    return AggregatedCommit(
        height=commit.height, round=commit.round,
        block_id=commit.block_id, signatures=sigs,
        bitmap=bitmap_encode(bits), agg_sig=agg)


def maybe_aggregate(commit: Commit, val_set) -> Commit:
    """Commit-assembly gate: return the aggregated form iff the
    validator set is uniformly BLS with every proof of possession
    registered, else the commit unchanged. Deterministic in
    consensus-visible data (valset key types + genesis/val-update
    PoPs), and a no-op for every non-BLS valset."""
    if isinstance(commit, AggregatedCommit) or val_set is None:
        return commit
    if not any(cs.for_block() for cs in commit.signatures):
        return commit
    from ..aggsig.aggregate import valset_pops_ok
    if len(val_set) != len(commit.signatures):
        return commit
    if not valset_pops_ok(val_set):
        return commit
    try:
        return from_commit(commit)
    except ValueError:
        return commit
