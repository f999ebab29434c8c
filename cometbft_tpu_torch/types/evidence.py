"""Evidence of Byzantine behavior (reference types/evidence.go).

DuplicateVoteEvidence — two signed votes from one validator for the same
(height, round, type) but different blocks — is the output of
`ErrVoteConflictingVotes` (types/vote_set.py) and the input to the
evidence pool's verification (internal/evidence/verify.go:110-210).
LightClientAttackEvidence captures a conflicting light block trace.

Wire form: proto Evidence oneof {duplicate_vote_evidence=1,
light_client_attack_evidence=2} (proto/cometbft/types/v1/evidence.proto);
EvidenceList is `repeated Evidence evidence = 1`, hashed like other
merkle'd lists (types/evidence.go EvidenceList.Hash over individual
evidence hashes).

Copy of `cometbft_tpu/types/evidence.py` (the port keeps its own).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field as dc_field
from typing import List, Optional

from ..crypto import merkle
from . import proto
from .proto import Timestamp
from .vote import Vote


class EvidenceError(Exception):
    pass


@dataclass
class DuplicateVoteEvidence:
    """reference types/evidence.go:33-41."""
    vote_a: Vote
    vote_b: Vote
    total_voting_power: int = 0
    validator_power: int = 0
    timestamp: Timestamp = dc_field(default_factory=Timestamp)

    @classmethod
    def from_conflict(cls, vote_a: Vote, vote_b: Vote, val_set,
                      block_time: Timestamp) -> "DuplicateVoteEvidence":
        """reference types/evidence.go:45-60 NewDuplicateVoteEvidence:
        votes are ordered by block key so the evidence hash is unique per
        conflict regardless of discovery order."""
        if vote_a is None or vote_b is None:
            raise EvidenceError("missing vote")
        if vote_a.block_id.key() <= vote_b.block_id.key():
            a, b = vote_a, vote_b
        else:
            a, b = vote_b, vote_a
        _, val = val_set.get_by_address(vote_a.validator_address)
        if val is None:
            raise EvidenceError("validator not in set")
        return cls(vote_a=a, vote_b=b,
                   total_voting_power=val_set.total_voting_power(),
                   validator_power=val.voting_power,
                   timestamp=block_time)

    def abci_kind(self) -> str:
        return "DUPLICATE_VOTE"

    def height(self) -> int:
        return self.vote_a.height

    def time(self) -> Timestamp:
        return self.timestamp

    def addresses(self) -> List[bytes]:
        return [self.vote_a.validator_address]

    def encode(self) -> bytes:
        body = (proto.f_embed(1, self.vote_a.encode())
                + proto.f_embed(2, self.vote_b.encode())
                + proto.f_varint(3, self.total_voting_power)
                + proto.f_varint(4, self.validator_power)
                + proto.f_embed(5, self.timestamp.encode()))
        return proto.f_embed(1, body)  # oneof slot 1

    @classmethod
    def decode_body(cls, body: bytes) -> "DuplicateVoteEvidence":
        f = proto.parse_fields(body)
        va = proto.field_bytes(f, 1, None)
        vb = proto.field_bytes(f, 2, None)
        if va is None or vb is None:
            raise ValueError("duplicate vote evidence missing votes")
        ts = proto.field_bytes(f, 5, None)
        return cls(
            vote_a=Vote.decode(va), vote_b=Vote.decode(vb),
            total_voting_power=proto.to_int64(proto.field_int(f, 3, 0)),
            validator_power=proto.to_int64(proto.field_int(f, 4, 0)),
            timestamp=(Timestamp.decode(ts) if ts is not None
                       else Timestamp()))

    def hash(self) -> bytes:
        return hashlib.sha256(self.encode()).digest()

    def validate_basic(self) -> None:
        """reference types/evidence.go:117-133."""
        if self.vote_a is None or self.vote_b is None:
            raise EvidenceError("missing vote")
        self.vote_a.validate_basic()
        self.vote_b.validate_basic()
        if self.vote_a.block_id.key() > self.vote_b.block_id.key():
            raise EvidenceError("votes not ordered by block id")
        if self.vote_a.block_id.key() == self.vote_b.block_id.key():
            raise EvidenceError("votes are for the same block")

    def __repr__(self) -> str:
        return (f"DuplicateVoteEvidence{{"
                f"{self.vote_a.validator_address.hex()[:12]} "
                f"h{self.vote_a.height}/r{self.vote_a.round}}}")


@dataclass(frozen=True)
class ByzantineRef:
    """Address-only stand-in for a byzantine validator the (attacker-
    controlled) conflicting validator set does not list — wire decode
    must preserve every claimed address for hash stability."""
    address: bytes


@dataclass
class LightClientAttackEvidence:
    """A conflicting light block signed by validators who were trusted
    at common_height (reference types/evidence.go:155-263
    LightClientAttackEvidence) — what the light client's witness
    detector produces on header divergence (light/detector.go)."""
    conflicting_block: object            # light.types.LightBlock
    common_height: int
    byzantine_validators: List = dc_field(default_factory=list)
    total_voting_power: int = 0
    timestamp: Timestamp = dc_field(default_factory=Timestamp)

    def abci_kind(self) -> str:
        return "LIGHT_CLIENT_ATTACK"

    def height(self) -> int:
        return self.common_height

    def time(self) -> Timestamp:
        return self.timestamp

    def addresses(self) -> List[bytes]:
        return [v.address for v in self.byzantine_validators]

    def conflicting_header_is_invalid(self, trusted_header) -> bool:
        """Lunatic attack iff the conflicting header's derived fields
        differ from the trusted chain's (reference evidence.go:178)."""
        h, t = self.conflicting_block.header, trusted_header
        return (h.validators_hash != t.validators_hash
                or h.next_validators_hash != t.next_validators_hash
                or h.consensus_hash != t.consensus_hash
                or h.app_hash != t.app_hash
                or h.last_results_hash != t.last_results_hash)

    def encode(self) -> bytes:
        from ..state.state import _valset_to_json
        lb = self.conflicting_block
        blk = (proto.f_embed(1, lb.signed_header.header.encode())
               + proto.f_embed(2, lb.signed_header.commit.encode())
               + proto.f_bytes(3, _valset_to_json(lb.validator_set)))
        body = (proto.f_embed(1, blk)
                + proto.f_varint(2, self.common_height)
                + proto.f_varint(3, self.total_voting_power)
                + proto.f_embed(4, self.timestamp.encode())
                + b"".join(proto.f_bytes(
                    5, v.address) for v in self.byzantine_validators))
        return proto.f_embed(2, body)  # oneof slot 2

    @classmethod
    def decode_body(cls, body: bytes) -> "LightClientAttackEvidence":
        from ..light.types import LightBlock, SignedHeader
        from ..state.state import _valset_from_json
        from .block import Commit, Header
        f = proto.parse_fields(body)
        bf = proto.parse_fields(proto.field_bytes(f, 1, b""))
        lb = LightBlock(
            SignedHeader(Header.decode(proto.field_bytes(bf, 1, b"")),
                         Commit.decode(proto.field_bytes(bf, 2, b""))),
            _valset_from_json(proto.field_bytes(bf, 3, b"")))
        ts = proto.field_bytes(f, 4, None)
        ev = cls(conflicting_block=lb,
                 common_height=proto.to_int64(proto.field_int(f, 2, 0)),
                 total_voting_power=proto.to_int64(
                     proto.field_int(f, 3, 0)),
                 timestamp=(Timestamp.decode(ts) if ts is not None
                            else Timestamp()))
        # byzantine entries resolved against the conflicting block's set
        # when present, else kept as bare address refs — the set is
        # ATTACKER-CONTROLLED and may omit them; dropping entries would
        # change the hash across a wire round-trip and break dedup
        for addr in proto.field_all_bytes(f, 5):
            _i, val = lb.validator_set.get_by_address(addr)
            ev.byzantine_validators.append(
                val if val is not None else ByzantineRef(addr))
        return ev

    def hash(self) -> bytes:
        return hashlib.sha256(self.encode()).digest()

    def validate_basic(self) -> None:
        """reference types/evidence.go ValidateABCI/ValidateBasic."""
        if self.conflicting_block is None:
            raise EvidenceError("missing conflicting block")
        if self.common_height <= 0:
            raise EvidenceError("non-positive common height")
        if self.common_height > self.conflicting_block.height:
            raise EvidenceError("common height above conflicting block")
        self.conflicting_block.signed_header.commit.validate_basic()

    def __repr__(self) -> str:
        return (f"LightClientAttackEvidence{{common:{self.common_height} "
                f"conflict:{self.conflicting_block.height} "
                f"byz:{len(self.byzantine_validators)}}}")


def decode_evidence(buf: bytes):
    """Evidence oneof decoder."""
    f = proto.parse_fields(buf)
    dv = proto.field_bytes(f, 1, None)
    if dv is not None:
        return DuplicateVoteEvidence.decode_body(dv)
    lc = proto.field_bytes(f, 2, None)
    if lc is not None:
        return LightClientAttackEvidence.decode_body(lc)
    raise ValueError("unknown evidence kind")


@dataclass
class EvidenceList:
    evidence: List = dc_field(default_factory=list)

    def hash(self) -> bytes:
        """merkle over evidence hashes (types/evidence.go:270-277)."""
        return merkle.hash_from_byte_slices(
            [ev.hash() for ev in self.evidence])

    def encode(self) -> bytes:
        return b"".join(proto.f_embed(1, ev.encode())
                        for ev in self.evidence)

    @classmethod
    def decode(cls, buf: bytes) -> "EvidenceList":
        f = proto.parse_fields(buf)
        return cls([decode_evidence(raw)
                    for raw in proto.field_all_bytes(f, 1)])

    def __len__(self) -> int:
        return len(self.evidence)

    def __iter__(self):
        return iter(self.evidence)
