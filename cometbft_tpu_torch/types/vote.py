"""Vote type, sign-bytes, and verification (reference types/vote.go,
types/canonical.go:57-66).

Copy of `cometbft_tpu/types/vote.py` (the port keeps its own).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Optional

from ..crypto.keys import PubKey
from . import proto
from .block import BlockID
from .proto import Timestamp

PREVOTE_TYPE = 1    # proto/cometbft/types/v1/types.proto:19-25
PRECOMMIT_TYPE = 2
PROPOSAL_TYPE = 32

MAX_VOTE_BYTES = 209  # types/vote.go MaxVoteBytes (with 64-byte signature)


def is_vote_type_valid(t: int) -> bool:
    return t in (PREVOTE_TYPE, PRECOMMIT_TYPE)


@dataclass
class Vote:
    type_: int = PREVOTE_TYPE
    height: int = 0
    round: int = 0
    block_id: BlockID = dc_field(default_factory=BlockID)
    timestamp: Timestamp = dc_field(default_factory=Timestamp)
    validator_address: bytes = b""
    validator_index: int = -1
    signature: bytes = b""
    extension: bytes = b""
    extension_signature: bytes = b""

    def is_nil(self) -> bool:
        return self.block_id.is_nil()

    def commit_sig(self) -> "CommitSig":
        """Vote -> CommitSig (reference types/vote.go CommitSig); callers
        map a missing vote to CommitSig.absent()."""
        from .block import (CommitSig, BLOCK_ID_FLAG_COMMIT,
                            BLOCK_ID_FLAG_NIL)
        if self.block_id.is_complete():
            flag = BLOCK_ID_FLAG_COMMIT
        elif self.block_id.is_nil():
            flag = BLOCK_ID_FLAG_NIL
        else:
            raise ValueError(f"vote has neither nil nor complete blockID: "
                             f"{self.block_id}")
        return CommitSig(flag, self.validator_address, self.timestamp,
                         self.signature)

    def sign_bytes(self, chain_id: str) -> bytes:
        """Varint-length-prefixed canonical proto (types/vote.go:142-158)."""
        return proto.marshal_delimited(proto.canonical_vote(
            self.type_, self.height, self.round, self.block_id.canonical(),
            self.timestamp, chain_id))

    def extension_sign_bytes(self, chain_id: str) -> bytes:
        """types/vote.go:160-173."""
        return proto.marshal_delimited(proto.canonical_vote_extension(
            self.extension, self.height, self.round, chain_id))

    def verify(self, chain_id: str, pub_key: PubKey) -> bool:
        """Per-vote signature check — the consensus addVote hot path
        (reference types/vote.go:235)."""
        if pub_key.address() != self.validator_address:
            return False
        return pub_key.verify_signature(self.sign_bytes(chain_id),
                                        self.signature)

    def verify_vote_and_extension(self, chain_id: str,
                                  pub_key: PubKey) -> bool:
        """reference types/vote.go VerifyVoteAndExtension."""
        if not self.verify(chain_id, pub_key):
            return False
        if self.type_ == PRECOMMIT_TYPE and not self.block_id.is_nil():
            if not self.extension_signature:
                return False
            return pub_key.verify_signature(
                self.extension_sign_bytes(chain_id), self.extension_signature)
        return True

    def validate_basic(self) -> None:
        if not is_vote_type_valid(self.type_):
            raise ValueError(f"invalid vote type {self.type_}")
        if self.height <= 0:
            raise ValueError("non-positive height")
        if self.round < 0:
            raise ValueError("negative round")
        if not self.block_id.is_nil() and not self.block_id.is_complete():
            raise ValueError("blockID must be nil or complete")
        if len(self.validator_address) != 20:
            raise ValueError("bad validator address")
        if self.validator_index < 0:
            raise ValueError("negative validator index")
        from .block import MAX_SIGNATURE_SIZE
        if not self.signature or len(self.signature) > MAX_SIGNATURE_SIZE:
            raise ValueError("signature missing or oversized")

    def encode(self) -> bytes:
        """proto Vote (types.proto fields 1-10) — the p2p/WAL wire form."""
        out = (proto.f_varint(1, self.type_)
               + proto.f_varint(2, self.height)
               + proto.f_varint(3, self.round)
               + proto.f_embed(4, self.block_id.encode())
               + proto.f_embed(5, self.timestamp.encode())
               + proto.f_bytes(6, self.validator_address)
               + proto.f_varint(7, self.validator_index)
               + proto.f_bytes(8, self.signature)
               + proto.f_bytes(9, self.extension)
               + proto.f_bytes(10, self.extension_signature))
        return out

    @classmethod
    def decode(cls, buf: bytes) -> "Vote":
        f = proto.parse_fields(buf)
        bid = proto.field_bytes(f, 4, None)
        ts = proto.field_bytes(f, 5, None)
        return cls(
            type_=proto.field_int(f, 1, 0),
            height=proto.to_int64(proto.field_int(f, 2, 0)),
            round=proto.to_int64(proto.field_int(f, 3, 0)),
            block_id=BlockID.decode(bid) if bid is not None else BlockID(),
            timestamp=Timestamp.decode(ts) if ts is not None else Timestamp(),
            validator_address=proto.field_bytes(f, 6, b""),
            validator_index=proto.to_int64(proto.field_int(f, 7, 0)),
            signature=proto.field_bytes(f, 8, b""),
            extension=proto.field_bytes(f, 9, b""),
            extension_signature=proto.field_bytes(f, 10, b""))


@dataclass
class Proposal:
    """reference types/proposal.go."""
    height: int = 0
    round: int = 0
    pol_round: int = -1
    block_id: BlockID = dc_field(default_factory=BlockID)
    timestamp: Timestamp = dc_field(default_factory=Timestamp)
    signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        return proto.marshal_delimited(proto.canonical_proposal(
            PROPOSAL_TYPE, self.height, self.round, self.pol_round,
            self.block_id.canonical(), self.timestamp, chain_id))

    def validate_basic(self) -> None:
        if self.height < 0 or self.round < 0:
            raise ValueError("negative height/round")
        if self.pol_round < -1 or self.pol_round >= self.round:
            raise ValueError("invalid POL round")
        if not self.block_id.is_complete():
            raise ValueError("proposal must have a complete blockID")

    def is_timely(self, recv_time: Timestamp, precision_ns: int,
                  message_delay_ns: int) -> bool:
        """PBTS timeliness (reference types/proposal.go:85-103
        IsTimely): accept iff
          recv_time >= timestamp - precision, and
          recv_time <= timestamp + message_delay + precision."""
        ts = self.timestamp.seconds * 1_000_000_000 + self.timestamp.nanos
        rt = recv_time.seconds * 1_000_000_000 + recv_time.nanos
        return ts - precision_ns <= rt <= ts + message_delay_ns + precision_ns
