"""ExtendedCommit: a commit whose signatures carry their ABCI vote
extensions (reference types/block.go ExtendedCommit / ExtendedCommitSig,
types/vote_set.go:635 MakeExtendedCommit). Persisted beside the block
so a restarted proposer can still hand the previous height's extensions
to PrepareProposal (reference store.SaveBlockWithExtendedCommit,
state/execution.go buildLastCommitInfo). Copy of
`cometbft_tpu/types/extended_commit.py`; the encoding is byte-identical."""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import List

from . import proto
from .block import (BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_COMMIT,
                    BlockID, Commit, CommitSig)
from .proto import Timestamp


@dataclass
class ExtendedCommitSig:
    """CommitSig + the extension it carried (types/block.go:760)."""
    commit_sig: CommitSig = dc_field(default_factory=CommitSig.absent)
    extension: bytes = b""
    extension_signature: bytes = b""

    def encode(self) -> bytes:
        return (proto.f_embed(1, self.commit_sig.encode())
                + proto.f_bytes(2, self.extension)
                + proto.f_bytes(3, self.extension_signature))

    @classmethod
    def decode(cls, buf: bytes) -> "ExtendedCommitSig":
        f = proto.parse_fields(buf)
        return cls(CommitSig.decode(proto.field_bytes(f, 1, b"")),
                   proto.field_bytes(f, 2, b""),
                   proto.field_bytes(f, 3, b""))


@dataclass
class ExtendedCommit:
    height: int = 0
    round: int = 0
    block_id: BlockID = dc_field(default_factory=BlockID)
    signatures: List[ExtendedCommitSig] = dc_field(default_factory=list)

    def to_commit(self) -> Commit:
        """Strip extensions (reference ExtendedCommit.ToCommit)."""
        return Commit(height=self.height, round=self.round,
                      block_id=self.block_id,
                      signatures=[s.commit_sig for s in self.signatures])

    def extensions(self) -> List[tuple]:
        """[(validator_index, address, extension)] of the non-absent
        signatures that actually extended — the LocalLastCommit payload
        PrepareProposal receives (abci ExtendedVoteInfo)."""
        out = []
        for i, s in enumerate(self.signatures):
            if s.commit_sig.block_id_flag == BLOCK_ID_FLAG_COMMIT and \
                    s.extension_signature:
                out.append((i, s.commit_sig.validator_address,
                            s.extension))
        return out

    def encode(self) -> bytes:
        out = (proto.f_varint(1, self.height)
               + proto.f_varint(2, self.round)
               + proto.f_embed(3, self.block_id.encode()))
        for s in self.signatures:
            out += proto.f_embed(4, s.encode())
        return out

    @classmethod
    def decode(cls, buf: bytes) -> "ExtendedCommit":
        f = proto.parse_fields(buf)
        bid = proto.field_bytes(f, 3, None)
        return cls(proto.to_int64(proto.field_int(f, 1, 0)),
                   proto.to_int64(proto.field_int(f, 2, 0)),
                   BlockID.decode(bid) if bid is not None else BlockID(),
                   [ExtendedCommitSig.decode(b)
                    for b in proto.field_all_bytes(f, 4)])
