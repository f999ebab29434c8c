"""Core consensus datatypes: BlockID, PartSetHeader, CommitSig, Commit,
Header, Data, Block — with the reference's exact hashing and sign-bytes
semantics (types/block.go, types/canonical.go), re-built on the hand-rolled
wire encoder in `proto.py`.

Hashing rules reproduced:
- Header.Hash = RFC-6962 merkle over 14 field encodings
  (types/block.go:440-475),
- Commit.Hash = merkle over CommitSig proto encodings
  (types/block.go:949-967),
- Data.Hash = merkle over sha256(tx) leaves (types/tx.go:29-50),
- CommitSig.BlockID maps Absent/Nil -> zero BlockID
  (types/block.go:634-647).

Copy of `cometbft_tpu/types/block.py` (the port keeps its own).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field as dc_field
from typing import List, Optional, Sequence

from ..crypto import merkle
from . import proto
from .proto import Timestamp

BLOCK_ID_FLAG_ABSENT = 1   # reference types/block.go:579-584
BLOCK_ID_FLAG_COMMIT = 2
BLOCK_ID_FLAG_NIL = 3

MAX_HEADER_BYTES = 626  # reference types/block.go MaxHeaderBytes
BLOCK_PART_SIZE = 65536  # reference types/part_set.go BlockPartSizeBytes

# Largest accepted vote/commit signature: 64B covers ed25519/secp/sr25519;
# 96B is a compressed-G2 bls12_381 signature (the reference bumped
# MaxSignatureSize the same way when BLS landed behind its build tag).
MAX_SIGNATURE_SIZE = 96


@dataclass(frozen=True)
class PartSetHeader:
    total: int = 0
    hash: bytes = b""

    def is_zero(self) -> bool:
        return self.total == 0 and not self.hash

    def encode(self) -> bytes:
        """proto PartSetHeader (types.proto: total=1, hash=2)."""
        return proto.f_varint(1, self.total) + proto.f_bytes(2, self.hash)

    @classmethod
    def decode(cls, buf: bytes) -> "PartSetHeader":
        f = proto.parse_fields(buf)
        return cls(proto.field_int(f, 1, 0), proto.field_bytes(f, 2, b""))


@dataclass(frozen=True)
class BlockID:
    hash: bytes = b""
    parts: PartSetHeader = dc_field(default_factory=PartSetHeader)

    def is_nil(self) -> bool:
        return not self.hash and self.parts.is_zero()

    def is_complete(self) -> bool:
        return len(self.hash) == 32 and self.parts.total > 0 \
            and len(self.parts.hash) == 32

    def encode(self) -> bytes:
        """proto BlockID (types.proto: hash=1, part_set_header=2 nonnull)."""
        return (proto.f_bytes(1, self.hash)
                + proto.f_embed(2, self.parts.encode()))

    def canonical(self) -> Optional[bytes]:
        """CanonicalBlockID payload, or None when nil (the nullable
        pointer in CanonicalVote — reference types/canonical.go:18-34)."""
        if self.is_nil():
            return None
        return proto.canonical_block_id(self.hash, self.parts.total,
                                        self.parts.hash)

    def key(self) -> bytes:
        return self.hash + self.parts.hash + self.parts.total.to_bytes(4, "big")

    @classmethod
    def decode(cls, buf: bytes) -> "BlockID":
        f = proto.parse_fields(buf)
        psh = proto.field_bytes(f, 2, None)
        return cls(proto.field_bytes(f, 1, b""),
                   PartSetHeader.decode(psh) if psh is not None
                   else PartSetHeader())


@dataclass(frozen=True)
class CommitSig:
    block_id_flag: int = BLOCK_ID_FLAG_ABSENT
    validator_address: bytes = b""
    timestamp: Timestamp = dc_field(default_factory=Timestamp)
    signature: bytes = b""

    @classmethod
    def absent(cls) -> "CommitSig":
        return cls()

    def for_block(self) -> bool:
        return self.block_id_flag == BLOCK_ID_FLAG_COMMIT

    def absent_(self) -> bool:
        return self.block_id_flag == BLOCK_ID_FLAG_ABSENT

    def block_id(self, commit_block_id: BlockID) -> BlockID:
        """reference types/block.go:634-647."""
        if self.block_id_flag == BLOCK_ID_FLAG_COMMIT:
            return commit_block_id
        if self.block_id_flag in (BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_NIL):
            return BlockID()
        raise ValueError(f"unknown BlockIDFlag {self.block_id_flag}")

    def encode(self) -> bytes:
        """proto CommitSig (types.proto: flag=1, validator_address=2,
        timestamp=3 nonnull, signature=4)."""
        return (proto.f_varint(1, self.block_id_flag)
                + proto.f_bytes(2, self.validator_address)
                + proto.f_embed(3, self.timestamp.encode())
                + proto.f_bytes(4, self.signature))

    @classmethod
    def decode(cls, buf: bytes) -> "CommitSig":
        f = proto.parse_fields(buf)
        ts = proto.field_bytes(f, 3, None)
        return cls(proto.field_int(f, 1, 0),
                   proto.field_bytes(f, 2, b""),
                   Timestamp.decode(ts) if ts is not None else Timestamp(),
                   proto.field_bytes(f, 4, b""))

    def validate_basic(self) -> None:
        if self.block_id_flag not in (BLOCK_ID_FLAG_ABSENT,
                                      BLOCK_ID_FLAG_COMMIT,
                                      BLOCK_ID_FLAG_NIL):
            raise ValueError(f"unknown BlockIDFlag {self.block_id_flag}")
        if self.block_id_flag == BLOCK_ID_FLAG_ABSENT:
            if self.validator_address or self.signature \
                    or not self.timestamp.is_zero():
                raise ValueError("absent CommitSig must be empty")
        else:
            if len(self.validator_address) != 20:
                raise ValueError("validator address must be 20 bytes")
            if not self.signature or len(self.signature) > MAX_SIGNATURE_SIZE:
                raise ValueError("signature absent or oversized")


@dataclass
class Commit:
    height: int = 0
    round: int = 0
    block_id: BlockID = dc_field(default_factory=BlockID)
    signatures: List[CommitSig] = dc_field(default_factory=list)

    def size(self) -> int:
        return len(self.signatures)

    def hash(self) -> bytes:
        """merkle over CommitSig encodings (types/block.go:949-967)."""
        return merkle.hash_from_byte_slices(
            [cs.encode() for cs in self.signatures])

    def median_time(self, val_set) -> Optional[Timestamp]:
        """Voting-power-weighted median of the commit timestamps — BFT
        time (reference types/block.go:922-950 MedianTime): with <1/3
        byzantine power the median always lies between two honest
        clocks. None when no counted signature carries a real timestamp
        (synthetic commits); callers fall back to local time."""
        stamped = []
        total = 0
        for cs in self.signatures:
            if cs.absent_() or cs.timestamp.is_zero():
                continue
            _i, val = val_set.get_by_address(cs.validator_address)
            if val is None:
                continue
            ns = cs.timestamp.seconds * 1_000_000_000 + cs.timestamp.nanos
            stamped.append((ns, val.voting_power))
            total += val.voting_power
        if not stamped:
            return None
        stamped.sort()
        acc, half = 0, total // 2
        for ns, power in stamped:
            acc += power
            if acc > half:
                return Timestamp(ns // 1_000_000_000, ns % 1_000_000_000)
        return Timestamp(stamped[-1][0] // 1_000_000_000,
                         stamped[-1][0] % 1_000_000_000)

    def vote_sign_bytes(self, chain_id: str, val_idx: int) -> bytes:
        """Sign-bytes of the precommit this CommitSig attests
        (types/block.go:873-885 -> vote.go:150 -> canonical.go:57)."""
        from .vote import PRECOMMIT_TYPE
        cs = self.signatures[val_idx]
        bid = cs.block_id(self.block_id)
        return proto.marshal_delimited(proto.canonical_vote(
            PRECOMMIT_TYPE, self.height, self.round, bid.canonical(),
            cs.timestamp, chain_id))

    def validate_basic(self) -> None:
        if self.height < 0 or self.round < 0:
            raise ValueError("negative height/round")
        if self.height >= 1:
            if self.block_id.is_nil():
                raise ValueError("commit for nil block")
            if not self.signatures:
                raise ValueError("no signatures in commit")
            for cs in self.signatures:
                cs.validate_basic()

    def encode(self) -> bytes:
        """proto Commit (types.proto: height=1, round=2, block_id=3 nonnull,
        signatures=4 repeated)."""
        out = (proto.f_varint(1, self.height)
               + proto.f_varint(2, self.round)
               + proto.f_embed(3, self.block_id.encode()))
        for cs in self.signatures:
            out += proto.f_embed(4, cs.encode())
        return out

    @classmethod
    def decode(cls, buf: bytes) -> "Commit":
        f = proto.parse_fields(buf)
        if cls is Commit and 6 in f:
            # aggregate seal present (agg_sig=6): dispatch to the
            # AggregatedCommit wire form so every existing decode path
            # (blockstore, block parts, WAL) round-trips it
            from .agg_commit import AggregatedCommit
            return AggregatedCommit.decode(buf)
        bid = proto.field_bytes(f, 3, None)
        return cls(proto.to_int64(proto.field_int(f, 1, 0)),
                   proto.to_int64(proto.field_int(f, 2, 0)),
                   BlockID.decode(bid) if bid is not None else BlockID(),
                   [CommitSig.decode(b)
                    for b in proto.field_all_bytes(f, 4)])


@dataclass(frozen=True)
class Header:
    version_block: int = 0
    version_app: int = 0
    chain_id: str = ""
    height: int = 0
    time: Timestamp = dc_field(default_factory=Timestamp)
    last_block_id: BlockID = dc_field(default_factory=BlockID)
    last_commit_hash: bytes = b""
    data_hash: bytes = b""
    validators_hash: bytes = b""
    next_validators_hash: bytes = b""
    consensus_hash: bytes = b""
    app_hash: bytes = b""
    last_results_hash: bytes = b""
    evidence_hash: bytes = b""
    proposer_address: bytes = b""

    def hash(self) -> bytes:
        """Merkle root of the field encodings (types/block.go:440-475).

        Returns b"" when the header is incomplete (nil semantics).
        Memoized per instance: the dataclass is frozen and every field
        is an immutable value, and profiling shows the consensus loop
        hashes each header ~10x (votes, validation, gossip ids) — the
        memo removes ~40% of the loop's cumulative cost."""
        if not self.validators_hash:
            return b""
        memo = self.__dict__.get("_hash_memo")
        if memo is not None:
            return memo
        fields = [
            proto.consensus_version(self.version_block, self.version_app),
            proto.cdc_string(self.chain_id),
            proto.cdc_int64(self.height),
            self.time.encode(),
            self.last_block_id.encode(),
            proto.cdc_bytes(self.last_commit_hash),
            proto.cdc_bytes(self.data_hash),
            proto.cdc_bytes(self.validators_hash),
            proto.cdc_bytes(self.next_validators_hash),
            proto.cdc_bytes(self.consensus_hash),
            proto.cdc_bytes(self.app_hash),
            proto.cdc_bytes(self.last_results_hash),
            proto.cdc_bytes(self.evidence_hash),
            proto.cdc_bytes(self.proposer_address),
        ]
        root = merkle.hash_from_byte_slices(fields)
        object.__setattr__(self, "_hash_memo", root)
        return root

    def encode(self) -> bytes:
        """proto Header (types.proto fields 1-14)."""
        return (proto.f_embed(
                    1, proto.consensus_version(self.version_block,
                                               self.version_app))
                + proto.f_string(2, self.chain_id)
                + proto.f_varint(3, self.height)
                + proto.f_embed(4, self.time.encode())
                + proto.f_embed(5, self.last_block_id.encode())
                + proto.f_bytes(6, self.last_commit_hash)
                + proto.f_bytes(7, self.data_hash)
                + proto.f_bytes(8, self.validators_hash)
                + proto.f_bytes(9, self.next_validators_hash)
                + proto.f_bytes(10, self.consensus_hash)
                + proto.f_bytes(11, self.app_hash)
                + proto.f_bytes(12, self.last_results_hash)
                + proto.f_bytes(13, self.evidence_hash)
                + proto.f_bytes(14, self.proposer_address))

    @classmethod
    def decode(cls, buf: bytes) -> "Header":
        f = proto.parse_fields(buf)
        ver = proto.parse_fields(proto.field_bytes(f, 1, b""))
        ts = proto.field_bytes(f, 4, None)
        lbi = proto.field_bytes(f, 5, None)
        try:
            chain_id = proto.field_bytes(f, 2, b"").decode("utf-8")
        except UnicodeDecodeError as e:
            raise ValueError(f"chain_id not utf-8: {e}") from None
        return cls(
            version_block=proto.field_int(ver, 1, 0),
            version_app=proto.field_int(ver, 2, 0),
            chain_id=chain_id,
            height=proto.to_int64(proto.field_int(f, 3, 0)),
            time=Timestamp.decode(ts) if ts is not None else Timestamp(),
            last_block_id=(BlockID.decode(lbi) if lbi is not None
                           else BlockID()),
            last_commit_hash=proto.field_bytes(f, 6, b""),
            data_hash=proto.field_bytes(f, 7, b""),
            validators_hash=proto.field_bytes(f, 8, b""),
            next_validators_hash=proto.field_bytes(f, 9, b""),
            consensus_hash=proto.field_bytes(f, 10, b""),
            app_hash=proto.field_bytes(f, 11, b""),
            last_results_hash=proto.field_bytes(f, 12, b""),
            evidence_hash=proto.field_bytes(f, 13, b""),
            proposer_address=proto.field_bytes(f, 14, b""))

    def validate_basic(self) -> None:
        if not self.chain_id or len(self.chain_id) > 50:
            raise ValueError("bad chain_id")
        if self.height <= 0:
            raise ValueError("non-positive height")
        for name in ("last_commit_hash", "data_hash", "validators_hash",
                     "next_validators_hash", "consensus_hash",
                     "last_results_hash", "evidence_hash"):
            h = getattr(self, name)
            if h and len(h) != 32:
                raise ValueError(f"bad {name} length")
        if len(self.proposer_address) != 20:
            raise ValueError("bad proposer address")


def tx_hash(tx: bytes) -> bytes:
    return hashlib.sha256(tx).digest()


@dataclass
class Data:
    txs: List[bytes] = dc_field(default_factory=list)

    def hash(self) -> bytes:
        """merkle over sha256(tx) leaves (types/tx.go:29-50)."""
        return merkle.hash_from_byte_slices([tx_hash(t) for t in self.txs])

    def encode(self) -> bytes:
        out = b""
        for t in self.txs:
            out += proto.f_bytes(1, t)
        return out

    @classmethod
    def decode(cls, buf: bytes) -> "Data":
        f = proto.parse_fields(buf)
        return cls(proto.field_all_bytes(f, 1))


@dataclass
class Block:
    header: Header
    data: Data = dc_field(default_factory=Data)
    evidence: list = dc_field(default_factory=list)
    last_commit: Commit = dc_field(default_factory=Commit)

    def hash(self) -> bytes:
        return self.header.hash()

    def encode(self) -> bytes:
        """proto Block (block.proto: header=1, data=2, evidence=3,
        last_commit=4)."""
        from .evidence import EvidenceList
        out = (proto.f_embed(1, self.header.encode())
               + proto.f_embed(2, self.data.encode())
               + proto.f_embed(3, EvidenceList(self.evidence).encode()))
        out += proto.f_embed(4, self.last_commit.encode())
        return out

    @classmethod
    def decode(cls, buf: bytes) -> "Block":
        from .evidence import EvidenceList
        f = proto.parse_fields(buf)
        hdr = proto.field_bytes(f, 1, None)
        if hdr is None:
            raise ValueError("block without header")
        data = proto.field_bytes(f, 2, None)
        ev = proto.field_bytes(f, 3, None)
        lc = proto.field_bytes(f, 4, None)
        return cls(header=Header.decode(hdr),
                   data=Data.decode(data) if data is not None else Data(),
                   evidence=(list(EvidenceList.decode(ev).evidence)
                             if ev is not None else []),
                   last_commit=Commit.decode(lc) if lc is not None
                   else Commit())

    def evidence_hash(self) -> bytes:
        from .evidence import EvidenceList
        return EvidenceList(self.evidence).hash()

    def make_part_set(self, part_size: int = BLOCK_PART_SIZE) -> "PartSet":
        return PartSet.from_data(self.encode(), part_size)


@dataclass
class Part:
    index: int
    bytes_: bytes
    proof: merkle.Proof

    def encode(self) -> bytes:
        """proto Part (types.proto): index=1, bytes=2, proof=3
        {total=1, index=2, leaf_hash=3, aunts=4 repeated}."""
        pf = (proto.f_varint(1, self.proof.total)
              + proto.f_varint(2, self.proof.index)
              + proto.f_bytes(3, self.proof.leaf_hash)
              + b"".join(proto.f_bytes(4, a) for a in self.proof.aunts))
        return (proto.f_varint(1, self.index)
                + proto.f_bytes(2, self.bytes_)
                + proto.f_embed(3, pf))

    @classmethod
    def decode(cls, buf: bytes) -> "Part":
        f = proto.parse_fields(buf)
        pf = proto.parse_fields(proto.field_bytes(f, 3, b""))
        return cls(
            index=proto.field_int(f, 1, 0),
            bytes_=proto.field_bytes(f, 2, b""),
            proof=merkle.Proof(
                total=proto.to_int64(proto.field_int(pf, 1, 0)),
                index=proto.to_int64(proto.field_int(pf, 2, 0)),
                leaf_hash=proto.field_bytes(pf, 3, b""),
                aunts=proto.field_all_bytes(pf, 4)))


class PartSet:
    """Block chunking for gossip (reference types/part_set.go): the block
    proto bytes split into parts, each with a merkle inclusion proof
    against the PartSetHeader hash."""

    def __init__(self, header: PartSetHeader, parts: List[Optional[Part]]):
        self.header = header
        self.parts = parts

    @classmethod
    def from_data(cls, data: bytes, part_size: int = BLOCK_PART_SIZE
                  ) -> "PartSet":
        chunks = [data[i:i + part_size]
                  for i in range(0, max(len(data), 1), part_size)]
        root, proofs = merkle.proofs_from_byte_slices(chunks)
        parts = [Part(i, c, p) for i, (c, p) in enumerate(zip(chunks, proofs))]
        return cls(PartSetHeader(len(chunks), root), parts)

    def is_complete(self) -> bool:
        return all(p is not None for p in self.parts)

    def reassemble(self) -> bytes:
        assert self.is_complete()
        return b"".join(p.bytes_ for p in self.parts)

    @classmethod
    def new_from_header(cls, header: PartSetHeader) -> "PartSet":
        return cls(header, [None] * header.total)

    def add_part(self, part: Part) -> bool:
        """Verify the part's proof against the header before accepting
        (reference types/part_set.go AddPart)."""
        if not (0 <= part.index < self.header.total):
            return False
        if self.parts[part.index] is not None:
            return False
        # the proof must be FOR this slot — a valid part replayed at a
        # different index would otherwise be stored there (reference
        # types/part_set.go Part.ValidateBasic)
        if part.proof.index != part.index \
                or part.proof.total != self.header.total:
            return False
        if not part.proof.verify(self.header.hash, part.bytes_):
            return False
        self.parts[part.index] = part
        return True
