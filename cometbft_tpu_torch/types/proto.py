"""Hand-rolled protobuf wire encoding for the consensus-critical messages.

Wire-level parity with the reference is normative: one byte of difference in
canonical sign-bytes breaks every signature (SURVEY §7 hard part (e)). The
encoders below reproduce the exact emission rules of the reference's
generated gogoproto marshalers (reference api/cometbft/types/v1/
canonical.pb.go:598-648):

- proto3 scalars are emitted iff non-zero / non-empty,
- nullable embedded messages iff present,
- NON-nullable embedded messages (e.g. timestamps, part_set_header) are
  ALWAYS emitted, even when empty,
- sfixed64 height/round in canonical messages (fixed-size encoding is what
  makes the sign-bytes length predictable for hardware signers),
- sign-bytes are varint-length-prefixed (reference internal/protoio,
  types/vote.go:150 MarshalDelimited).

Field numbers cited per message from the reference .proto files
(proto/cometbft/types/v1/{canonical,types}.proto, crypto/v1/keys.proto,
version/v1/types.proto).

Copy of `cometbft_tpu/types/proto.py` (the port keeps its own).
"""

from __future__ import annotations

from dataclasses import dataclass

# wire types
_VARINT = 0
_FIX64 = 1
_BYTES = 2


def uvarint(n: int) -> bytes:
    assert n >= 0
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def varint(n: int) -> bytes:
    """proto varint of an int64 (negative -> 10-byte two's complement)."""
    return uvarint(n & 0xFFFFFFFFFFFFFFFF if n < 0 else n)


def tag(field: int, wire: int) -> bytes:
    return uvarint((field << 3) | wire)


def f_varint(field: int, n: int) -> bytes:
    """Scalar varint field, proto3 rule: omitted when zero."""
    return b"" if n == 0 else tag(field, _VARINT) + varint(n)


def f_sfixed64(field: int, n: int) -> bytes:
    if n == 0:
        return b""
    return tag(field, _FIX64) + (n & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little")


def f_bytes(field: int, b: bytes) -> bytes:
    if not b:
        return b""
    return tag(field, _BYTES) + uvarint(len(b)) + b


def f_string(field: int, s: str) -> bytes:
    return f_bytes(field, s.encode("utf-8"))


def f_embed(field: int, payload: bytes) -> bytes:
    """Embedded message, ALWAYS emitted (gogoproto nullable=false)."""
    return tag(field, _BYTES) + uvarint(len(payload)) + payload


def f_embed_opt(field: int, payload: bytes | None) -> bytes:
    """Embedded message pointer: omitted when None."""
    return b"" if payload is None else f_embed(field, payload)


def marshal_delimited(payload: bytes) -> bytes:
    return uvarint(len(payload)) + payload


# --- wire decoding -----------------------------------------------------------

def read_uvarint(buf: bytes, pos: int) -> tuple[int, int]:
    """(value, new_pos); raises ValueError on truncation/overlong."""
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def to_int64(u: int) -> int:
    """Interpret a uint64 wire value as int64 two's complement."""
    return u - (1 << 64) if u >= (1 << 63) else u


def parse_fields(buf: bytes) -> dict:
    """Parse a proto message into {field_number: [values]} where a value is
    an int (varint / fixed64 / fixed32, raw unsigned) or bytes
    (length-delimited). Unknown wire types raise."""
    fields: dict = {}
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = read_uvarint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == _VARINT:
            val, pos = read_uvarint(buf, pos)
        elif wire == _FIX64:
            if pos + 8 > n:
                raise ValueError("truncated fixed64")
            val = int.from_bytes(buf[pos:pos + 8], "little")
            pos += 8
        elif wire == _BYTES:
            ln, pos = read_uvarint(buf, pos)
            if pos + ln > n:
                raise ValueError("truncated bytes field")
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:  # fixed32
            if pos + 4 > n:
                raise ValueError("truncated fixed32")
            val = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        fields.setdefault(field, []).append(val)
    return fields


def field_one(fields: dict, num: int, default=None):
    vals = fields.get(num)
    return vals[-1] if vals else default


def field_int(fields: dict, num: int, default: int = 0) -> int:
    """field_one that enforces a varint/fixed wire value. A peer encoding
    the field with the wrong wire type gets ValueError — a decode failure —
    instead of an int leaking into message constructors (decoders must
    never crash the ingest loop with TypeError/AttributeError)."""
    v = field_one(fields, num, default)
    if not isinstance(v, int):
        raise ValueError(f"field {num}: expected scalar, got bytes")
    return v


def field_bytes(fields: dict, num: int, default=b""):
    """field_one that enforces a length-delimited wire value. A None
    default passes through for optional embedded messages."""
    v = field_one(fields, num, default)
    if v is None:
        return None
    if not isinstance(v, (bytes, bytearray)):
        raise ValueError(f"field {num}: expected bytes, got scalar")
    return bytes(v)


def field_all(fields: dict, num: int) -> list:
    return fields.get(num, [])


def field_all_bytes(fields: dict, num: int) -> list:
    vals = fields.get(num, [])
    if any(not isinstance(v, (bytes, bytearray)) for v in vals):
        raise ValueError(f"field {num}: expected bytes, got scalar")
    return [bytes(v) for v in vals]


# --- google.protobuf.Timestamp ----------------------------------------------

# Go's zero time.Time (Jan 1, year 1, UTC) as Unix seconds. gogoproto's
# stdtime marshals the zero time as Timestamp{seconds: -62135596800}, NOT
# as an empty message — absent CommitSigs carry zero timestamps (reference
# types/block.go:612), so this sentinel is wire-normative for Commit.hash()
# and every header hash above it.
GO_ZERO_SECONDS = -62135596800


@dataclass(frozen=True, order=True)
class Timestamp:
    """(seconds, nanos) since epoch, UTC — the canonical time form
    (reference types/canonical.go:80-86 forces UTC).

    The default value is Go's ZERO time (year 1), not the Unix epoch, so
    that default-constructed timestamps encode byte-identically to the
    reference's zero time.Time."""
    seconds: int = GO_ZERO_SECONDS
    nanos: int = 0

    def encode(self) -> bytes:
        return f_varint(1, self.seconds) + f_varint(2, self.nanos)

    @classmethod
    def now(cls) -> "Timestamp":
        # read through the time seam: under simnet's virtual clock every
        # in-process node stamps votes/blocks from the same deterministic
        # source (libs/timesource.py); live nodes get time.time_ns
        from ..libs import timesource
        t = timesource.time_ns()
        return cls(t // 1_000_000_000, t % 1_000_000_000)

    @classmethod
    def decode(cls, buf: bytes) -> "Timestamp":
        f = parse_fields(buf)
        return cls(to_int64(field_int(f, 1, 0)), to_int64(field_int(f, 2, 0)))

    def is_zero(self) -> bool:
        return self.seconds == GO_ZERO_SECONDS and self.nanos == 0


# --- canonical messages (proto/cometbft/types/v1/canonical.proto) -----------

def canonical_part_set_header(total: int, hash_: bytes) -> bytes:
    return f_varint(1, total) + f_bytes(2, hash_)


def canonical_block_id(hash_: bytes, psh_total: int, psh_hash: bytes) -> bytes:
    return (f_bytes(1, hash_)
            + f_embed(2, canonical_part_set_header(psh_total, psh_hash)))


def canonical_vote(type_: int, height: int, round_: int,
                   block_id: bytes | None, ts: Timestamp,
                   chain_id: str) -> bytes:
    """CanonicalVote: type=1, height=2 sfixed64, round=3 sfixed64,
    block_id=4 (nullable), timestamp=5 (non-nullable), chain_id=6."""
    return (f_varint(1, type_)
            + f_sfixed64(2, height)
            + f_sfixed64(3, round_)
            + f_embed_opt(4, block_id)
            + f_embed(5, ts.encode())
            + f_string(6, chain_id))


def canonical_proposal(type_: int, height: int, round_: int, pol_round: int,
                       block_id: bytes | None, ts: Timestamp,
                       chain_id: str) -> bytes:
    """CanonicalProposal: type=1, height=2 sfixed64, round=3 sfixed64,
    pol_round=4 int64, block_id=5, timestamp=6, chain_id=7."""
    return (f_varint(1, type_)
            + f_sfixed64(2, height)
            + f_sfixed64(3, round_)
            + f_varint(4, pol_round & 0xFFFFFFFFFFFFFFFF if pol_round < 0
                       else pol_round)
            + f_embed_opt(5, block_id)
            + f_embed(6, ts.encode())
            + f_string(7, chain_id))


def canonical_vote_extension(extension: bytes, height: int, round_: int,
                             chain_id: str) -> bytes:
    """CanonicalVoteExtension: extension=1, height=2 sfixed64,
    round=3 sfixed64, chain_id=4."""
    return (f_bytes(1, extension)
            + f_sfixed64(2, height)
            + f_sfixed64(3, round_)
            + f_string(4, chain_id))


# --- wrapper-value encodings (header field hashing) --------------------------

def cdc_bytes(b: bytes) -> bytes:
    """gogotypes.BytesValue{Value: b} proto bytes; nil-like inputs -> empty
    (reference types/encoding_helper.go cdcEncode)."""
    return f_bytes(1, b)


def cdc_string(s: str) -> bytes:
    return f_string(1, s)


def cdc_int64(n: int) -> bytes:
    return f_varint(1, n)


# --- crypto keys & version (for validator-set / header hashing) --------------

def public_key_proto(key_type: str, key_bytes: bytes) -> bytes:
    """cometbft.crypto.v1.PublicKey oneof: ed25519=1, secp256k1=2,
    bls12381=3 (reference proto/cometbft/crypto/v1/keys.proto).
    "bls12_381" is crypto/bls12381.KEY_TYPE (const.go spells the wire
    type string with the underscore); both spellings map to field 3 so
    a BLS validator hashes instead of KeyError-ing mid-consensus."""
    field = {"ed25519": 1, "secp256k1": 2,
             "bls12381": 3, "bls12_381": 3}[key_type]
    return tag(field, _BYTES) + uvarint(len(key_bytes)) + key_bytes


def simple_validator(pubkey_proto: bytes, voting_power: int) -> bytes:
    """SimpleValidator: pub_key=1 (nullable ptr), voting_power=2
    (reference types/validator.go:118-133)."""
    return f_embed_opt(1, pubkey_proto) + f_varint(2, voting_power)


def consensus_version(block: int, app: int) -> bytes:
    """cometbft.version.v1.Consensus: block=1, app=2."""
    return f_varint(1, block) + f_varint(2, app)
