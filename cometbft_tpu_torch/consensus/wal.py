"""Consensus write-ahead log (reference internal/consensus/wal.go:59-108,
wal_generator.go, internal/autofile/group.go).

Every message the consensus state machine processes is WAL-logged BEFORE
it is processed; own votes/proposals are written with fsync (WriteSync)
so a crashed node can never un-know a signature it released. On commit,
an `#ENDHEIGHT <h>` marker closes the height (reference state.go:1890);
replay on boot scans back to the last marker and re-feeds everything
after it (replay.go:95 catchupReplay).

Record framing (reference wal.go TimedWALMessage + autofile framing):
  u32 crc32(payload) | u32 len | payload
payload = u8 kind | body:
  kind 0 END_HEIGHT: varint height
  kind 1 VOTE:       proto Vote bytes
  kind 2 PROPOSAL:   proto-ish Proposal bytes (see _encode_proposal)
  kind 3 BLOCK_PART: varint height | varint round | varint index |
                     part bytes
  kind 4 TIMEOUT:    varint height | varint round | varint step |
                     varint duration_ms
A torn tail (crash mid-append) is detected by crc/length and truncated,
like db/kv.FileDB.

Copy of `cometbft_tpu/consensus/wal.py` over the port's `types/vote`
`Vote` and `Proposal`; a WAL written by either package reads in the
other. The recovery doctor reads the WAL; the port's consensus state
machine (`consensus/state.py`) writes and replays it.
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass
from typing import Iterator, List, Optional, Union

from ..libs import faultio
from ..types import proto
from ..types.block import BlockID
from ..types.vote import Vote, Proposal

_END_HEIGHT = 0
_VOTE = 1
_PROPOSAL = 2
_BLOCK_PART = 3
_TIMEOUT = 4


@dataclass(frozen=True)
class EndHeightMessage:
    height: int


@dataclass(frozen=True)
class WALVote:
    vote: Vote
    peer_id: str = ""


@dataclass(frozen=True)
class WALProposal:
    proposal: Proposal
    peer_id: str = ""


@dataclass(frozen=True)
class WALBlockPart:
    height: int
    round: int
    index: int
    part: bytes
    peer_id: str = ""


@dataclass(frozen=True)
class WALTimeout:
    """reference internal/consensus/ticker.go timeoutInfo."""
    height: int
    round: int
    step: int
    duration_ms: int


WALMessage = Union[EndHeightMessage, WALVote, WALProposal, WALBlockPart,
                   WALTimeout]


def _encode_proposal(p: Proposal) -> bytes:
    return (proto.f_varint(1, p.height)
            + proto.f_varint(2, p.round)
            + proto.f_varint(3, p.pol_round & 0xFFFFFFFFFFFFFFFF
                             if p.pol_round < 0 else p.pol_round)
            + proto.f_embed(4, p.block_id.encode())
            + proto.f_embed(5, p.timestamp.encode())
            + proto.f_bytes(6, p.signature))


def _decode_proposal(b: bytes) -> Proposal:
    f = proto.parse_fields(b)
    bid = proto.field_bytes(f, 4, None)
    ts = proto.field_bytes(f, 5, None)
    return Proposal(
        height=proto.to_int64(proto.field_int(f, 1, 0)),
        round=proto.to_int64(proto.field_int(f, 2, 0)),
        pol_round=proto.to_int64(proto.field_int(f, 3, 0)),
        block_id=BlockID.decode(bid) if bid is not None else BlockID(),
        timestamp=(proto.Timestamp.decode(ts) if ts is not None
                   else proto.Timestamp()),
        signature=proto.field_bytes(f, 6, b""))


def encode_message(msg: WALMessage) -> bytes:
    if isinstance(msg, EndHeightMessage):
        return bytes([_END_HEIGHT]) + proto.uvarint(msg.height)
    if isinstance(msg, WALVote):
        return bytes([_VOTE]) + msg.vote.encode()
    if isinstance(msg, WALProposal):
        return bytes([_PROPOSAL]) + _encode_proposal(msg.proposal)
    if isinstance(msg, WALBlockPart):
        return (bytes([_BLOCK_PART]) + proto.uvarint(msg.height)
                + proto.uvarint(msg.round) + proto.uvarint(msg.index)
                + msg.part)
    if isinstance(msg, WALTimeout):
        return (bytes([_TIMEOUT]) + proto.uvarint(msg.height)
                + proto.uvarint(msg.round) + proto.uvarint(msg.step)
                + proto.uvarint(msg.duration_ms))
    raise TypeError(f"unknown WAL message {type(msg)}")


def decode_message(payload: bytes) -> WALMessage:
    kind = payload[0]
    body = payload[1:]
    if kind == _END_HEIGHT:
        h, _ = proto.read_uvarint(body, 0)
        return EndHeightMessage(h)
    if kind == _VOTE:
        return WALVote(Vote.decode(body))
    if kind == _PROPOSAL:
        return WALProposal(_decode_proposal(body))
    if kind == _BLOCK_PART:
        h, pos = proto.read_uvarint(body, 0)
        r, pos = proto.read_uvarint(body, pos)
        i, pos = proto.read_uvarint(body, pos)
        return WALBlockPart(h, r, i, body[pos:])
    if kind == _TIMEOUT:
        h, pos = proto.read_uvarint(body, 0)
        r, pos = proto.read_uvarint(body, pos)
        s, pos = proto.read_uvarint(body, pos)
        d, pos = proto.read_uvarint(body, pos)
        return WALTimeout(h, r, s, d)
    raise ValueError(f"unknown WAL record kind {kind}")


class WAL:
    """reference internal/consensus/wal.go baseWAL over a rotating file
    group (reference internal/autofile/group.go).

    Layout mirrors autofile.Group: the head file at `path` receives all
    appends; when it exceeds `head_size_limit` bytes the head is
    renamed to `path.NNN` (monotonically increasing 3-digit index) at a
    record boundary and a fresh head is opened — rename+create, both
    atomic, so a kill between them at worst leaves an empty head.
    Readers iterate rotated files in index order, then the head. When
    the group exceeds `total_size_limit`, the OLDEST rotated files are
    dropped (reference Group.checkTotalSizeLimit group.go:238 — the WAL
    only ever needs data after the last #ENDHEIGHT; older heights are
    in the block store).

    Only the head can carry a torn tail (crash mid-append): rotated
    files are closed at record boundaries, so boot-time CRC repair
    truncates the head alone."""

    def __init__(self, path: str, head_size_limit: int = 8 << 20,
                 total_size_limit: int = 1 << 30):
        self.path = path
        self.head_size_limit = head_size_limit
        self.total_size_limit = total_size_limit
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if os.path.exists(path):
            good = self._scan_good_prefix(path)
            if good != os.path.getsize(path):
                with faultio.open_file(path, "r+b", label="wal:head") as f:
                    f.truncate(good)
        self._f = faultio.open_file(path, "ab", label="wal:head")

    # --- group layout ---------------------------------------------------------

    def _rotated(self) -> List[str]:
        """Rotated file paths, oldest first (index order)."""
        d = os.path.dirname(self.path) or "."
        base = os.path.basename(self.path)
        out = []
        for name in os.listdir(d):
            if name.startswith(base + "."):
                suffix = name[len(base) + 1:]
                if suffix.isdigit():
                    out.append((int(suffix), os.path.join(d, name)))
        return [p for _, p in sorted(out)]

    def _group_files(self) -> List[str]:
        return self._rotated() + [self.path]

    def _maybe_rotate(self) -> None:
        if self._f.tell() < self.head_size_limit:
            return
        rotated = self._rotated()
        nxt = 0
        if rotated:
            nxt = int(rotated[-1].rsplit(".", 1)[1]) + 1
        faultio.fsync(self._f)
        self._f.close()
        from ..libs.fail import fail_point
        fail_point("wal:pre-rotate-rename")
        os.rename(self.path, f"{self.path}.{nxt:03d}")
        fail_point("wal:post-rotate-rename")
        self._f = faultio.open_file(self.path, "ab", label="wal:head")
        # total-size enforcement: drop oldest rotated files
        files = self._rotated()
        total = sum(os.path.getsize(p) for p in files + [self.path])
        while files and total > self.total_size_limit:
            victim = files.pop(0)
            total -= os.path.getsize(victim)
            os.remove(victim)

    @staticmethod
    def _scan_good_prefix(path: str) -> int:
        good = 0
        with faultio.open_file(path, "rb", label="wal:read") as f:
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    break
                crc, ln = struct.unpack("<II", hdr)
                payload = f.read(ln)
                if len(payload) < ln or zlib.crc32(payload) != crc:
                    break
                good += 8 + ln
        return good

    # --- writes ---------------------------------------------------------------

    def write(self, msg: WALMessage) -> None:
        """Buffered append (reference wal.go:107 Write — group-buffered,
        flushed on ticker; we flush per-record, cheap for a local file).
        Rotation happens BEFORE the append so a record never straddles
        files and ENDHEIGHT markers land in the file whose records they
        close."""
        self._maybe_rotate()
        payload = encode_message(msg)
        rec = struct.pack("<II", zlib.crc32(payload), len(payload)) + payload
        self._f.write(rec)
        self._f.flush()

    def write_sync(self, msg: WALMessage) -> None:
        """fsync'd append — REQUIRED for own votes/proposals and
        #ENDHEIGHT (reference wal.go:83 WriteSync, state.go:825,1890):
        the signature must be durable before it can reach the network."""
        self.write(msg)
        faultio.fsync(self._f)

    # --- reads ----------------------------------------------------------------

    def replay_messages(self, after_height: int) -> List[WALMessage]:
        """All messages after the #ENDHEIGHT marker for `after_height`
        (reference replay.go:95 catchupReplay + wal.go SearchForEndHeight
        — the search spans the whole rotated group). If the marker is
        absent and the WAL is non-empty for a lower height, returns []
        (nothing to replay for this height)."""
        msgs: List[WALMessage] = []
        found = after_height == 0 and self._is_empty_or_starts_fresh()
        for msg in self.iter_messages():
            if found:
                msgs.append(msg)
            elif (isinstance(msg, EndHeightMessage)
                    and msg.height == after_height):
                found = True
                msgs = []
        return msgs

    def _is_empty_or_starts_fresh(self) -> bool:
        return True

    def iter_messages(self) -> Iterator[WALMessage]:
        """Stream every record across the group: rotated files oldest
        first, then the head (reference autofile GroupReader).

        A CRC/length-corrupt record ENDS the whole stream, wherever it
        sits: continuing into newer files after a gap would hand replay
        a non-contiguous message sequence (a missed ENDHEIGHT or
        proposal with its votes still following). The expected case —
        a torn HEAD tail from a crash mid-append — is already repaired
        by the constructor; mid-group corruption is disk damage and
        conservatively truncates replay at the gap (reference
        WALDecoder's DataCorruptionError posture, wal.go:284)."""
        for path in self._group_files():
            try:
                f = faultio.open_file(path, "rb", label="wal:read")
            except FileNotFoundError:
                continue  # pruned concurrently by total-size enforcement
            with f:
                while True:
                    hdr = f.read(8)
                    if len(hdr) < 8:
                        break
                    crc, ln = struct.unpack("<II", hdr)
                    payload = f.read(ln)
                    if len(payload) < ln or zlib.crc32(payload) != crc:
                        # corrupt record: end the WHOLE stream — but
                        # LOUDLY. The constructor already repaired any
                        # torn head tail, so landing here is disk
                        # damage an operator must hear about, not a
                        # silent short replay.
                        self._note_corruption(path, f.tell())
                        return
                    yield decode_message(payload)

    @staticmethod
    def _note_corruption(path: str, offset: int) -> None:
        import sys
        print(f"WAL corruption: CRC/length-bad record in {path} near "
              f"offset {offset}; replay truncated at the gap",
              file=sys.stderr, flush=True)
        # lazy: consensus/ -> store/ is a runtime-only edge, and this
        # is a cold disk-damage path
        from ..store import recovery
        m = recovery.metrics()
        if m is not None:
            m.wal_corruption.inc()

    def close(self) -> None:
        self._f.close()


class NilWAL:
    """Discard-everything WAL for tests (reference wal.go nilWAL)."""

    def write(self, msg: WALMessage) -> None:
        pass

    def write_sync(self, msg: WALMessage) -> None:
        pass

    def replay_messages(self, after_height: int) -> List[WALMessage]:
        return []

    def iter_messages(self):
        return iter(())

    def close(self) -> None:
        pass
