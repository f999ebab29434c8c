"""Block store: blocks persisted as parts + meta + commits
(reference store/store.go:194-331,527-559; port of
`cometbft_tpu/store/blockstore.py`).

Key layout (height big-endian so byte order == height order for scans):
  H:<height>      -> block meta (block_id proto || header proto)
  P:<height>:<i>  -> part bytes
  C:<height>      -> canonical commit for height (block h+1's LastCommit)
  SC:<height>     -> seen commit (the commit this node observed)
  AS:<height>     -> adopted seal (block_id || header || commit) — a
                     height finalized via sealsync whose BODY has not
                     backfilled yet; never advances base/height, and
                     save_block deletes it when the body arrives
  base / height / adopted_tip -> chain span markers
"""

from __future__ import annotations

import threading
from typing import Optional

from ..db.kv import KVStore
from ..types import proto
from ..types.block import Block, BlockID, Commit, Header, PartSet

_KEY_BASE = b"blockstore:base"
_KEY_HEIGHT = b"blockstore:height"
_KEY_ADOPTED_TIP = b"blockstore:adopted_tip"


def _h(prefix: bytes, height: int) -> bytes:
    return prefix + height.to_bytes(8, "big")


class BlockStore:
    def __init__(self, db: KVStore):
        self._db = db
        self._lock = threading.RLock()
        b = db.get(_KEY_BASE)
        h = db.get(_KEY_HEIGHT)
        a = db.get(_KEY_ADOPTED_TIP)
        self._base = int.from_bytes(b, "big") if b else 0
        self._height = int.from_bytes(h, "big") if h else 0
        self._adopted_tip = int.from_bytes(a, "big") if a else 0

    def base(self) -> int:
        with self._lock:
            return self._base

    def height(self) -> int:
        with self._lock:
            return self._height

    def size(self) -> int:
        with self._lock:
            return self._height - self._base + 1 if self._height else 0

    def save_block(self, block: Block, parts: PartSet,
                   seen_commit: Commit, extended_commit=None) -> None:
        """reference store/store.go:527 SaveBlock /
        SaveBlockWithExtendedCommit (extensions must survive a restart
        so the next proposer can feed them to PrepareProposal)."""
        height = block.header.height
        with self._lock:
            # idempotent for the current tip: a crash between save and
            # state-apply means the same height is legitimately re-saved on
            # retry (reference blocksync saves before applying,
            # internal/blocksync/reactor.go:527-532)
            if self._height and height not in (self._height, self._height + 1):
                raise ValueError(
                    f"non-contiguous save: have {self._height}, got {height}")
            sets = []
            meta = (proto.f_embed(1, BlockID(
                        block.hash(), parts.header).encode())
                    + proto.f_embed(2, block.header.encode()))
            sets.append((_h(b"H:", height), meta))
            # hash -> height index (reference store.go keeps BH: keys)
            # so /block_by_hash is one read, not a reverse scan
            sets.append((b"BH:" + block.hash(),
                         height.to_bytes(8, "big")))
            for part in parts.parts:
                sets.append((_h(b"P:", height) + part.index.to_bytes(4, "big"),
                             part.bytes_))
            # block h carries the canonical commit for h-1
            if block.last_commit.height:
                sets.append((_h(b"C:", height - 1),
                             block.last_commit.encode()))
            sets.append((_h(b"SC:", height), seen_commit.encode()))
            if extended_commit is not None:
                sets.append((_h(b"EC:", height),
                             extended_commit.encode()))
            new_base = self._base or height
            sets.append((_KEY_BASE, new_base.to_bytes(8, "big")))
            sets.append((_KEY_HEIGHT, height.to_bytes(8, "big")))
            deletes = []
            if height <= self._adopted_tip:
                # body backfilled for an adopted height: the canonical
                # H:/P:/SC: keys now own it, drop the seal record
                deletes.append(_h(b"AS:", height))
            self._db.write_batch(sets, deletes)
            self._base, self._height = new_base, height

    def load_block(self, height: int) -> Optional[Block]:
        meta = self.load_block_meta(height)
        if meta is None:
            return None
        block_id, _ = meta
        chunks = []
        for i in range(block_id.parts.total if block_id.parts.total else 1):
            p = self._db.get(_h(b"P:", height) + i.to_bytes(4, "big"))
            if p is None:
                return None
            chunks.append(p)
        return Block.decode(b"".join(chunks))

    def load_block_meta(self, height: int
                        ) -> Optional[tuple[BlockID, Header]]:
        raw = self._db.get(_h(b"H:", height))
        if raw is None:
            return None
        f = proto.parse_fields(raw)
        return (BlockID.decode(proto.field_one(f, 1, b"")),
                Header.decode(proto.field_one(f, 2, b"")))

    def height_by_hash(self, block_hash: bytes) -> Optional[int]:
        """O(1) via the BH: index (reference store.go blockHashKey)."""
        raw = self._db.get(b"BH:" + block_hash)
        return int.from_bytes(raw, "big") if raw is not None else None

    def load_block_part(self, height: int, index: int) -> Optional[bytes]:
        return self._db.get(_h(b"P:", height) + index.to_bytes(4, "big"))

    def load_block_commit(self, height: int) -> Optional[Commit]:
        """Canonical commit for `height` (from block height+1's LastCommit,
        reference store/store.go LoadBlockCommit)."""
        raw = self._db.get(_h(b"C:", height))
        return Commit.decode(raw) if raw is not None else None

    def load_extended_commit(self, height: int):
        """reference store.go LoadBlockExtendedCommit."""
        from ..types.extended_commit import ExtendedCommit
        raw = self._db.get(_h(b"EC:", height))
        return ExtendedCommit.decode(raw) if raw is not None else None

    def load_seen_commit(self, height: int) -> Optional[Commit]:
        raw = self._db.get(_h(b"SC:", height))
        return Commit.decode(raw) if raw is not None else None

    def bootstrap_seen_commit(self, height: int, commit: Commit) -> None:
        """Statesync bootstrap (reference node/node.go:152
        BootstrapState → store.SaveSeenCommit): record the
        light-verified commit for the restored height so consensus can
        propose at height+1 before any block exists locally."""
        with self._lock:
            self._db.set(_h(b"SC:", height), commit.encode())

    # --- adopted seals (sealsync/) ----------------------------------------

    def adopted_tip(self) -> int:
        """Highest height with adopted finality (0 = none). Distinct
        from height(): adopted heights have NO body yet — blocksync
        backfill is what moves height() up to meet it."""
        with self._lock:
            return self._adopted_tip

    def save_adopted_seal(self, height: int, block_id: BlockID,
                          header: Header, commit: Commit) -> None:
        """Record adopted finality for `height` WITHOUT advancing
        base/height (sealsync install — the body arrives later via
        save_block, which supersedes this record). Contiguity is
        enforced against the combined tip so the adopted span always
        extends the chain; rewriting an already-adopted height is
        idempotent (adoption resume replans the whole span)."""
        with self._lock:
            tip = max(self._height, self._adopted_tip)
            if tip and height > tip + 1:
                raise ValueError(
                    f"non-contiguous adopted seal: tip {tip}, "
                    f"got {height}")
            raw = (proto.f_embed(1, block_id.encode())
                   + proto.f_embed(2, header.encode())
                   + proto.f_embed(3, commit.encode()))
            sets = [(_h(b"AS:", height), raw)]
            new_tip = max(self._adopted_tip, height)
            sets.append((_KEY_ADOPTED_TIP, new_tip.to_bytes(8, "big")))
            self._db.write_batch(sets)
            self._adopted_tip = new_tip

    def adopted_seal_heights(self) -> list[int]:
        """Heights with a live AS: record, ascending (the recovery
        doctor's orphan scan; b";" is b":" + 1, closing the prefix)."""
        with self._lock:
            return [int.from_bytes(k[3:], "big")
                    for k, _ in self._db.iterate(b"AS:", b"AS;")]

    def drop_adopted_seal(self, height: int) -> None:
        """Remove one AS: record without touching adopted_tip — the
        doctor's repair for a seal whose body is already canonical
        (save_block should have deleted it; a pre-v2 crash between
        batches could strand it)."""
        with self._lock:
            self._db.write_batch([], [_h(b"AS:", height)])

    def load_adopted_seal(self, height: int
                          ) -> Optional[tuple[BlockID, Header, Commit]]:
        raw = self._db.get(_h(b"AS:", height))
        if raw is None:
            return None
        f = proto.parse_fields(raw)
        return (BlockID.decode(proto.field_one(f, 1, b"")),
                Header.decode(proto.field_one(f, 2, b"")),
                Commit.decode(proto.field_one(f, 3, b"")))

    def delete_block(self, height: int) -> None:
        """Remove the TIP block (reference store/store.go
        DeleteLatestBlock — the rollback repair path)."""
        with self._lock:
            if height != self._height:
                raise ValueError(
                    f"can only delete the tip ({self._height}), "
                    f"got {height}")
            meta = self.load_block_meta(height)
            deletes = [_h(b"H:", height), _h(b"C:", height),
                       _h(b"SC:", height), _h(b"EC:", height)]
            if meta:
                deletes.append(b"BH:" + meta[0].hash)
                for i in range(meta[0].parts.total):
                    deletes.append(_h(b"P:", height)
                                   + i.to_bytes(4, "big"))
            self._height = height - 1
            self._db.write_batch(
                [(_KEY_HEIGHT, self._height.to_bytes(8, "big"))], deletes)

    def prune_blocks(self, retain_height: int) -> int:
        """Delete blocks below retain_height; returns pruned count
        (reference store/store.go PruneBlocks)."""
        with self._lock:
            if retain_height > self._height + 1:
                raise ValueError(
                    f"cannot prune beyond height+1 ({self._height + 1}), "
                    f"got {retain_height}")
            if retain_height <= self._base:
                return 0
            pruned = 0
            deletes = []
            for h in range(self._base, min(retain_height, self._height + 1)):
                meta = self.load_block_meta(h)
                deletes.append(_h(b"H:", h))
                deletes.append(_h(b"C:", h))
                deletes.append(_h(b"SC:", h))
                deletes.append(_h(b"EC:", h))
                if meta:
                    deletes.append(b"BH:" + meta[0].hash)
                    for i in range(meta[0].parts.total):
                        deletes.append(_h(b"P:", h) + i.to_bytes(4, "big"))
                pruned += 1
            self._base = retain_height
            self._db.write_batch(
                [(_KEY_BASE, retain_height.to_bytes(8, "big"))], deletes)
            return pruned
