"""Trusted light-block store (reference light/store/db/db.go) over the
KVStore seam — heights big-endian keyed so iteration is height-ordered.

Copy of `cometbft_tpu/light/store.py` (the port keeps its own), over
the port's `db/kv.MemDB` or any other `KVStore`.
"""

from __future__ import annotations

from typing import Optional

from ..state.state import _valset_from_json, _valset_to_json
from ..types.block import Commit, Header
from .types import LightBlock, SignedHeader
from ..types import proto

_PREFIX = b"lb:"
_END = _PREFIX + b"\xff" * 9  # past any 8-byte big-endian height key


def _key(height: int) -> bytes:
    return _PREFIX + height.to_bytes(8, "big")


class LightStore:
    def __init__(self, db):
        self._db = db

    def save_light_block(self, lb: LightBlock) -> None:
        body = (proto.f_embed(1, lb.signed_header.header.encode())
                + proto.f_embed(2, lb.signed_header.commit.encode())
                + proto.f_bytes(3, _valset_to_json(lb.validator_set)))
        self._db.set(_key(lb.height), body)

    def light_block(self, height: int) -> Optional[LightBlock]:
        raw = self._db.get(_key(height))
        if raw is None:
            return None
        f = proto.parse_fields(raw)
        return LightBlock(
            SignedHeader(Header.decode(proto.field_bytes(f, 1, b"")),
                         Commit.decode(proto.field_bytes(f, 2, b""))),
            _valset_from_json(proto.field_bytes(f, 3, b"")))

    def latest(self) -> Optional[LightBlock]:
        last = None
        for _k, _v in self._db.iterate(_PREFIX, _END):
            last = _k
        if last is None:
            return None
        return self.light_block(int.from_bytes(last[len(_PREFIX):], "big"))

    def lowest(self) -> Optional[LightBlock]:
        return self.lowest_above(0)

    def lowest_above(self, height: int) -> Optional[LightBlock]:
        """The lowest trusted block with height >= `height`."""
        for k, _v in self._db.iterate(_key(height), _END):
            return self.light_block(int.from_bytes(k[len(_PREFIX):], "big"))
        return None

    def highest_below(self, height: int) -> Optional[LightBlock]:
        """The highest trusted block with height < `height` (one ordered
        key scan, not per-height gets — the detector's common-anchor
        lookup)."""
        last = None
        for k, _v in self._db.iterate(_PREFIX, _key(height)):
            last = k
        if last is None:
            return None
        return self.light_block(int.from_bytes(last[len(_PREFIX):], "big"))

    def delete(self, height: int) -> None:
        """Evict a block (a detected-attack header must not stay
        trusted)."""
        self._db.delete(_key(height))

    def prune(self, keep: int) -> None:
        """Keep the `keep` highest blocks (reference db.go Prune)."""
        keys = [k for k, _ in self._db.iterate(_PREFIX, _END)]
        for k in keys[:max(0, len(keys) - keep)]:
            self._db.delete(k)
