"""Seal-chain planning: the host-side trust rule for adopting decided
heights from `(height, header, AggregatedCommit)` tuples alone.

The rule that makes skip verification sound is pure hashing, no
pairings: `Block.hash() == Header.hash()`, so
`header_{h+1}.last_block_id.hash == header_h.hash()` chains headers
backward, and `header_{h+1}.last_commit_hash == commit_h.hash()` binds
the served commit for every interior height. One verified seal at a
span's tip therefore proves every earlier header AND commit in the
span. Validator-set continuity rides the same chain:
`header_h.next_validators_hash` pins the set for h+1, so an epoch
boundary only needs the new set's BYTES (validated against the pinned
hash) plus self-certifying proofs of possession — never extra trust.

`plan_adoption` runs ALL of these checks and decides the pivot
schedule (which seals actually pay a pairing) before any pairing is
marshaled — the same thresholds-are-host-side rule as farm/planner.py:
pivots are the span tip, every epoch boundary's last pre-change
height, and a bounded-skip stride so no single seal is trusted for
more than `max_skip` heights.

Copy of `cometbft_tpu/sealsync/chain.py` (the port keeps its own): pure
hashing and tallying, no device work.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional

from ..types import proto
from ..types.agg_commit import AggregatedCommit
from ..types.block import Commit, Header
from ..types.validator import ValidatorSet

DEFAULT_MAX_SKIP = 64


class SealChainError(ValueError):
    """A served seal span failed a host-side continuity check: the
    provider is wrong or lying. Carries the first offending height so
    the caller can report/ban precisely."""

    def __init__(self, height: int, reason: str):
        super().__init__(f"seal chain invalid at height {height}: {reason}")
        self.height = height
        self.reason = reason


@dataclass(frozen=True)
class SealTuple:
    """One decided height as served by a provider: the header, its
    aggregate seal, and — only at an epoch boundary — the new
    validator set's bytes plus proofs of possession for its keys.
    Valset bytes are NEVER trusted as served: the planner admits them
    only if their hash equals the hash pinned by the (hash-chained)
    predecessor header, and PoPs are self-certifying."""

    height: int
    header: Header
    commit: AggregatedCommit
    valset: Optional[ValidatorSet] = None
    pops: Dict[bytes, bytes] = dc_field(default_factory=dict)

    def encode(self) -> bytes:
        """proto: height=1, header=2, commit=3, epoch=4 (JSON valset +
        hex pops, present only at a boundary)."""
        out = (proto.f_varint(1, self.height)
               + proto.f_embed(2, self.header.encode())
               + proto.f_embed(3, self.commit.encode()))
        if self.valset is not None:
            from ..state.state import _valset_to_json
            epoch = json.dumps({
                "valset": _valset_to_json(self.valset).decode(),
                "pops": {pub.hex(): pop.hex()
                         for pub, pop in sorted(self.pops.items())},
            }).encode()
            out += proto.f_embed(4, epoch)
        return out

    @classmethod
    def decode(cls, buf: bytes) -> "SealTuple":
        f = proto.parse_fields(buf)
        commit = Commit.decode(proto.field_one(f, 3, b""))
        if not isinstance(commit, AggregatedCommit):
            raise ValueError("seal tuple commit is not aggregated")
        valset = None
        pops: Dict[bytes, bytes] = {}
        raw_epoch = proto.field_one(f, 4, None)
        if raw_epoch is not None:
            from ..state.state import _valset_from_json
            d = json.loads(raw_epoch)
            valset = _valset_from_json(d["valset"].encode())
            pops = {bytes.fromhex(pub): bytes.fromhex(pop)
                    for pub, pop in d.get("pops", {}).items()}
        return cls(proto.to_int64(proto.field_int(f, 1, 0)),
                   Header.decode(proto.field_one(f, 2, b"")),
                   commit, valset, pops)


@dataclass
class AdoptionPlan:
    """plan_adoption's output: the admitted span plus the pivot
    schedule. Every continuity fact below is already host-verified;
    only the `pivots` still owe a pairing."""

    tuples: List[SealTuple]
    pivots: List[int]
    vals_for: Dict[int, ValidatorSet]
    # pubkey -> PoP for keys first seen inside this span (epoch
    # boundaries); must pass register_pops_batch before any pivot
    # pairing is marshaled
    new_pops: Dict[bytes, bytes]

    @property
    def start(self) -> int:
        return self.tuples[0].height

    @property
    def tip(self) -> int:
        return self.tuples[-1].height


def plan_adoption(chain_id: str, trusted_height: int,
                  trusted_vals: ValidatorSet, tuples: List[SealTuple],
                  max_skip: int = DEFAULT_MAX_SKIP,
                  trusted_vh: Optional[bytes] = None) -> AdoptionPlan:
    """Admit a served seal span against the local trust anchor and
    decide which heights are pivots. `trusted_vals` is the newest set
    whose BYTES the caller holds; `trusted_vh` is the hash pinned for
    `trusted_height + 1`'s set (defaults to trusted_vals.hash() — they
    differ only when the anchor's own header announced a set change,
    in which case the span must open with the new set's bytes, exactly
    like an interior epoch boundary). Raises SealChainError on the
    FIRST violation — all checks are hashing/tallying; no pairing runs
    here."""
    if not tuples:
        raise SealChainError(trusted_height + 1, "empty span")
    if max_skip < 1:
        raise ValueError(f"max_skip must be >= 1, got {max_skip}")
    vals_for: Dict[int, ValidatorSet] = {}
    new_pops: Dict[bytes, bytes] = {}
    cur_vals: Optional[ValidatorSet] = trusted_vals
    expected_vh = trusted_vh if trusted_vh is not None \
        else trusted_vals.hash()
    prev: Optional[SealTuple] = None
    for i, t in enumerate(tuples):
        h = trusted_height + 1 + i
        if t.height != h:
            raise SealChainError(h, f"non-contiguous span (got {t.height})")
        hdr = t.header
        if hdr.chain_id != chain_id:
            raise SealChainError(h, f"wrong chain id {hdr.chain_id!r}")
        if hdr.height != h:
            raise SealChainError(h, f"header height {hdr.height}")
        try:
            hdr.validate_basic()
            t.commit.validate_basic()
        except ValueError as exc:
            raise SealChainError(h, f"structural: {exc}") from exc
        if t.commit.height != h:
            raise SealChainError(h, f"commit height {t.commit.height}")
        if t.commit.block_id.hash != hdr.hash():
            raise SealChainError(h, "commit does not seal this header")
        if prev is not None:
            if hdr.last_block_id.hash != prev.header.hash():
                raise SealChainError(h, "broken header hash chain")
            if hdr.last_commit_hash != prev.commit.hash():
                raise SealChainError(h, "last_commit_hash does not bind "
                                        "served predecessor commit")
            expected_vh = prev.header.next_validators_hash
        if hdr.validators_hash != expected_vh:
            raise SealChainError(h, "validators_hash breaks continuity")
        if cur_vals is None or cur_vals.hash() != hdr.validators_hash:
            # epoch boundary (or a span opening past one): the new
            # set's bytes must be served and must hash to the value
            # the chain itself pinned — the bytes are untrusted, the
            # hash they must match is not
            if t.valset is None:
                raise SealChainError(h, "epoch boundary without valset")
            if t.valset.hash() != hdr.validators_hash:
                raise SealChainError(h, "served valset hash mismatch")
            cur_vals = t.valset
            new_pops.update(t.pops)
        if len(cur_vals) != len(t.commit.signatures):
            raise SealChainError(h, "signature count != valset size")
        vals_for[h] = cur_vals
        prev = t
    pivots = _pivot_schedule(tuples, max_skip)
    return AdoptionPlan(tuples, pivots, vals_for, new_pops)


def _pivot_schedule(tuples: List[SealTuple], max_skip: int) -> List[int]:
    """Pivots = span tip (always: it anchors the whole hash chain) +
    the last height of each epoch (the final seal signed by each set —
    defense in depth so a set change is attested by the outgoing set's
    own seal) + a `max_skip` stride so one seal never vouches for an
    unbounded run of heights."""
    pivots = set()
    last = tuples[-1].height
    pivots.add(last)
    for i, t in enumerate(tuples):
        if i + 1 < len(tuples) and tuples[i + 1].header.validators_hash \
                != t.header.validators_hash:
            pivots.add(t.height)
        if (i + 1) % max_skip == 0:
            pivots.add(t.height)
    return sorted(pivots)
