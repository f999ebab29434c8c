"""Validator and ValidatorSet with proposer-priority rotation
(reference types/validator.go, types/validator_set.go).

The rotation algorithm is reproduced exactly — it is consensus-critical
(every node must agree on the proposer): rescale priorities into a
2*totalPower window, center on the average, then per increment add each
validator's power and debit the max-priority validator by totalPower
(reference types/validator_set.go:105-235); ties break toward the smaller
address (types/validator.go:64-85).

Copy of `cometbft_tpu/types/validator.py` (the port keeps its own).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional

from ..crypto.keys import PubKey
from ..crypto import merkle
from . import proto

MAX_TOTAL_VOTING_POWER = (2**63 - 1) // 8   # validator_set.go:25
PRIORITY_WINDOW_SIZE_FACTOR = 2             # validator_set.go:30
_I64_MAX = 2**63 - 1
_I64_MIN = -(2**63)


def _clip(v: int) -> int:
    """safeAddClip/safeSubClip semantics: saturate at int64 bounds."""
    return max(_I64_MIN, min(_I64_MAX, v))


@dataclass
class Validator:
    pub_key: PubKey
    voting_power: int
    proposer_priority: int = 0

    @property
    def address(self) -> bytes:
        return self.pub_key.address()

    def bytes_(self) -> bytes:
        """SimpleValidator proto encoding, the validator-hash leaf
        (reference types/validator.go:118-133)."""
        pk = proto.public_key_proto(self.pub_key.type_(),
                                    self.pub_key.bytes_())
        return proto.simple_validator(pk, self.voting_power)

    def copy(self) -> "Validator":
        return Validator(self.pub_key, self.voting_power,
                         self.proposer_priority)

    def compare_proposer_priority(self, other: "Validator") -> "Validator":
        """Higher priority wins; ties break toward the smaller address
        (reference types/validator.go:64-85)."""
        if self.proposer_priority > other.proposer_priority:
            return self
        if self.proposer_priority < other.proposer_priority:
            return other
        if self.address < other.address:
            return self
        if self.address > other.address:
            return other
        raise ValueError("cannot compare identical validators")


class ValidatorSet:
    """Sorted validator set (by descending power, then ascending address —
    reference types/validator_set.go ValidatorsByVotingPower)."""

    # class-level default so raw __new__ constructions (e.g. state
    # deserialization) inherit an empty memo instead of AttributeError
    _hash: Optional[bytes] = None

    def __init__(self, validators: List[Validator],
                 proposer: Optional[Validator] = None):
        vals = sorted((v.copy() for v in validators),
                      key=lambda v: (-v.voting_power, v.address))
        self.validators: List[Validator] = vals
        self._by_address: Dict[bytes, int] = {
            v.address: i for i, v in enumerate(vals)}
        if len(self._by_address) != len(vals):
            raise ValueError("duplicate validator address")
        self._total: Optional[int] = None
        self._hash: Optional[bytes] = None
        if proposer is not None:
            idx = self._by_address.get(proposer.address)
            self.proposer: Optional[Validator] = (
                vals[idx] if idx is not None else proposer)
        elif vals:
            # fresh set: one increment establishes the initial proposer
            self.proposer = None
            self.increment_proposer_priority(1)
        else:
            self.proposer = None

    def __len__(self) -> int:
        return len(self.validators)

    def is_empty(self) -> bool:
        return not self.validators

    def total_voting_power(self) -> int:
        if self._total is None:
            t = sum(v.voting_power for v in self.validators)
            if t > MAX_TOTAL_VOTING_POWER:
                raise ValueError("total voting power exceeds cap")
            self._total = t
        return self._total

    def get_by_address(self, addr: bytes
                       ) -> tuple[int, Optional[Validator]]:
        idx = self._by_address.get(addr)
        if idx is None:
            return -1, None
        return idx, self.validators[idx]

    def get_by_index(self, idx: int) -> Optional[Validator]:
        if 0 <= idx < len(self.validators):
            return self.validators[idx]
        return None

    def has_address(self, addr: bytes) -> bool:
        return addr in self._by_address

    def hash(self) -> bytes:
        """merkle over SimpleValidator encodings
        (reference types/validator_set.go:348-354). Memoized: the hash
        covers (pubkey, power) only — proposer-priority rotation does
        not change it — and the one membership mutator
        (update_with_change_set) invalidates, same discipline as
        _total. Blocksync apply compares valset hashes per height, so
        recomputing the merkle each call dominated the sequential
        apply stage the pipeline cannot hide."""
        if self._hash is None:
            self._hash = merkle.hash_from_byte_slices(
                [v.bytes_() for v in self.validators])
        return self._hash

    def get_proposer(self) -> Optional[Validator]:
        return self.proposer

    def copy(self) -> "ValidatorSet":
        cp = ValidatorSet.__new__(ValidatorSet)
        cp.validators = [v.copy() for v in self.validators]
        cp._by_address = {v.address: i for i, v in enumerate(cp.validators)}
        cp._total = self._total
        cp._hash = self._hash
        cp.proposer = None
        if self.proposer is not None:
            idx = cp._by_address.get(self.proposer.address)
            cp.proposer = (cp.validators[idx] if idx is not None
                           else self.proposer.copy())
        return cp

    # --- proposer rotation (validator_set.go:105-235) -----------------------

    def rescale_priorities(self, diff_max: int) -> None:
        if diff_max <= 0:
            return
        prios = [v.proposer_priority for v in self.validators]
        diff = max(prios) - min(prios)
        if diff > diff_max:
            ratio = (diff + diff_max - 1) // diff_max
            for v in self.validators:
                # Go integer division truncates toward zero
                q = abs(v.proposer_priority) // ratio
                v.proposer_priority = q if v.proposer_priority >= 0 else -q

    def _shift_by_avg_proposer_priority(self) -> None:
        n = len(self.validators)
        avg = sum(v.proposer_priority for v in self.validators) // n
        for v in self.validators:
            v.proposer_priority = _clip(v.proposer_priority - avg)

    def _increment_once(self) -> Validator:
        total = self.total_voting_power()
        for v in self.validators:
            v.proposer_priority = _clip(v.proposer_priority + v.voting_power)
        mostest = self.validators[0]
        for v in self.validators[1:]:
            mostest = mostest.compare_proposer_priority(v)
        mostest.proposer_priority = _clip(mostest.proposer_priority - total)
        return mostest

    def increment_proposer_priority(self, times: int) -> None:
        if self.is_empty():
            raise ValueError("empty validator set")
        if times <= 0:
            raise ValueError("times must be positive")
        diff_max = PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power()
        self.rescale_priorities(diff_max)
        self._shift_by_avg_proposer_priority()
        proposer = None
        for _ in range(times):
            proposer = self._increment_once()
        self.proposer = proposer

    def copy_increment_proposer_priority(self, times: int) -> "ValidatorSet":
        cp = self.copy()
        cp.increment_proposer_priority(times)
        return cp

    # --- set updates (validator_set.go:594-666) -----------------------------

    def update_with_change_set(self, changes: List[Validator]) -> None:
        """Apply ABCI validator updates: power 0 removes, new validators
        enter with priority -1.125*total (so re-bonding can't reset a
        negative priority), then rescale/center/re-sort
        (reference types/validator_set.go:479-666)."""
        if not changes:
            return
        seen = set()
        for c in changes:
            if c.voting_power < 0:
                raise ValueError("negative voting power")
            if c.address in seen:
                raise ValueError("duplicate address in changes")
            seen.add(c.address)
        updates = sorted((c for c in changes if c.voting_power > 0),
                         key=lambda v: v.address)
        deletes = [c for c in changes if c.voting_power == 0]

        for d in deletes:
            if not self.has_address(d.address):
                raise ValueError("removing non-existent validator")
        removed_power = sum(
            self.get_by_address(d.address)[1].voting_power for d in deletes)

        # total after updates, before removals (verifyUpdates)
        delta = 0
        for u in updates:
            _, cur = self.get_by_address(u.address)
            delta += u.voting_power - (cur.voting_power if cur else 0)
        tvp_after_updates = self.total_voting_power() + delta
        if tvp_after_updates - removed_power > MAX_TOTAL_VOTING_POWER:
            raise ValueError("total voting power would exceed cap")

        new_count = sum(1 for u in updates if not self.has_address(u.address))
        survivors = len(self.validators) - len(deletes)
        if new_count == 0 and survivors == 0:
            raise ValueError("updates would result in empty set")

        for u in updates:
            _, cur = self.get_by_address(u.address)
            if cur is None:
                u.proposer_priority = -(tvp_after_updates
                                        + (tvp_after_updates >> 3))
            else:
                u.proposer_priority = cur.proposer_priority

        # apply updates then removals
        by_addr = {v.address: v for v in self.validators}
        for u in updates:
            by_addr[u.address] = u.copy()
        for d in deletes:
            del by_addr[d.address]
        self.validators = sorted(
            by_addr.values(), key=lambda v: (-v.voting_power, v.address))
        self._by_address = {v.address: i
                            for i, v in enumerate(self.validators)}
        self._total = None
        self._hash = None
        self.total_voting_power()

        self.rescale_priorities(
            PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power())
        self._shift_by_avg_proposer_priority()
        if self.proposer is not None:
            idx = self._by_address.get(self.proposer.address)
            self.proposer = (self.validators[idx] if idx is not None
                             else None)
