"""BitArray: the vote/part bitmap exchanged between peers
(reference internal/bits/bit_array.go; copy of
`cometbft_tpu/libs/bits.py`).

Backed by a single python int (arbitrary-precision bitmask) instead of the
reference's []uint64 — the operations consensus gossip needs (or/and/sub,
pick-random-set-bit, copy) are one-liners on an int and the proto wire form
([]uint64 little-endian words) is produced only at the boundary.
"""

from __future__ import annotations

import random
from typing import List, Optional


class BitArray:
    __slots__ = ("bits", "_mask")

    def __init__(self, bits: int):
        if bits < 0:
            raise ValueError("negative size")
        self.bits = bits
        self._mask = 0

    # --- element access ------------------------------------------------------

    def size(self) -> int:
        return self.bits

    def get_index(self, i: int) -> bool:
        if not (0 <= i < self.bits):
            return False
        return bool((self._mask >> i) & 1)

    def set_index(self, i: int, v: bool) -> bool:
        if not (0 <= i < self.bits):
            return False
        if v:
            self._mask |= (1 << i)
        else:
            self._mask &= ~(1 << i)
        return True

    def copy(self) -> "BitArray":
        out = BitArray(self.bits)
        out._mask = self._mask
        return out

    # --- set algebra (sizes may differ; result max size, ref behavior) -------

    def or_(self, other: "BitArray") -> "BitArray":
        out = BitArray(max(self.bits, other.bits))
        out._mask = self._mask | other._mask
        return out

    def and_(self, other: "BitArray") -> "BitArray":
        out = BitArray(min(self.bits, other.bits))
        out._mask = self._mask & other._mask & ((1 << out.bits) - 1)
        return out

    def not_(self) -> "BitArray":
        out = BitArray(self.bits)
        out._mask = ~self._mask & ((1 << self.bits) - 1)
        return out

    def sub(self, other: "BitArray") -> "BitArray":
        """Bits set in self but not in other (reference Sub: trailing bits
        of a shorter `other` are treated as unset)."""
        out = BitArray(self.bits)
        out._mask = self._mask & ~other._mask
        return out

    def update(self, other: "BitArray") -> None:
        """Overwrite contents from other (sizes must match, ref Update)."""
        if other.bits != self.bits:
            raise ValueError("BitArray sizes differ")
        self._mask = other._mask

    # --- queries -------------------------------------------------------------

    def is_empty(self) -> bool:
        return self._mask == 0

    def is_full(self) -> bool:
        return self.bits > 0 and self._mask == (1 << self.bits) - 1

    def ones(self) -> List[int]:
        m = self._mask
        out = []
        i = 0
        while m:
            if m & 1:
                out.append(i)
            m >>= 1
            i += 1
        return out

    def num_true_bits(self) -> int:
        return self._mask.bit_count()

    def pick_random(self, rng: Optional[random.Random] = None
                    ) -> Optional[int]:
        """A uniformly random set bit, or None (reference PickRandom)."""
        ones = self.ones()
        if not ones:
            return None
        return (rng or random).choice(ones)

    # --- wire ----------------------------------------------------------------

    def to_words(self) -> List[int]:
        """[]uint64 little-endian words (proto libs.bits.v1.BitArray elems)."""
        n = (self.bits + 63) // 64
        return [(self._mask >> (64 * i)) & 0xFFFFFFFFFFFFFFFF
                for i in range(n)]

    @classmethod
    def from_words(cls, bits: int, words: List[int]) -> "BitArray":
        out = cls(bits)
        m = 0
        for i, w in enumerate(words):
            m |= (w & 0xFFFFFFFFFFFFFFFF) << (64 * i)
        out._mask = m & ((1 << bits) - 1) if bits else 0
        return out

    def __eq__(self, other) -> bool:
        return (isinstance(other, BitArray) and other.bits == self.bits
                and other._mask == self._mask)

    def __repr__(self) -> str:
        s = "".join("x" if self.get_index(i) else "_"
                    for i in range(min(self.bits, 60)))
        return f"BA{{{self.bits}:{s}}}"
