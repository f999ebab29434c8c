"""Light-client data types (reference types/light.go).

A LightBlock is the minimum a light client needs: a SignedHeader
(header + the commit that sealed it) and the validator set that signed.

Copy of `cometbft_tpu/light/types.py` (the port keeps its own).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..types.block import Commit, Header
from ..types.validator import ValidatorSet


class LightBlockError(Exception):
    pass


@dataclass
class SignedHeader:
    """reference types/block.go:1430 SignedHeader."""
    header: Header
    commit: Commit

    def validate_basic(self, chain_id: str) -> None:
        """reference types/block.go:1445-1477."""
        if self.header is None:
            raise LightBlockError("missing header")
        if self.commit is None:
            raise LightBlockError("missing commit")
        self.header.validate_basic()
        self.commit.validate_basic()
        if self.header.chain_id != chain_id:
            raise LightBlockError(
                f"header chain id {self.header.chain_id} != {chain_id}")
        if self.commit.height != self.header.height:
            raise LightBlockError(
                f"commit height {self.commit.height} != header height "
                f"{self.header.height}")
        if self.commit.block_id.hash != self.header.hash():
            raise LightBlockError("commit signs a different header hash")

    @property
    def height(self) -> int:
        return self.header.height


@dataclass
class LightBlock:
    """reference types/light.go:14."""
    signed_header: SignedHeader
    validator_set: ValidatorSet

    def validate_basic(self, chain_id: str) -> None:
        """reference types/light.go:55-79."""
        if self.validator_set is None:
            raise LightBlockError("missing validator set")
        self.signed_header.validate_basic(chain_id)
        if self.signed_header.header.validators_hash != \
                self.validator_set.hash():
            raise LightBlockError(
                "validator set does not match header validators_hash")

    @property
    def height(self) -> int:
        return self.signed_header.height

    @property
    def header(self) -> Header:
        return self.signed_header.header
