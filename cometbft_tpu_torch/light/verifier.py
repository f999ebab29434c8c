"""Stateless light-client verification core (reference
light/verifier.go:30-145).

Two modes:
- `verify_adjacent` (heights differ by 1): the untrusted header's
  validators_hash must equal the trusted header's next_validators_hash —
  then one VerifyCommitLight over the known set.
- `verify_non_adjacent` (bisection jumps): the TRUSTED set must have
  signed with >= trust_level (default 1/3) power (VerifyCommitLightTrusting),
  AND the untrusted set must have +2/3 on its own commit.

Both go through the same batch-verify seam as consensus/blocksync — on
bulk catch-up the signatures tile onto the device kernels.

Port of `cometbft_tpu/light/verifier.py`: each entry point takes
`device=` (default cuda) and hands it to `verify_commit_light` and
`verify_commit_light_trusting`, where a commit of
`BATCH_VERIFY_THRESHOLD` or more signatures batches on the card.
"""

from __future__ import annotations

from ..types import validation
from ..types.proto import Timestamp
from .types import LightBlock, LightBlockError

# reference light/verifier.go defaultMaxClockDrift
MAX_CLOCK_DRIFT_SECONDS = 10


class VerificationError(Exception):
    pass


class ErrOldHeader(VerificationError):
    pass


class ErrNewValSetCantBeTrusted(VerificationError):
    """Not enough trusted power signed the new header — bisect."""


class ErrInvalidHeader(VerificationError):
    pass


def _expired(trusted: LightBlock, trusting_period_s: int,
             now: Timestamp) -> bool:
    """reference light/verifier.go:204 HeaderExpired."""
    t = trusted.header.time
    return t.seconds + trusting_period_s < now.seconds


def _validate_untrusted(chain_id: str, trusted: LightBlock,
                        untrusted: LightBlock, now: Timestamp,
                        max_drift_s: int) -> None:
    """reference light/verifier.go:149-201 verifyNewHeaderAndVals."""
    try:
        untrusted.validate_basic(chain_id)
    except LightBlockError as e:
        raise ErrInvalidHeader(str(e)) from e
    if untrusted.height <= trusted.height:
        raise ErrInvalidHeader(
            f"untrusted height {untrusted.height} <= trusted "
            f"{trusted.height}")
    if untrusted.header.time <= trusted.header.time:
        raise ErrInvalidHeader("untrusted header time not after trusted")
    if untrusted.header.time.seconds > now.seconds + max_drift_s:
        raise ErrInvalidHeader("untrusted header is from the future")


def verify_adjacent(chain_id: str, trusted: LightBlock,
                    untrusted: LightBlock, trusting_period_s: int,
                    now: Timestamp,
                    max_drift_s: int = MAX_CLOCK_DRIFT_SECONDS,
                    device=None) -> None:
    """reference light/verifier.go:91-143 VerifyAdjacent."""
    if untrusted.height != trusted.height + 1:
        raise ErrInvalidHeader("headers must be adjacent in height")
    if _expired(trusted, trusting_period_s, now):
        raise ErrOldHeader("trusted header expired")
    _validate_untrusted(chain_id, trusted, untrusted, now, max_drift_s)
    if untrusted.header.validators_hash != \
            trusted.header.next_validators_hash:
        raise ErrInvalidHeader(
            "untrusted validators_hash != trusted next_validators_hash")
    try:
        validation.verify_commit_light(
            chain_id, untrusted.validator_set,
            untrusted.signed_header.commit.block_id,
            untrusted.height, untrusted.signed_header.commit,
            device=device)
    except validation.CommitVerificationError as e:
        raise ErrInvalidHeader(f"invalid commit: {e}") from e


def verify_non_adjacent(chain_id: str, trusted: LightBlock,
                        untrusted: LightBlock, trusting_period_s: int,
                        now: Timestamp,
                        trust_level: validation.Fraction =
                        validation.DEFAULT_TRUST_LEVEL,
                        max_drift_s: int = MAX_CLOCK_DRIFT_SECONDS,
                        device=None) -> None:
    """reference light/verifier.go:30-88 VerifyNonAdjacent."""
    if untrusted.height == trusted.height + 1:
        raise ErrInvalidHeader("use verify_adjacent for adjacent headers")
    if _expired(trusted, trusting_period_s, now):
        raise ErrOldHeader("trusted header expired")
    _validate_untrusted(chain_id, trusted, untrusted, now, max_drift_s)
    try:
        validation.verify_commit_light_trusting(
            chain_id, trusted.validator_set,
            untrusted.signed_header.commit, trust_level, device=device)
    except validation.ErrNotEnoughVotingPowerSigned as e:
        raise ErrNewValSetCantBeTrusted(str(e)) from e
    except validation.CommitVerificationError as e:
        raise ErrInvalidHeader(f"trusting verify failed: {e}") from e
    try:
        validation.verify_commit_light(
            chain_id, untrusted.validator_set,
            untrusted.signed_header.commit.block_id,
            untrusted.height, untrusted.signed_header.commit,
            device=device)
    except validation.CommitVerificationError as e:
        raise ErrInvalidHeader(f"invalid commit: {e}") from e


def verify(chain_id: str, trusted: LightBlock, untrusted: LightBlock,
           trusting_period_s: int, now: Timestamp,
           trust_level: validation.Fraction =
           validation.DEFAULT_TRUST_LEVEL, device=None) -> None:
    """reference light/verifier.go Verify: dispatch on adjacency."""
    if untrusted.height == trusted.height + 1:
        verify_adjacent(chain_id, trusted, untrusted, trusting_period_s,
                        now, device=device)
    else:
        verify_non_adjacent(chain_id, trusted, untrusted,
                            trusting_period_s, now, trust_level,
                            device=device)
