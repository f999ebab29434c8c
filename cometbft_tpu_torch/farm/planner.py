"""Bisection planning: expand one client's update into signature-lane
work items, entirely host-side.

The enabling observation: both light-client threshold rules are pure
functions of ADDRESSES and voting power — `verify_commit_light_trusting`
tallies the power of trusted-set members who signed, and
`verify_commit_light` tallies claimed-set power — so whether a skipping
jump CAN be trusted (the bisection decision, light/client.py
`_verify_skipping`'s ErrNewValSetCantBeTrusted branch) is decided before
any signature is cryptographically verified. types/validation.py's own
batch path works the same way: it tallies optimistically while ADDING
lanes to the batch verifier, early-exits the scan at the threshold, and
only then verifies the added lanes (a false lane fails the whole check
afterwards). The planner mirrors that exact semantics, which is what
makes farm verdicts equal to LightClient verdicts lane for lane.

So a whole bisection schedule — every pivot, every threshold decision —
costs only provider fetches and hashing; the signature lanes it emits
are verified LATER, coalesced with every other session's lanes in one
shared device batch (batcher.py).

Copy of `cometbft_tpu/farm/planner.py` (the port keeps its own): host
work only.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..light import verifier
from ..light.types import LightBlock
from ..pipeline.cache import SigCache
from ..types.block import Commit
from ..types.proto import Timestamp
from ..types.validation import (CommitVerificationError,
                                DEFAULT_TRUST_LEVEL,
                                ErrNotEnoughVotingPowerSigned, Fraction)
from ..types.validator import ValidatorSet

CACHE_PATH = "farm"  # SigCache attribution label for farm lanes


class PlanBudgetExceeded(verifier.VerificationError):
    """The bisection needed more provider fetches than the farm's
    per-request budget allows — a byzantine target (or a pathological
    valset-rotation chain) must not let one client pin the service."""


@dataclass
class Lane:
    """One pending signature verification: a device batch lane."""
    pub: bytes          # raw pubkey bytes (device wire form)
    msg: bytes          # canonical vote sign-bytes
    sig: bytes
    pk: object          # crypto PubKey (CPU-fallback verify)
    sig_index: int      # index into the commit's signature list


@dataclass
class PlannedCheck:
    """One VerifyCommitLight / VerifyCommitLightTrusting whose
    threshold already passed host-side; `lanes` await verification."""
    kind: str                     # "light" | "trusting"
    commit: Commit
    lanes: List[Lane] = field(default_factory=list)
    tallied: int = 0              # power tallied at early-exit
    total: int = 0                # total power of the tallying set
    needed: int = 0               # strict floor (accept iff tallied >)
    cache_hits: int = 0           # lanes skipped via SigCache


def plan_commit_light(chain_id: str, vals: ValidatorSet, block_id,
                      height: int, commit: Commit,
                      cache: SigCache) -> PlannedCheck:
    """Lane plan for types/validation.verify_commit_light (+2/3 of the
    header's OWN claimed set, early-exit at the threshold). Raises the
    same structural/power errors; signature verdicts come later."""
    _basic(vals, commit, height, block_id)
    total = vals.total_voting_power()
    needed = total * 2 // 3
    planned = PlannedCheck("light", commit, total=total, needed=needed)
    for idx, cs in enumerate(commit.signatures):
        if not cs.for_block():
            continue
        _validate_sig(cs, idx)
        val = vals.get_by_index(idx)
        _add_lane(planned, chain_id, commit, idx, val, cs, cache)
        planned.tallied += val.voting_power
        if planned.tallied > needed:
            break
    if planned.tallied <= needed:
        raise ErrNotEnoughVotingPowerSigned(planned.tallied, needed)
    return planned


def plan_commit_trusting(chain_id: str, vals: ValidatorSet,
                         commit: Commit, trust_level: Fraction,
                         cache: SigCache) -> PlannedCheck:
    """Lane plan for verify_commit_light_trusting (trust_level of the
    TRUSTED set, matched by address, double votes rejected)."""
    if vals is None:
        raise CommitVerificationError("nil validator set")
    if commit is None:
        raise CommitVerificationError("nil commit")
    if trust_level.denominator == 0:
        raise CommitVerificationError("trustLevel has zero denominator")
    total = vals.total_voting_power()
    needed = (total * trust_level.numerator) // trust_level.denominator
    planned = PlannedCheck("trusting", commit, total=total, needed=needed)
    seen: Dict[int, int] = {}
    for idx, cs in enumerate(commit.signatures):
        if not cs.for_block():
            continue
        _validate_sig(cs, idx)
        val_idx, val = vals.get_by_address(cs.validator_address)
        if val is None:
            continue  # signer outside the trusted set: no vouching power
        if val_idx in seen:
            raise CommitVerificationError(
                f"double vote from validator {val_idx} "
                f"({seen[val_idx]} and {idx})")
        seen[val_idx] = idx
        _add_lane(planned, chain_id, commit, idx, val, cs, cache)
        planned.tallied += val.voting_power
        if planned.tallied > needed:
            break
    if planned.tallied <= needed:
        raise ErrNotEnoughVotingPowerSigned(planned.tallied, needed)
    return planned


def _basic(vals: ValidatorSet, commit: Commit, height: int,
           block_id) -> None:
    """types/validation._verify_basic, restated (it is private there)."""
    if vals is None:
        raise CommitVerificationError("nil validator set")
    if commit is None:
        raise CommitVerificationError("nil commit")
    if len(vals) != len(commit.signatures):
        raise CommitVerificationError(
            f"validator set size {len(vals)} != "
            f"{len(commit.signatures)} sigs")
    if height != commit.height:
        raise CommitVerificationError(
            f"invalid commit height: want {height}, got {commit.height}")
    if block_id != commit.block_id:
        raise CommitVerificationError("invalid commit -- wrong block ID")


def _validate_sig(cs, idx: int) -> None:
    try:
        cs.validate_basic()
    except ValueError as e:
        raise CommitVerificationError(
            f"invalid signature at index {idx}: {e}") from e


def _add_lane(planned: PlannedCheck, chain_id: str, commit: Commit,
              idx: int, val, cs, cache: SigCache) -> None:
    msg = commit.vote_sign_bytes(chain_id, idx)
    pkb = val.pub_key.bytes_()
    if cache.seen(pkb, msg, cs.signature, path=CACHE_PATH):
        planned.cache_hits += 1  # previously verified TRUE: no lane
        return
    planned.lanes.append(Lane(pkb, msg, cs.signature, val.pub_key, idx))


# --- the per-client schedule --------------------------------------------------


@dataclass
class VerifyStep:
    """One header acceptance: the checks must ALL verify for `lb` to
    become trusted; `record` is the decision in the vocabulary
    tools/check_light_spec.check_decisions validates."""
    lb: LightBlock
    adjacent: bool
    checks: List[PlannedCheck]
    record: Dict


def plan_update(chain_id: str, trusted: LightBlock, target: LightBlock,
                provider, now: Timestamp, trusting_period_s: int,
                trust_level: Fraction = DEFAULT_TRUST_LEVEL,
                cache: Optional[SigCache] = None,
                max_fetches: int = 128,
                max_drift_s: int = verifier.MAX_CLOCK_DRIFT_SECONDS
                ) -> List[VerifyStep]:
    """The light/client.py `_verify_skipping` loop with verification
    deferred: returns the ordered steps (pivot chain) whose checks the
    batcher verifies in shared batches. Raises the verifier/validation
    errors for every host-side rejection (expiry, time/height ordering,
    valset-hash binding, insufficient power, bisection stall)."""
    cache = cache if cache is not None else SigCache(0)  # 0 = disabled
    steps: List[VerifyStep] = []
    cur = trusted
    pivots = [target]
    fetches = 0
    while pivots:
        candidate = pivots[-1]
        adjacent = candidate.height == cur.height + 1
        if verifier._expired(cur, trusting_period_s, now):
            raise verifier.ErrOldHeader("trusted header expired")
        verifier._validate_untrusted(chain_id, cur, candidate, now,
                                     max_drift_s)
        trusting: Optional[PlannedCheck] = None
        if adjacent:
            if candidate.header.validators_hash != \
                    cur.header.next_validators_hash:
                raise verifier.ErrInvalidHeader(
                    "untrusted validators_hash != trusted "
                    "next_validators_hash")
        else:
            try:
                trusting = plan_commit_trusting(
                    chain_id, cur.validator_set,
                    candidate.signed_header.commit, trust_level, cache)
            except ErrNotEnoughVotingPowerSigned:
                # the trusted set cannot vouch: bisect toward it
                # (light/client.py:180-188)
                mid = (cur.height + candidate.height) // 2
                if mid in (cur.height, candidate.height):
                    raise verifier.ErrInvalidHeader(
                        "bisection cannot make progress")
                if fetches >= max_fetches:
                    raise PlanBudgetExceeded(
                        f"bisection exceeded {max_fetches} fetches")
                fetches += 1
                lb = provider.light_block(mid)
                lb.validate_basic(chain_id)
                pivots.append(lb)
                continue
        own = plan_commit_light(
            chain_id, candidate.validator_set,
            candidate.signed_header.commit.block_id, candidate.height,
            candidate.signed_header.commit, cache)
        checks = [own] if trusting is None else [trusting, own]
        steps.append(VerifyStep(candidate, adjacent, checks, _record(
            cur, candidate, adjacent, trusting, own, trust_level)))
        cur = candidate
        pivots.pop()
    return steps


def _record(cur: LightBlock, candidate: LightBlock, adjacent: bool,
            trusting: Optional[PlannedCheck], own: PlannedCheck,
            trust_level: Fraction) -> Dict:
    """Decision record — the farm's acceptance restated as the power
    tallies tools/check_light_spec.check_decisions re-judges."""
    return {
        "height": candidate.height,
        "from_height": cur.height,
        "adjacent": adjacent,
        "valhash_bound": adjacent,  # checked above for adjacent steps
        "own_signed": own.tallied,
        "own_total": own.total,
        "trusted_signed": trusting.tallied if trusting else 0,
        "trusted_total": trusting.total if trusting else 0,
        "trust_num": trust_level.numerator,
        "trust_den": trust_level.denominator,
        "hash": candidate.header.hash().hex(),
    }
