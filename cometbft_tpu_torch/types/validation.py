"""Commit verification — single, batch, and trusting forms
(reference types/validation.go; port of `cometbft_tpu/types/validation.py`).

The batch path feeds the port's CUDA kernels through the same plugin seam
the reference uses (crypto/batch.create_batch_verifier); because the
kernels are lane-parallel they return per-signature verdicts, so failure
attribution needs no second pass (reference falls back to per-sig loops,
types/validation.go:306-315). The JAX package takes its device from the
process; here each entry point takes `device=` (default cuda) and hands it
to the batch verifier.

The cross-commit tiling form (many commits → one device batch) lives in
engine/blocksync; these functions are the per-commit semantics they must
agree with.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from ..crypto import batch as crypto_batch
from ..pipeline.cache import shared_cache
from .block import Commit, CommitSig, BlockID
from .validator import ValidatorSet

# Minimum signature count before the device batch path pays for itself.
# The reference sets 2 (types/validation.go:13) because its batch verifier
# is a cheap same-thread CPU MSM; here "batch" means a device dispatch, so
# small commits — consensus rounds, tiny validator sets — go through the
# single-signature path instead, and the kernels serve the bulk tiles
# (blocksync, light client) they were built for. The JAX package's value,
# kept for its semantics: against the native host verify (~0.27 ms a
# signature on an H100's host) a 200-lane flush of 0.4-0.9 s no longer
# pays for itself, and the crossover is still to be measured (ROADMAP.md
# Queue 2 item 10).
BATCH_VERIFY_THRESHOLD = 64


class CommitVerificationError(Exception):
    pass


class ErrInvalidCommitSignatures(CommitVerificationError):
    pass


class ErrNotEnoughVotingPowerSigned(CommitVerificationError):
    def __init__(self, got: int, needed: int):
        super().__init__(f"insufficient voting power: got {got}, "
                         f"needed more than {needed}")
        self.got = got
        self.needed = needed


class ErrWrongSignature(CommitVerificationError):
    def __init__(self, idx: int, sig: bytes):
        super().__init__(f"wrong signature (#{idx}): {sig.hex()}")
        self.idx = idx


@dataclass(frozen=True)
class Fraction:
    """reference libs/math/fraction.go."""
    numerator: int
    denominator: int


DEFAULT_TRUST_LEVEL = Fraction(1, 3)


def _verify_basic(vals: ValidatorSet, commit: Commit, height: int,
                  block_id: BlockID) -> None:
    """reference types/validation.go:408-431."""
    if vals is None:
        raise CommitVerificationError("nil validator set")
    if commit is None:
        raise CommitVerificationError("nil commit")
    if len(vals) != len(commit.signatures):
        raise ErrInvalidCommitSignatures(
            f"validator set size {len(vals)} != {len(commit.signatures)} sigs")
    if height != commit.height:
        raise CommitVerificationError(
            f"invalid commit height: want {height}, got {commit.height}")
    if block_id != commit.block_id:
        raise CommitVerificationError("invalid commit -- wrong block ID")


def _should_batch_verify(vals: ValidatorSet, commit: Commit) -> bool:
    prop = vals.get_proposer()
    if prop is None:
        return False
    threshold = BATCH_VERIFY_THRESHOLD
    if prop.pub_key.type_() == "bls12_381":
        # BLS per-sig verification is pairing-bound (two Miller loops
        # plus a final exponentiation EACH); the multi-pairing batch
        # shares one final exponentiation across the whole set, so it
        # pays for itself at the reference's own threshold of 2
        # (types/validation.go:13), on the host
        threshold = 2
    return (len(commit.signatures) >= threshold
            and crypto_batch.supports_batch_verifier(prop.pub_key))


def _verify_commit_core(chain_id: str, vals: ValidatorSet, commit: Commit,
                        voting_power_needed: int,
                        ignore: Callable[[CommitSig], bool],
                        count: Callable[[CommitSig], bool],
                        count_all: bool, lookup_by_index: bool,
                        device=None) -> None:
    """Shared body of the batch and single paths
    (reference types/validation.go:218-322 and :331-405; one body here
    because attribution is free with per-lane verdicts). `device` is
    where a batch of `BATCH_VERIFY_THRESHOLD` or more ed25519 signatures
    runs (default cuda, `device.resolve_device`), alone or as the
    ed25519 bucket of a mixed-curve set's `MixedBatchVerifier`, and where
    an aggregated (BLS) commit's pairing equation settles."""
    from .agg_commit import AggregatedCommit
    if isinstance(commit, AggregatedCommit):
        # the BLS aggregate seal: one multi-pairing check for the whole
        # commit (aggsig/verify.py), same ignore/count semantics and
        # exception vocabulary, whole-aggregate verdict SigCache-keyed
        from ..aggsig import verify as aggsig_verify
        aggsig_verify.verify_aggregated_commit(
            chain_id, vals, commit, voting_power_needed,
            ignore=ignore, count=count, count_all=count_all,
            lookup_by_index=lookup_by_index, cache=shared_cache(),
            device=device)
        return
    use_batch = _should_batch_verify(vals, commit)
    bv = None
    if use_batch:
        if len({v.pub_key.type_() for v in vals.validators}) > 1:
            # heterogeneous valset: a proposer-keyed single-curve
            # verifier would TypeError on the first foreign-curve
            # lane; the mixed dispatcher buckets per curve (batched
            # where supported, per-sig singles otherwise) with exact
            # per-lane attribution, its ed25519 bucket on `device`
            bv, ok = crypto_batch.MixedBatchVerifier(device=device), True
        else:
            bv, ok = crypto_batch.create_batch_verifier(
                vals.get_proposer().pub_key, device=device)
        use_batch = ok

    # verified-signature cache (pipeline/cache): commits re-checked by
    # the light client or blocksync's respeculation path skip signatures
    # a previous pass already verified TRUE; cached lanes never reach
    # the device and failed lanes are never cached, so verdicts are
    # byte-identical with the uncached path
    cache = shared_cache()

    tallied = 0
    seen = {}
    batch_idxs = []
    batch_items = []  # (pub_bytes, msg, sig) per device lane, for cache
    for idx, cs in enumerate(commit.signatures):
        if ignore(cs):
            continue
        try:
            cs.validate_basic()
        except ValueError as e:
            raise CommitVerificationError(
                f"invalid signature at index {idx}: {e}") from e

        if lookup_by_index:
            val = vals.get_by_index(idx)
        else:
            val_idx, val = vals.get_by_address(cs.validator_address)
            if val is None:
                continue
            if val_idx in seen:
                raise CommitVerificationError(
                    f"double vote from validator {val_idx} "
                    f"({seen[val_idx]} and {idx})")
            seen[val_idx] = idx

        msg = commit.vote_sign_bytes(chain_id, idx)
        pkb = val.pub_key.bytes_()
        if cache.seen(pkb, msg, cs.signature, path="commit"):
            pass  # previously verified TRUE: no work either path
        elif use_batch:
            bv.add(val.pub_key, msg, cs.signature)
            batch_idxs.append(idx)
            batch_items.append((pkb, msg, cs.signature))
        else:
            if not val.pub_key.verify_signature(msg, cs.signature):
                raise ErrWrongSignature(idx, cs.signature)
            cache.add(pkb, msg, cs.signature)

        if count(cs):
            tallied += val.voting_power
        if not count_all and tallied > voting_power_needed:
            break

    if tallied <= voting_power_needed:
        raise ErrNotEnoughVotingPowerSigned(tallied, voting_power_needed)

    if use_batch and len(bv):
        all_ok, oks = bv.verify()
        for (pkb, msg, sig), ok in zip(batch_items, oks):
            if ok:
                cache.add(pkb, msg, sig)
        if not all_ok:
            first_bad = next(i for i, o in zip(batch_idxs, oks) if not o)
            raise ErrWrongSignature(
                first_bad, commit.signatures[first_bad].signature)


def verify_commit(chain_id: str, vals: ValidatorSet, block_id: BlockID,
                  height: int, commit: Commit, device=None) -> None:
    """+2/3 signed, checking ALL signatures
    (reference types/validation.go:26-53). Raises on failure."""
    _verify_basic(vals, commit, height, block_id)
    needed = vals.total_voting_power() * 2 // 3
    _verify_commit_core(
        chain_id, vals, commit, needed,
        ignore=lambda c: c.absent_(),
        count=lambda c: c.for_block(),
        count_all=True, lookup_by_index=True, device=device)


def verify_commit_light(chain_id: str, vals: ValidatorSet, block_id: BlockID,
                        height: int, commit: Commit,
                        count_all: bool = False, device=None) -> None:
    """+2/3 signed, early-exit once the threshold is reached — blocksync /
    light-client form (reference types/validation.go:61-116)."""
    _verify_basic(vals, commit, height, block_id)
    needed = vals.total_voting_power() * 2 // 3
    _verify_commit_core(
        chain_id, vals, commit, needed,
        ignore=lambda c: not c.for_block(),
        count=lambda _: True,
        count_all=count_all, lookup_by_index=True, device=device)


def verify_commit_light_trusting(chain_id: str, vals: ValidatorSet,
                                 commit: Commit,
                                 trust_level: Fraction = DEFAULT_TRUST_LEVEL,
                                 count_all: bool = False,
                                 device=None) -> None:
    """trustLevel of a TRUSTED validator set signed this commit — validators
    matched by address, unknown signers skipped, double votes rejected
    (reference types/validation.go:118-215)."""
    if vals is None:
        raise CommitVerificationError("nil validator set")
    if commit is None:
        raise CommitVerificationError("nil commit")
    if trust_level.denominator == 0:
        raise CommitVerificationError("trustLevel has zero denominator")
    needed = (vals.total_voting_power()
              * trust_level.numerator) // trust_level.denominator
    _verify_commit_core(
        chain_id, vals, commit, needed,
        ignore=lambda c: not c.for_block(),
        count=lambda _: True,
        count_all=count_all, lookup_by_index=False, device=device)
