"""VoteSet: 2/3-majority vote accounting for one (height, round, type)
(reference types/vote_set.go:158-473).

Semantics reproduced exactly:
- `votes` keeps one canonical vote per validator (the first seen; votes
  for the 2/3-majority block take priority once one exists),
- `votes_by_block` tracks per-block tallies; conflicting votes are only
  retained for blocks a peer claimed has a 2/3 majority (memory-bounded
  double-sign tracking, the DoS argument at vote_set.go:26-56),
- quorum = total_power * 2/3 + 1, first quorum latches `maj23`.

Single-threaded by design: the consensus engine serializes all mutations
through its event loop (SURVEY §2.3: the single-writer receiveRoutine),
so the reference's mutex has no analog here.

Port of `cometbft_tpu/types/vote_set.py`. `add_votes` takes the device its
batch verifies on (`device=`, default cuda), where the JAX package takes
it from the process.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..device import resolve_device
from ..libs.bits import BitArray
from .block import BlockID, Commit, CommitSig
from .vote import Vote, PRECOMMIT_TYPE

MAX_VOTES_COUNT = 10000  # DoS bound, reference types/vote_set.go:14-17


class VoteError(Exception):
    pass


class ErrVoteUnexpectedStep(VoteError):
    pass


class ErrVoteInvalidValidatorIndex(VoteError):
    pass


class ErrVoteInvalidValidatorAddress(VoteError):
    pass


class ErrVoteInvalidSignature(VoteError):
    pass


class ErrVoteNonDeterministicSignature(VoteError):
    """Same validator, same block, different signature bytes."""


class ErrVoteConflictingVotes(VoteError):
    """Double-sign: same validator voted for two different blocks.

    Carries both votes — the raw material of DuplicateVoteEvidence
    (reference types/vote_set.go NewConflictingVoteError)."""

    def __init__(self, existing: Vote, new: Vote, added: bool):
        super().__init__(
            f"conflicting votes from validator "
            f"{new.validator_address.hex()}")
        self.vote_a = existing
        self.vote_b = new
        self.added = added


class _BlockVotes:
    """Votes for one particular block (reference vote_set.go:675-705)."""

    __slots__ = ("peer_maj23", "bit_array", "votes", "sum")

    def __init__(self, peer_maj23: bool, num_validators: int):
        self.peer_maj23 = peer_maj23
        self.bit_array = BitArray(num_validators)
        self.votes: List[Optional[Vote]] = [None] * num_validators
        self.sum = 0

    def add_verified_vote(self, vote: Vote, voting_power: int) -> None:
        idx = vote.validator_index
        if self.votes[idx] is None:
            self.bit_array.set_index(idx, True)
            self.votes[idx] = vote
            self.sum += voting_power

    def get_by_index(self, idx: int) -> Optional[Vote]:
        return self.votes[idx]


class VoteSet:
    def __init__(self, chain_id: str, height: int, round_: int,
                 signed_msg_type: int, val_set, extensions_enabled=False):
        if height == 0:
            raise ValueError("cannot make VoteSet for height 0")
        self.chain_id = chain_id
        self.height = height
        self.round = round_
        self.signed_msg_type = signed_msg_type
        self.val_set = val_set
        self.extensions_enabled = extensions_enabled
        n = len(val_set)
        self.votes_bit_array = BitArray(n)
        self.votes: List[Optional[Vote]] = [None] * n
        self.sum = 0
        self.maj23: Optional[BlockID] = None
        self.votes_by_block: Dict[bytes, _BlockVotes] = {}
        self.peer_maj23s: Dict[str, BlockID] = {}

    def size(self) -> int:
        return len(self.val_set)

    # --- adding votes --------------------------------------------------------

    def add_vote(self, vote: Optional[Vote]) -> bool:
        """Returns True if added, False for exact duplicates; raises
        VoteError otherwise (reference vote_set.go:158 AddVote)."""
        val = self._precheck(vote)
        if val is None:
            return False  # exact duplicate
        self._check_signature(vote, val)
        return self._finish_add(vote, val)

    def _check_signature(self, vote: Vote, val) -> None:
        """The per-vote hot path (types/vote.go:235); raises on failure.
        Shared by add_vote and add_votes' non-batched fallback."""
        addr = vote.validator_address
        if self.extensions_enabled:
            if vote.block_id.is_nil() and \
                    (vote.extension or vote.extension_signature):
                # reference Vote.ValidateBasic: extensions only ride
                # non-nil precommits — unsigned bytes on a nil vote
                # would be stored and re-gossiped otherwise
                raise VoteError("extension data on nil precommit")
            if not vote.verify_vote_and_extension(self.chain_id,
                                                  val.pub_key):
                raise ErrVoteInvalidSignature(
                    f"failed to verify extended vote from {addr.hex()}")
        else:
            # re-gossiped votes hit the verified-signature cache instead
            # of re-running the host verify (or burning a device lane);
            # only verified-TRUE signatures are ever cached, so a hit
            # can't flip a verdict
            from ..pipeline.cache import shared_cache
            cache = shared_cache()
            pkb = val.pub_key.bytes_()
            sb = vote.sign_bytes(self.chain_id)
            if not cache.seen(pkb, sb, vote.signature, path="vote"):
                # _precheck pinned addr == val.address, so Vote.verify's
                # address check is redundant here — verify against the
                # already-encoded sign bytes (one encode, not two)
                if not val.pub_key.verify_signature(sb, vote.signature):
                    raise ErrVoteInvalidSignature(
                        f"failed to verify vote from {addr.hex()}")
                cache.add(pkb, sb, vote.signature)
            if vote.extension or vote.extension_signature:
                raise VoteError("unexpected vote extension data")

    def add_votes(self, votes: List[Vote], device=None) -> List:
        """Batched ingest: marshal every pending signature into ONE
        device batch on `device` (default cuda; the crypto/batch seam →
        the RLC kernels of ops/ed25519), then
        add with per-lane verdicts — the TPU-native form of the addVote
        hot path for gossip bursts and catch-up, where per-signature
        host verification (~400µs on a small host core) would dominate
        (reference crypto/ed25519/ed25519.go:208-241 batches the same
        way for commits; here it is applied to live vote ingest).

        Returns one entry per vote: True (added), False (exact
        duplicate), or the VoteError instance that add_vote would have
        raised (conflicts carry both votes).
        """
        device = resolve_device(device)
        out: List = [None] * len(votes)
        pend = []
        for i, v in enumerate(votes):
            try:
                val = self._precheck(v)
            except VoteError as e:
                out[i] = e
                continue
            if val is None:
                out[i] = False
                continue
            if not self.extensions_enabled and \
                    (v.extension or v.extension_signature):
                out[i] = VoteError("unexpected vote extension data")
                continue
            pend.append((i, v, val))

        if not pend:
            return out
        from ..crypto import batch as crypto_batch
        from .validation import BATCH_VERIFY_THRESHOLD
        bv = None
        # same threshold rationale as commit verification: below it the
        # native single-sig path beats a device dispatch
        if not self.extensions_enabled and \
                len(pend) >= BATCH_VERIFY_THRESHOLD:
            bv, ok = crypto_batch.create_batch_verifier(
                pend[0][2].pub_key, device=device)
            if ok and all(val.pub_key.type_() == pend[0][2].pub_key.type_()
                          for _i, _v, val in pend):
                # verified-signature cache: a re-gossiped burst costs
                # zero device lanes; only misses are marshaled, and
                # verified-true lanes are written back
                from ..pipeline.cache import shared_cache
                cache = shared_cache()
                marshal = [(val.pub_key.bytes_(),
                            v.sign_bytes(self.chain_id), v.signature,
                            val.pub_key)
                           for _i, v, val in pend]
                # fail-closed: every lane starts UNVERIFIED (None is
                # falsy below); only a cache hit or an explicit verifier
                # verdict marks it — a short lane_oks from a buggy
                # backend must never admit an unchecked vote
                oks = [None] * len(pend)
                lanes = []                # positions needing the device
                for pos, (pkb, sb, sig, pk) in enumerate(marshal):
                    if cache.seen(pkb, sb, sig, path="vote"):
                        oks[pos] = True
                        continue
                    bv.add(pk, sb, sig)
                    lanes.append(pos)
                if lanes:
                    _, lane_oks = bv.verify()
                    for pos, lane_ok in zip(lanes, lane_oks):
                        oks[pos] = lane_ok
                        if lane_ok:
                            pkb, sb, sig, _pk = marshal[pos]
                            cache.add(pkb, sb, sig)
            else:
                bv = None
        if bv is None:
            oks = []
            for i, v, val in pend:
                try:
                    self._check_signature(v, val)
                    oks.append(True)
                except VoteError as e:
                    out[i] = e
                    oks.append(False)

        for (i, v, _val), sig_ok in zip(pend, oks):
            if not sig_ok:
                if out[i] is None:  # batched path: generic attribution
                    out[i] = ErrVoteInvalidSignature(
                        f"failed to verify vote from "
                        f"{v.validator_address.hex()}")
                continue
            try:
                # re-precheck: an earlier vote in THIS batch may have
                # landed for the same validator (duplicate in one gossip
                # burst) — without this the duplicate would hit
                # _add_verified_vote's assertion
                val = self._precheck(v)
                if val is None:
                    out[i] = False
                    continue
                out[i] = self._finish_add(v, val)
            except VoteError as e:
                out[i] = e
        return out

    def _precheck(self, vote: Optional[Vote]):
        """Everything before the signature check (reference
        vote_set.go:158-240): returns the validator, or None for an
        exact duplicate; raises VoteError."""
        if vote is None:
            raise VoteError("nil vote")
        idx = vote.validator_index
        addr = vote.validator_address
        block_key = vote.block_id.key()

        if idx < 0:
            raise ErrVoteInvalidValidatorIndex(f"index {idx} < 0")
        if not addr:
            raise ErrVoteInvalidValidatorAddress("empty address")
        if (vote.height != self.height or vote.round != self.round
                or vote.type_ != self.signed_msg_type):
            raise ErrVoteUnexpectedStep(
                f"expected {self.height}/{self.round}/{self.signed_msg_type},"
                f" got {vote.height}/{vote.round}/{vote.type_}")

        val = self.val_set.get_by_index(idx)
        if val is None:
            raise ErrVoteInvalidValidatorIndex(
                f"no validator at index {idx} in set of "
                f"{len(self.val_set)}")
        if addr != val.address:
            raise ErrVoteInvalidValidatorAddress(
                f"vote address {addr.hex()} != validator {idx} address "
                f"{val.address.hex()}")

        existing = self._get_vote(idx, block_key)
        if existing is not None:
            if existing.signature == vote.signature:
                return None  # exact duplicate
            raise ErrVoteNonDeterministicSignature(
                f"existing vote: {existing}; new vote: {vote}")
        return val

    def _finish_add(self, vote: Vote, val) -> bool:
        added, conflicting = self._add_verified_vote(
            vote, vote.block_id.key(), val.voting_power)
        if conflicting is not None:
            raise ErrVoteConflictingVotes(conflicting, vote, added)
        if not added:
            raise AssertionError("expected to add non-conflicting vote")
        return added

    def _get_vote(self, idx: int, block_key: bytes) -> Optional[Vote]:
        v = self.votes[idx]
        if v is not None and v.block_id.key() == block_key:
            return v
        bv = self.votes_by_block.get(block_key)
        if bv is not None:
            return bv.get_by_index(idx)
        return None

    def _add_verified_vote(self, vote: Vote, block_key: bytes,
                           voting_power: int):
        """reference vote_set.go:260-329 addVerifiedVote."""
        idx = vote.validator_index
        conflicting = None

        existing = self.votes[idx]
        if existing is not None:
            if existing.block_id == vote.block_id:
                raise AssertionError("unexpected duplicate vote")
            conflicting = existing
            # replace only if the new vote is for the latched maj23 block
            if self.maj23 is not None and self.maj23.key() == block_key:
                self.votes[idx] = vote
                self.votes_bit_array.set_index(idx, True)
        else:
            self.votes[idx] = vote
            self.votes_bit_array.set_index(idx, True)
            self.sum += voting_power

        bv = self.votes_by_block.get(block_key)
        if bv is not None:
            if conflicting is not None and not bv.peer_maj23:
                return False, conflicting
        else:
            if conflicting is not None:
                # not tracking this block: forget the conflicting vote
                return False, conflicting
            bv = _BlockVotes(False, len(self.val_set))
            self.votes_by_block[block_key] = bv

        orig_sum = bv.sum
        quorum = self.val_set.total_voting_power() * 2 // 3 + 1
        bv.add_verified_vote(vote, voting_power)

        if orig_sum < quorum <= bv.sum and self.maj23 is None:
            self.maj23 = vote.block_id
            for i, v in enumerate(bv.votes):
                if v is not None:
                    self.votes[i] = v
        return True, conflicting

    def set_peer_maj23(self, peer_id: str, block_id: BlockID) -> None:
        """A peer claims 2/3 majority for block_id: start tracking
        conflicting votes for it (reference vote_set.go:335-368)."""
        block_key = block_id.key()
        existing = self.peer_maj23s.get(peer_id)
        if existing is not None:
            if existing == block_id:
                return
            raise VoteError(
                f"conflicting maj23 claim from peer {peer_id}")
        self.peer_maj23s[peer_id] = block_id

        bv = self.votes_by_block.get(block_key)
        if bv is not None:
            bv.peer_maj23 = True
        else:
            self.votes_by_block[block_key] = _BlockVotes(
                True, len(self.val_set))

    # --- queries -------------------------------------------------------------

    def bit_array(self) -> BitArray:
        return self.votes_bit_array.copy()

    def bit_array_by_block_id(self, block_id: BlockID
                              ) -> Optional[BitArray]:
        bv = self.votes_by_block.get(block_id.key())
        return bv.bit_array.copy() if bv is not None else None

    def get_by_index(self, idx: int) -> Optional[Vote]:
        return self.votes[idx]

    def get_by_address(self, addr: bytes) -> Optional[Vote]:
        idx, val = self.val_set.get_by_address(addr)
        if val is None:
            return None
        return self.votes[idx]

    def list_votes(self) -> List[Vote]:
        return [v for v in self.votes if v is not None]

    def has_two_thirds_majority(self) -> bool:
        return self.maj23 is not None

    def is_commit(self) -> bool:
        return (self.signed_msg_type == PRECOMMIT_TYPE
                and self.maj23 is not None)

    def has_two_thirds_any(self) -> bool:
        return self.sum > self.val_set.total_voting_power() * 2 // 3

    def has_all(self) -> bool:
        return self.sum == self.val_set.total_voting_power()

    def two_thirds_majority(self) -> Optional[BlockID]:
        """The latched 2/3-majority block, or None."""
        return self.maj23

    # --- commit construction -------------------------------------------------

    def _make_commit_plain(self) -> Commit:
        """Per-lane-signature commit assembly (reference
        MakeExtendedCommit vote_set.go:635 + ExtendedCommit.ToCommit):
        one CommitSig slot per validator, absent where no usable vote."""
        if self.signed_msg_type != PRECOMMIT_TYPE:
            raise VoteError("cannot make commit from non-precommit VoteSet")
        if self.maj23 is None:
            raise VoteError("cannot make commit without +2/3 majority")
        sigs = []
        for v in self.votes:
            if v is None:
                sigs.append(CommitSig.absent())
                continue
            cs = v.commit_sig()
            # votes for a different (non-maj23) block are marked absent
            if cs.for_block() and v.block_id != self.maj23:
                cs = CommitSig.absent()
            sigs.append(cs)
        return Commit(height=self.height, round=self.round,
                      block_id=self.maj23, signatures=sigs)

    def make_commit(self) -> Commit:
        """Commit assembly. When the validator set is uniformly BLS
        with registered proofs of possession, the for-block signatures
        fold into the AggregatedCommit seal (one 96B aggregate + a
        signer bitmap — types/agg_commit.py); every other valset gets
        the plain per-lane form, byte-for-byte as before."""
        from .agg_commit import maybe_aggregate
        return maybe_aggregate(self._make_commit_plain(), self.val_set)

    def make_extended_commit(self) -> "ExtendedCommit":
        """Commit + the vote extensions that rode each precommit
        (reference vote_set.go:635 MakeExtendedCommit). Always the
        plain per-lane form: extensions pair with individual
        signatures, never with the aggregate seal."""
        from .extended_commit import ExtendedCommit, ExtendedCommitSig
        commit = self._make_commit_plain()
        ext_sigs = []
        for cs, v in zip(commit.signatures, self.votes):
            if cs.for_block() and v is not None:
                ext_sigs.append(ExtendedCommitSig(
                    cs, v.extension, v.extension_signature))
            else:
                ext_sigs.append(ExtendedCommitSig(cs))
        return ExtendedCommit(height=commit.height, round=commit.round,
                              block_id=commit.block_id,
                              signatures=ext_sigs)

    def __repr__(self) -> str:
        voted = self.votes_bit_array.num_true_bits()
        return (f"VoteSet{{H:{self.height} R:{self.round} "
                f"T:{self.signed_msg_type} {voted}/{len(self.val_set)} "
                f"maj23:{self.maj23 is not None}}}")
