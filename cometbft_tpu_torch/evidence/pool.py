"""Evidence pool: collect, verify, store, and serve Byzantine-fault
evidence (reference internal/evidence/pool.go:142-308, verify.go:110-210).

Consensus feeds it conflicting votes (ErrVoteConflictingVotes →
add_duplicate_vote); the proposer reaps pending evidence into blocks;
committed evidence is marked and pruned once outside the evidence
age window (ConsensusParams.evidence_max_age_*).

Port of `cometbft_tpu/evidence/pool.py`. The pool carries the device its
light-client-attack commit checks batch on (`device=`, default cuda),
and `verify_light_client_attack` takes it; duplicate votes are checked
one signature at a time on the host. `evidence/reactor.py` (gossip)
comes with node boot (ROADMAP.md Queue 1 item 10).
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

from ..device import resolve_device
from ..state.state import State
from ..types.evidence import (DuplicateVoteEvidence, EvidenceError,
                              LightClientAttackEvidence)
from ..types.proto import Timestamp
from ..types.vote import Vote


def verify_duplicate_vote(ev: DuplicateVoteEvidence, state: State,
                          val_set) -> None:
    """reference internal/evidence/verify.go:164-210 VerifyDuplicateVote.

    val_set must be the validator set AT the evidence height. Raises
    EvidenceError if invalid.
    """
    ev.validate_basic()
    a, b = ev.vote_a, ev.vote_b
    if a.height != b.height or a.round != b.round or \
            a.type_ != b.type_:
        raise EvidenceError("votes from different HRS")
    if a.validator_address != b.validator_address:
        raise EvidenceError("votes from different validators")
    if a.block_id.key() == b.block_id.key():
        raise EvidenceError("votes for the same block")

    idx, val = val_set.get_by_address(a.validator_address)
    if val is None:
        raise EvidenceError(
            f"address {a.validator_address.hex()} not in validator set "
            f"at height {a.height}")
    if a.validator_index != idx or b.validator_index != idx:
        raise EvidenceError("wrong validator index")

    # power bookkeeping must match what the header committed to
    if ev.validator_power != val.voting_power:
        raise EvidenceError(
            f"evidence validator power {ev.validator_power} != "
            f"{val.voting_power}")
    if ev.total_voting_power != val_set.total_voting_power():
        raise EvidenceError("evidence total power mismatch")

    chain_id = state.chain_id
    for v in (a, b):
        if not val.pub_key.verify_signature(
                v.sign_bytes(chain_id), v.signature):
            raise EvidenceError("invalid signature on duplicate vote")


def verify_light_client_attack(ev: LightClientAttackEvidence,
                               state: State, common_vals,
                               trusted_header,
                               common_time=None,
                               trusted_commit=None, device=None) -> None:
    """reference internal/evidence/verify.go:110-160
    VerifyLightClientAttack.

    common_vals: validator set at ev.common_height (the trust anchor);
    trusted_header: this node's header at the conflicting height (None
    if beyond our tip); common_time: the committed block time at
    common_height when known; trusted_commit: this node's commit for
    the conflicting height when known (classifies equivocation vs
    amnesia for the byzantine-list check). `device` is where the
    commit checks batch (default cuda). Raises EvidenceError."""
    from ..types import validation
    ev.validate_basic()
    lb = ev.conflicting_block
    sh = lb.signed_header
    if common_time is not None and ev.timestamp != common_time:
        # the timestamp is hashed: left unpinned, re-gossiping the same
        # attack with fresh timestamps would mint unlimited new hashes
        # (dedup bypass) and a future timestamp would never expire
        raise EvidenceError(
            "evidence timestamp does not match the common block time")
    if lb.validator_set.hash() != sh.header.validators_hash:
        # the 2/3 equivocation check below runs against this set; an
        # inconsistent (freely attacker-chosen) set would make it
        # vacuous (reference validates the conflicting block first)
        raise EvidenceError(
            "conflicting block validator set does not match its header")
    # the conflicting header must genuinely diverge from our chain
    if trusted_header is not None and \
            trusted_header.hash() == sh.header.hash():
        raise EvidenceError("conflicting block matches the trusted chain")
    # 1/3+ of the commonly-trusted set must have signed the conflicting
    # header (otherwise it could not have fooled a light client)
    try:
        validation.verify_commit_light_trusting(
            state.chain_id, common_vals, sh.commit,
            validation.Fraction(1, 3), device=device)
    except Exception as e:  # noqa: BLE001 — any verification error
        raise EvidenceError(
            f"conflicting commit not signed by 1/3+ of common set: {e}")
    # for a non-lunatic (equivocation) attack the conflicting block's
    # own set must also carry 2/3 of it (reference verify.go:139)
    if trusted_header is not None and \
            not ev.conflicting_header_is_invalid(trusted_header):
        try:
            validation.verify_commit_light(
                state.chain_id, lb.validator_set, sh.commit.block_id,
                sh.header.height, sh.commit, device=device)
        except Exception as e:  # noqa: BLE001 — must stay within the
            # EvidenceError contract: callers (validate_block →
            # consensus precommit) only convert EvidenceError; anything
            # else would crash the state machine on a malicious block
            raise EvidenceError(
                f"equivocation commit fails 2/3 verification: {e}")
    if ev.total_voting_power != common_vals.total_voting_power():
        raise EvidenceError("evidence total power mismatch")
    # claimed byzantine validators must belong to the common set and
    # have signed the conflicting commit
    signers = {cs.validator_address
               for cs in sh.commit.signatures if cs.for_block()}
    for val in ev.byzantine_validators:
        _i, common = common_vals.get_by_address(val.address)
        if common is None:
            raise EvidenceError(
                f"byzantine validator {val.address.hex()[:12]} not in "
                f"common set")
        if val.address not in signers:
            raise EvidenceError(
                f"byzantine validator {val.address.hex()[:12]} did not "
                f"sign the conflicting block")
    # ...and the list must be COMPLETE: evidence that omits (all) the
    # punishable addresses would otherwise commit a LIGHT_CLIENT_ATTACK
    # with nobody to punish (reference verify.go:217-255 ValidateABCI
    # compares count/addresses/powers against the computed list)
    expected = expected_byzantine_validators(ev, common_vals,
                                             trusted_header,
                                             trusted_commit)
    if expected is not None:
        want = sorted((v.address, v.voting_power) for v in expected)
        got = sorted((v.address, v.voting_power)
                     for v in ev.byzantine_validators)
        if want != got:
            raise EvidenceError(
                f"byzantine validator list mismatch: evidence names "
                f"{len(got)}, computed intersection has {len(want)}")


def expected_byzantine_validators(ev: LightClientAttackEvidence,
                                  common_vals, trusted_header,
                                  trusted_commit):
    """The attack's punishable set, by attack style (reference
    types/evidence.go:250-293 GetByzantineValidators). None when the
    style cannot be determined locally (no trusted header/commit)."""
    sh = ev.conflicting_block.signed_header
    if trusted_header is None:
        return None
    if ev.conflicting_header_is_invalid(trusted_header):
        # lunatic: common-set members who voted for the invalid header
        out = []
        for cs in sh.commit.signatures:
            if not cs.for_block():
                continue
            _i, val = common_vals.get_by_address(cs.validator_address)
            if val is not None:
                out.append(val)
        return out
    if trusted_commit is None:
        return None
    if trusted_commit.round == sh.commit.round:
        # equivocation: conflicting-set members who signed both commits
        # (valset hashes match, so signature indexing is aligned)
        out = []
        vs = ev.conflicting_block.validator_set
        for i, sa in enumerate(sh.commit.signatures):
            if not sa.for_block() or i >= len(trusted_commit.signatures):
                continue
            if not trusted_commit.signatures[i].for_block():
                continue
            _j, val = vs.get_by_address(sa.validator_address)
            if val is not None:
                out.append(val)
        return out
    return []  # amnesia: no validators punished (reference :295-300)


class EvidencePool:
    """reference internal/evidence/pool.go Pool."""

    def __init__(self, state_store=None, block_store=None, device=None):
        self.device = resolve_device(device)
        self.state_store = state_store
        self.block_store = block_store
        self._pending: List[DuplicateVoteEvidence] = []
        self._committed: set = set()
        self._seen: set = set()
        self._lock = threading.RLock()
        self._on_new: List = []

    def on_new_evidence(self, cb) -> None:
        """Register an admission hook (the gossip reactor broadcasts
        from it — reference pool.go evidence clist waker)."""
        self._on_new.append(cb)

    # --- intake --------------------------------------------------------------

    def add_duplicate_vote(self, vote_a: Vote, vote_b: Vote,
                           state: State) -> Optional[DuplicateVoteEvidence]:
        """Consensus-discovered conflict (reference pool.go:142
        AddEvidence via state.go tryAddVote)."""
        val_set = self._validators_at(vote_a.height, state)
        if val_set is None:
            return None
        try:
            ev = DuplicateVoteEvidence.from_conflict(
                vote_a, vote_b, val_set, state.last_block_time)
            return self.add_evidence(ev, state)
        except EvidenceError:
            return None

    def add_evidence(self, ev, state: State):
        """Verify + admit (gossiped, consensus-local, or detector-made).
        Accepts DuplicateVoteEvidence and LightClientAttackEvidence."""
        with self._lock:
            key = ev.hash()
            if key in self._seen or key in self._committed:
                return None
            val_set = self._validators_at(ev.height(), state)
            if val_set is None:
                return None
            if self._expired(ev, state):
                return None
            self._verify_one(ev, state, val_set)
            self._pending.append(ev)
            self._seen.add(key)
        # hooks run OUTSIDE the lock: the gossip broadcast they trigger
        # can block on peer queues and must not hold up intake
        for cb in self._on_new:
            cb(ev)
        return ev

    def _verify_one(self, ev, state: State, val_set) -> None:
        if isinstance(ev, LightClientAttackEvidence):
            trusted = None
            common_time = None
            trusted_commit = None
            if self.block_store is not None:
                h = ev.conflicting_block.height
                meta = self.block_store.load_block_meta(h)
                if meta is not None:
                    trusted = meta[1]
                trusted_commit = (self.block_store.load_seen_commit(h)
                                  or self.block_store.load_block_commit(h))
                common_meta = self.block_store.load_block_meta(
                    ev.common_height)
                if common_meta is not None:
                    common_time = common_meta[1].time
            if common_time is None:
                # truncated store (statesynced node): the pinning block
                # is gone, so bound the timestamp instead — not in the
                # future, not outside the max-age window — so one attack
                # can only mint hashes within a closing window rather
                # than without limit (the exact-match dedup pin below is
                # unavailable without the common block)
                now = state.last_block_time.seconds
                if ev.timestamp.seconds > now:
                    raise EvidenceError(
                        "evidence timestamp is in the future")
                if now - ev.timestamp.seconds > \
                        state.consensus_params.evidence_max_age_seconds:
                    raise EvidenceError(
                        "evidence timestamp outside the max-age window")
            verify_light_client_attack(ev, state, val_set, trusted,
                                       common_time=common_time,
                                       trusted_commit=trusted_commit,
                                       device=self.device)
        else:
            verify_duplicate_vote(ev, state, val_set)

    def _validators_at(self, height: int, state: State):
        if height == state.last_block_height + 1:
            return state.validators
        if height == state.last_block_height:
            return state.last_validators
        if self.state_store is not None:
            return self.state_store.load_validators(height)
        return None

    def _expired(self, ev, state: State) -> bool:
        """reference pool.go isExpired: beyond BOTH age bounds."""
        p = state.consensus_params
        age_blocks = state.last_block_height - ev.height()
        age_secs = (state.last_block_time.seconds - ev.time().seconds)
        return (age_blocks > p.evidence_max_age_num_blocks
                and age_secs > p.evidence_max_age_seconds)

    # --- proposal / commit flow ---------------------------------------------

    def pending_evidence(self, max_bytes: int = -1
                         ) -> List[DuplicateVoteEvidence]:
        """reference pool.go:100 PendingEvidence (byte-bounded reap)."""
        with self._lock:
            out, total = [], 0
            for ev in self._pending:
                sz = len(ev.encode())
                if max_bytes >= 0 and total + sz > max_bytes:
                    break
                out.append(ev)
                total += sz
            return out

    def check_evidence(self, evs: List[DuplicateVoteEvidence],
                       state: State) -> None:
        """Block-validation hook: every piece must verify (reference
        pool.go:308 CheckEvidence). Raises EvidenceError."""
        seen_in_block = set()
        for ev in evs:
            key = ev.hash()
            if key in seen_in_block:
                raise EvidenceError("duplicate evidence in block")
            seen_in_block.add(key)
            if key in self._committed:
                raise EvidenceError("evidence already committed")
            val_set = self._validators_at(ev.height(), state)
            if val_set is None:
                raise EvidenceError(
                    f"no validator set for evidence height {ev.height()}")
            self._verify_one(ev, state, val_set)

    def update(self, state: State,
               committed: List[DuplicateVoteEvidence]) -> None:
        """Post-commit: mark included evidence, prune expired (reference
        pool.go:80 Update)."""
        with self._lock:
            for ev in committed:
                self._committed.add(ev.hash())
            self._pending = [
                ev for ev in self._pending
                if ev.hash() not in self._committed
                and not self._expired(ev, state)]

    def size(self) -> int:
        return len(self._pending)
