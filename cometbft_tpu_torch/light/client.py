"""Light client: sequential + skipping (bisection) verification with
witness cross-checking (reference light/client.go:473,612,705,
light/detector.go).

The third north-star call site: on a 10k-header catch-up, each header's
commit flows through the same batch-verify seam the blocksync tile uses,
so bulk light verification rides the device kernels.

Port of `cometbft_tpu/light/client.py`. What differs: `LightClient`
takes `device=` (default cuda, resolved once at construction) and every
commit check hands it down; the attack style of detector evidence is
classified by this module's copy of the JAX package's
`evidence/pool.expected_byzantine_validators` (the evidence pool is not
ported yet, ROADMAP.md Queue 1: the host-only layers).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ..device import resolve_device
from ..types.proto import Timestamp
from ..types import validation
from . import verifier
from .provider import Provider, ProviderError
from .store import LightStore
from .types import LightBlock


class LightClientError(Exception):
    pass


def expected_byzantine_validators(ev, common_vals, trusted_header,
                                  trusted_commit):
    """The attack's punishable set, by attack style (reference
    types/evidence.go:250-293 GetByzantineValidators). None when the
    style cannot be determined locally (no trusted header/commit).
    Copy of `cometbft_tpu/evidence/pool.py:152`."""
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


class ErrNoWitnesses(LightClientError):
    pass


@dataclass
class ConflictingHeadersError(LightClientError):
    """A witness returned a different header for a verified height — the
    divergence the detector reports as a light-client attack (reference
    light/detector.go:21-92). Carries the constructed
    LightClientAttackEvidence (reference detector.go
    newLightClientAttackEvidence → provider ReportEvidence)."""
    primary: LightBlock
    witness: LightBlock
    witness_index: int
    evidence: object = None

    def __str__(self) -> str:
        return (f"witness {self.witness_index} disagrees at height "
                f"{self.primary.height}")


@dataclass
class TrustOptions:
    """reference light/client.go:58-90."""
    period_seconds: int
    height: int
    hash: bytes

    def validate(self) -> None:
        if self.period_seconds <= 0:
            raise LightClientError("trusting period must be positive")
        if self.height <= 0:
            raise LightClientError("trusted height must be positive")
        if len(self.hash) != 32:
            raise LightClientError("trusted hash must be 32 bytes")


class LightClient:
    """reference light/client.go Client (sequential=False selects
    skipping/bisection, the default). `device` (default cuda) is where a
    commit of `validation.BATCH_VERIFY_THRESHOLD` or more signatures
    batch-verifies."""

    def __init__(self, chain_id: str, trust_options: TrustOptions,
                 primary: Provider, witnesses: List[Provider],
                 store: LightStore, sequential: bool = False,
                 trust_level: validation.Fraction =
                 validation.DEFAULT_TRUST_LEVEL,
                 now_fn=Timestamp.now, device=None):
        trust_options.validate()
        self.device = resolve_device(device)
        self.chain_id = chain_id
        self.trusting_period = trust_options.period_seconds
        self.primary = primary
        self.witnesses = list(witnesses)
        self.store = store
        self.sequential = sequential
        self.trust_level = trust_level
        self._now = now_fn
        self._initialize(trust_options)

    def _initialize(self, opts: TrustOptions) -> None:
        """Fetch + pin the trust root (reference client.go:388-470
        initializeWithTrustOptions)."""
        existing = self.store.light_block(opts.height)
        if existing is not None:
            if existing.header.hash() != opts.hash:
                raise LightClientError(
                    "trusted hash does not match stored header")
            return
        lb = self.primary.light_block(opts.height)
        lb.validate_basic(self.chain_id)
        if lb.header.hash() != opts.hash:
            raise LightClientError(
                f"primary returned header hash "
                f"{lb.header.hash().hex()[:16]} != trusted "
                f"{opts.hash.hex()[:16]}")
        # the set that signed must be the one committed to by the header
        validation.verify_commit_light(
            self.chain_id, lb.validator_set,
            lb.signed_header.commit.block_id, lb.height,
            lb.signed_header.commit, device=self.device)
        self.store.save_light_block(lb)

    # --- public API -----------------------------------------------------------

    def trusted_light_block(self, height: int) -> Optional[LightBlock]:
        return self.store.light_block(height)

    def latest_trusted(self) -> Optional[LightBlock]:
        return self.store.latest()

    def update(self, now: Optional[Timestamp] = None) -> LightBlock:
        """Verify the primary's latest header (reference client.go:506)."""
        latest = self.primary.light_block(0)
        return self.verify_light_block_at_height(latest.height, now)

    def verify_light_block_at_height(self, height: int,
                                     now: Optional[Timestamp] = None
                                     ) -> LightBlock:
        """reference light/client.go:473-504."""
        now = now or self._now()
        got = self.store.light_block(height)
        if got is not None:
            return got
        latest = self.store.latest()
        if latest is None:
            raise LightClientError("store empty — client not initialized")
        if height < latest.height:
            # backwards verification (reference client.go:934): walk the
            # hash links down from the closest trusted header
            return self._verify_backwards(height)
        lb = self.primary.light_block(height)
        lb.validate_basic(self.chain_id)
        if self.sequential:
            self._verify_sequential(latest, lb, now)
        else:
            self._verify_skipping(latest, lb, now)
        self._cross_check(lb)
        self.store.save_light_block(lb)
        return lb

    # --- verification strategies ----------------------------------------------

    def _verify_sequential(self, trusted: LightBlock, target: LightBlock,
                           now: Timestamp) -> None:
        """reference light/client.go:612-668: fetch and verify EVERY
        header between trusted and target."""
        cur = trusted
        for h in range(trusted.height + 1, target.height + 1):
            nxt = (target if h == target.height
                   else self.primary.light_block(h))
            nxt.validate_basic(self.chain_id)
            verifier.verify_adjacent(
                self.chain_id, cur, nxt, self.trusting_period, now,
                device=self.device)
            self.store.save_light_block(nxt)
            cur = nxt

    def _verify_skipping(self, trusted: LightBlock, target: LightBlock,
                         now: Timestamp) -> None:
        """Bisection (reference light/client.go:705-772 verifySkipping):
        try the jump; when the trusted set can't vouch (<1/3 overlap),
        bisect toward the trusted header until it can."""
        cur = trusted
        pivots = [target]
        while pivots:
            candidate = pivots[-1]
            try:
                if candidate.height == cur.height + 1:
                    verifier.verify_adjacent(
                        self.chain_id, cur, candidate,
                        self.trusting_period, now, device=self.device)
                else:
                    verifier.verify_non_adjacent(
                        self.chain_id, cur, candidate,
                        self.trusting_period, now, self.trust_level,
                        device=self.device)
            except verifier.ErrNewValSetCantBeTrusted:
                mid = (cur.height + candidate.height) // 2
                if mid in (cur.height, candidate.height):
                    raise LightClientError(
                        "bisection cannot make progress")
                lb = self.primary.light_block(mid)
                lb.validate_basic(self.chain_id)
                pivots.append(lb)
                continue
            self.store.save_light_block(candidate)
            cur = candidate
            pivots.pop()

    def _verify_backwards(self, height: int) -> LightBlock:
        """Hash-linked walk down from the closest trusted header above
        (client.go:934-988)."""
        cur = self.store.lowest_above(height)
        while cur is not None and cur.height > height:
            prev = self.primary.light_block(cur.height - 1)
            prev.validate_basic(self.chain_id)
            if cur.header.last_block_id.hash != prev.header.hash():
                raise LightClientError(
                    f"backwards hash mismatch at {prev.height}")
            self.store.save_light_block(prev)
            cur = prev
        if cur is None or cur.height != height:
            raise LightClientError(f"cannot reach height {height}")
        return cur

    # --- detector ---------------------------------------------------------------

    def _cross_check(self, lb: LightBlock) -> None:
        """Compare the verified header against every witness (reference
        light/detector.go:21-92, compareNewHeaderWithWitness). On
        divergence, build LightClientAttackEvidence against the highest
        trusted (common) header below the conflict and report it to the
        witnesses that can act on it (detector.go ReportEvidence)."""
        for i, w in enumerate(self.witnesses):
            try:
                other = w.light_block(lb.height)
            except ProviderError:
                continue  # witness lagging — reference retries/drops
            if other.header.hash() != lb.header.hash():
                # the disputed header must not stay trusted: the verify
                # strategies saved it before this cross-check ran, and a
                # stored block short-circuits all future verification
                self.store.delete(lb.height)
                # the anchor must be a header BOTH sides share — recent
                # stored headers came from the (possibly lying) primary,
                # so walk down until the witness agrees, evicting every
                # primary-only header passed on the way (the reference
                # detector walks its trace the same way,
                # detector.go examineConflictingHeaderAgainstTrace)
                common = self._common_anchor(w, lb.height)
                ev_witness = self._make_attack_evidence(other, common,
                                                        counterpart=lb)
                ev_primary = self._make_attack_evidence(lb, common,
                                                        counterpart=other)
                self._report(self.primary, ev_witness)
                self._report(w, ev_primary)
                raise ConflictingHeadersError(lb, other, i,
                                              evidence=ev_witness)

    def _common_anchor(self, witness: Provider,
                       below: int) -> Optional[LightBlock]:
        """Highest stored block below `below` whose hash the witness
        confirms; stored blocks the witness disputes (headers only the
        primary vouched for) are evicted rather than trusted."""
        while True:
            cand = self.store.highest_below(below)
            if cand is None:
                return None
            try:
                theirs = witness.light_block(cand.height)
                if theirs.header.hash() == cand.header.hash():
                    return cand
            except ProviderError:
                return cand  # witness can't say; keep the stored anchor
            self.store.delete(cand.height)
            below = cand.height

    @staticmethod
    def _report(provider, evidence) -> None:
        if evidence is None:
            return
        report = getattr(provider, "report_evidence", None)
        if report is not None:
            try:
                report(evidence)
            except ProviderError:
                pass

    def _make_attack_evidence(self, conflicting: LightBlock, common,
                              counterpart: LightBlock = None):
        """Evidence anchored at the highest trusted height below the
        conflict (the common header, detector.go:169).

        The byzantine list MUST use the same per-attack-style formula
        full nodes verify with (evidence/pool.py
        expected_byzantine_validators — lunatic / equivocation /
        amnesia, reference types/evidence.go:250-300): a list built
        with the lunatic formula for a non-lunatic attack would fail
        every pool's completeness check and the genuine evidence would
        be dropped network-wide. `counterpart` is the block the honest
        side holds at the same height (classifies the style)."""
        from ..types.evidence import LightClientAttackEvidence
        if common is None:
            return None
        ev = LightClientAttackEvidence(
            conflicting_block=conflicting,
            common_height=common.height,
            byzantine_validators=[],
            total_voting_power=common.validator_set.total_voting_power(),
            timestamp=common.header.time)
        byz = expected_byzantine_validators(
            ev, common.validator_set,
            counterpart.header if counterpart is not None else None,
            counterpart.signed_header.commit
            if counterpart is not None else None)
        if byz is None:
            # style undeterminable (no counterpart): fall back to the
            # lunatic formula — verifiers without the trusted block
            # skip completeness too
            signers = {cs.validator_address for cs in
                       conflicting.signed_header.commit.signatures
                       if cs.for_block()}
            byz = [v for v in common.validator_set.validators
                   if v.address in signers]
        ev.byzantine_validators = byz
        return ev
