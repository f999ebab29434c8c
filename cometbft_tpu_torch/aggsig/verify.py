"""Aggregated-commit verification: one pairing equation per commit
(port of `cometbft_tpu/aggsig/verify.py`).

Per commit the check is

    e(-g1, S_agg) · Π_j e(Σ_{i∈group_j} pk_i, H(m_j)) == 1

where groups collect covered signers by identical sign-bytes (the
canonical precommit message differs only in the per-validator
timestamp, so commits whose precommits share timestamps collapse to a
single group and the whole commit costs TWO Miller loops and ONE final
exponentiation, independent of validator-set size).

The whole pairing check is routed through a PairingChecker so many
commits verify together during blocksync: the marshal stage stops at
the (G1, G2) pair lists, and the checker settles the fused
`final_exp(Π miller(P_i, Q_i)) == 1` verdicts in one
`ops/bls12.bls_miller_finalexp` call per tile (per chunk of 64), on the
checker's device. Items with more than MILLER_PAIRS live pairs
(multi-group commits) take the host Miller product and then the
FinalExpChecker, whose hard part runs `ops/bls12.bls_hard_pow` on the
same device. Every kernel batch carries a known-one and a known-not-one
canary item.

Where the port differs from the JAX package (its no-fallback rule):
- the device decides, not a backend string: `FinalExpChecker(device=)`
  and `PairingChecker(device=)` resolve it with
  `device.resolve_device` (cuda unless the caller asks for the CPU, where
  the kernel wrappers run their plain torch versions), and
  `shared_finalexp(device)` / `shared_pairing(device)` keep one checker
  per device. COMETBFT_TPU_AGGSIG_KERNEL and the JAX package's
  `is_device_platform` are gone;
- a kernel error (build, launch, shape) propagates; an attached
  DeviceSupervisor hears of it first (`report_trip`). The JAX package
  quarantines the kernel and recomputes on the host oracle;
- a wrong canary verdict is counted (`canary_failures`, and
  AggsigMetrics.canary_failures), reported (`report_corruption`) and
  raised as `KernelCanaryError`. The JAX package re-verifies the batch
  on the host oracle.

Whole-aggregate verdicts are SigCache-keyed (path="aggsig"): the
triple (b"aggsig|" + valset-hash, seal-digest, agg_sig) makes a hit
exactly "this aggregate already verified TRUE against this validator
set on this chain". Nil-vote lanes keep individual signatures and
verify per-signature with their own cache entries.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..crypto import bls12381 as bls
from ..device import resolve_device
from ..ops.bls12 import KernelCanaryError
from ..trace import shared_tracer
from ..types.validation import (CommitVerificationError,
                                ErrNotEnoughVotingPowerSigned,
                                ErrWrongSignature)
from .aggregate import has_pop

# Aggregate-path tallies (counts only, never logged from deterministic
# paths; bls.OP_COUNTERS carries the raw miller/final-exp counts).
# "aggregates_kernel" counts verdicts the kernel wrappers settled, on
# either device; the JAX package's "aggregates_cpu" (its host re-verify)
# has no counterpart in the port.
AGG_COUNTERS = {"aggregates_kernel": 0, "pop_rejections": 0,
                "cache_hits": 0}

_metrics = None  # libs/metrics_gen.AggsigMetrics, wired by the caller


def set_metrics(m) -> None:
    global _metrics
    _metrics = m


class AggregateVerificationError(CommitVerificationError):
    """The aggregate itself failed (bad pairing / signer without PoP /
    malformed seal) — distinct from power/structure errors so callers
    can attribute rejections."""


def _canary_failed(checker, what: str) -> None:
    """A kernel batch answered a canary item wrong (or lost lanes):
    counted, reported to the checker's supervisor, raised. Nothing
    re-verifies on the CPU."""
    checker.canary_failures += 1
    if checker.supervisor is not None:
        checker.supervisor.report_corruption(what)
    if _metrics is not None:
        _metrics.canary_failures.inc()
    raise KernelCanaryError(f"{what} answered wrong")


def _settled(n: int, device: torch.device) -> None:
    AGG_COUNTERS["aggregates_kernel"] += n
    if _metrics is not None:
        _metrics.aggregates_verified.inc(n, backend=device.type)


# --- batched final-exponentiation checker -------------------------------------

class FinalExpChecker:
    """Batched `final_exponentiation(m) == 1` verdicts: the easy part
    on the host per element, the hard part through `bls_hard_pow` on
    `device` (default cuda). Every batch carries a known-one and a
    known-not-one element; a wrong canary verdict raises
    KernelCanaryError, and a kernel error propagates, each reported to
    the attached supervisor first."""

    def __init__(self, device=None, supervisor=None):
        self.device = resolve_device(device)
        self.supervisor = supervisor
        self.canary_failures = 0
        self._canaries = None

    def _canary_pair(self):
        """(known-one, known-not-one) Miller products, computed once:
        miller(-g1,Q)·miller(g1,Q) final-exponentiates to exactly 1;
        miller(g1,Q) alone final-exponentiates to e(g1,Q) != 1 by
        pairing non-degeneracy."""
        if self._canaries is None:
            q = bls.G2_GEN
            good = bls.miller_product([(bls.G1_NEG, q), (bls.G1_GEN, q)])
            bad = bls.miller_loop(bls.G1_GEN, q)
            self._canaries = (good, bad)
        return self._canaries

    def check(self, elems: Sequence) -> List[bool]:
        if not elems:
            return []
        from ..ops import bls12 as kernel
        good, bad = self._canary_pair()
        batch = list(elems) + [good, bad]
        try:
            verdicts = kernel.final_exp_is_one_batch(batch,
                                                     device=self.device)
        except Exception as exc:
            if self.supervisor is not None:
                self.supervisor.report_trip(exc)
            raise
        if len(verdicts) != len(batch) or not verdicts[-2] or verdicts[-1]:
            _canary_failed(self, "bls finalexp canary")
        _settled(len(elems), self.device)
        return [bool(v) for v in verdicts[:-2]]


# --- fused pairing checker ----------------------------------------------------

class PairingChecker:
    """Batched `final_exp(Π miller(P_i, Q_i)) == 1` verdicts over
    items that are LISTS OF PAIRS (the marshal stage's output).

    Items whose live pair count fits the kernel's fixed shape
    (MILLER_PAIRS — the 2-loop commit equation) settle in ONE fused
    `bls_miller_finalexp` call on `device` (default cuda), canary-gated
    like FinalExpChecker. Items with more pairs (multi-group commits)
    take the host Miller product and then the attached FinalExpChecker
    (`bls_hard_pow` on the same device), as in the JAX package."""

    def __init__(self, device=None, supervisor=None,
                 finalexp: Optional[FinalExpChecker] = None):
        self.device = resolve_device(device)
        self.supervisor = supervisor
        self.finalexp = finalexp or FinalExpChecker(self.device, supervisor)
        self.canary_failures = 0

    @staticmethod
    def _live(pairs) -> list:
        return [(p, q) for p, q in pairs
                if p is not None and q is not None]

    @staticmethod
    def _canary_items():
        """(known-one, known-not-one) pair lists in the kernel's own
        2-pair shape: miller(-g1,Q)·miller(g1,Q) final-exponentiates
        to exactly 1; e(g1,Q)^2 != 1 (non-degeneracy, odd order r)."""
        q = bls.G2_GEN
        return ([(bls.G1_NEG, q), (bls.G1_GEN, q)],
                [(bls.G1_GEN, q), (bls.G1_GEN, q)])

    def check(self, items: Sequence) -> List[bool]:
        items = [list(p) for p in items]
        if not items:
            return []
        from ..ops import bls12 as kernel
        fuse = [i for i, p in enumerate(items)
                if len(self._live(p)) <= kernel.MILLER_PAIRS]
        fuse_set = set(fuse)
        rest = [i for i in range(len(items)) if i not in fuse_set]
        verdicts = [False] * len(items)
        if fuse:
            good, bad = self._canary_items()
            batch = [items[i] for i in fuse] + [good, bad]
            try:
                out = kernel.miller_finalexp_is_one_batch(
                    batch, device=self.device)
            except Exception as exc:
                if self.supervisor is not None:
                    self.supervisor.report_trip(exc)
                raise
            if len(out) != len(batch) or not out[-2] or out[-1]:
                _canary_failed(self, "bls miller canary")
            # the kernel path never calls host miller_product, so the
            # pairings-per-commit evidence is tallied here instead
            bls.OP_COUNTERS["miller_loops"] += sum(
                len(self._live(items[i])) for i in fuse)
            _settled(len(fuse), self.device)
            for i, v in zip(fuse, out[:len(fuse)]):
                verdicts[i] = bool(v)
        if rest:
            products = [bls.miller_product(items[i]) for i in rest]
            for i, v in zip(rest, self.finalexp.check(products)):
                verdicts[i] = bool(v)
        return verdicts


_shared_checkers: Dict[torch.device, FinalExpChecker] = {}
_shared_pairings: Dict[torch.device, PairingChecker] = {}
_shared_lock = threading.Lock()


def shared_finalexp(device=None) -> FinalExpChecker:
    """Process-wide checker of `device` (default cuda), one per device."""
    dev = resolve_device(device)
    with _shared_lock:
        fx = _shared_checkers.get(dev)
        if fx is None:
            fx = _shared_checkers[dev] = FinalExpChecker(dev)
        return fx


def shared_pairing(device=None) -> PairingChecker:
    """Process-wide pairing checker of `device` (default cuda); it
    reuses that device's shared_finalexp checker as its final-exp
    stage, so the counters stay coherent across both paths."""
    dev = resolve_device(device)
    fx = shared_finalexp(dev)
    with _shared_lock:
        pc = _shared_pairings.get(dev)
        if pc is None:
            pc = _shared_pairings[dev] = PairingChecker(dev, finalexp=fx)
        return pc


def reset_shared_finalexp() -> None:
    with _shared_lock:
        _shared_checkers.clear()
        _shared_pairings.clear()


# --- commit verification ------------------------------------------------------

def _count_pairings(n: int) -> None:
    if _metrics is not None:
        _metrics.pairings_total.inc(n)


def _prepare(chain_id: str, vals, commit, voting_power_needed: int,
             ignore, count, lookup_by_index: bool, cache):
    """Shared body: returns ("ok", None) on a cache hit, ("fail", exc)
    on any decided rejection, or ("pend", (pairs, cache_key)) when
    only the pairing equation is outstanding — the (G1, G2) pair list
    stays unevaluated so settle time can batch whole Miller loops
    through the fused kernel, not just final exponentiations."""
    try:
        commit.validate_basic()
        covered = commit.covered_indices()
    except ValueError as e:
        return "fail", CommitVerificationError(
            f"malformed aggregated commit: {e}")

    covered_set = set(covered)
    tallied = 0
    seen: Dict[int, int] = {}
    entries: List[Tuple[int, object]] = []     # covered (idx, validator)
    nil_checks: List[Tuple[int, object, object]] = []
    for idx, cs in enumerate(commit.signatures):
        is_cov = idx in covered_set
        if not is_cov and ignore(cs):
            continue
        if lookup_by_index:
            val = vals.get_by_index(idx)
            if val is None:
                return "fail", CommitVerificationError(
                    f"no validator at index {idx}")
        else:
            val_idx, val = vals.get_by_address(cs.validator_address)
            if val is None:
                if is_cov:
                    # an unknown signer's key cannot be subtracted from
                    # the aggregate: the trusting form requires every
                    # covered signer known to the trusted set
                    # (docs/AGGSIG.md)
                    return "fail", CommitVerificationError(
                        f"aggregate signer at index {idx} unknown to "
                        f"trusted validator set")
                continue
            if val_idx in seen:
                return "fail", CommitVerificationError(
                    f"double vote from validator {val_idx} "
                    f"({seen[val_idx]} and {idx})")
            seen[val_idx] = idx
        if is_cov:
            if val.pub_key.type_() != bls.KEY_TYPE:
                return "fail", CommitVerificationError(
                    f"aggregate signer at index {idx} is not a BLS key")
            entries.append((idx, val))
        elif not cs.absent_():
            nil_checks.append((idx, val, cs))
        if count(cs):
            tallied += val.voting_power

    if tallied <= voting_power_needed:
        return "fail", ErrNotEnoughVotingPowerSigned(
            tallied, voting_power_needed)

    for idx, val in entries:
        if not has_pop(val.pub_key.bytes_()):
            AGG_COUNTERS["pop_rejections"] += 1
            if _metrics is not None:
                _metrics.pop_rejections.inc()
            return "fail", AggregateVerificationError(
                f"aggregate signer at index {idx} has no registered "
                f"proof of possession")

    vh = vals.hash()
    cache_key = (b"aggsig|" + vh,
                 commit.seal_digest(chain_id, vh), commit.agg_sig)
    if cache is not None and cache.seen(*cache_key, path="aggsig"):
        AGG_COUNTERS["cache_hits"] += 1
        return "ok", None

    # nil-vote lanes: individual signatures, individually cached
    for idx, val, cs in nil_checks:
        msg = commit.vote_sign_bytes(chain_id, idx)
        pkb = val.pub_key.bytes_()
        if cache is not None and cache.seen(pkb, msg, cs.signature,
                                            path="aggsig"):
            continue
        if not val.pub_key.verify_signature(msg, cs.signature):
            return "fail", ErrWrongSignature(idx, cs.signature)
        if cache is not None:
            cache.add(pkb, msg, cs.signature)

    try:
        s_agg = bls.g2_decompress(commit.agg_sig)
    except ValueError:
        s_agg = None
    if s_agg is None:
        return "fail", AggregateVerificationError(
            "aggregate signature is not a valid G2 point")

    groups: Dict[bytes, object] = {}
    for idx, val in entries:
        fixed = bls._fixed_msg(commit.vote_sign_bytes(chain_id, idx))
        pt = val.pub_key.point
        prev = groups.get(fixed)
        groups[fixed] = pt if prev is None else bls._fq.pt_add(prev, pt)

    pairs = [(bls.G1_NEG, s_agg)]
    for fixed, pk_sum in groups.items():
        pairs.append((pk_sum, bls.hash_to_g2_cached(fixed)))
    _count_pairings(len(pairs))
    return "pend", (pairs, cache_key)


def verify_aggregated_commit(chain_id: str, vals, commit,
                             voting_power_needed: int, *,
                             ignore, count, count_all: bool,
                             lookup_by_index: bool,
                             cache=None, checker=None,
                             device=None) -> None:
    """The AggregatedCommit analog of validation._verify_commit_core:
    same ignore/count callbacks, same exception vocabulary, one
    multi-pairing instead of n signature checks. count_all is accepted
    for signature parity; the aggregate is a single check, so there is
    no early-exit variant to pick."""
    del count_all
    status, payload = _prepare(chain_id, vals, commit,
                               voting_power_needed, ignore, count,
                               lookup_by_index, cache)
    if status == "fail":
        raise payload
    if status == "ok":
        return
    pairs, cache_key = payload
    ok = (checker or shared_pairing(device)).check([pairs])[0]
    if not ok:
        raise AggregateVerificationError(
            "aggregate signature does not verify against the signer "
            "bitmap")
    if cache is not None:
        cache.add(*cache_key)


class AggSeal:
    """A marshaled aggregate-commit check: either already decided
    ("ok"/"fail") or pending its pairing equation ("pend", payload =
    (pairs, cache_key)). The blocksync marshal stage produces these so
    settle_tile can batch many commits' Miller loops + final
    exponentiations through one PairingChecker call."""

    __slots__ = ("status", "payload")

    def __init__(self, status: str, payload):
        self.status = status
        self.payload = payload


def prepare_full_commit(chain_id: str, vals, commit, needed: int,
                        cache=None) -> AggSeal:
    """FULL verify_commit semantics (absent ignored, every included
    signature checked, for-block power > 2/3) marshaled into an
    AggSeal — the aggregate analog of blocksync's lane marshal."""
    with shared_tracer().start("aggsig.marshal") as span:
        status, payload = _prepare(
            chain_id, vals, commit, needed,
            ignore=lambda c: c.absent_(),
            count=lambda c: c.for_block(),
            lookup_by_index=True, cache=cache)
        span.set_attr("status", status)
    return AggSeal(status, payload)


def settle_seals(seals: Sequence[AggSeal], cache=None,
                 checker=None, device=None) -> List[bool]:
    """Resolve marshaled seals to verdicts, batching every pending
    pairing equation (Miller loops AND final exponentiation) through
    one checker call; verified-TRUE aggregates feed the cache."""
    pend = [i for i, s in enumerate(seals) if s.status == "pend"]
    verdicts = [s.status == "ok" for s in seals]
    if pend:
        with shared_tracer().start("aggsig.settle", seals=len(seals),
                                   pending=len(pend)):
            oks = (checker or shared_pairing(device)).check(
                [seals[i].payload[0] for i in pend])
        for i, ok in zip(pend, oks):
            verdicts[i] = bool(ok)
            if ok and cache is not None:
                cache.add(*seals[i].payload[1])
    return verdicts


def verify_aggregated_commits_bulk(chain_id: str, items, cache=None,
                                   checker=None,
                                   device=None) -> List[bool]:
    """Blocksync form: many (vals, commit, voting_power_needed)
    triples verified with FULL verify_commit semantics and their
    pairing equations batched through one checker call. Returns
    per-item verdicts (True/False), never raises per-item errors."""
    seals = [prepare_full_commit(chain_id, vals, commit, needed, cache)
             for vals, commit, needed in items]
    return settle_seals(seals, cache=cache, checker=checker, device=device)
