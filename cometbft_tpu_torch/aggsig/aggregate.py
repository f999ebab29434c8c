"""Signature aggregation, signer bitmaps, and proof-of-possession.

Aggregation model (BLS basic scheme over the min-pubkey-size variant:
48B G1 pubkeys, 96B G2 signatures, matching crypto/bls12381.py):

  S_agg = Σ S_i   (G2 point addition of the covered signatures)

verified against the signers' pubkeys grouped by message:

  e(g1, S_agg) == Π_j e(Σ_{i∈group_j} pk_i, H(m_j))

Rogue-key defense is proof-of-possession: pk_atk = pk' − Σ pk_honest
lets an attacker sign for the whole group unless every aggregated key
has demonstrated knowledge of its secret. A PoP is a BLS signature by
the key over a domain-separated message bound to the pubkey bytes; it
is verified ONCE when the key enters a validator set (genesis load or
val-update) and recorded in a process registry — aggregate
verification refuses any bitmap signer without a registered PoP
(aggsig/verify.py), so an unregistered key can never contribute to an
accepted aggregate.

Port of `cometbft_tpu/aggsig/aggregate.py`. One difference: the JAX
package takes the PoP kernel route when its compile ledger says the
fused Miller kernel is warm at the batch's bucket (a stand-in for minutes
of jit); the port routes by device, as the farm does: the kernel route
whenever the pairing checker it would use is on cuda, the host route on
the CPU (`register_pops_batch(device=)`).
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from ..crypto import bls12381 as bls
from ..device import resolve_device

# Domain separation for proofs of possession: a PoP must never be
# confusable with a consensus signature, so the signed message is a
# tagged digest of the pubkey — the tag makes the >32-byte message
# sha256-hashed by _fixed_msg, keeping PoPs off the short-message
# padding deviation entirely.
POP_TAG = b"COMETBFT_TPU_BLS_POP_V1|"


# --- signer bitmap ------------------------------------------------------------
# Bit i (byte i//8, LSB-first within the byte) marks validator index i
# as covered by the aggregate signature. Stray bits beyond the
# validator count are an encoding error, not ignorable padding — a
# forged high bit must fail structure validation, never silently drop.

def bitmap_encode(bits: Sequence[bool]) -> bytes:
    out = bytearray((len(bits) + 7) // 8)
    for i, b in enumerate(bits):
        if b:
            out[i // 8] |= 1 << (i % 8)
    return bytes(out)


def bitmap_decode(bitmap: bytes, n: int) -> List[bool]:
    """bitmap -> n bools; raises ValueError on wrong length or stray
    bits past n."""
    if len(bitmap) != (n + 7) // 8:
        raise ValueError(
            f"bitmap length {len(bitmap)} != {(n + 7) // 8} for {n} slots")
    bits = [bool(bitmap[i // 8] >> (i % 8) & 1) for i in range(n)]
    for j in range(n, len(bitmap) * 8):
        if bitmap[j // 8] >> (j % 8) & 1:
            raise ValueError(f"stray bitmap bit {j} past {n} validators")
    return bits


# --- aggregation --------------------------------------------------------------

def aggregate_signatures(sigs: Iterable[bytes]) -> bytes:
    """Sum compressed G2 signatures -> one compressed G2 point. Each
    input is decompressed with full curve/subgroup validation; raises
    ValueError on any malformed signature or an empty input."""
    acc = None
    n = 0
    for sig in sigs:
        pt = bls.g2_decompress(sig)
        if pt is None:
            raise ValueError("cannot aggregate the infinity signature")
        acc = pt if acc is None else bls._fq2.pt_add(acc, pt)
        n += 1
    if n == 0:
        raise ValueError("nothing to aggregate")
    return bls.g2_compress(acc)


def aggregate_pubkey_points(points) -> Optional[tuple]:
    """Sum decompressed G1 pubkey points (message-group aggregation)."""
    acc = None
    for pt in points:
        acc = pt if acc is None else bls._fq.pt_add(acc, pt)
    return acc


# --- proof of possession ------------------------------------------------------

def _pop_msg(pub_bytes: bytes) -> bytes:
    return POP_TAG + pub_bytes


def pop_prove(priv: "bls.Bls12381PrivKey") -> bytes:
    """The key's proof of possession: sign the tagged pubkey bytes."""
    pub = priv.pub_key().bytes_()
    return priv.sign(_pop_msg(pub))


def deterministic_keys_with_pops(n: int, rng):
    """n seeded BLS keys plus their PoP map — the shared genesis
    recipe for simnet (harness.make_genesis) and chain_gen, so key
    seeding and PoP derivation can never silently diverge between the
    engine and the fixtures that test it."""
    keys = [bls.Bls12381PrivKey.generate(
                seed=bytes(rng.randrange(256) for _ in range(32)))
            for _ in range(n)]
    return keys, {k.pub_key().bytes_(): pop_prove(k) for k in keys}


def pop_verify(pub_bytes: bytes, pop: bytes) -> bool:
    try:
        pk = bls.Bls12381PubKey(pub_bytes)
    except ValueError:
        return False
    return pk.verify_signature(_pop_msg(pub_bytes), pop)


# Process-wide registry of pubkeys whose PoP verified TRUE. Populated
# from genesis (state.State.from_genesis) and by callers admitting BLS
# keys via validator updates; consulted by aggregate verification.
# The verified PoP BYTES are retained alongside the flag: a seal
# provider (sealsync/) must re-serve them to laggards crossing an
# epoch boundary — a PoP is self-certifying, so re-serving costs no
# trust, but it cannot be reconstructed from the flag alone.
# guarded-by: _POP_LOCK: _POP_OK, _POP_BYTES
_POP_LOCK = threading.Lock()
_POP_OK: Dict[bytes, bool] = {}
_POP_BYTES: Dict[bytes, bytes] = {}


def register_pop(pub_bytes: bytes, pop: bytes, metrics=None) -> bool:
    """Verify + record a key's proof of possession. Idempotent: a key
    already registered returns True without re-verifying (a PoP is a
    one-time admission check, amortized over the key's lifetime)."""
    with _POP_LOCK:
        if _POP_OK.get(pub_bytes):
            return True
    ok = pop_verify(pub_bytes, pop)
    if ok:
        with _POP_LOCK:
            _POP_OK[pub_bytes] = True
            _POP_BYTES[pub_bytes] = pop
    elif metrics is not None:
        metrics.pop_rejections.inc()
    return ok


def _pop_device(device) -> torch.device:
    """The device whose route admits PoPs: the caller's, else the card
    when one is present. Without a card no pairing checker can run on
    cuda, and the host route is the only route."""
    if device is not None:
        return resolve_device(device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _kernel_pop_check(pending, device, metrics=None):
    """PoP admission through the fused pairing kernel on `device`'s
    shared checker: each key is one 2-pair item (e(-g1, s_pop)·e(pk,
    H(msg)) == 1 — the kernel's native shape), so per-key verdicts are
    exact with NO random-linear-combination round and no per-failure
    fallback. Returns all_ok. A kernel error or a wrong canary raises."""
    from .verify import shared_pairing
    pc = shared_pairing(device)
    items = []
    lanes: List[bytes] = []
    all_ok = True
    for pub, pop in pending:
        try:
            pk = bls.Bls12381PubKey(pub)
            s = (bls.g2_decompress(pop)
                 if len(pop) == bls.SIGNATURE_LENGTH else None)
        except ValueError:
            s = None
        if s is None:
            all_ok = False
            if metrics is not None:
                metrics.pop_rejections.inc()
            continue
        h = bls.hash_to_g2_cached(bls._fixed_msg(_pop_msg(pub)))
        items.append([(bls.G1_NEG, s), (pk.point, h)])
        lanes.append((pub, pop))
    oks = pc.check(items) if items else []
    with _POP_LOCK:
        for (pub, pop), ok in zip(lanes, oks):
            if ok:
                _POP_OK[pub] = True
                _POP_BYTES[pub] = pop
    for ok in oks:
        if not ok:
            all_ok = False
            if metrics is not None:
                metrics.pop_rejections.inc()
    return all_ok


def register_pops_batch(pops: Dict[bytes, bytes], metrics=None,
                        device=None) -> bool:
    """Verify + record many proofs of possession in one batch —
    genesis admission of an n-validator BLS set costs ~1 Miller loop
    per key plus shared final exponentiation work instead of n full
    verifies. On cuda (`device`, default the card when one is present)
    each key rides the shared PairingChecker's fused kernel as its own
    exact 2-pairing lane, cold process or not; on the CPU the
    random-linear-combination multi-pairing (BlsBatchVerifier) runs
    host-side. Per-key verdicts are exact on both routes; returns True
    iff every PoP verified."""
    pending = [(pub, pop) for pub, pop in pops.items()
               if not has_pop(pub)]
    if not pending:
        return True
    dev = _pop_device(device)
    if dev.type == "cuda":
        return _kernel_pop_check(pending, dev, metrics=metrics)
    bv = BlsBatchVerifier()
    lanes: List[bytes] = []
    all_ok = True
    for pub, pop in pending:
        try:
            pk = bls.Bls12381PubKey(pub)
        except ValueError:
            all_ok = False
            continue
        bv.add(pk, _pop_msg(pub), pop)
        lanes.append((pub, pop))
    if len(bv):
        batch_ok, oks = bv.verify()
        all_ok = all_ok and batch_ok
        with _POP_LOCK:
            for (pub, pop), ok in zip(lanes, oks):
                if ok:
                    _POP_OK[pub] = True
                    _POP_BYTES[pub] = pop
        if metrics is not None:
            for ok in oks:
                if not ok:
                    metrics.pop_rejections.inc()
    return all_ok


def has_pop(pub_bytes: bytes) -> bool:
    with _POP_LOCK:
        return bool(_POP_OK.get(pub_bytes))


def registered_pop(pub_bytes: bytes) -> Optional[bytes]:
    """The verified PoP bytes for `pub_bytes`, or None. Keys admitted
    before PoP retention existed (flag only) also return None — the
    seal provider then simply cannot attest that key's epoch, which is
    a serving gap, never a soundness one."""
    with _POP_LOCK:
        return _POP_BYTES.get(pub_bytes)


def reset_pop_registry() -> None:
    """Drop all registered PoPs (tests)."""
    with _POP_LOCK:
        _POP_OK.clear()
        _POP_BYTES.clear()


def valset_pops_ok(val_set) -> bool:
    """True iff every validator key is BLS AND has a registered PoP —
    the assembly-side gate for producing an AggregatedCommit. (The
    verification side re-checks per signer: assembly gating is an
    optimization, verification gating is the security property.)"""
    if len(val_set) == 0:
        return False
    for v in val_set.validators:
        if v.pub_key.type_() != bls.KEY_TYPE:
            return False
        if not has_pop(v.pub_key.bytes_()):
            return False
    return True


# --- batch verification of independent signatures -----------------------------

def _batch_coefficients(items: Sequence[Tuple[bytes, bytes, bytes]]
                        ) -> List[int]:
    """Deterministic 128-bit random-linear-combination coefficients,
    Fiat-Shamir-derived from the whole batch: an adversary choosing
    (pk, msg, sig) triples cannot anticipate coefficients that cancel
    a forgery against an honest lane (same construction as the RLC
    batch equation in ops/ed25519). First coefficient pinned to 1 —
    a standard optimization that cannot weaken the bound."""
    h = hashlib.sha256()
    for pub, msg, sig in items:
        for part in (pub, hashlib.sha256(msg).digest(), sig):
            h.update(len(part).to_bytes(4, "big"))
            h.update(part)
    seed = h.digest()
    out = [1]
    for i in range(1, len(items)):
        c = int.from_bytes(
            hashlib.sha256(seed + i.to_bytes(4, "big")).digest()[:16],
            "big")
        out.append(c | 1)  # never zero
    return out


class BlsBatchVerifier:
    """crypto.keys.BatchVerifier for bls12_381 keys: one multi-pairing
    over the whole batch (random linear combination, single final
    exponentiation); on a combined failure, falls back to per-signature
    verification for exact attribution — the same contract the other
    batch verifiers honor (all-ok fast path, per-lane verdicts).

    Unlike commit aggregation this verifies INDEPENDENT (pk, msg, sig)
    triples, so no proof of possession is required: the per-lane RLC
    coefficients already prevent cross-lane cancellation."""

    def __init__(self):
        self._items: List[Tuple[object, bytes, bytes]] = []

    def __len__(self) -> int:
        return len(self._items)

    def add(self, pk, msg: bytes, sig: bytes) -> None:
        if pk.type_() != bls.KEY_TYPE:
            raise TypeError(f"bls batch verifier got {pk.type_()} key")
        self._items.append((pk, msg, sig))

    def _combined_ok(self) -> bool:
        triples = [(pk.bytes_(), msg, sig) for pk, msg, sig in self._items]
        coeffs = _batch_coefficients(triples)
        sig_acc = None
        by_msg: Dict[bytes, object] = {}
        for (pk, msg, sig), c in zip(self._items, coeffs):
            try:
                s = bls.g2_decompress(sig)
            except ValueError:
                return False
            if s is None:
                return False
            cs = bls._fq2.pt_mul(c, s)
            sig_acc = cs if sig_acc is None else bls._fq2.pt_add(sig_acc, cs)
            cp = bls._fq.pt_mul(c, pk._pt)
            fixed = bls._fixed_msg(msg)
            prev = by_msg.get(fixed)
            by_msg[fixed] = cp if prev is None else bls._fq.pt_add(prev, cp)
        pairs = [(bls.G1_NEG, sig_acc)]
        for fixed, pk_sum in by_msg.items():
            pairs.append((pk_sum, bls.hash_to_g2_cached(fixed)))
        return bls.multi_pairing_is_one(pairs)

    def verify(self) -> Tuple[bool, List[bool]]:
        if not self._items:
            return False, []  # empty batch is a failure, like the others
        if self._combined_ok():
            return True, [True] * len(self._items)
        oks = [pk.verify_signature(msg, sig)
               for pk, msg, sig in self._items]
        return all(oks), oks
