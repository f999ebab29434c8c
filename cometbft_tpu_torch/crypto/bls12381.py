"""Pure-Python BLS12-381 key type (reference
crypto/bls12381/key_bls12381.go + const.go — there the curve rides the
cosmos/crypto cgo wrapper over blst behind a build tag; this
environment has no blst, so the curve is implemented from scratch:
VERDICT r4 missing #9, the last unimplemented component rows).

Scope and compatibility:

- Key/signature SHAPES and semantics match the reference exactly:
  32-byte secret scalars, 48-byte compressed G1 public keys, 96-byte
  compressed G2 signatures (ZCash serialization: compression/infinity/
  sign bits in the top three bits of the first byte), address =
  sha256(pubkey)[:20] (tmhash.SumTruncated), and messages longer than
  32 bytes are sha256-hashed before signing
  (key_bls12381.go:84-97,122-144 Sign/VerifySignature).
- The PAIRING is the real thing: optimal-ate-style Miller loop over
  the Fq12 tower with a full final exponentiation — verification is
  e(g1, sig) == e(pk, H(m)) with subgroup checks on deserialization.
- Two DOCUMENTED interop deviations (both local to the sign path;
  verification of our own signatures is self-consistent):
  1. HASH-TO-CURVE: expand_message_xmd (RFC 9380 §5.3.1, SHA-256)
     feeding a deterministic try-and-increment map onto the twist,
     then cofactor clearing — NOT the IETF SSWU suite. The SSWU
     3-isogeny constant tables cannot be transcribed here with
     confidence and no blst/py_ecc exists in the image to validate
     them against; a sound, deterministic, constant-documented map
     keeps the scheme secure (hash outputs are indistinguishable from
     random curve points) at the cost of signature interop with
     Ethereum-suite signers. Swapping `hash_to_g2` for SSWU restores
     byte interop without touching anything else.
  2. SHORT-MESSAGE PADDING: messages of at most 32 bytes are
     zero-padded to exactly 32 before hashing to the curve
     (`_fixed_msg`). The reference passes short messages to blst as
     raw bytes, unpadded — so even with SSWU in place, signatures
     over messages shorter than 32 bytes would differ from the
     reference's, and messages differing only in trailing zero bytes
     within the 32-byte window sign identically here. Consensus
     messages are always longer than 32 bytes (sha256-hashed on both
     sides), so the divergence is confined to short ad-hoc payloads.

Everything derivable is DERIVED from the curve parameter x (checked at
import): r = x^4 - x^2 + 1, p = (x-1)^2/3·r + x, G1 cofactor
(x-1)^2/3, and the twist cofactor from the sextic-twist order
p^2 + 1 - (t2 - 3f2)/2 (t2 = t^2-2p, 3f2^2 = 4p^2-t2^2) — pinned by
tests multiplying random curve points to infinity.

Performance: a verify costs two pairings ≈ seconds in pure Python.
This key type exists for validator-key compatibility coverage, not the
hot path (the reference gates it behind a build tag for the same
reason); consensus ed25519 remains the TPU-accelerated path.
"""

from __future__ import annotations

import collections
import hashlib
import threading
from typing import Optional, Tuple

from ..libs.env import env_int

# --- parameters (identities asserted below) -----------------------------------

X_PARAM = -0xD201000000010000
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

assert R == X_PARAM**4 - X_PARAM**2 + 1
assert P == (X_PARAM - 1) ** 2 // 3 * R + X_PARAM

H1 = (X_PARAM - 1) ** 2 // 3                  # G1 cofactor
_T = X_PARAM + 1                              # trace of Frobenius
_T2 = _T * _T - 2 * P
_F2 = __import__("math").isqrt((4 * P * P - _T2 * _T2) // 3)
assert 3 * _F2 * _F2 == 4 * P * P - _T2 * _T2
_N2 = P * P + 1 - (_T2 - 3 * _F2) // 2        # sextic M-twist order
assert _N2 % R == 0
H2 = _N2 // R                                 # twist cofactor

KEY_TYPE = "bls12_381"                        # const.go KeyType
PRIV_KEY_SIZE = 32
PUB_KEY_SIZE = 48
SIGNATURE_LENGTH = 96
MAX_MSG_LEN = 32

# --- Fq and Fq2 ---------------------------------------------------------------

def _inv(a: int) -> int:
    return pow(a, P - 2, P)


F2 = Tuple[int, int]                          # a0 + a1*u, u^2 = -1


def f2(a0: int, a1: int = 0) -> F2:
    return (a0 % P, a1 % P)


F2_ZERO, F2_ONE = (0, 0), (1, 0)
XI = (1, 1)                                   # Fq6 non-residue 1+u


def f2_add(a: F2, b: F2) -> F2:
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a: F2, b: F2) -> F2:
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_neg(a: F2) -> F2:
    return ((-a[0]) % P, (-a[1]) % P)


def f2_mul(a: F2, b: F2) -> F2:
    return ((a[0] * b[0] - a[1] * b[1]) % P,
            (a[0] * b[1] + a[1] * b[0]) % P)


def f2_sq(a: F2) -> F2:
    return f2_mul(a, a)


def f2_inv(a: F2) -> F2:
    d = _inv(a[0] * a[0] + a[1] * a[1])
    return (a[0] * d % P, (-a[1]) * d % P)


def f2_pow(a: F2, e: int) -> F2:
    out = F2_ONE
    while e:
        if e & 1:
            out = f2_mul(out, a)
        a = f2_sq(a)
        e >>= 1
    return out


def fq_sqrt(a: int) -> Optional[int]:
    """p ≡ 3 (mod 4): sqrt = a^((p+1)/4), checked."""
    s = pow(a, (P + 1) // 4, P)
    return s if s * s % P == a % P else None


def f2_sqrt(a: F2) -> Optional[F2]:
    """Complex method for p ≡ 3 (mod 4); returns None for non-squares."""
    a0, a1 = a
    if a1 == 0:
        s = fq_sqrt(a0)
        if s is not None:
            return (s, 0)
        s = fq_sqrt(-a0 % P)
        return None if s is None else (0, s)
    alpha = fq_sqrt((a0 * a0 + a1 * a1) % P)
    if alpha is None:
        return None
    delta = (a0 + alpha) * _inv(2) % P
    x0 = fq_sqrt(delta)
    if x0 is None:
        delta = (a0 - alpha) * _inv(2) % P
        x0 = fq_sqrt(delta)
        if x0 is None:
            return None
    x1 = a1 * _inv(2 * x0) % P
    cand = (x0, x1)
    return cand if f2_sq(cand) == a else None


# --- Fq12 tower: Fq12 = Fq2[v]/(v^3 - ξ) [w]/(w^2 - v) ------------------------
# Represented flat: 6 Fq2 coefficients of w^0..w^5 (w^6 = ξ).

F12 = Tuple[F2, F2, F2, F2, F2, F2]
F12_ONE: F12 = (F2_ONE, F2_ZERO, F2_ZERO, F2_ZERO, F2_ZERO, F2_ZERO)


def f12_mul(a: F12, b: F12) -> F12:
    acc = [F2_ZERO] * 11
    for i in range(6):
        ai = a[i]
        if ai == F2_ZERO:
            continue
        for j in range(6):
            if b[j] == F2_ZERO:
                continue
            acc[i + j] = f2_add(acc[i + j], f2_mul(ai, b[j]))
    for k in range(10, 5, -1):                # w^6 = ξ
        if acc[k] != F2_ZERO:
            acc[k - 6] = f2_add(acc[k - 6], f2_mul(acc[k], XI))
    return tuple(acc[:6])


def f12_sq(a: F12) -> F12:
    return f12_mul(a, a)


def f12_pow(a: F12, e: int) -> F12:
    out = F12_ONE
    while e:
        if e & 1:
            out = f12_mul(out, a)
        a = f12_sq(a)
        e >>= 1
    return out


# Fq6 helpers for inversion only: Fq6 = Fq2[v]/(v^3 - ξ), and the flat
# w-representation splits as a = A(v) + B(v)·w with w^2 = v, i.e.
# A = (a0, a2, a4), B = (a1, a3, a5) in v-coefficients.

def _f6_mul(a, b):
    c = [F2_ZERO] * 5
    for i in range(3):
        for j in range(3):
            c[i + j] = f2_add(c[i + j], f2_mul(a[i], b[j]))
    return (f2_add(c[0], f2_mul(c[3], XI)),
            f2_add(c[1], f2_mul(c[4], XI)),
            c[2])


def _f6_inv(a):
    """Standard Fq6 inversion: inv = (A, B, C)/F with
    A = c0^2 - ξ c1 c2, B = ξ c2^2 - c0 c1, C = c1^2 - c0 c2,
    F = c0 A + ξ c1 C + ξ c2 B."""
    c0, c1, c2 = a
    A = f2_sub(f2_sq(c0), f2_mul(XI, f2_mul(c1, c2)))
    B = f2_sub(f2_mul(XI, f2_sq(c2)), f2_mul(c0, c1))
    C = f2_sub(f2_sq(c1), f2_mul(c0, c2))
    F = f2_add(f2_mul(c0, A),
               f2_mul(XI, f2_add(f2_mul(c1, C), f2_mul(c2, B))))
    fi = f2_inv(F)
    return (f2_mul(A, fi), f2_mul(B, fi), f2_mul(C, fi))


def _f6_mul_v(a):
    """Multiply by v (v^3 = ξ): (c0, c1, c2) -> (ξ c2, c0, c1)."""
    return (f2_mul(a[2], XI), a[0], a[1])


def f12_inv(a: F12) -> F12:
    """Tower inversion: a = A + B·w, w^2 = v, so
    a^-1 = (A - B·w) / (A^2 - B^2·v)."""
    A = (a[0], a[2], a[4])
    B = (a[1], a[3], a[5])
    den = tuple(f2_sub(x, y) for x, y in
                zip(_f6_mul(A, A), _f6_mul_v(_f6_mul(B, B))))
    di = _f6_inv(den)
    iA = _f6_mul(A, di)
    iB = _f6_mul(tuple(f2_neg(x) for x in B), di)
    return (iA[0], iB[0], iA[1], iB[1], iA[2], iB[2])


# --- curve points (Jacobian over generic field ops) ---------------------------
# G1: y^2 = x^3 + 4 over Fq; G2: y^2 = x^3 + 4(1+u) over Fq2 (M-twist).

B1 = 4
B2 = (4, 4)

G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GEN = (
    (0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
     0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E),
    (0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
     0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE),
)


class _Curve:
    """Affine short-Weierstrass group law parameterized by the field."""

    def __init__(self, add, sub, mul, sq, inv, neg, b, zero, one,
                 two, three):
        self.add, self.sub, self.mul = add, sub, mul
        self.sq, self.inv, self.neg = sq, inv, neg
        self.b, self.zero, self.one = b, zero, one
        self.two, self.three = two, three

    def on_curve(self, pt) -> bool:
        if pt is None:
            return True
        x, y = pt
        return self.sq(y) == self.add(self.mul(self.sq(x), x), self.b)

    def pt_add(self, p, q):
        if p is None:
            return q
        if q is None:
            return p
        if p[0] == q[0]:
            if p[1] != q[1] or p[1] == self.zero:
                return None
            num = self.mul(self.three, self.sq(p[0]))
            den = self.mul(self.two, p[1])
        else:
            num = self.sub(q[1], p[1])
            den = self.sub(q[0], p[0])
        lam = self.mul(num, self.inv(den))
        x3 = self.sub(self.sub(self.sq(lam), p[0]), q[0])
        return (x3, self.sub(self.mul(lam, self.sub(p[0], x3)), p[1]))

    def pt_neg(self, p):
        return None if p is None else (p[0], self.neg(p[1]))

    def pt_mul_affine(self, k, p):
        """Affine double-and-add — one field inversion PER BIT. Kept as
        the oracle `pt_mul` (Jacobian) is pinned against."""
        acc = None
        while k:
            if k & 1:
                acc = self.pt_add(acc, p)
            p = self.pt_add(p, p)
            k >>= 1
        return acc

    # --- Jacobian scalar multiplication ----------------------------------
    # (X, Y, Z) with x = X/Z^2, y = Y/Z^3. One field inversion for the
    # whole multiplication instead of one per bit: on Fq2 that turns a
    # ~600us-per-bit affine ladder into ~20us-per-bit, which is what
    # makes BLS signing / cofactor clearing / subgroup checks usable in
    # a consensus loop. Equality with pt_mul_affine is property-pinned
    # (tests/test_aggsig.py) for random scalars including group-order
    # multiples (-> infinity).

    def _jac_double(self, P3):
        X1, Y1, Z1 = P3
        mul, sq, add, sub = self.mul, self.sq, self.add, self.sub
        if Y1 == self.zero:
            return None
        A = sq(X1)
        B = sq(Y1)
        C = sq(B)
        D = sub(sub(sq(add(X1, B)), A), C)
        D = add(D, D)
        E = add(add(A, A), A)
        X3 = sub(sq(E), add(D, D))
        C8 = add(C, C)
        C8 = add(C8, C8)
        C8 = add(C8, C8)
        Y3 = sub(mul(E, sub(D, X3)), C8)
        Z3 = mul(add(Y1, Y1), Z1)
        return (X3, Y3, Z3)

    def _jac_add_affine(self, P3, q):
        """Mixed addition: Jacobian accumulator + affine q (q != inf)."""
        mul, sq, sub = self.mul, self.sq, self.sub
        X1, Y1, Z1 = P3
        x2, y2 = q
        Z1Z1 = sq(Z1)
        U2 = mul(x2, Z1Z1)
        S2 = mul(mul(y2, Z1), Z1Z1)
        H = sub(U2, X1)
        R = sub(S2, Y1)
        if H == self.zero:
            if R == self.zero:
                return self._jac_double(P3)
            return None
        HH = sq(H)
        H3 = mul(H, HH)
        V = mul(X1, HH)
        X3 = sub(sub(sq(R), H3), V)
        X3 = sub(X3, V)
        Y3 = sub(mul(R, sub(V, X3)), mul(Y1, H3))
        Z3 = mul(Z1, H)
        return (X3, Y3, Z3)

    def pt_mul(self, k, p):
        if p is None or k == 0:
            return None
        acc = None
        for bit in bin(k)[2:]:
            if acc is not None:
                acc = self._jac_double(acc)
            if bit == "1":
                if acc is None:
                    acc = (p[0], p[1], self.one)
                else:
                    acc = self._jac_add_affine(acc, p)
        if acc is None:
            return None
        X, Y, Z = acc
        zi = self.inv(Z)
        zi2 = self.sq(zi)
        return (self.mul(X, zi2), self.mul(self.mul(Y, zi2), zi))


_fq = _Curve(lambda a, b: (a + b) % P, lambda a, b: (a - b) % P,
             lambda a, b: a * b % P, lambda a: a * a % P, _inv,
             lambda a: -a % P, B1, 0, 1, 2, 3)
_fq2 = _Curve(f2_add, f2_sub, f2_mul, f2_sq, f2_inv, f2_neg, B2,
              F2_ZERO, F2_ONE, (2, 0), (3, 0))
_fq12_two = (F2_ZERO,) * 6
_fq12 = _Curve(
    lambda a, b: tuple(f2_add(x, y) for x, y in zip(a, b)),
    lambda a, b: tuple(f2_sub(x, y) for x, y in zip(a, b)),
    f12_mul, f12_sq, f12_inv,
    lambda a: tuple(f2_neg(x) for x in a),
    ((4, 0), F2_ZERO, F2_ZERO, F2_ZERO, F2_ZERO, F2_ZERO),
    (F2_ZERO,) * 6, F12_ONE,
    ((2, 0), F2_ZERO, F2_ZERO, F2_ZERO, F2_ZERO, F2_ZERO),
    ((3, 0), F2_ZERO, F2_ZERO, F2_ZERO, F2_ZERO, F2_ZERO))


_XI_INV = f2_inv(XI)


def _untwist(q):
    """E'(Fq2) -> E(Fq12): (x', y') -> (x'/w^2, y'/w^3).

    The M-twist satisfies y'^2 = x'^3 + 4ξ; dividing through by w^6 = ξ
    gives (y'/w^3)^2 = (x'/w^2)^3 + 4, i.e. the mapped point lies on
    E(Fq12): y^2 = x^3 + 4. With w^-2 = w^4·ξ^-1 and w^-3 = w^3·ξ^-1,
    the images are single-coefficient Fq12 elements (pinned on-curve by
    tests/test_bls12381.py)."""
    x, y = q
    ex = [F2_ZERO] * 6
    ex[4] = f2_mul(x, _XI_INV)
    ey = [F2_ZERO] * 6
    ey[3] = f2_mul(y, _XI_INV)
    return (tuple(ex), tuple(ey))


def _embed_g1(p):
    x, y = p
    ex = (f2(x), F2_ZERO, F2_ZERO, F2_ZERO, F2_ZERO, F2_ZERO)
    ey = (f2(y), F2_ZERO, F2_ZERO, F2_ZERO, F2_ZERO, F2_ZERO)
    return (ex, ey)


# --- pairing ------------------------------------------------------------------

def _line(f_add, f_sub, f_mul, f_sq, f_inv, a, b, px, py):
    """Evaluate the line through a,b (or tangent at a when a==b) at
    (px, py); returns (line_value, a+b). Generic over the field."""
    if a[0] == b[0] and a[1] == b[1]:
        num = f_mul(_fq12.three, f_sq(a[0]))
        den = f_mul(_fq12.two, a[1])
    elif a[0] == b[0]:
        # vertical line x - a.x
        return f_sub(px, a[0]), None
    else:
        num = f_sub(b[1], a[1])
        den = f_sub(b[0], a[0])
    lam = f_mul(num, f_inv(den))
    val = f_sub(f_sub(py, a[1]), f_mul(lam, f_sub(px, a[0])))
    x3 = f_sub(f_sub(f_sq(lam), a[0]), b[0])
    y3 = f_sub(f_mul(lam, f_sub(a[0], x3)), a[1])
    return val, (x3, y3)


# Pairing-op tally for perf attribution (bench.py --aggsig reads the
# deltas): miller_loops is the O(n)-vs-O(1) evidence for aggregate
# commits, final_exps the shared-exponentiation evidence. Counts only —
# never logged from deterministic paths.
OP_COUNTERS = {"miller_loops": 0, "final_exps": 0}


def miller_loop_slow(p_g1, q_g2) -> F12:
    """Miller loop f_{r,Q}(P) over Fq12 with both points embedded.
    Textbook double-and-add over the full group order r — simple,
    slow, and unambiguous (no twist/frobenius shortcuts to get wrong).
    Retained as the oracle the optimal-ate fast path (`miller_loop`)
    is pinned against: both are nondegenerate bilinear pairings after
    final exponentiation, so their `multi_pairing_is_one` verdicts
    are identical (they differ by a fixed exponent coprime to r)."""
    if p_g1 is None or q_g2 is None:
        return F12_ONE
    OP_COUNTERS["miller_loops"] += 1
    px, py = _embed_g1(p_g1)
    q = _untwist(q_g2)
    f = F12_ONE
    t = q
    c = _fq12
    for bit in bin(R)[3:]:
        val, t = _line(c.add, c.sub, c.mul, c.sq, c.inv, t, t, px, py)
        f = f12_mul(f12_sq(f), val)
        if bit == "1":
            val, t = _line(c.add, c.sub, c.mul, c.sq, c.inv, t, q,
                           px, py)
            f = f12_mul(f, val)
    return f


# --- optimal-ate Miller loop (the fast path) ----------------------------------
# The ate pairing loops over the BLS parameter x (64 bits, 6 set bits)
# instead of the 255-bit group order r, with the twist point kept in
# Jacobian coordinates on E'(Fq2) so no step inverts anything — the
# slow oracle's per-bit Fq12 inversion is what made it the host floor.
# x is negative: f_{x,Q} = conj(f_{|x|,Q}) up to factors the final
# exponentiation kills (conj(f)^E = f^{-E} EXACTLY, because
# (conj(f)·f)^E = f^{(p^6+1)·E} and r | p^6+1).

X_ABS = -X_PARAM
_X_BITS = bin(X_ABS)[2:]
MILLER_STEPS = len(_X_BITS) - 1               # 63 doubling steps
MILLER_ADD_STEPS = _X_BITS[1:].count("1")     # 5 addition steps


def f12_conj(a: F12) -> F12:
    """a ↦ a^(p^6): Frobenius^6 is the identity on the Fq2
    coefficients and w^(p^6) = w·ξ^((p^6-1)/6) = -w, so conjugation
    negates the odd-w coefficients (pinned against f12_frobenius
    applied six times by tests)."""
    return (a[0], f2_neg(a[1]), a[2], f2_neg(a[3]), a[4], f2_neg(a[5]))


def f12_mul_sparse035(a: F12, c0: F2, c3: F2, c5: F2) -> F12:
    """Multiply by a line value c0 + c3·w^3 + c5·w^5 — the sparse
    shape every evaluated optimal-ate line takes after untwisting
    (18 Fq2 products instead of f12_mul's 36; dense-vs-sparse
    equivalence is test-pinned)."""
    acc = [F2_ZERO] * 11
    for i in range(6):
        ai = a[i]
        if ai == F2_ZERO:
            continue
        acc[i] = f2_add(acc[i], f2_mul(ai, c0))
        acc[i + 3] = f2_add(acc[i + 3], f2_mul(ai, c3))
        acc[i + 5] = f2_add(acc[i + 5], f2_mul(ai, c5))
    for k in range(10, 5, -1):
        if acc[k] != F2_ZERO:
            acc[k - 6] = f2_add(acc[k - 6], f2_mul(acc[k], XI))
    return tuple(acc[:6])


def _f2_scale(a: F2, s: int) -> F2:
    return (a[0] * s % P, a[1] * s % P)


def prepare_pair_lines(p_g1, q_g2):
    """Evaluated line coefficients for f_{|x|,Q}(P): one entry per
    doubling step, ((c0, c3, c5) doubling line, addition line or None).

    Derivation: the untwist sends (x', y') on the M-twist to
    (x'/w^2, y'/w^3) on E(Fq12), so a twist-side chord/tangent of
    slope λ' evaluates at embedded P = (px, py) to
    py + (λ'x' − y')·ξ^{-1}·w^3 − λ'·px·ξ^{-1}·w^5; scaling by ξ and
    by the Jacobian denominators (Z3·Z1Z1 for the tangent, Z3 for the
    chord) clears every inversion. All scalings are Fq2* factors,
    which the final exponentiation kills ((p^2-1) | (p^12-1)/r).
    Shared by the host fast path and the ops/bls12 kernel marshal."""
    px, py = p_g1
    xq, yq = q_g2
    X, Y, Z = xq, yq, F2_ONE
    out = []
    for bit in _X_BITS[1:]:
        # tangent at T=(X,Y,Z), line scaled by Z3·Z1Z1 (dbl-2009-l)
        A = f2_sq(X)
        B = f2_sq(Y)
        Z1Z1 = f2_sq(Z)
        C = f2_sq(B)
        D = f2_sub(f2_sub(f2_sq(f2_add(X, B)), A), C)
        D = f2_add(D, D)                          # 4·X·Y^2
        E = f2_add(f2_add(A, A), A)               # 3·X^2
        Z3 = f2_mul(f2_add(Y, Y), Z)
        dbl = (_f2_scale(f2_mul(XI, f2_mul(Z3, Z1Z1)), py),
               f2_sub(f2_mul(E, X), f2_add(B, B)),
               _f2_scale(f2_neg(f2_mul(E, Z1Z1)), px))
        X3 = f2_sub(f2_sq(E), f2_add(D, D))
        C8 = f2_add(C, C)
        C8 = f2_add(C8, C8)
        C8 = f2_add(C8, C8)
        Y3 = f2_sub(f2_mul(E, f2_sub(D, X3)), C8)
        X, Y, Z = X3, Y3, Z3
        add = None
        if bit == "1":
            # chord through T and affine Q, anchored at Q, scaled Z3
            Z1Z1 = f2_sq(Z)
            U2 = f2_mul(xq, Z1Z1)
            S2 = f2_mul(yq, f2_mul(Z, Z1Z1))
            H = f2_sub(U2, X)
            Rr = f2_sub(S2, Y)
            Z3 = f2_mul(Z, H)
            add = (_f2_scale(f2_mul(XI, Z3), py),
                   f2_sub(f2_mul(Rr, xq), f2_mul(yq, Z3)),
                   _f2_scale(f2_neg(Rr), px))
            HH = f2_sq(H)
            H3 = f2_mul(H, HH)
            V = f2_mul(X, HH)
            X3 = f2_sub(f2_sub(f2_sq(Rr), H3), f2_add(V, V))
            Y3 = f2_sub(f2_mul(Rr, f2_sub(V, X3)), f2_mul(Y, H3))
            X, Y, Z = X3, Y3, Z3
        out.append((dbl, add))
    return out


def miller_loop(p_g1, q_g2) -> F12:
    """Optimal-ate Miller loop f_{x,Q}(P): 63 inversion-free Jacobian
    doubling steps + 5 additions over |x| = 0xd201000000010000, sparse
    line multiplications, final conjugation for the negative x.
    Final-exponentiation-equal to the slow |x|-loop over the generic
    embedded machinery, and verdict-equivalent to the r-loop oracle
    (`miller_loop_slow`) — both pinned by tests."""
    if p_g1 is None or q_g2 is None:
        return F12_ONE
    return miller_product([(p_g1, q_g2)])


_FINAL_EXP = (P**12 - 1) // R


def pairing(p_g1, q_g2) -> F12:
    """e(P, Q) = miller(P, Q)^((p^12-1)/r). Full-exponent final
    exponentiation: ~4300 Fq12 squarings, correct by construction."""
    return f12_pow(miller_loop(p_g1, q_g2), _FINAL_EXP)


# --- fast final exponentiation + multi-pairing --------------------------------
# (p^12-1)/r = (p^6-1) · (p^2+1) · (p^4-p^2+1)/r: the first two factors
# (the "easy part") are one inversion plus Frobenius maps, leaving a
# ~1270-bit pow instead of the monolithic ~4310-bit one — ~3.4x fewer
# Fq12 operations. final_exponentiation == f12_pow(·, _FINAL_EXP) is
# property-pinned by tests/test_aggsig.py on real Miller outputs.

assert (P - 1) % 6 == 0
_FROB_GAMMA = tuple(f2_pow(XI, i * (P - 1) // 6) for i in range(6))

_HARD_EXP = (P**4 - P**2 + 1) // R
assert _HARD_EXP * R == P**4 - P**2 + 1
assert (P**6 - 1) * (P**2 + 1) * _HARD_EXP == _FINAL_EXP


def f2_conj(a: F2) -> F2:
    """Frobenius on Fq2 (p-th power) is conjugation: a0 + a1·u with
    u^2 = -1 maps to a0 - a1·u."""
    return (a[0], (-a[1]) % P)


def f12_frobenius(a: F12) -> F12:
    """a ↦ a^p on the flat w-basis: coefficient-wise Fq2 conjugation,
    then w^i picks up ξ^{i(p-1)/6} (w^p = w·(w^6)^{(p-1)/6} = w·ξ^{(p-1)/6}).
    Pinned against f12_pow(a, P) by tests."""
    return tuple(f2_mul(f2_conj(c), _FROB_GAMMA[i])
                 for i, c in enumerate(a))


def final_exp_easy(f: F12) -> F12:
    """The (p^6-1)(p^2+1) "easy part": one inversion plus Frobenius
    maps. Split out so the batched kernel (ops/bls12) can take over at
    the hard part — the fixed-exponent pow that is pure mul/square and
    therefore lane-parallel."""
    m = f
    for _ in range(6):                       # f^(p^6)
        m = f12_frobenius(m)
    m = f12_mul(m, f12_inv(f))               # f^(p^6-1)
    return f12_mul(f12_frobenius(f12_frobenius(m)), m)   # ^(p^2+1)


def final_exponentiation(f: F12) -> F12:
    """f^((p^12-1)/r) via the easy/hard split above."""
    OP_COUNTERS["final_exps"] += 1
    return f12_pow(final_exp_easy(f), _HARD_EXP)


def miller_product_slow(pairs) -> F12:
    """Product of slow-oracle (r-loop) Miller loops over (P_g1, Q_g2)
    pairs. Retained as the oracle bench.py --miller-backend=oracle and
    the fast-vs-slow verdict tests run against."""
    out = F12_ONE
    for p_g1, q_g2 in pairs:
        out = f12_mul(out, miller_loop_slow(p_g1, q_g2))
    return out


def miller_product(pairs) -> F12:
    """Product of optimal-ate Miller loops over (P_g1, Q_g2) pairs —
    the shared part of a multi-pairing check (one final exponentiation
    serves all of them) — with the per-step Fq12 squaring SHARED
    across pairs: one f12_sq per parameter bit regardless of pair
    count, which the per-pair slow oracle cannot express."""
    live = [(p, q) for p, q in pairs if p is not None and q is not None]
    if not live:
        return F12_ONE
    OP_COUNTERS["miller_loops"] += len(live)
    prepared = [prepare_pair_lines(p, q) for p, q in live]
    f = F12_ONE
    for step in range(MILLER_STEPS):
        f = f12_sq(f)
        for lines in prepared:
            dbl, add = lines[step]
            f = f12_mul_sparse035(f, *dbl)
            if add is not None:
                f = f12_mul_sparse035(f, *add)
    return f12_conj(f)


def multi_pairing_is_one(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 with ONE shared final exponentiation —
    the aggregate-verification primitive. A two-pairing equality
    e(a,b) == e(c,d) is multi_pairing_is_one([(-a, b), (c, d)])."""
    return final_exponentiation(miller_product(pairs)) == F12_ONE


G1_NEG = (G1_GEN[0], P - G1_GEN[1])


# --- serialization (ZCash format, as blst/cosmos-crypto emit) -----------------

def g1_compress(p) -> bytes:
    if p is None:
        return bytes([0xC0]) + bytes(47)
    x, y = p
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= 0x80
    if y > (P - 1) // 2:
        out[0] |= 0x20
    return bytes(out)


def g1_decompress(b: bytes):
    if len(b) != 48 or not b[0] & 0x80:
        raise ValueError("bad G1 encoding")
    if b[0] & 0x40:
        if any(b[1:]) or b[0] != 0xC0:
            raise ValueError("bad G1 infinity")
        return None
    sign = bool(b[0] & 0x20)
    x = int.from_bytes(bytes([b[0] & 0x1F]) + b[1:], "big")
    if x >= P:
        raise ValueError("G1 x out of range")
    y = fq_sqrt((x * x % P * x + B1) % P)
    if y is None:
        raise ValueError("G1 x not on curve")
    if (y > (P - 1) // 2) != sign:
        y = P - y
    pt = (x, y)
    if _fq.pt_mul(R, pt) is not None:
        raise ValueError("G1 point not in subgroup")
    return pt


def _g2_y_is_larger(y: F2) -> bool:
    """Lexicographic on (c1, c0) against the negation."""
    y0, y1 = y
    n0, n1 = (-y0) % P, (-y1) % P
    return (y1, y0) > (n1, n0)


def g2_compress(q) -> bytes:
    if q is None:
        return bytes([0xC0]) + bytes(95)
    (x0, x1), y = q
    out = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
    out[0] |= 0x80
    if _g2_y_is_larger(y):
        out[0] |= 0x20
    return bytes(out)


def g2_decompress(b: bytes):
    if len(b) != 96 or not b[0] & 0x80:
        raise ValueError("bad G2 encoding")
    if b[0] & 0x40:
        if any(b[1:]) or b[0] != 0xC0:
            raise ValueError("bad G2 infinity")
        return None
    sign = bool(b[0] & 0x20)
    x1 = int.from_bytes(bytes([b[0] & 0x1F]) + b[1:48], "big")
    x0 = int.from_bytes(b[48:], "big")
    if x0 >= P or x1 >= P:
        raise ValueError("G2 x out of range")
    x = (x0, x1)
    y = f2_sqrt(f2_add(f2_mul(f2_sq(x), x), B2))
    if y is None:
        raise ValueError("G2 x not on curve")
    if _g2_y_is_larger(y) != sign:
        y = f2_neg(y)
    pt = (x, y)
    if _fq2.pt_mul(R, pt) is not None:
        raise ValueError("G2 point not in subgroup")
    return pt


# --- hash to G2 (documented non-IETF map; module docstring) -------------------

def expand_message_xmd(msg: bytes, dst: bytes, length: int) -> bytes:
    """RFC 9380 §5.3.1 with SHA-256 (this part IS the standard)."""
    if len(dst) > 255:
        raise ValueError("DST too long")
    b_in_bytes, r_in_bytes = 32, 64
    ell = (length + b_in_bytes - 1) // b_in_bytes
    if ell > 255:
        raise ValueError("length too large")
    dst_prime = dst + bytes([len(dst)])
    z_pad = bytes(r_in_bytes)
    l_i_b = length.to_bytes(2, "big")
    b0 = hashlib.sha256(z_pad + msg + l_i_b + b"\x00" + dst_prime).digest()
    bs = [hashlib.sha256(b0 + b"\x01" + dst_prime).digest()]
    for i in range(2, ell + 1):
        prev = bytes(a ^ c for a, c in zip(b0, bs[-1]))
        bs.append(hashlib.sha256(prev + bytes([i]) + dst_prime).digest())
    return b"".join(bs)[:length]


DST = b"COMETBFT_TPU_BLS_SIG_BLS12381G2_XMD:SHA-256_TAI_RO_"


def hash_to_g2(msg: bytes):
    """Deterministic hash onto the r-torsion of the twist: xmd-expand
    to an Fq2 x-candidate + sign bit, increment a counter until x lands
    on the curve, clear the cofactor. Not the IETF SSWU suite (see
    module docstring); constant-time properties are NOT claimed (the
    verify path hashes public data only)."""
    for ctr in range(256):
        uni = expand_message_xmd(msg + bytes([ctr]), DST, 129)
        x0 = int.from_bytes(uni[:64], "big") % P
        x1 = int.from_bytes(uni[64:128], "big") % P
        x = (x0, x1)
        y = f2_sqrt(f2_add(f2_mul(f2_sq(x), x), B2))
        if y is None:
            continue
        if uni[128] & 1:
            y = f2_neg(y)
        pt = _fq2.pt_mul(H2, (x, y))
        if pt is not None:
            return pt
    raise ValueError("hash_to_g2 failed (probability ~2^-256)")


# Explicit LRU with a hard cap instead of functools.lru_cache: the
# memo is keyed by raw sign-bytes, so on a long chain it grows with
# distinct (height, round) forever — the cap bounds it and the
# eviction counter makes the pressure observable (mirrors the
# SigCache's hits/misses/evictions discipline). Cap is env-tunable
# because a blocksync verifier re-touches at most a few tiles' worth
# of messages at once.
H2C_CACHE_CAP = env_int("COMETBFT_TPU_H2C_CACHE_CAP", 1024, minimum=2)
H2G2_COUNTERS = {"hits": 0, "misses": 0, "evictions": 0}
_H2C_LOCK = threading.Lock()
_H2C_CACHE: "collections.OrderedDict[bytes, object]" = \
    collections.OrderedDict()


def hash_to_g2_cached(msg: bytes):
    """Memoized hash_to_g2 over the (immutable) message bytes. The
    same consensus sign-bytes are hashed by the signer, by every
    verifier in the process (simnet runs all nodes in-process), and by
    the aggregate-commit verifier's message grouping — a pure function
    of msg, so the memo cannot change any verdict. Bounded LRU
    (H2C_CACHE_CAP entries, evictions counted in H2G2_COUNTERS)."""
    with _H2C_LOCK:
        pt = _H2C_CACHE.get(msg)
        if pt is not None:
            _H2C_CACHE.move_to_end(msg)
            H2G2_COUNTERS["hits"] += 1
            return pt
    pt = hash_to_g2(msg)        # outside the lock: the map is pure
    with _H2C_LOCK:
        H2G2_COUNTERS["misses"] += 1
        _H2C_CACHE[msg] = pt
        _H2C_CACHE.move_to_end(msg)
        while len(_H2C_CACHE) > H2C_CACHE_CAP:
            _H2C_CACHE.popitem(last=False)
            H2G2_COUNTERS["evictions"] += 1
    return pt


def reset_hash_to_g2_cache() -> None:
    """Test hook: drop memoized points and zero the counters."""
    with _H2C_LOCK:
        _H2C_CACHE.clear()
        for k in H2G2_COUNTERS:
            H2G2_COUNTERS[k] = 0


# --- the key type (reference key_bls12381.go surface) -------------------------

def _fixed_msg(msg: bytes) -> bytes:
    """>32 bytes -> sha256 (key_bls12381.go:90-97/133-136); at most 32
    bytes -> zero-padded to exactly 32. The padding is interop
    deviation #2 (module docstring): the reference hands short
    messages to blst raw, unpadded — Go's `[32]byte(msg)` conversion
    would PANIC for len < 32, so there is no padded-array semantics to
    match there. Padding makes trailing-zero variants within the
    32-byte window sign identically, which is acceptable only because
    consensus sign-bytes are always longer than 32 bytes."""
    if len(msg) > MAX_MSG_LEN:
        return hashlib.sha256(msg).digest()
    return msg.ljust(MAX_MSG_LEN, b"\x00")


class Bls12381PrivKey:
    def __init__(self, raw: bytes):
        if len(raw) != PRIV_KEY_SIZE:
            raise ValueError("bls12_381 private key must be 32 bytes")
        self._sk = int.from_bytes(raw, "big")
        # STRICT range check, matching blst's SecretKeyFromBytes
        # (key_bls12381.go:44): scalars outside [1, r-1] are rejected,
        # never silently reduced — the same key file must be accepted
        # or rejected identically by both implementations
        if not 1 <= self._sk < R:
            raise ValueError("bls12_381 private key out of range")
        self._raw = raw

    @classmethod
    def generate(cls, seed: Optional[bytes] = None) -> "Bls12381PrivKey":
        import secrets
        if seed is not None:
            sk = int.from_bytes(
                hashlib.sha256(b"bls-keygen" + seed).digest(), "big") % R
            if sk == 0:  # pragma: no cover — 2^-255
                sk = 1
        else:
            sk = secrets.randbelow(R - 1) + 1
        return cls(sk.to_bytes(32, "big"))

    def sign(self, msg: bytes) -> bytes:
        h = hash_to_g2_cached(_fixed_msg(msg))
        return g2_compress(_fq2.pt_mul(self._sk, h))

    def pub_key(self) -> "Bls12381PubKey":
        return Bls12381PubKey(
            g1_compress(_fq.pt_mul(self._sk, G1_GEN)))

    def bytes_(self) -> bytes:
        return self._raw

    def type_(self) -> str:
        return KEY_TYPE


class Bls12381PubKey:
    def __init__(self, raw: bytes):
        if len(raw) != PUB_KEY_SIZE:
            raise ValueError("bls12_381 public key must be 48 bytes")
        self._raw = raw
        self._pt = g1_decompress(raw)  # validates curve + subgroup
        if self._pt is None:
            raise ValueError("bls12_381 public key is infinity")

    @property
    def point(self):
        """The decompressed (subgroup-checked) G1 point — consumed by
        aggsig's pubkey grouping so aggregation never re-decompresses."""
        return self._pt

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        if len(sig) != SIGNATURE_LENGTH:
            return False
        try:
            s = g2_decompress(sig)
        except ValueError:
            return False
        if s is None:
            return False
        h = hash_to_g2_cached(_fixed_msg(msg))
        # e(g1, s) == e(pk, h)  ⟺  e(-g1, s)·e(pk, h) == 1: two Miller
        # loops sharing one final exponentiation (same verdict as the
        # two-pairing equality, pinned by tests)
        return multi_pairing_is_one([(G1_NEG, s), (self._pt, h)])

    def address(self) -> bytes:
        return hashlib.sha256(self._raw).digest()[:20]

    def bytes_(self) -> bytes:
        return self._raw

    def type_(self) -> str:
        return KEY_TYPE
