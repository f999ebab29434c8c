"""secp256k1 ECDSA keys and signatures
(reference crypto/secp256k1/secp256k1.go — btcec-backed there; pure
Python here: ECDSA is a consensus-edge key type for app/account keys,
not the validator hot path, so host arithmetic is the right cost tier).

Semantics matched to the reference:
- pubkey: 33-byte compressed SEC1 encoding
- address: RIPEMD160(SHA256(pubkey)) (secp256k1.go:41-47, bitcoin style)
- signature: 64-byte r || s with the low-s rule enforced on both sign
  and verify (malleability, secp256k1.go Sign/VerifySignature)
- nonce: RFC 6979 deterministic (SHA-256)

Copy of `cometbft_tpu/crypto/secp256k1.py` (the port keeps its own).
"""

from __future__ import annotations

import hashlib
import hmac
from dataclasses import dataclass

# curve parameters (SEC2)
P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
B = 7

SECP256K1_KEY_TYPE = "secp256k1"


def _inv(a: int, m: int) -> int:
    return pow(a, m - 2, m)


def _pt_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * _inv(2 * y1, P) % P
    else:
        lam = (y2 - y1) * _inv(x2 - x1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return x3, (lam * (x1 - x3) - y1) % P


def _pt_mul(k: int, pt):
    acc = None
    while k:
        if k & 1:
            acc = _pt_add(acc, pt)
        pt = _pt_add(pt, pt)
        k >>= 1
    return acc


def _compress(pt) -> bytes:
    x, y = pt
    return bytes([2 + (y & 1)]) + x.to_bytes(32, "big")


def _decompress(b: bytes):
    if len(b) != 33 or b[0] not in (2, 3):
        return None
    x = int.from_bytes(b[1:], "big")
    if x >= P:
        return None
    y2 = (pow(x, 3, P) + B) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        return None
    if (y & 1) != (b[0] & 1):
        y = P - y
    return x, y


def _rfc6979_k(privkey: int, msg_hash: bytes) -> int:
    """Deterministic nonce (RFC 6979, SHA-256)."""
    x = privkey.to_bytes(32, "big")
    h1 = msg_hash
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = hmac.new(k, v + b"\x00" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 1 <= cand < N:
            return cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


def address_from_pubkey(pub: bytes) -> bytes:
    """RIPEMD160(SHA256(pubkey)) (reference secp256k1.go:41-47)."""
    return hashlib.new("ripemd160",
                       hashlib.sha256(pub).digest()).digest()


@dataclass(frozen=True)
class Secp256k1PubKey:
    raw: bytes  # 33-byte compressed

    def __post_init__(self):
        if len(self.raw) != 33:
            raise ValueError("secp256k1 pubkey must be 33 bytes")

    def address(self) -> bytes:
        return address_from_pubkey(self.raw)

    def bytes_(self) -> bytes:
        return self.raw

    def type_(self) -> str:
        return SECP256K1_KEY_TYPE

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        """64-byte r||s, low-s enforced (secp256k1.go VerifySignature
        rejects high-s)."""
        if len(sig) != 64:
            return False
        r = int.from_bytes(sig[:32], "big")
        s = int.from_bytes(sig[32:], "big")
        if not (1 <= r < N and 1 <= s < N):
            return False
        if s > N // 2:
            return False  # malleable high-s rejected
        pt = _decompress(self.raw)
        if pt is None:
            return False
        e = int.from_bytes(hashlib.sha256(msg).digest(), "big") % N
        w = _inv(s, N)
        u1, u2 = e * w % N, r * w % N
        R = _pt_add(_pt_mul(u1, (GX, GY)), _pt_mul(u2, pt))
        if R is None:
            return False
        return R[0] % N == r


@dataclass(frozen=True)
class Secp256k1PrivKey:
    secret: bytes  # 32 bytes

    def __post_init__(self):
        d = int.from_bytes(self.secret, "big")
        if len(self.secret) != 32 or not (1 <= d < N):
            raise ValueError("invalid secp256k1 secret")

    @classmethod
    def generate(cls, rng=None) -> "Secp256k1PrivKey":
        import secrets
        while True:
            raw = (secrets.token_bytes(32) if rng is None else
                   bytes(rng.randrange(256) for _ in range(32)))
            d = int.from_bytes(raw, "big")
            if 1 <= d < N:
                return cls(raw)

    def pub_key(self) -> Secp256k1PubKey:
        d = int.from_bytes(self.secret, "big")
        return Secp256k1PubKey(_compress(_pt_mul(d, (GX, GY))))

    def bytes_(self) -> bytes:
        return self.secret

    def type_(self) -> str:
        return SECP256K1_KEY_TYPE

    def sign(self, msg: bytes) -> bytes:
        """Deterministic ECDSA over sha256(msg), low-s normalized."""
        d = int.from_bytes(self.secret, "big")
        h = hashlib.sha256(msg).digest()
        e = int.from_bytes(h, "big") % N
        while True:
            k = _rfc6979_k(d, h)
            R = _pt_mul(k, (GX, GY))
            r = R[0] % N
            if r == 0:
                h = hashlib.sha256(h).digest()
                continue
            s = _inv(k, N) * (e + r * d) % N
            if s == 0:
                h = hashlib.sha256(h).digest()
                continue
            if s > N // 2:
                s = N - s
            return r.to_bytes(32, "big") + s.to_bytes(32, "big")
