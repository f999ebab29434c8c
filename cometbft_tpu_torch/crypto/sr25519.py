"""sr25519: Schnorr signatures over ristretto255 with Merlin transcripts
(reference crypto/sr25519/ — curve25519-voi's schnorrkel implementation;
batch verify at crypto/sr25519/batch.go:44-77, merlin transcripts :69).

Layered the way schnorrkel is:
- Keccak-f[1600] → STROBE-128 (AD / meta-AD / PRF ops) → Merlin
  transcript (append_message / challenge_bytes),
- ristretto255 group on top of the edwards25519 big-int oracle
  (ref_ed25519): canonical decode/encode, torsion-free by construction,
- Schnorr: sig = R(32) || s(32) with schnorrkel's high-bit marker on s;
  k = transcript challenge binding proto-name, context, message, A, R.

Structure follows the published schnorrkel/merlin/STROBE specs.
Cross-implementation vectors pinned in tests/test_curves.py:
- the merlin crate's transcript equivalence vector (byte-exact through
  Keccak-f[1600] → STROBE-128 → Merlin framing), and
- schnorrkel's MiniSecretKey Ed25519-expansion → public key vector
  (byte-exact ristretto255 encode + scalar mul + cofactor division),
which together cover every primitive a signature touches; sign/verify/
batch round-trips and tamper rejection are validated in-tree on top.

Copy of `cometbft_tpu/crypto/sr25519.py` (the port keeps its own), over
the port's copy of the edwards25519 oracle. The batch verifier runs on
the host, as in the JAX package: the device path is ed25519's.
"""

from __future__ import annotations

import hashlib
import hmac
from dataclasses import dataclass
from typing import List, Optional, Tuple

from . import ref_ed25519 as ed

SR25519_KEY_TYPE = "sr25519"

SIGNING_CTX = b"substrate"

# --- Keccak-f[1600] ----------------------------------------------------------

_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_ROT = [[0, 36, 3, 41, 18], [1, 44, 10, 45, 2], [62, 6, 43, 15, 61],
        [28, 55, 25, 21, 56], [27, 20, 39, 8, 14]]
_MASK = (1 << 64) - 1


def _rol(v: int, n: int) -> int:
    n %= 64
    return ((v << n) | (v >> (64 - n))) & _MASK


def keccak_f1600(state: bytearray) -> None:
    """In-place permutation over 200 bytes."""
    a = [[int.from_bytes(state[8 * (x + 5 * y):8 * (x + 5 * y) + 8],
                         "little") for y in range(5)] for x in range(5)]
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rol(a[x][y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & _MASK
                                     & b[(x + 2) % 5][y])
        # iota
        a[0][0] ^= rc
    for x in range(5):
        for y in range(5):
            state[8 * (x + 5 * y):8 * (x + 5 * y) + 8] = \
                a[x][y].to_bytes(8, "little")


# --- STROBE-128 (the subset merlin uses: AD, meta-AD, PRF) -------------------

_FLAG_I, _FLAG_A, _FLAG_C, _FLAG_T, _FLAG_M, _FLAG_K = (
    1, 2, 4, 8, 16, 32)
_STROBE_R = 166  # rate for sec=128 over keccak-f1600, minus 2 pad bytes


class Strobe128:
    def __init__(self, protocol: bytes):
        self.state = bytearray(200)
        seed = bytes([1, _STROBE_R + 2, 1, 0, 1, 96]) + b"STROBEv1.0.2"
        self.state[:len(seed)] = seed
        keccak_f1600(self.state)
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol, False)

    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[_STROBE_R + 1] ^= 0x80
        keccak_f1600(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] ^= byte
            self.pos += 1
            if self.pos == _STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray()
        for _ in range(n):
            out.append(self.state[self.pos])
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == _STROBE_R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            assert self.cur_flags == flags
            return
        assert not (flags & _FLAG_T), "transport ops unused"
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        force_f = flags & (_FLAG_C | _FLAG_K)
        if force_f and self.pos != 0:
            self._run_f()

    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_M | _FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool = False) -> bytes:
        self._begin_op(_FLAG_I | _FLAG_A | _FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool = False) -> None:
        self._begin_op(_FLAG_A | _FLAG_C, more)
        # KEY overwrites (duplex with C): absorb-as-overwrite
        for byte in data:
            self.state[self.pos] = byte
            self.pos += 1
            if self.pos == _STROBE_R:
                self._run_f()


# --- Merlin transcript --------------------------------------------------------

class Transcript:
    def __init__(self, label: bytes):
        self.strobe = Strobe128(b"Merlin v1.0")
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes) -> None:
        self.strobe.meta_ad(label
                            + len(message).to_bytes(4, "little"), False)
        self.strobe.ad(message, False)

    def append_u64(self, label: bytes, n: int) -> None:
        self.append_message(label, n.to_bytes(8, "little"))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label + n.to_bytes(4, "little"), False)
        return self.strobe.prf(n)

    def challenge_scalar(self, label: bytes) -> int:
        return int.from_bytes(self.challenge_bytes(label, 64),
                              "little") % ed.L

    def witness_bytes(self, label: bytes, nonce_seed: bytes,
                      n: int = 32) -> bytes:
        """Deterministic witness (schnorrkel witness_bytes with no
        external rng): fork the transcript, key in the nonce seed."""
        fork = Strobe128(b"Merlin v1.0")
        fork.state = bytearray(self.strobe.state)
        fork.pos = self.strobe.pos
        fork.pos_begin = self.strobe.pos_begin
        fork.cur_flags = self.strobe.cur_flags
        fork.meta_ad(label, False)
        fork.key(nonce_seed)
        return fork.prf(n)


# --- ristretto255 (over the edwards25519 oracle) ------------------------------

_D = ed.D
_P = ed.P
_SQRT_M1 = ed.SQRT_M1
_INVSQRT_A_MINUS_D = pow(
    (-1 - _D) % _P, (_P - 3) // 4, _P)  # placeholder; computed below


def _sqrt_ratio(u: int, v: int) -> Tuple[bool, int]:
    """sqrt(u/v) per ristretto: returns (was_square, root)."""
    v3 = v * v % _P * v % _P
    v7 = v3 * v3 % _P * v % _P
    r = u * v3 % _P * pow(u * v7 % _P, (_P - 5) // 8, _P) % _P
    check = v * r % _P * r % _P
    if check == u % _P:
        return True, min(r, _P - r)
    if check == (-u) % _P:
        r = r * _SQRT_M1 % _P
        return True, min(r, _P - r)
    if check == (-u * _SQRT_M1) % _P:
        r = r * _SQRT_M1 % _P
        return False, min(r, _P - r)
    return False, min(r, _P - r)


def ristretto_decode(b: bytes) -> Optional[tuple]:
    """32 bytes -> internal extended edwards point, or None."""
    if len(b) != 32:
        return None
    s = int.from_bytes(b, "little")
    if s >= _P or (s & 1):  # canonical and non-negative
        return None
    ss = s * s % _P
    u1 = (1 - ss) % _P
    u2 = (1 + ss) % _P
    u2_sqr = u2 * u2 % _P
    v = (-(_D * u1 % _P * u1) - u2_sqr) % _P
    ok, invsqrt = _sqrt_ratio(1, v * u2_sqr % _P)
    if not ok:
        return None
    den_x = invsqrt * u2 % _P
    den_y = invsqrt * den_x % _P * v % _P
    x = (s + s) % _P * den_x % _P
    if x % 2 == 1:
        x = _P - x
    y = u1 * den_y % _P
    t = x * y % _P
    # spec: reject when t is negative or y is zero — without the t check
    # two distinct byte strings decode to the same element (canonical
    # encoding is ristretto's whole point)
    if y == 0 or t % 2 == 1:
        return None
    return (x, y, 1, t)


def ristretto_encode(pt: tuple) -> bytes:
    """internal extended point -> canonical 32 bytes."""
    x0, y0, z0, t0 = pt
    u1 = (z0 + y0) * (z0 - y0) % _P
    u2 = x0 * y0 % _P
    _, invsqrt = _sqrt_ratio(1, u1 * u2 % _P * u2 % _P)
    den1 = invsqrt * u1 % _P
    den2 = invsqrt * u2 % _P
    z_inv = den1 * den2 % _P * t0 % _P
    ix = x0 * _SQRT_M1 % _P
    iy = y0 * _SQRT_M1 % _P
    enchanted = den1 * _INVSQRT_A_MINUS_D % _P
    rotate = (t0 * z_inv % _P) % 2 == 1
    if rotate:
        x, y = iy, ix
        den_inv = enchanted
    else:
        x, y = x0, y0
        den_inv = den2
    if (x * z_inv % _P) % 2 == 1:
        y = (-y) % _P
    s = (z0 - y) * den_inv % _P
    if s % 2 == 1:
        s = (-s) % _P
    return s.to_bytes(32, "little")


def _compute_invsqrt_a_minus_d() -> int:
    a_minus_d = (-1 - _D) % _P
    ok, r = _sqrt_ratio(1, a_minus_d)
    assert ok
    return r


_INVSQRT_A_MINUS_D = _compute_invsqrt_a_minus_d()


# --- Schnorr (schnorrkel layout) ---------------------------------------------

def _signing_transcript(context: bytes, msg: bytes, pub: bytes,
                        r_enc: Optional[bytes]) -> Transcript:
    t = Transcript(b"SigningContext")
    t.append_message(b"", context)
    t.append_message(b"sign-bytes", msg)
    t.append_message(b"proto-name", b"Schnorr-sig")
    t.append_message(b"sign:pk", pub)
    if r_enc is not None:
        t.append_message(b"sign:R", r_enc)
    return t


@dataclass(frozen=True)
class Sr25519PubKey:
    raw: bytes  # ristretto255 compressed

    def __post_init__(self):
        if len(self.raw) != 32:
            raise ValueError("sr25519 pubkey must be 32 bytes")

    def address(self) -> bytes:
        return hashlib.sha256(self.raw).digest()[:20]

    def bytes_(self) -> bytes:
        return self.raw

    def type_(self) -> str:
        return SR25519_KEY_TYPE

    def verify_signature(self, msg: bytes, sig: bytes,
                         context: bytes = SIGNING_CTX) -> bool:
        if len(sig) != 64:
            return False
        if not (sig[63] & 0x80):
            return False  # schnorrkel marker bit required
        s_bytes = sig[32:63] + bytes([sig[63] & 0x7F])
        s = int.from_bytes(s_bytes, "little")
        if s >= ed.L:
            return False
        r_enc = sig[:32]
        r_pt = ristretto_decode(r_enc)
        a_pt = ristretto_decode(self.raw)
        if r_pt is None or a_pt is None:
            return False
        t = _signing_transcript(context, msg, self.raw, r_enc)
        k = t.challenge_scalar(b"sign:c")
        # [s]B == R + [k]A  (torsion-free in ristretto: exact equation)
        sb = ed.pt_mul(s, ed.BASE)
        rhs = ed.pt_add(r_pt, ed.pt_mul(k, a_pt))
        return ristretto_encode(sb) == ristretto_encode(rhs)


@dataclass(frozen=True)
class Sr25519PrivKey:
    key: bytes        # 32-byte scalar seed
    nonce: bytes      # 32-byte nonce seed

    @classmethod
    def generate(cls, rng=None) -> "Sr25519PrivKey":
        import secrets
        if rng is None:
            return cls(secrets.token_bytes(32), secrets.token_bytes(32))
        return cls(bytes(rng.randrange(256) for _ in range(32)),
                   bytes(rng.randrange(256) for _ in range(32)))

    @classmethod
    def from_mini_secret(cls, seed: bytes) -> "Sr25519PrivKey":
        """schnorrkel MiniSecretKey ExpandMode::Ed25519 (the substrate
        default): scalar = ed25519-clamp(sha512(seed)[:32]) divided by
        the cofactor, nonce = sha512(seed)[32:]. Pinned against the
        public wasm-crypto derivation vector in tests/test_curves.py."""
        if len(seed) != 32:
            raise ValueError("mini secret must be 32 bytes")
        h = hashlib.sha512(seed).digest()
        key = bytearray(h[:32])
        key[0] &= 248
        key[31] &= 63
        key[31] |= 64
        scalar = int.from_bytes(bytes(key), "little") >> 3
        return cls(scalar.to_bytes(32, "little"), h[32:64])

    def _scalar(self) -> int:
        return int.from_bytes(self.key, "little") % ed.L

    def pub_key(self) -> Sr25519PubKey:
        return Sr25519PubKey(
            ristretto_encode(ed.pt_mul(self._scalar(), ed.BASE)))

    def bytes_(self) -> bytes:
        return self.key + self.nonce

    def type_(self) -> str:
        return SR25519_KEY_TYPE

    def sign(self, msg: bytes, context: bytes = SIGNING_CTX) -> bytes:
        d = self._scalar()
        pub = self.pub_key().raw
        t = _signing_transcript(context, msg, pub, None)
        r = int.from_bytes(
            t.witness_bytes(b"signing", self.nonce, 64), "little") % ed.L
        r_enc = ristretto_encode(ed.pt_mul(r, ed.BASE))
        t.append_message(b"sign:R", r_enc)
        k = t.challenge_scalar(b"sign:c")
        s = (k * d + r) % ed.L
        s_bytes = bytearray(s.to_bytes(32, "little"))
        s_bytes[31] |= 0x80  # schnorrkel format marker
        return r_enc + bytes(s_bytes)


class Sr25519BatchVerifier:
    """Batch verifier (reference crypto/sr25519/batch.go:44-77).

    Random-linear-combination over the Schnorr equations:
      Σ z_i·s_i · B  ==  Σ z_i·R_i + Σ (z_i·k_i)·A_i
    computed on the host oracle (sr25519 is not the consensus hot path;
    volume rides the ed25519 device kernels)."""

    def __init__(self):
        self._items: List[Tuple[Sr25519PubKey, bytes, bytes]] = []

    def __len__(self) -> int:
        return len(self._items)

    def add(self, pk, msg: bytes, sig: bytes) -> None:
        if pk.type_() != SR25519_KEY_TYPE:
            raise TypeError(f"sr25519 batch got {pk.type_()} key")
        self._items.append((pk, msg, sig))

    def verify(self) -> Tuple[bool, List[bool]]:
        import secrets
        if not self._items:
            return False, []
        lhs_scalar = 0
        rhs = None
        parsed = []
        for pk, msg, sig in self._items:
            if len(sig) != 64 or not (sig[63] & 0x80):
                parsed.append(None)
                continue
            s = int.from_bytes(sig[32:63] + bytes([sig[63] & 0x7F]),
                               "little")
            r_pt = ristretto_decode(sig[:32])
            a_pt = ristretto_decode(pk.raw)
            if s >= ed.L or r_pt is None or a_pt is None:
                parsed.append(None)
                continue
            t = _signing_transcript(SIGNING_CTX, msg, pk.raw, sig[:32])
            k = t.challenge_scalar(b"sign:c")
            parsed.append((s, r_pt, a_pt, k))
        if any(p is None for p in parsed):
            oks = [self._items[i][0].verify_signature(
                self._items[i][1], self._items[i][2])
                if parsed[i] is not None else False
                for i in range(len(self._items))]
            return all(oks), oks
        for s, r_pt, a_pt, k in parsed:
            z = int.from_bytes(secrets.token_bytes(16), "little")
            lhs_scalar = (lhs_scalar + z * s) % ed.L
            term = ed.pt_add(r_pt, ed.pt_mul(k, a_pt))
            zterm = ed.pt_mul(z, term)
            rhs = zterm if rhs is None else ed.pt_add(rhs, zterm)
        lhs = ed.pt_mul(lhs_scalar, ed.BASE)
        if ristretto_encode(lhs) == ristretto_encode(rhs):
            return True, [True] * len(self._items)
        oks = [pk.verify_signature(msg, sig)
               for pk, msg, sig in self._items]
        return all(oks), oks
