"""Key interfaces, the ed25519 implementation and the key factories by
type (port of `cometbft_tpu/crypto/keys.py`; sr25519 and secp256k1 live
in `sr25519.py` and `secp256k1.py`).

Mirrors the reference plugin surface (crypto/crypto.go:22-54: PubKey,
PrivKey, BatchVerifier), with the port's kernels behind
`Ed25519BatchVerifier`. Single-signature verification uses ZIP-215
semantics, the same as the batch path, which is what makes batch-failure
attribution sound.

Single signatures are checked and made by native host code
(`csrc/host/ed25519.cc`, built by g++ through `ops/_build.host_lib` at
first use), where the JAX package uses the `cryptography` wheel. A build
or load failure raises; nothing falls back to the Python oracle.
"""

from __future__ import annotations

import ctypes
import hashlib
from dataclasses import dataclass, field
from typing import List, Optional, Protocol, Tuple, runtime_checkable

from . import ref_ed25519 as ref
from ..device import resolve_device

ADDRESS_SIZE = 20  # reference crypto/tmhash/hash.go:78 (sha256, truncated)

ED25519_KEY_TYPE = "ed25519"


def address_from_pubkey_bytes(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()[:ADDRESS_SIZE]


_NATIVE = None


def native_ed25519() -> ctypes.CDLL:
    """The library of `csrc/host/ed25519.cc`, built and loaded on first
    use (raises with the compiler's output when it does not build).
    `host_lib` serialises the build; declaring the signatures twice from
    two threads is harmless."""
    global _NATIVE
    if _NATIVE is None:
        from ..ops import _build
        lib = _build.host_lib("ed25519")
        p, sz = ctypes.c_char_p, ctypes.c_size_t
        lib.cbt_sha512.argtypes = [p, sz, p]
        lib.cbt_sha512.restype = None
        lib.cbt_ed25519_pubkey.argtypes = [p, p]
        lib.cbt_ed25519_pubkey.restype = None
        lib.cbt_ed25519_sign.argtypes = [p, p, p, sz, p]
        lib.cbt_ed25519_sign.restype = None
        lib.cbt_ed25519_verify.argtypes = [p, p, sz, p]
        lib.cbt_ed25519_verify.restype = ctypes.c_int
        _NATIVE = lib
    return _NATIVE


def native_verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """Strict, cofactorless RFC 8032 verify in native code. Its accepts
    are a subset of ZIP-215's: a reject may still be ZIP-215-valid
    (non-canonical encodings, small- or mixed-order components)."""
    if len(pub) != 32 or len(sig) != 64:
        return False
    return native_ed25519().cbt_ed25519_verify(
        bytes(pub), bytes(msg), len(msg), bytes(sig)) == 1


def native_pubkey(seed: bytes) -> bytes:
    out = ctypes.create_string_buffer(32)
    native_ed25519().cbt_ed25519_pubkey(bytes(seed), out)
    return out.raw


def native_sign(seed: bytes, pub: bytes, msg: bytes) -> bytes:
    """RFC 8032 signature of msg; `pub` must be the seed's public key.
    Byte-identical with `ref.sign`."""
    out = ctypes.create_string_buffer(64)
    native_ed25519().cbt_ed25519_sign(bytes(seed), bytes(pub), bytes(msg),
                                      len(msg), out)
    return out.raw


@runtime_checkable
class PubKey(Protocol):
    def address(self) -> bytes: ...
    def bytes_(self) -> bytes: ...
    def verify_signature(self, msg: bytes, sig: bytes) -> bool: ...
    def type_(self) -> str: ...


@runtime_checkable
class PrivKey(Protocol):
    def sign(self, msg: bytes) -> bytes: ...
    def pub_key(self) -> PubKey: ...
    def bytes_(self) -> bytes: ...
    def type_(self) -> str: ...


class BatchVerifier(Protocol):
    """reference crypto/crypto.go:46-54."""

    def add(self, pk: PubKey, msg: bytes, sig: bytes) -> None: ...
    def verify(self) -> Tuple[bool, List[bool]]: ...


@dataclass(frozen=True)
class Ed25519PubKey:
    raw: bytes

    def __post_init__(self):
        if len(self.raw) != 32:
            raise ValueError(f"ed25519 pubkey must be 32B, got {len(self.raw)}")

    def address(self) -> bytes:
        return address_from_pubkey_bytes(self.raw)

    def bytes_(self) -> bytes:
        return self.raw

    def type_(self) -> str:
        return ED25519_KEY_TYPE

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        """Single-signature ZIP-215 verify, the consensus vote-intake
        hot path (reference types/vote.go:235). The native strict verify
        decides every accept; a reject is re-checked against the ZIP-215
        oracle, so the verdict is the oracle's on every input. Honest
        traffic never reaches the oracle."""
        if native_verify(self.raw, msg, sig):
            return True
        return ref.verify(self.raw, msg, sig, zip215=True)


@dataclass(frozen=True)
class Ed25519PrivKey:
    """RFC 8032 signing key, signing natively. The public key is derived
    from the seed on first use and kept on the key, so a signature costs
    one fixed-base multiplication. Signatures are byte-identical with
    `ref.sign`."""
    seed: bytes
    _pub: Optional[bytes] = field(
        default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        if len(self.seed) != 32:
            raise ValueError("ed25519 seed must be 32B")

    def _pub_bytes(self) -> bytes:
        if self._pub is None:
            object.__setattr__(self, "_pub", native_pubkey(self.seed))
        return self._pub

    @classmethod
    def generate(cls, rng=None) -> "Ed25519PrivKey":
        import secrets
        return cls(secrets.token_bytes(32) if rng is None
                   else bytes(rng.randrange(256) for _ in range(32)))

    def sign(self, msg: bytes) -> bytes:
        return native_sign(self.seed, self._pub_bytes(), msg)

    def pub_key(self) -> Ed25519PubKey:
        return Ed25519PubKey(self._pub_bytes())

    def bytes_(self) -> bytes:
        return self.seed

    def type_(self) -> str:
        return ED25519_KEY_TYPE


class Ed25519BatchVerifier:
    """Accumulate-and-flush batch verifier on the port's kernels
    (replaces curve25519-voi's CPU batch, reference
    crypto/ed25519/ed25519.go:208-241). `verify()` returns exact
    per-signature attribution.

    The JAX verifier's XLA:CPU compile clamp (a >64-lane flush on a CPU
    backend ran the native per-signature verify) and its CompileLedger
    are not ported: both worked around JAX compile times, and eager torch
    compiles nothing. `device` defaults to cuda and raises without a
    card."""

    def __init__(self, batch_size: Optional[int] = None, device=None):
        self._pubs: List[bytes] = []
        self._msgs: List[bytes] = []
        self._sigs: List[bytes] = []
        self._batch_size = batch_size
        self._device = resolve_device(device)

    def __len__(self) -> int:
        return len(self._pubs)

    def add(self, pk: PubKey, msg: bytes, sig: bytes) -> None:
        if pk.type_() != ED25519_KEY_TYPE:
            raise TypeError(f"ed25519 batch verifier got {pk.type_()} key")
        self._pubs.append(pk.bytes_())
        self._msgs.append(msg)
        self._sigs.append(sig)

    def verify(self) -> Tuple[bool, List[bool]]:
        if not self._pubs:
            return False, []
        from ..ops.ed25519 import verify_batch
        out = verify_batch(self._pubs, self._msgs, self._sigs,
                           batch_size=self._batch_size, device=self._device)
        oks = [bool(v) for v in out]
        return all(oks), oks


def privkey_from_type_bytes(key_type: str, raw: bytes) -> PrivKey:
    """Private-key factory by wire type string (the decode side of
    FilePV state files, which persist (type, raw) so a key round-trips
    with its type). sr25519 keys are 64 bytes (scalar seed and nonce
    seed, `Sr25519PrivKey.bytes_`), secp256k1 keys 32 and BLS keys 32;
    the JAX package reads ed25519 and BLS keys only, and the port's copy
    adds the other two."""
    if key_type == ED25519_KEY_TYPE:
        return Ed25519PrivKey(raw)
    if key_type == "sr25519":
        from .sr25519 import Sr25519PrivKey
        if len(raw) != 64:
            raise ValueError("sr25519 private key must be 64 bytes")
        return Sr25519PrivKey(raw[:32], raw[32:])
    if key_type == "secp256k1":
        from .secp256k1 import Secp256k1PrivKey
        return Secp256k1PrivKey(raw)
    if key_type == "bls12_381":
        from .bls12381 import Bls12381PrivKey
        return Bls12381PrivKey(raw)
    raise ValueError(f"unsupported privval key type {key_type!r}")


def pubkey_from_type_bytes(key_type: str, raw: bytes) -> PubKey:
    """Key factory by wire type string (reference
    crypto/encoding/codec.go:119 PubKeyFromTypeAndBytes). The type
    decides, never the length: sr25519 and ed25519 keys are both 32
    bytes."""
    if key_type == ED25519_KEY_TYPE:
        return Ed25519PubKey(raw)
    if key_type == "secp256k1":
        from .secp256k1 import Secp256k1PubKey
        return Secp256k1PubKey(raw)
    if key_type == "sr25519":
        from .sr25519 import Sr25519PubKey
        return Sr25519PubKey(raw)
    if key_type == "bls12_381":
        # pure-Python curve (reference gates this type behind a blst
        # build tag, crypto/bls12381/key_bls12381.go:1)
        from .bls12381 import Bls12381PubKey
        return Bls12381PubKey(raw)
    raise ValueError(f"unknown key type {key_type!r}")
