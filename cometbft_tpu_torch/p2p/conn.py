"""SecretConnection: authenticated-encrypted peer links
(reference p2p/conn/secret_connection.go:61-224).

Station-to-station over X25519 ECDH + HKDF-SHA256 + ChaCha20-Poly1305,
with an ed25519 identity signature over the handshake transcript:

  1. exchange ephemeral X25519 public keys (32 raw bytes each way)
  2. shared = X25519(eph_priv, peer_eph_pub); derive two 32-byte AEAD
     keys + a 32-byte challenge via HKDF(shared, transcript-hash)
  3. each side sends AEAD-sealed AuthSig{ed25519 pubkey, sig(challenge)}
     and checks the peer's
  4. frames: u32-LE length || AEAD ciphertext of more-flag || a chunk of
     up to 1024 bytes, nonces = 96-bit LE counters, one counter per
     direction (secret_connection.go:58 dataMaxSize/frame layout).

Key order is broken symmetrically by sorting the two ephemeral pubkeys
(lowest key's owner uses key #1 to send), the reference's rule
(secret_connection.go:329-339).

Port of `cometbft_tpu/p2p/conn.py`, byte for byte on the wire (a port
peer and a JAX-package peer handshake and talk), without the
`cryptography` wheel it uses: X25519 (the RFC 7748 ladder, one scalar
multiplication a handshake) and HKDF-SHA256 (`hmac`) are Python here;
ChaCha20-Poly1305 (RFC 8439), on the data path, is host C++
(`csrc/host/aead.cc`, built by g++ at first use), which seals or opens
all frames of one message in one call without the interpreter lock. A
failed build raises; nothing falls back to Python.
"""

from __future__ import annotations

import ctypes
import hashlib
import hmac
import os
import threading
import time
from typing import Tuple

from ..crypto.keys import Ed25519PrivKey, Ed25519PubKey
from ..ops import _build
from ..types import proto

DATA_MAX_SIZE = 1024  # reference p2p/conn/secret_connection.go:58
_HKDF_INFO = b"cometbft_tpu/secret_connection"

# The AEAD calls of this process, every connection's: wall seconds
# around them (the interpreter lock is released inside, so this includes
# the wait to take it back), the calling thread's CPU seconds in them,
# and the frames sealed and opened. chip_smoke.py reads them around a
# sync; the send and receive threads add under a lock.
AEAD_STATS = {"seal_s": 0.0, "open_s": 0.0, "seal_cpu_s": 0.0,
              "open_cpu_s": 0.0, "frames_sealed": 0, "frames_opened": 0}
_STATS_LOCK = threading.Lock()


class HandshakeError(Exception):
    pass


# --- X25519 (RFC 7748 §5) ---------------------------------------------------

_P = 2 ** 255 - 19
_A24 = 121665


def x25519(scalar: bytes, u: bytes) -> bytes:
    """X25519(k, u): the Montgomery ladder of RFC 7748 §5 on Python
    integers (clamped scalar, u's top bit masked)."""
    k = bytearray(scalar)
    k[0] &= 248
    k[31] &= 127
    k[31] |= 64
    k_int = int.from_bytes(k, "little")
    x1 = int.from_bytes(u, "little") & ((1 << 255) - 1)
    x2, z2, x3, z3, swap = 1, 0, x1, 1, 0
    for t in range(254, -1, -1):
        bit = (k_int >> t) & 1
        swap ^= bit
        if swap:
            x2, x3, z2, z3 = x3, x2, z3, z2
        swap = bit
        a, b = (x2 + z2) % _P, (x2 - z2) % _P
        aa, bb = a * a % _P, b * b % _P
        e = (aa - bb) % _P
        c, d = (x3 + z3) % _P, (x3 - z3) % _P
        da, cb = d * a % _P, c * b % _P
        x3 = (da + cb) ** 2 % _P
        z3 = x1 * (da - cb) ** 2 % _P
        x2 = aa * bb % _P
        z2 = e * (aa + _A24 * e) % _P
    if swap:
        x2, z2 = x3, z3
    return (x2 * pow(z2, _P - 2, _P) % _P).to_bytes(32, "little")


def x25519_base(scalar: bytes) -> bytes:
    return x25519(scalar, (9).to_bytes(32, "little"))


def hkdf_sha256(ikm: bytes, salt: bytes, info: bytes, length: int) -> bytes:
    """RFC 5869 HKDF with SHA-256 (what the reference derives with
    cryptography's HKDF)."""
    prk = hmac.new(salt, ikm, hashlib.sha256).digest()
    okm, t, i = b"", b"", 1
    while len(okm) < length:
        t = hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        okm += t
        i += 1
    return okm[:length]


def _hkdf(shared: bytes, transcript: bytes) -> Tuple[bytes, bytes, bytes]:
    okm = hkdf_sha256(shared, transcript, _HKDF_INFO, 96)
    return okm[:32], okm[32:64], okm[64:96]


# --- ChaCha20-Poly1305 (csrc/host/aead.cc) ----------------------------------

_lib = None
_lib_lock = threading.Lock()
_SZ = ctypes.c_size_t
_P8 = ctypes.c_char_p
_VP = ctypes.c_void_p


def _aead():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = _build.host_lib("aead")
        lib.cbt_aead_seal.restype = None
        lib.cbt_aead_seal.argtypes = [_P8, _P8, _P8, _SZ, _P8, _SZ, _VP]
        lib.cbt_aead_open.restype = ctypes.c_int
        lib.cbt_aead_open.argtypes = [_P8, _P8, _P8, _SZ, _P8, _SZ, _VP]
        lib.cbt_aead_frames_max.restype = _SZ
        lib.cbt_aead_frames_max.argtypes = [_SZ]
        lib.cbt_aead_seal_frames.restype = ctypes.c_uint64
        lib.cbt_aead_seal_frames.argtypes = [
            _P8, ctypes.c_uint64, _P8, _SZ, _VP, ctypes.POINTER(_SZ)]
        lib.cbt_aead_open_frames.restype = ctypes.c_int
        lib.cbt_aead_open_frames.argtypes = [
            _P8, ctypes.c_uint64, _VP, _SZ, _VP, ctypes.POINTER(_SZ),
            ctypes.POINTER(_SZ), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint32)]
        _lib = lib
        return lib


def chacha20poly1305_seal(key: bytes, nonce: bytes, plaintext: bytes,
                          aad: bytes = b"") -> bytes:
    """RFC 8439 §2.8 AEAD encryption: ciphertext || 16-byte tag."""
    if len(key) != 32 or len(nonce) != 12:
        raise ValueError("ChaCha20-Poly1305 takes a 32-byte key and a "
                         "12-byte nonce")
    out = ctypes.create_string_buffer(len(plaintext) + 16)
    _aead().cbt_aead_seal(key, nonce, aad, len(aad), plaintext,
                          len(plaintext), out)
    return out.raw


def chacha20poly1305_open(key: bytes, nonce: bytes, sealed: bytes,
                          aad: bytes = b"") -> bytes:
    """RFC 8439 §2.8 AEAD decryption; raises ValueError on a bad tag."""
    if len(key) != 32 or len(nonce) != 12:
        raise ValueError("ChaCha20-Poly1305 takes a 32-byte key and a "
                         "12-byte nonce")
    if len(sealed) < 16:
        raise ValueError("ciphertext shorter than its tag")
    n = len(sealed) - 16
    out = ctypes.create_string_buffer(max(n, 1))
    if _aead().cbt_aead_open(key, nonce, aad, len(aad), sealed, n, out):
        raise ValueError("ChaCha20-Poly1305 tag mismatch")
    return out.raw[:n]


class _Sealer:
    """Send direction: frames a whole message in one native call."""

    def __init__(self, key: bytes):
        self._key = key
        self._nonce = 0
        self._lib = _aead()

    def frames(self, data: bytes) -> bytes:
        out = ctypes.create_string_buffer(
            self._lib.cbt_aead_frames_max(len(data)))
        n = _SZ()
        t0, c0 = time.perf_counter(), time.thread_time()
        k = self._lib.cbt_aead_seal_frames(self._key, self._nonce, data,
                                           len(data), out, ctypes.byref(n))
        dt, dc = time.perf_counter() - t0, time.thread_time() - c0
        self._nonce += k
        with _STATS_LOCK:
            AEAD_STATS["seal_s"] += dt
            AEAD_STATS["seal_cpu_s"] += dc
            AEAD_STATS["frames_sealed"] += k
        return out.raw[:n.value]


class SecretConnection:
    """Wraps a socket-like object (sendall/recv) after a mutual
    authentication handshake."""

    def __init__(self, sock, priv_key: Ed25519PrivKey):
        self._sock = sock
        self._recv_buf = bytearray()
        eph_priv = os.urandom(32)
        eph_pub = x25519_base(eph_priv)

        # 1. ephemeral exchange
        self._send_raw(eph_pub)
        peer_eph = self._recv_exact(32)

        # 2. key derivation; sort breaks the symmetry
        lo, hi = sorted([eph_pub, peer_eph])
        transcript = hashlib.sha256(b"eph:" + lo + hi).digest()
        shared = x25519(eph_priv, peer_eph)
        if shared == bytes(32):
            raise HandshakeError("peer sent a low-order ephemeral key")
        k1, k2, challenge = _hkdf(shared, transcript)
        if eph_pub == lo:
            send_key, recv_key = k1, k2
        else:
            send_key, recv_key = k2, k1
        self._sealer = _Sealer(send_key)
        self._recv_key = recv_key
        self._recv_nonce = 0
        self._lib = _aead()

        # 3. identity auth over the encrypted channel
        sig = priv_key.sign(challenge)
        auth = (proto.f_bytes(1, priv_key.pub_key().bytes_())
                + proto.f_bytes(2, sig))
        self._write_frames(auth)
        peer_auth = self._read_message()
        f = proto.parse_fields(peer_auth)
        peer_pub = proto.field_bytes(f, 1, b"")
        peer_sig = proto.field_bytes(f, 2, b"")
        if len(peer_pub) != 32 or not Ed25519PubKey(peer_pub). \
                verify_signature(challenge, peer_sig):
            raise HandshakeError("peer identity signature invalid")
        self.peer_pubkey = Ed25519PubKey(peer_pub)

    # --- framing --------------------------------------------------------------

    def _send_raw(self, b: bytes) -> None:
        self._sock.sendall(b)

    def _fill(self) -> None:
        chunk = self._sock.recv(65536)
        if not chunk:
            raise ConnectionError("peer closed connection")
        self._recv_buf += chunk

    def _recv_exact(self, n: int) -> bytes:
        while len(self._recv_buf) < n:
            self._fill()
        out = bytes(self._recv_buf[:n])
        del self._recv_buf[:n]
        return out

    def _write_frames(self, data: bytes) -> None:
        """Chunk + seal + length-prefix, in one native call. Always
        writes >= 1 frame (an empty message is a single empty chunk)
        and marks the final chunk (u8 more-flag per frame)."""
        self._sock.sendall(self._sealer.frames(data))

    def _read_message(self) -> bytes:
        """Open the buffered frames of one message in one native call,
        reading from the socket while the message is incomplete."""
        parts = []
        lib = self._lib
        consumed, out_len = _SZ(), _SZ()
        frames, done, bad_len = ctypes.c_uint64(), ctypes.c_int(), \
            ctypes.c_uint32()
        while True:
            buf = self._recv_buf
            n = len(buf)
            if n >= 4:
                out = ctypes.create_string_buffer(n)
                src = (ctypes.c_char * n).from_buffer(buf)
                t0, c0 = time.perf_counter(), time.thread_time()
                rc = lib.cbt_aead_open_frames(
                    self._recv_key, self._recv_nonce, src, n, out,
                    ctypes.byref(consumed), ctypes.byref(out_len),
                    ctypes.byref(frames), ctypes.byref(done),
                    ctypes.byref(bad_len))
                dt, dc = time.perf_counter() - t0, time.thread_time() - c0
                del src
                self._recv_nonce += frames.value
                with _STATS_LOCK:
                    AEAD_STATS["open_s"] += dt
                    AEAD_STATS["open_cpu_s"] += dc
                    AEAD_STATS["frames_opened"] += frames.value
                if rc == -2:
                    raise ConnectionError(f"oversized frame {bad_len.value}")
                if rc != 0:
                    raise ConnectionError("AEAD open failed: bad tag")
                parts.append(out.raw[:out_len.value])
                del buf[:consumed.value]
                if done.value:
                    return b"".join(parts)
            self._fill()

    # --- public API -----------------------------------------------------------

    def send_message(self, data: bytes) -> None:
        self._write_frames(data)

    def recv_message(self) -> bytes:
        return self._read_message()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
