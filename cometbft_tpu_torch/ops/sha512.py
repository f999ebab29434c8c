"""Batched SHA-512 as torch ops (port of `cometbft_tpu/ops/sha512.py`).

The verify path needs k = SHA512(R || A || M) mod L per signature.
In the JAX package this is XLA code, not a Pallas kernel, so here it is
plain torch.

Each 64-bit word is a (hi, lo) pair of 32-bit halves held in int64 and
masked to [0, 2^32) after every operation: additions carry explicitly
and rotations stitch the halves, so no signed shift ever leaks a sign bit
into a rotation. The block loop masks per lane by its live block count,
so one call serves messages of different lengths up to the padded
maximum. `pad_messages` does the MD padding on the host.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

M32 = 0xFFFFFFFF


def _icbrt(n: int) -> int:
    """floor(cbrt(n)) by integer Newton steps from above (a float start
    is ~2^14 off at n ~ 2^200, and stepping by one took seconds)."""
    x = 1 << -(-n.bit_length() // 3)
    while True:
        y = (2 * x + n // (x * x)) // 3
        if y >= x:
            return x
        x = y


def _primes(n: int):
    ps, c = [], 2
    while len(ps) < n:
        if all(c % p for p in ps if p * p <= c):
            ps.append(c)
        c += 1
    return ps


# round constants: frac(cbrt(p)) and init state frac(sqrt(p)), low 64 bits
_K64 = [_icbrt(p << 192) & ((1 << 64) - 1) for p in _primes(80)]
_H64 = [math.isqrt(p << 128) & ((1 << 64) - 1) for p in _primes(8)]

W64 = Tuple[torch.Tensor, torch.Tensor]  # (hi, lo), each in [0, 2^32)


def _add(*xs: W64) -> W64:
    """Sum of 64-bit words mod 2^64: halves summed in int64 (at most five
    terms, < 2^35), the low half's carry moved into the high half."""
    lo = xs[0][1]
    hi = xs[0][0]
    for x in xs[1:]:
        lo = lo + x[1]
        hi = hi + x[0]
    return (hi + (lo >> 32)) & M32, lo & M32


def _rotr(x: W64, n: int) -> W64:
    hi, lo = x
    if n >= 32:
        hi, lo = lo, hi
        n -= 32
    if n == 0:
        return hi, lo
    return (((hi >> n) | (lo << (32 - n))) & M32,
            ((lo >> n) | (hi << (32 - n))) & M32)


def _shr(x: W64, n: int) -> W64:
    hi, lo = x
    if n < 32:
        return hi >> n, ((lo >> n) | (hi << (32 - n))) & M32
    return torch.zeros_like(hi), hi >> (n - 32)


def _xor3(a: W64, b: W64, c: W64) -> W64:
    return a[0] ^ b[0] ^ c[0], a[1] ^ b[1] ^ c[1]


def _big_sigma0(x):
    return _xor3(_rotr(x, 28), _rotr(x, 34), _rotr(x, 39))


def _big_sigma1(x):
    return _xor3(_rotr(x, 14), _rotr(x, 18), _rotr(x, 41))


def _small_sigma0(x):
    return _xor3(_rotr(x, 1), _rotr(x, 8), _shr(x, 7))


def _small_sigma1(x):
    return _xor3(_rotr(x, 19), _rotr(x, 61), _shr(x, 6))


def _ch(e: W64, f: W64, g: W64) -> W64:
    return ((e[0] & f[0]) ^ ((e[0] ^ M32) & g[0]),
            (e[1] & f[1]) ^ ((e[1] ^ M32) & g[1]))


def _maj(a: W64, b: W64, c: W64) -> W64:
    return ((a[0] & b[0]) ^ (a[0] & c[0]) ^ (b[0] & c[0]),
            (a[1] & b[1]) ^ (a[1] & c[1]) ^ (b[1] & c[1]))


def _compress(state: list, w: list) -> list:
    """One SHA-512 compression: state is 8 words, w the 16 block words,
    each word a (hi, lo) pair of (...,) tensors."""
    w = list(w)
    a, b, c, d, e, f, g, h = state
    for t in range(80):
        if t >= 16:
            w.append(_add(_small_sigma1(w[t - 2]), w[t - 7],
                          _small_sigma0(w[t - 15]), w[t - 16]))
        k = (_K64[t] >> 32, _K64[t] & M32)
        t1 = _add(h, _big_sigma1(e), _ch(e, f, g), k, w[t])
        t2 = _add(_big_sigma0(a), _maj(a, b, c))
        h, g, f, e, d, c, b, a = g, f, e, _add(d, t1), c, b, a, _add(t1, t2)
    return [_add(s, r) for s, r in zip(state, (a, b, c, d, e, f, g, h))]


def _block_words(block: torch.Tensor) -> list:
    """(..., 128) bytes big-endian -> 16 (hi, lo) words."""
    b = block.to(torch.int64).reshape(*block.shape[:-1], 16, 8)
    hi = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]
    lo = (b[..., 4] << 24) | (b[..., 5] << 16) | (b[..., 6] << 8) | b[..., 7]
    return [(hi[..., i], lo[..., i]) for i in range(16)]


def sha512_blocks(blocks: torch.Tensor, nblocks: torch.Tensor
                  ) -> torch.Tensor:
    """SHA-512 over pre-padded blocks.

    blocks:  (..., B, 128) uint8, already MD-padded (see pad_messages)
    nblocks: (...,) int, how many of the B blocks are live per message
    returns: (..., 64) uint8 digest
    """
    batch = blocks.shape[:-2]
    zero = torch.zeros(batch, dtype=torch.int64, device=blocks.device)
    state = [(zero + (h >> 32), zero + (h & M32)) for h in _H64]
    nblocks = nblocks.to(device=blocks.device)
    for bi in range(blocks.shape[-2]):
        new = _compress(state, _block_words(blocks[..., bi, :]))
        live = bi < nblocks
        state = [(torch.where(live, n[0], s[0]), torch.where(live, n[1], s[1]))
                 for n, s in zip(new, state)]
    words = torch.stack([torch.stack(s, dim=-1) for s in state], dim=-2)
    shifts = torch.tensor([24, 16, 8, 0], device=blocks.device)
    out = (words[..., None] >> shifts) & 0xFF          # (..., 8, 2, 4)
    return out.reshape(*batch, 64).to(torch.uint8)


def pad_messages(msgs, max_blocks: int) -> tuple[np.ndarray, np.ndarray]:
    """Host helper: list of bytes -> (N, max_blocks, 128) uint8 + (N,)
    int32. Standard SHA-512 padding: 0x80, zeros, 128-bit big-endian bit
    length."""
    n = len(msgs)
    out = np.zeros((n, max_blocks, 128), dtype=np.uint8)
    nblocks = np.zeros((n,), dtype=np.int32)
    for i, m in enumerate(msgs):
        ln = len(m)
        nb = (ln + 17 + 127) // 128
        if nb > max_blocks:
            raise ValueError(f"message {ln}B needs {nb} blocks > {max_blocks}")
        buf = bytearray(nb * 128)
        buf[:ln] = m
        buf[ln] = 0x80
        buf[-16:] = (8 * ln).to_bytes(16, "big")
        out[i, :nb] = np.frombuffer(bytes(buf), dtype=np.uint8).reshape(nb, 128)
        nblocks[i] = nb
    return out, nblocks
