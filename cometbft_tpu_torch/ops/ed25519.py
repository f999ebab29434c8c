"""Batched ed25519 verification in torch (port of
`cometbft_tpu/ops/ed25519.py`).

Two formulations, as in the JAX package:

- `verify_core`: every lane evaluates the cofactored ZIP-215 equation
  [8]([s]B - R - [k]A) == O with shared doublings (Straus), so each lane
  gets its own verdict. It attributes a failed RLC chunk and serves
  strict mode. Plain torch.
- `verify_rlc_core_cuda`: one random-linear-combination equation per
  chunk, with the point stages in the three CUDA kernels of
  `cuda_verify` (decompression, window sums, epilogue). On a CPU tensor
  the same function runs their plain versions. Its lane-local part
  (the per-block partials of `rlc_window_sums`, and S = sum z_i s_i) and
  its finish (`rlc_epilogue`) are already separate calls.

Host-facing arrays are batch-leading numpy (`prepare_batch`); they move
to the device once, and the functions transpose them to the limb-leading
layout there.
"""

from __future__ import annotations

import functools
import secrets
from typing import Sequence, Tuple

import numpy as np
import torch

from . import cuda_verify as cv
from . import edwards as ed
from .field import fe_neg
from .scalar import (bytes_to_limbs, sc_dot_mod_l, sc_lt_l, sc_mul,
                     sc_nibbles, sc_reduce_wide)
from .sha512 import pad_messages, sha512_blocks
from ..crypto import ref_ed25519 as ref
from ..device import resolve_device

ZWIN = 32  # radix-16 windows covering the 128-bit random coefficients


class KernelCanaryError(RuntimeError):
    """The RLC kernels accepted a batch holding a known-invalid lane."""


def _split_sig(sig: torch.Tensor):
    sig_b = sig.movedim(-1, 0)                         # (64, N)
    return sig_b[:32], bytes_to_limbs(sig_b[32:])      # R bytes, s limbs


def _challenge(hblocks: torch.Tensor, hnblocks: torch.Tensor
               ) -> torch.Tensor:
    """k = SHA512(R || A || M) mod L -> (16, N)."""
    digest = sha512_blocks(hblocks, hnblocks).movedim(-1, 0)
    return sc_reduce_wide(bytes_to_limbs(digest))


def verify_core(pub: torch.Tensor, sig: torch.Tensor,
                hblocks: torch.Tensor, hnblocks: torch.Tensor,
                zip215: bool = True) -> torch.Tensor:
    """Per-lane verify.

    pub:      (N, 32) uint8 public keys
    sig:      (N, 64) uint8 signatures (R || s)
    hblocks:  (N, B, 128) uint8 SHA-512-padded R||A||M blocks
    hnblocks: (N,) int32 live block counts
    returns:  (N,) bool validity
    """
    r_enc, s = _split_sig(sig)
    s_ok = sc_lt_l(s)
    a_pt, a_ok = ed.pt_decompress(pub.movedim(-1, 0), zip215=zip215)
    r_pt, r_ok = ed.pt_decompress(r_enc, zip215=zip215)
    k = _challenge(hblocks, hnblocks)

    # [s]B + [k](-A), then subtract R, then clear the cofactor
    neg_a_tab = ed.window_table(ed.pt_neg(a_pt))
    acc = ed.straus_double_mul(s, k, neg_a_tab)
    acc = ed.pt_add(acc, ed.pt_neg(r_pt))
    acc = ed.pt_double(ed.pt_double(ed.pt_double(acc)))
    return s_ok & a_ok & r_ok & ed.pt_is_identity(acc)


def _scalar_side(s, s_ok, a_ok, r_ok, k, z):
    """Struct mask, S = sum z_i s_i mod L and t_i = z_i k_i mod L.
    Structurally invalid lanes get z zeroed, so they drop out of all
    three sums."""
    struct_ok = s_ok & a_ok & r_ok
    zl = z.movedim(-1, 0).to(torch.int64) * struct_ok[None]   # (8, N)
    s_sum = sc_dot_mod_l(zl, s)
    z16 = torch.cat([zl, torch.zeros_like(zl)])
    t = sc_mul(z16, k)
    return struct_ok, s_sum, z16, t


def _neg_packed(p: torch.Tensor) -> torch.Tensor:
    """-P of a packed point, strict limbs (the kernel boundary)."""
    return cv.pack_point((fe_neg(p[0]), p[1], p[2], fe_neg(p[3])))


def verify_rlc_core_cuda(pub: torch.Tensor, sig: torch.Tensor,
                         hblocks: torch.Tensor, hnblocks: torch.Tensor,
                         z: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random-linear-combination batch verify (counterpart of the JAX
    `verify_rlc_core_pallas`):

        [8]( [sum z_i s_i]B - sum z_i R_i - sum (z_i k_i) A_i ) == O

    with z_i 128-bit random coefficients (z: (N, 8) int32 limbs). The
    point stages run in the CUDA kernels: decompression of A and R (one
    call on their encodings side by side), the fused window sums, and
    the epilogue. SHA-512 and the scalar work stay in torch. Returns
    (batch_ok 0-d bool, struct_ok (N,) bool). If batch_ok is True every
    struct_ok lane holds a valid signature; if False the caller
    attributes with `verify_core`."""
    r_enc, s = _split_sig(sig)
    s_ok = sc_lt_l(s)
    # A and R in one call: (32, 2N), A's lanes first
    n = pub.shape[0]
    pts, oks = cv.pt_decompress_tiled(torch.cat(
        [pub.movedim(-1, 0), r_enc], dim=-1).to(torch.int32).contiguous())
    a_pt, r_pt = pts[..., :n], pts[..., n:]
    a_ok, r_ok = oks[:n], oks[n:]
    k = _challenge(hblocks, hnblocks)
    struct_ok, s_sum, z16, t = _scalar_side(s, s_ok, a_ok, r_ok, k, z)

    out = cv.rlc_window_sums(
        _neg_packed(a_pt), _neg_packed(r_pt),
        sc_nibbles(t).to(torch.int32).contiguous(),
        sc_nibbles(z16)[:ZWIN].to(torch.int32).contiguous())
    b_tab = torch.as_tensor(ed.small_base_table(), device=pub.device)
    batch_ok = cv.rlc_epilogue(cv.fold_partials(out), b_tab.contiguous(),
                               sc_nibbles(s_sum).to(torch.int32).contiguous())
    return batch_ok, struct_ok


def make_rlc_coefficients(n: int, rng=None) -> np.ndarray:
    """(n, 8) int32 16-bit limbs of 128-bit random coefficients. Defaults
    to OS entropy (`secrets`); an adversary who can predict z_i can craft
    a bad batch that passes the combined check. `rng` is a numpy
    Generator, for tests."""
    if rng is None:
        raw = np.frombuffer(secrets.token_bytes(16 * n), dtype=np.uint8)
    else:
        raw = rng.integers(0, 256, size=16 * n, dtype=np.uint8)
    b = raw.reshape(n, 16).astype(np.int32)
    return b[:, 0::2] | (b[:, 1::2] << 8)


# A known-good (pub, sig, msg) that pads partial batches: generated once
# from the oracle so padded lanes exercise the same code path.
@functools.lru_cache(maxsize=None)
def _dummy() -> Tuple[bytes, bytes, bytes]:
    seed = b"\x42" * 32
    msg = b"cometbft-tpu pad lane"
    return ref.pubkey_from_seed(seed), ref.sign(seed, msg), msg


def prepare_batch(pubs: Sequence[bytes], msgs: Sequence[bytes],
                  sigs: Sequence[bytes], batch_size: int,
                  max_msg_len: int = 256
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                             np.ndarray]:
    """Host marshalling: pad to `batch_size` lanes and build the SHA-512
    input blocks for k = H(R || A || M).

    Oversized or malformed inputs are mapped to the dummy lane and masked
    invalid. Returns (pub[N,32], sig[N,64], hblocks[N,B,128],
    hnblocks[N], ok[N]) where ok marks real lanes that were well-formed."""
    n = len(pubs)
    if not (n == len(msgs) == len(sigs)):
        raise ValueError("pubs/msgs/sigs length mismatch")
    if n > batch_size:
        raise ValueError(f"{n} signatures exceed batch_size {batch_size}")
    dpub, dsig, dmsg = _dummy()
    max_blocks = (64 + max_msg_len + 17 + 127) // 128

    pub_a = np.zeros((batch_size, 32), dtype=np.uint8)
    sig_a = np.zeros((batch_size, 64), dtype=np.uint8)
    live = np.zeros((batch_size,), dtype=bool)
    forced_bad = np.zeros((batch_size,), dtype=bool)
    hash_inputs = []
    for i in range(batch_size):
        if i < n:
            p, m, sg = pubs[i], msgs[i], sigs[i]
            live[i] = True
            if len(p) != 32 or len(sg) != 64 or len(m) > max_msg_len:
                forced_bad[i] = True
                p, m, sg = dpub, dmsg, dsig
        else:
            p, m, sg = dpub, dmsg, dsig
        pub_a[i] = np.frombuffer(p, dtype=np.uint8)
        sig_a[i] = np.frombuffer(sg, dtype=np.uint8)
        hash_inputs.append(sg[:32] + p + m)
    hblocks, hnblocks = pad_messages(hash_inputs, max_blocks)
    return pub_a, sig_a, hblocks, hnblocks, live & ~forced_bad


def _to_device(device, *arrays):
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


def verify_batch(pubs: Sequence[bytes], msgs: Sequence[bytes],
                 sigs: Sequence[bytes], batch_size: int | None = None,
                 zip215: bool = True, rlc: bool = True,
                 device=None) -> np.ndarray:
    """Host API: returns (len(pubs),) bool array.

    batch_size defaults to the next power of two; larger inputs are
    verified in batch_size chunks. The default path evaluates one RLC
    equation per chunk on the CUDA kernels; a failing chunk is attributed
    per lane by `verify_core`. Strict RFC 8032 mode (zip215=False) is
    per-lane only. `device` defaults to cuda and raises without a card."""
    dev = resolve_device(device)
    dispatch = _rlc_dispatch if (rlc and zip215) else None

    def fallback(pub, sig, hb, hn):
        return verify_core(pub, sig, hb, hn, zip215=zip215)

    return _verify_batch_loop(pubs, msgs, sigs, batch_size, dispatch,
                              fallback, dev)


# counters of the host protocol: chunks passed by the RLC equation, and
# chunks attributed per lane (failed equation or strict mode)
STATS = {"rlc_pass": 0, "per_lane": 0}


def _verify_batch_loop(pubs, msgs, sigs, batch_size, dispatch, fallback,
                       device) -> np.ndarray:
    """The host chunking protocol: pad each chunk to the fixed
    `batch_size` bucket with power-of-two message capacity, try one RLC
    equation per chunk via `dispatch(pub, sig, hb, hn, z)`, and attribute
    failed chunks (or serve strict mode, dispatch=None) via the per-lane
    `fallback(pub, sig, hb, hn)`."""
    n = len(pubs)
    if n == 0:
        return np.zeros((0,), dtype=bool)
    if batch_size is None:
        batch_size = 1 << (n - 1).bit_length()
    outs = []
    for lo in range(0, n, batch_size):
        hi = min(lo + batch_size, n)
        chunk_msgs = msgs[lo:hi]
        max_msg_len = max((len(m) for m in chunk_msgs), default=0)
        cap = 64
        while cap < max_msg_len:
            cap *= 2
        pub_a, sig_a, hb, hn, ok_mask = prepare_batch(
            pubs[lo:hi], chunk_msgs, sigs[lo:hi], batch_size, cap)
        args = _to_device(device, pub_a, sig_a, hb, hn)
        out = None
        if dispatch is not None:
            z = torch.as_tensor(make_rlc_coefficients(batch_size),
                                device=device)
            batch_ok, struct_ok = dispatch(*args, z)
            if bool(batch_ok):
                out = struct_ok.cpu().numpy()
                STATS["rlc_pass"] += 1
        if out is None:
            out = fallback(*args).cpu().numpy()
            STATS["per_lane"] += 1
        outs.append(out[:hi - lo] & ok_mask[:hi - lo])
    return np.concatenate(outs)


# Miscompile canary (reference posture: a batch verifier may never accept
# what per-signature verification would reject). On the first dispatch
# and every CANARY_INTERVAL-th after, the RLC kernels first run on a
# batch of known-good dummy lanes with one lane's s corrupted: the
# verdict must be False. A True raises KernelCanaryError; nothing
# degrades silently.
_CANARY_INTERVAL = 16
_canary = {"runs": 0, "trips": 0, "dispatches": 0}


def canary_stats() -> dict:
    """Snapshot of the canary counters ({"runs", "trips", "dispatches"})."""
    return dict(_canary)


@functools.lru_cache(maxsize=8)
def _canary_batch(batch_size: int, n_blocks: int):
    """Constant canary inputs for one (batch, hash-blocks) bucket: every
    lane carries the known-good dummy signature, except the last, whose s
    has bit 0 flipped (it stays canonical, so the batch equation must
    fail)."""
    pub, sig, msg = _dummy()
    bad = sig[:32] + bytes([sig[32] ^ 1]) + sig[33:]
    assert int.from_bytes(bad[32:64], "little") < ref.L
    pubs = [pub] * batch_size
    msgs = [msg] * batch_size
    sigs = [sig] * (batch_size - 1) + [bad]
    cap = max(n_blocks * 128 - 64 - 17, 1)  # msg cap giving >= n_blocks
    pub_a, sig_a, hb, hn, _ = prepare_batch(pubs, msgs, sigs,
                                            batch_size, cap)
    if hb.shape[1] < n_blocks:
        pad = np.zeros((batch_size, n_blocks - hb.shape[1], 128),
                       dtype=hb.dtype)
        hb = np.concatenate([hb, pad], axis=1)
    else:
        hb = hb[:, :n_blocks]
    z = make_rlc_coefficients(batch_size)
    return pub_a, sig_a, hb, hn, z


def _run_canary(batch_size: int, n_blocks: int, device) -> None:
    args = _to_device(device, *_canary_batch(batch_size, n_blocks))
    _canary["runs"] += 1
    batch_ok, _ = verify_rlc_core_cuda(*args)
    if bool(batch_ok):
        _canary["trips"] += 1
        raise KernelCanaryError(
            "RLC kernels returned batch_ok=True on a batch with a "
            f"known-invalid lane (batch {batch_size}, {n_blocks} blocks, "
            f"device {device})")


def _rlc_dispatch(pub, sig, hb, hn, z):
    """RLC verify through `verify_rlc_core_cuda`: the CUDA kernels on a
    CUDA tensor, their plain versions on a CPU one. No try around it: a
    build or launch failure raises, and so does a canary trip."""
    if _canary["dispatches"] % _CANARY_INTERVAL == 0:
        _run_canary(pub.shape[0], hb.shape[1], pub.device)
    _canary["dispatches"] += 1
    return verify_rlc_core_cuda(pub, sig, hb, hn, z)


_prewarmed: set = set()  # (device, batch, msg cap) warmed in this process


def prewarm_verify_kernels(batch_size: int = 8192, msg_cap: int = 128,
                           device=None) -> None:
    """Build the kernels and run the (batch, msg-cap) bucket's RLC path
    and the per-lane attribution path once before live traffic, so the
    nvcc build and the first launches do not land mid-blocksync. The
    tampered lane corrupts a low byte of s: the signature stays
    structurally valid and the per-lane path really runs. A bucket
    already warmed on the device in this process is not warmed again."""
    dev = resolve_device(device)
    key = (str(dev), batch_size, msg_cap)
    if key in _prewarmed:
        return
    pub, sig, msg = _dummy()
    bad = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
    pub_a, sig_a, hb, hn, _ = prepare_batch([pub], [msg], [sig],
                                            batch_size, msg_cap)
    z = torch.as_tensor(make_rlc_coefficients(batch_size), device=dev)
    _rlc_dispatch(*_to_device(dev, pub_a, sig_a, hb, hn), z)
    pub_a, sig_a, hb, hn, _ = prepare_batch([pub], [msg], [bad],
                                            batch_size, msg_cap)
    verify_core(*_to_device(dev, pub_a, sig_a, hb, hn), zip215=True)
    _prewarmed.add(key)
